"""N1, NEE's light-sample kernel (ops/kernels/nee.py, csrc/nee.cu), against
its plain versions render/nee.py::nee_sample_plain and nee_contrib_plain.

On the CPU: the wrappers' contract (CPU tensors take the plain versions and
launch nothing; what a launch does not take raises), and
render/nee.py::direct_light, now the two calls around the shadow rays,
against the body as it was written before the sample became N1
(`direct_light_before` below), bit for bit on the first two bounces of a
scene with triangle and sphere lights, one with triangle lights alone and
`volume_parameterized` (a sphere light, media, parameterized surfaces).

On the card (marked `gpu`, skipped without one; the file imports no JAX):
every output of N1 bit-identical to the plain versions run on the same card
(NaN where they have NaN), on the bounce-0 and bounce-1 hits of those scenes
at 70,001 and 1,048,576 rays and on seeded hits of every material type; the
NEE bounces of the bench teapot's chunk 0 (bench.nee's cell) through the
executor, each call compared as it happens; 112 launches of each entry an
image of bench.nee's scene and none on demo.staged's; the registers and
spills of both entries. Run them there:

    python -m pytest tests/test_torch_nee_kernel.py -q -m gpu
"""

import dataclasses

import numpy as np
import pytest
import torch

import cs397raytracingsp22_tpu_torch as T
from cs397raytracingsp22_tpu_torch.ops.intersect import intersect_scene, intersect_scene_plain
from cs397raytracingsp22_tpu_torch.ops.kernels import nee as n1
from cs397raytracingsp22_tpu_torch.ops.kernels import shade
from cs397raytracingsp22_tpu_torch.render import driver, integrator, nee
from cs397raytracingsp22_tpu_torch.scenes import bench_scene, cornell
from cs397raytracingsp22_tpu_torch.utils import rng as rnglib
from cs397raytracingsp22_tpu_torch.utils import vecmath as vm
# sibling test modules by their bare names (pytest puts tests/ on sys.path)
from test_torch_bounce_kernel import volume_parameterized
from test_torch_shade_kernel import _Done, cell_scene, seeded

torch.set_num_threads(1)  # several test workers share the cores

MAX_DIST = 100.0
KEY = 2**33 + 22
SAMPLE_OUTPUTS = ("did", "shoot", "sh_o", "sh_dir", "t_max", "pending")
# name -> the scene built at (width, height, spp); its light counts
SCENES = {
    "cornell_config3": (lambda w, h, spp: cornell.build_config3(w, h, spp=spp, path_depth=4),
                        (2, 1)),
    "bench_scene": (lambda w, h, spp: bench_scene.build(w, h, spp=spp, path_depth=8), (2, 0)),
    "volume_parameterized": (lambda w, h, spp: sized(volume_parameterized(T), w, h, spp), (0, 2)),
}


def sized(scene, w, h, spp):
    cam = dataclasses.replace(scene.camera, screen_width=w, screen_height=h, aa_sample_count=spp)
    return dataclasses.replace(scene, camera=cam)


def bounce_inputs(name: str, n: int, dev):
    """The scene's compiled tables and the inputs of NEE's sample at bounces
    0 and 1 of its first n camera rays (n <= 256² × 16), the path's bounce
    body between them (K2 and S1 on the card): [(hit, d_in, u_choice,
    alive, u, uids)]."""
    build, counts = SCENES[name]
    side, spp = (32, 4) if n <= 4096 else (256, 16)
    scene = build(side, side, spp)
    sd, cam = scene.compile(device=dev), scene.camera
    assert (sd.n_lt_tri, sd.n_lt_sph) == counts and sd.nee_ok
    ids = torch.arange(side * side, dtype=torch.int32, device=dev)
    o, d, uids = driver._gen_chunk_rays(cam, ids, KEY, 0, spp, 1)
    o, d, uids = o[:n], d[:n], uids[:n]
    thr = torch.ones((n, 3), device=dev)
    rad = torch.zeros((n, 3), device=dev)
    alive = torch.ones((n,), dtype=torch.bool, device=dev)
    out = []
    for depth in range(2):
        ball, u_choice, u_vol = integrator._bounce_draws(sd, KEY, uids,
                                                         rnglib.SITE_BOUNCE0 + depth)
        t_max = torch.where(alive, MAX_DIST, 0.0)
        hit = intersect_scene(sd, o, d, integrator.PATH_T_MIN, t_max, u_vol)
        out.append((hit, d, u_choice, alive, nee.nee_draws(sd, KEY, uids, depth), uids))
        o, d, thr, rad, alive, _ = shade.shade_update(hit, o, d, thr, rad, alive, ball, u_choice)
    return sd, out


def same_bits(a, b) -> torch.Tensor:
    """Per row: a and b equal bit for bit (NaN where the other is NaN)."""
    assert a.shape == b.shape and a.dtype == b.dtype
    if a.dtype == torch.float32:
        same = (a.view(torch.int32) == b.view(torch.int32)) | (a.isnan() & b.isnan())
    else:
        same = a == b
    return same.reshape(a.shape[0], -1).all(dim=1)


def assert_same(got, want, names, what=""):
    assert len(got) == len(want) == len(names)
    for name, a, b in zip(names, got, want):
        bad = (~same_bits(a.contiguous(), b.contiguous())).nonzero()[:, 0]
        assert bad.numel() == 0, (what, name, bad[:8].tolist())


# ---------------------------------------------------------------- CPU ----


def direct_light_before(scene, hit, d_in, u_choice, live, uids, rng_key, depth, t_min,
                        max_trace_dist, intersect):
    """render/nee.py::direct_light as it was before its sample became N1:
    one body of torch ops around the shadow rays, live the live hits."""
    u = nee.nee_draws(scene, rng_key, uids, depth)
    x, n_l, emission, inv_pdf = nee.sample_light_point(scene, u[:, 0], u[:, 1], u[:, 2])
    has_normal = vm.magnitude2(hit.normal) > 0.0
    applies, f, ball_weighted = nee._diffuse_mask(hit, d_in, u_choice, has_normal)
    did = live & applies
    to_l = x - hit.point
    dist2 = vm.dot(to_l, to_l)
    inv_dist = torch.rsqrt(torch.clamp(dist2, min=1e-12))
    dist = dist2 * inv_dist
    wl = to_l * inv_dist[:, None]
    cos_x = torch.where(has_normal, torch.clamp(vm.dot(wl, hit.normal), 0.0, 1.0),
                        torch.ones_like(dist))
    cos_y = torch.abs(vm.dot(wl, n_l))
    r_len = torch.clamp(u[:, 3] ** (1.0 / 3.0), min=1e-6)
    t_light = dist / r_len
    shoot = did & (t_light <= max_trace_dist)
    sh_o = torch.where(shoot[:, None], hit.point, 0.0)
    sh_dir = torch.where(shoot[:, None], wl * r_len[:, None], 1.0)
    t_max = torch.where(shoot, nee.SHADOW_T_MAX * t_light, 0.0)
    sh = intersect(scene, sh_o, sh_dir, t_min, t_max, u[:, 4:].contiguous())
    geo = cos_x * cos_y / torch.clamp(dist2, min=1e-12) * inv_pdf
    geo = geo * torch.where(ball_weighted, r_len, torch.ones_like(r_len))
    ok = shoot & ~sh.valid
    contrib = torch.where(ok[:, None], f * emission * geo[:, None], 0.0)
    return contrib, did, shoot.sum()


@pytest.mark.parametrize("name", sorted(SCENES))
def test_direct_light_matches_the_body_before(name):
    """direct_light (N1's plain versions on CPU tensors around the shadow
    rays, the rays alive) against direct_light_before (the live hits), on
    1,024 rays at bounces 0 and 1: contribution, did and shadow-ray count
    bit for bit."""
    sd, inputs = bounce_inputs(name, 1024, "cpu")
    before = dict(n1.LAUNCHES)
    for depth, (hit, d, u_choice, alive, _, uids) in enumerate(inputs):
        args = (uids, KEY, depth, integrator.PATH_T_MIN, MAX_DIST)
        got = nee.direct_light(sd, hit, d, u_choice, alive, *args,
                               intersect=intersect_scene_plain)
        want = direct_light_before(sd, hit, d, u_choice, alive & hit.valid, *args,
                                   intersect=intersect_scene_plain)
        assert_same(got[:2], want[:2], ("contrib", "did"), (name, depth))
        assert got[2].dtype == torch.int64 and int(got[2]) == int(want[2]) > 0
        assert bool((got[0].amax(dim=1) > 0).any()), "the lights must reach the vertices"
    assert n1.LAUNCHES == before


@pytest.mark.parametrize("name", sorted(SCENES))
def test_cpu_tensors_take_the_plain_version(name):
    sd, inputs = bounce_inputs(name, 1024, "cpu")
    hit, d, u_choice, alive, u, _ = inputs[1]
    before = dict(n1.LAUNCHES)
    got = n1.nee_sample(sd, hit, d, u_choice, alive, u, MAX_DIST)
    want = nee.nee_sample_plain(sd, hit, d, u_choice, alive, u, MAX_DIST)
    assert_same(got, want, SAMPLE_OUTPUTS, name)
    assert [x.dtype for x in got] == [torch.bool] * 2 + [torch.float32] * 4
    did, shoot = got[:2]
    assert bool(shoot.any()) and not bool((shoot & ~did).any()) and not bool((did & ~alive).any())
    sh_valid = torch.arange(alive.shape[0]) % 3 == 0
    contrib = n1.nee_contrib(sh_valid, got[5])
    assert_same([contrib], [nee.nee_contrib_plain(sh_valid, got[5])], ["contrib"], name)
    assert n1.LAUNCHES == before
    if not torch.cuda.is_available():
        assert before == {"nee_sample": 0, "nee_contrib": 0}


@pytest.mark.parametrize("bad", ["float64_d_in", "float64_albedo", "int64_mtype", "strided_d_in",
                                 "strided_u", "narrow_u", "shape_point", "shape_u_choice",
                                 "int_live", "float64_lt_sph", "no_lights", "cuda_expected"])
def test_sample_launch_checks_raise(bad):
    """What a sample launch checks before it launches, on CPU tensors
    against the device a launch expects."""
    sd, inputs = bounce_inputs("cornell_config3", 256, "cpu")
    # the plain draws and intersection give some views; a launch takes them packed
    hit, d, u_choice, alive, u, _ = (
        dataclasses.replace(x, **{f.name: getattr(x, f.name).contiguous()
                                  for f in dataclasses.fields(x)})
        if dataclasses.is_dataclass(x) else x.contiguous() for x in inputs[0])
    rays = dict(d_in=d, u_choice=u_choice, live=alive)
    dev = torch.device("cpu")
    assert n1.check_sample_inputs(sd, hit, rays, u, dev) == 256
    if bad == "float64_d_in":
        rays["d_in"] = d.double()
    elif bad == "float64_albedo":
        hit = dataclasses.replace(hit, albedo=hit.albedo.double())
    elif bad == "int64_mtype":
        hit = dataclasses.replace(hit, mtype=hit.mtype.long())
    elif bad == "strided_d_in":
        rays["d_in"] = torch.cat([d, d], dim=1)[:, ::2]
    elif bad == "strided_u":
        u = torch.cat([u, u], dim=1)[:, ::2]
    elif bad == "narrow_u":
        u = u[:, :3].contiguous()
    elif bad == "shape_point":
        hit = dataclasses.replace(hit, point=hit.point[:255])
    elif bad == "shape_u_choice":
        rays["u_choice"] = u_choice[:, None]
    elif bad == "int_live":
        rays["live"] = alive.to(torch.int32)
    elif bad == "float64_lt_sph":
        sd = dataclasses.replace(sd, lt_sph=sd.lt_sph.double())
    elif bad == "no_lights":
        sd = dataclasses.replace(sd, n_lt_tri=0, n_lt_sph=0)
    else:
        dev = torch.device("cuda")  # CPU tensors where the launch's device is CUDA
    with pytest.raises(ValueError):
        n1.check_sample_inputs(sd, hit, rays, u, dev)


def test_other_devices_raise():
    """Meta tensors: both entries take CPU or CUDA tensors."""
    sd, inputs = bounce_inputs("cornell_config3", 64, "cpu")
    hit, d, u_choice, alive, u, _ = inputs[0]
    with pytest.raises(ValueError, match="CPU or CUDA"):
        n1.nee_sample(sd, hit, d.to("meta"), u_choice, alive, u, MAX_DIST)
    flags = torch.zeros((8,), dtype=torch.bool, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        n1.nee_contrib(flags, torch.zeros((8, 3), device="meta"))


# --------------------------------------------------------------- card ----


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def check_on_card(sd, hit, d, u_choice, live, u, what):
    """N1a and N1b against their plain versions on the same inputs, one
    launch each; returns the rays that shot."""
    before = dict(n1.LAUNCHES)
    got = n1.nee_sample(sd, hit, d, u_choice, live, u, MAX_DIST)
    assert_same(got, nee.nee_sample_plain(sd, hit, d, u_choice, live, u, MAX_DIST),
                SAMPLE_OUTPUTS, what)
    shoot, pending = got[1], got[5]
    sh_valid = (torch.arange(live.shape[0], device=live.device) % 3 == 0) | ~hit.valid
    contrib = n1.nee_contrib(sh_valid, pending)
    assert_same([contrib], [nee.nee_contrib_plain(sh_valid, pending)], ["contrib"], what)
    assert n1.LAUNCHES == {k: v + 1 for k, v in before.items()}
    return int(shoot.sum())


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(SCENES))
@pytest.mark.parametrize("n", [70_001, 1 << 20])
def test_nee_on_card(cuda, name, n):
    """The scene's bounce-0 and bounce-1 NEE inputs: every output of N1
    bit-identical to the plain versions on the same card."""
    sd, inputs = bounce_inputs(name, n, cuda)
    for depth, (hit, d, u_choice, alive, u, _) in enumerate(inputs):
        assert check_on_card(sd, hit, d, u_choice, alive, u, (name, n, depth)) > 0


@pytest.mark.gpu
@pytest.mark.parametrize("n", [70_001, 1 << 20])
def test_nee_on_card_seeded(cuda, n):
    """Seeded hits of every material type (unknown ones, zero and
    unnormalised normals, dead rays), uniform draws with both ends of
    [0, 1), lights of both kinds: N1 bit-identical to the plain versions."""
    sd = cornell.build_config3(8, 8, spp=1).compile(device=cuda)
    hit, state, _, _ = seeded(n, seed=n, dev=cuda)
    g = np.random.default_rng(n + 1)
    u = g.random((n, 6)).astype(np.float32)
    u[:16] = [[0.0] * 6, [1 - 2**-24] * 6] * 8
    u = torch.from_numpy(u).to(cuda)
    check_on_card(sd, hit, state["d"], state["u_choice"], state["alive"], u, ("seeded", n))


@pytest.mark.gpu
def test_bench_nee_chunk_on_card(cuda, monkeypatch):
    """bench.nee's chunk 0 (1,048,576 camera rays of the bench teapot with
    NEE) through the executor: N1's calls at its first two NEE bounces each
    compared with the plain versions on their own inputs as they happen."""
    scene = cell_scene("bench.nee")
    sd, cam = scene.compile(device=cuda), scene.camera
    px = driver.chunk_pixels(sd, cam, cam.aa_sample_count)
    n_px = cam.screen_width * cam.screen_height
    ids = torch.arange(px, dtype=torch.int32, device=cuda) * ((n_px + px - 1) // px)
    o, d, uids = driver._gen_chunk_rays(cam, ids, KEY, 0, cam.aa_sample_count, 1)
    assert o.shape[0] == 1_048_576
    calls, sample, contrib = [0, 0], n1.nee_sample, n1.nee_contrib

    def checked_sample(*args):
        got = sample(*args)
        assert_same(got, nee.nee_sample_plain(*args), SAMPLE_OUTPUTS, calls[0])
        assert bool(got[1].any())
        calls[0] += 1
        return got

    def checked_contrib(*args):
        got = contrib(*args)
        assert_same([got], [nee.nee_contrib_plain(*args)], ["contrib"], calls[1])
        assert bool((got > 0).any())
        calls[1] += 1
        if calls[1] == 2:
            raise _Done
        return got

    monkeypatch.setattr(n1, "nee_sample", checked_sample)
    monkeypatch.setattr(n1, "nee_contrib", checked_contrib)
    with pytest.raises(_Done):
        integrator.path_trace_shrink(sd, o, d, uids, KEY, cam.path_depth, cam.max_trace_dist,
                                     nee=True)
    assert calls == [2, 2]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["demo.staged", "bench.nee"])
def test_render_launch_counts(cuda, cell):
    """Each entry of N1 once a NEE bounce of a render: 16 chunks × 7 NEE
    bounces = 112 an image of bench.nee's scene; none on demo.staged's."""
    scene = cell_scene(cell)
    before = dict(n1.LAUNCHES)
    _, stats = driver.render_to_image(scene, device=cuda, seed=11, verbose=False)
    torch.cuda.synchronize()
    per = 0 if cell == "demo.staged" else stats.chunks * (scene.camera.path_depth - 1)
    assert per in (0, 112)
    assert n1.LAUNCHES == {k: v + per for k, v in before.items()}


@pytest.mark.gpu
def test_kernel_attrs(cuda):
    """Both entries build with no spills."""
    for entry in n1.LAUNCHES:
        regs, spill = n1.kernel_attrs(entry)
        assert 0 < regs <= 255 and spill == 0, (entry, regs, spill)


@pytest.mark.gpu
def test_card_launch_checks_raise(cuda):
    sd, inputs = bounce_inputs("cornell_config3", 256, cuda)
    hit, d, u_choice, alive, u, _ = inputs[0]
    for bad in (dict(d_in=d.double()), dict(u=u[:, :3].contiguous()), dict(live=alive.cpu()),
                dict(u_choice=u_choice[:128])):
        args = dict(d_in=d, u_choice=u_choice, live=alive, u=u) | bad
        with pytest.raises(ValueError):
            n1.nee_sample(sd, hit, max_trace_dist=MAX_DIST, **args)
    pending = torch.zeros((256, 3), device=cuda)
    for valid, bad in ((alive.cpu(), pending), (alive, pending.double()), (alive[:128], pending),
                       (alive.to(torch.uint8), pending), (alive, pending[:, :2])):
        with pytest.raises(ValueError):
            n1.nee_contrib(valid, bad)
