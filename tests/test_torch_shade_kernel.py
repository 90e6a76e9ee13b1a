"""S1, the per-bounce shading kernel (ops/kernels/shade.py, csrc/shade.cu),
against its plain version ops/bsdf.py::shade_plain.

On the CPU: the wrapper's contract (CPU tensors take the plain version and
launch nothing; what a launch does not take raises), and the bounce body
integrator.bounce_update, which now shades through the wrapper, against the
body as it was written before the shading became one call (`body_before`
below, NEE's sample after the scatter), bit for bit on the Cornell box's
rays with NEE off, on, on its first bounce and on its last.

On the card (marked `gpu`, skipped without one; the file imports no JAX):
every output of S1 bit-identical to shade_plain run on the same card (NaN
where it has NaN), on seeded hits of each material (both faces, a
dielectric's critical angle, zero-normal volume hits, unknown types, dead
rays, NEE's flags and terms, non-finite throughputs) and on the rays of
bounces 0-2 of demo_scene's chunk 0 through the staged executor and of the
bench teapot's chunk 0 with NEE; and one launch per bounce of a render of
the demo.staged and bench.nee cells' scenes. Run them there:

    python -m pytest tests/test_torch_shade_kernel.py -q -m gpu
"""

import dataclasses

import numpy as np
import pytest
import torch

from cs397raytracingsp22_tpu_torch.ops import bsdf
from cs397raytracingsp22_tpu_torch.ops.intersect import HitRecord, intersect_scene_plain
from cs397raytracingsp22_tpu_torch.ops.kernels import shade
from cs397raytracingsp22_tpu_torch.render import driver, integrator, nee
from cs397raytracingsp22_tpu_torch.scenes import bench_scene, cornell, drone_demo
from cs397raytracingsp22_tpu_torch.utils import rng as rnglib
from cs397raytracingsp22_tpu_torch.utils import vecmath as vm

torch.set_num_threads(1)  # several test workers share the cores

OUTPUTS = ("o", "d", "thr", "rad", "live_hit", "prev_nee")
# the modes of a bounce: (previous vertex's NEE flags given, NEE sample given)
MODES = {"path": (False, False), "nee": (True, True), "nee_first": (False, True),
         "nee_last": (True, False)}


def seeded(n: int, seed: int, dev):
    """Seeded inputs of a shading over n rays: (hit, state, prev_nee,
    (contrib, did)). Material types 0-4 and a few unknown ones (-1, 5),
    front and back faces, indices of refraction from 1 to 2.5 (a back face
    sees eta = ior, so a dielectric meets its critical angle), roughness
    and metallic at 0, 1 and between, a tenth of the normals zero (volume
    hits) and some not of unit length, unnormalised directions, a fifth of
    the rays dead and a sixth missed, a few throughputs inf or NaN."""
    g = np.random.default_rng(seed)

    def unit(m):
        v = g.normal(size=(m, 3))
        return v / np.linalg.norm(v, axis=1, keepdims=True)

    normal = unit(n) * np.where(g.random(n) < 0.2, g.uniform(0.5, 2.0, n), 1.0)[:, None]
    normal[g.random(n) < 0.1] = 0.0
    mtype = g.choice([-1, 0, 1, 2, 3, 4, 5], n, p=[0.01, 0.2, 0.2, 0.25, 0.2, 0.13, 0.01])
    rough = g.random(n)
    rough[g.random(n) < 0.1] = 0.0
    rough[g.random(n) < 0.1] = 1.0
    metal = g.random(n)
    metal[g.random(n) < 0.1] = 0.0
    metal[g.random(n) < 0.1] = 1.0
    ior = g.uniform(1.0, 2.5, n)
    ior[::7] = 1.5
    emission = np.where(g.random(n)[:, None] < 0.3, g.uniform(0.0, 5.0, (n, 3)), 0.0)
    ball = unit(n) * g.random(n)[:, None] ** (1.0 / 3.0)
    thr = g.uniform(0.0, 2.0, (n, 3))
    thr[::997, 0] = np.inf
    thr[1::1009, 1] = np.nan

    def on(x, dtype=torch.float32):
        return torch.as_tensor(np.ascontiguousarray(x)).to(dtype).to(dev)

    o = g.normal(size=(n, 3)) * 3.0
    d = g.normal(size=(n, 3))
    t = g.uniform(1e-3, 20.0, n)
    hit = HitRecord(valid=on(g.random(n) < 0.85, torch.bool), t=on(t),
                    point=on(o + t[:, None] * d), normal=on(normal),
                    frontface=on(g.random(n) < 0.5, torch.bool), mtype=on(mtype, torch.int32),
                    albedo=on(g.random((n, 3))), emission=on(emission), roughness=on(rough),
                    metallic=on(metal), ior=on(ior))
    state = dict(o=on(o), d=on(d), thr=on(thr), rad=on(g.uniform(0.0, 3.0, (n, 3))),
                 alive=on(g.random(n) < 0.8, torch.bool), ball=on(ball),
                 u_choice=on(g.random(n)))
    sample = (on(g.uniform(0.0, 2.0, (n, 3))), on(g.random(n) < 0.6, torch.bool))
    return hit, state, on(g.random(n) < 0.3, torch.bool), sample


def args_of(mode, state, prev_nee, sample):
    has_prev, has_sample = MODES[mode]
    return dict(state, prev_nee=prev_nee if has_prev else None,
                nee=sample if has_sample else None)


def assert_same(got, want, what=""):
    """Every output bit for bit; a float may be NaN where the other is NaN;
    prev_nee None in both or equal."""
    assert len(got) == len(want) == len(OUTPUTS)
    for name, a, b in zip(OUTPUTS, got, want):
        if a is None or b is None:
            assert a is None and b is None, (what, name)
            continue
        a, b = a.contiguous(), b.contiguous()
        assert a.shape == b.shape and a.dtype == b.dtype, (what, name)
        if a.dtype == torch.float32:
            same = (a.view(torch.int32) == b.view(torch.int32)) | (a.isnan() & b.isnan())
        else:
            same = a == b
        bad = (~same).reshape(a.shape[0], -1).any(dim=1).nonzero()[:, 0]
        assert bad.numel() == 0, (what, name, bad[:8].tolist())


# ---------------------------------------------------------------- CPU ----


def body_before(scene, o, d, thr, rad, alive, uids, rng_key, depth, max_trace_dist, *,
                intersect, prev_nee=None, do_nee=False):
    """integrator.bounce_update as it was before its shading became one call
    of shade.shade_update: the miss term before the span, NEE's sample
    after the scatter."""
    ball, u_choice, u_vol = integrator._bounce_draws(scene, rng_key, uids,
                                                     rnglib.SITE_BOUNCE0 + depth)
    t_max = torch.where(
        alive,
        torch.full_like(alive, max_trace_dist, dtype=torch.float32),
        torch.zeros_like(alive, dtype=torch.float32),
    )
    hit = intersect(scene, o, d, integrator.PATH_T_MIN, t_max, u_vol)
    live_hit = alive & hit.valid
    live_miss = alive & ~hit.valid
    background = torch.zeros(d.shape[:-1] + (3,), dtype=torch.float32, device=d.device)
    rad = rad + torch.where(live_miss[:, None], thr * background, 0.0)
    segs = alive.sum()
    emit = live_hit if prev_nee is None else live_hit & ~prev_nee
    rad = rad + torch.where(emit[:, None], thr * hit.emission, 0.0)
    new_dir, att, inv_pdf = bsdf.scatter(hit, d, ball, u_choice)
    has_normal = vm.magnitude2(hit.normal) > 0.0
    dot_term = torch.where(
        has_normal,
        torch.clamp(torch.abs(vm.dot(new_dir, hit.normal)), 0.0, 1.0),
        torch.ones_like(inv_pdf),
    )
    factor = (dot_term * inv_pdf)[:, None] * att
    prev_nee = None
    if do_nee:
        contrib, did, shadow = nee.direct_light(
            scene, hit, d, u_choice, live_hit, uids, rng_key, depth, integrator.PATH_T_MIN,
            max_trace_dist, intersect=intersect,
        )
        rad = rad + torch.where(live_hit[:, None], thr * contrib, 0.0)
        prev_nee = live_hit & did
        segs = segs + shadow
    thr = torch.where(live_hit[:, None], thr * factor, thr)
    o = torch.where(live_hit[:, None], hit.point, o)
    d = torch.where(live_hit[:, None], new_dir, d)
    return o, d, thr, rad, live_hit, prev_nee, segs


@pytest.fixture(scope="module")
def cornell_rays():
    """The Cornell box with its spheres (a NEE-able scene, every material
    type but Isotropic): 4,096 camera rays and the compiled tables."""
    scene = cornell.build_config3(32, 32, spp=4, path_depth=4)
    sd = scene.compile(device="cpu")
    o, d, uids = driver._gen_chunk_rays(scene.camera, torch.arange(32 * 32, dtype=torch.int32),
                                        7, 0, 4, 1)
    return sd, o, d, uids


@pytest.mark.parametrize("mode", sorted(MODES))
def test_bounce_body_matches_the_body_before(cornell_rays, mode):
    """Three bounces of integrator.bounce_update (the plain shading on CPU
    tensors) against body_before, every output bit for bit, with the
    previous vertex's flags and NEE's sample as the mode gives them."""
    sd, o, d, uids = cornell_rays
    has_prev, has_sample = MODES[mode]
    n = o.shape[0]
    state = (o, d, torch.ones((n, 3)), torch.zeros((n, 3)), torch.ones((n,), dtype=torch.bool))
    prev = torch.arange(n) % 3 == 0 if has_prev else None
    before = dict(shade.LAUNCHES)
    for depth in range(3):
        kw = dict(intersect=intersect_scene_plain, prev_nee=prev, do_nee=has_sample)
        got = integrator.bounce_update(sd, *state, uids, 7, depth, 100.0, **kw)
        want = body_before(sd, *state, uids, 7, depth, 100.0, **kw)
        assert_same(got[:6], want[:6], (mode, depth))
        assert torch.equal(got[6], want[6])
        assert bool(got[4].any()), "no ray hit anything"
        state = got[:5]
        if has_prev:
            prev = got[5] if has_sample else torch.arange(n) % (depth + 2) == 0
    assert shade.LAUNCHES == before


@pytest.mark.parametrize("mode", sorted(MODES))
def test_cpu_tensors_take_the_plain_version(mode):
    hit, state, prev, sample = seeded(3000, seed=len(mode), dev="cpu")
    args = args_of(mode, state, prev, sample)
    before = dict(shade.LAUNCHES)
    got = shade.shade_update(hit, **args)
    assert_same(got, bsdf.shade_plain(hit, **args), mode)
    assert (got[5] is None) == (args["nee"] is None)
    assert shade.LAUNCHES == before
    if not torch.cuda.is_available():
        assert before == {"shade": 0}


@pytest.mark.parametrize("bad", ["float64_thr", "int64_mtype", "uint8_alive", "strided_o",
                                 "strided_u_choice", "shape_d", "shape_ior", "shape_contrib",
                                 "int_did", "cuda_expected"])
def test_launch_checks_raise(bad):
    """What a launch checks before it launches, on CPU tensors against the
    device a launch expects."""
    hit, state, prev, (contrib, did) = seeded(64, seed=5, dev="cpu")
    dev = torch.device("cpu")
    nee_inputs = dict(prev_nee=prev, contrib=contrib, did=did)
    assert shade.check_inputs(hit, state, nee_inputs, dev) == 64
    assert shade.check_inputs(hit, state, dict.fromkeys(nee_inputs), dev) == 64
    if bad == "float64_thr":
        state["thr"] = state["thr"].double()
    elif bad == "int64_mtype":
        hit = dataclasses.replace(hit, mtype=hit.mtype.long())
    elif bad == "uint8_alive":
        state["alive"] = state["alive"].to(torch.uint8)
    elif bad == "strided_o":
        state["o"] = torch.cat([state["o"], state["o"]], dim=1)[:, ::2]
    elif bad == "strided_u_choice":
        state["u_choice"] = torch.stack([state["u_choice"]] * 2, dim=1)[:, 0]
    elif bad == "shape_d":
        state["d"] = state["d"][:63]
    elif bad == "shape_ior":
        hit = dataclasses.replace(hit, ior=hit.ior[:, None])
    elif bad == "shape_contrib":
        nee_inputs["contrib"] = contrib[:, :2].contiguous()
    elif bad == "int_did":
        nee_inputs["did"] = did.to(torch.int32)
    else:
        dev = torch.device("cuda")  # CPU tensors where the launch's device is CUDA
    with pytest.raises(ValueError):
        shade.check_inputs(hit, state, nee_inputs, dev)


def test_other_devices_raise():
    """A meta tensor: the shading takes CPU or CUDA tensors."""
    hit, state, _, _ = seeded(8, seed=1, dev="cpu")
    state = {k: x.to("meta") for k, x in state.items()}
    with pytest.raises(ValueError, match="CPU or CUDA"):
        shade.shade_update(hit, **state)


# --------------------------------------------------------------- card ----


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("n", [70_001, 1 << 20])
def test_shade_on_card(cuda, mode, n):
    """Seeded hits of every material: every output of S1 bit-identical to
    shade_plain on the same card, in one launch."""
    hit, state, prev, sample = seeded(n, seed=n + len(mode), dev=cuda)
    args = args_of(mode, state, prev, sample)
    before = shade.LAUNCHES["shade"]
    got = shade.shade_update(hit, **args)
    assert shade.LAUNCHES["shade"] == before + 1
    assert_same(got, bsdf.shade_plain(hit, **args), mode)


def cell_scene(cell: str):
    """The scene of a benchmark cell at its size: demo.staged's drone demo,
    bench.nee's bench teapot with NEE."""
    if cell == "demo.staged":
        return drone_demo.build(1024, 1024, spp=64, path_depth=10)
    scene = bench_scene.build(512, 512, spp=64, path_depth=8)
    return dataclasses.replace(scene, camera=dataclasses.replace(scene.camera, nee=True))


class _Done(Exception):
    """Raised by the checker once it has checked the bounces it needs."""


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["demo.staged", "bench.nee"])
def test_rendered_rays_on_card(cuda, cell, monkeypatch):
    """The rays of bounces 0-2 of the cell's chunk 0 (4,194,304 camera rays
    on demo_scene, 1,048,576 on the bench teapot with NEE) through the
    staged executor: each call of the shading compared with shade_plain on
    its own inputs as it happens."""
    scene = cell_scene(cell)
    sd, cam = scene.compile(device=cuda), scene.camera
    px = driver.chunk_pixels(sd, cam, cam.aa_sample_count)
    n_px = cam.screen_width * cam.screen_height
    ids = torch.arange(px, dtype=torch.int32, device=cuda) * ((n_px + px - 1) // px)
    o, d, uids = driver._gen_chunk_rays(cam, ids, 2**33 + 20, 0, cam.aa_sample_count, 1)
    calls, real = [0], shade.shade_update

    def checked(hit, *args, **kw):
        got = real(hit, *args, **kw)
        assert_same(got, bsdf.shade_plain(hit, *args, **kw), (cell, calls[0]))
        assert bool(got[4].any()), (cell, calls[0])
        assert (got[5] is not None) == cam.nee
        calls[0] += 1
        if calls[0] == 3:
            raise _Done
        return got

    monkeypatch.setattr(shade, "shade_update", checked)
    with pytest.raises(_Done):
        integrator.path_trace_shrink(sd, o, d, uids, 2**33 + 20, cam.path_depth,
                                     cam.max_trace_dist, nee=cam.nee)
    assert o.shape[0] == (4_194_304 if cell == "demo.staged" else 1_048_576)


@pytest.mark.gpu
def test_card_launch_checks_raise(cuda):
    hit, state, prev, (contrib, did) = seeded(64, seed=9, dev=cuda)
    for bad in (dict(thr=state["thr"].double()), dict(o=torch.cat([state["o"]] * 2, dim=1)[:, ::2]),
                dict(u_choice=state["u_choice"][:32]), dict(alive=state["alive"].cpu())):
        with pytest.raises(ValueError):
            shade.shade_update(hit, **(state | bad))
    with pytest.raises(ValueError):
        shade.shade_update(dataclasses.replace(hit, mtype=hit.mtype.long()), **state)
    with pytest.raises(ValueError):
        shade.shade_update(hit, **state, prev_nee=prev, nee=(contrib, did.cpu()))


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["demo.staged", "bench.nee"])
def test_render_launch_counts(cuda, cell, monkeypatch):
    """One S1 launch per bounce of a render of the cell's scene: depth a
    chunk."""
    scene = cell_scene(cell)
    calls, body = [0], integrator.bounce_update

    def counted(*args, **kwargs):
        calls[0] += 1
        return body(*args, **kwargs)

    monkeypatch.setattr(integrator, "bounce_update", counted)
    before = shade.LAUNCHES["shade"]
    _, stats = driver.render_to_image(scene, device=cuda, seed=11, verbose=False)
    torch.cuda.synchronize()
    assert calls[0] == stats.chunks * scene.camera.path_depth
    assert shade.LAUNCHES["shade"] - before == calls[0]
