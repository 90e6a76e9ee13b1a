"""D1, the draws kernels (ops/kernels/draws.py, csrc/draws.cu), against
their plain torch versions.

On the CPU: the wrapper's contract (CPU tensors take the plain versions and
launch nothing; what a launch does not take raises), the camera launch's
host-side constants and a torch re-statement of the kernel's per-ray
arithmetic from them against Camera.generate_rays_plain, and the column
layouts of `_bounce_draws` and `nee_draws` against bounce_uniforms and
counter_uniforms. The plain versions' bits against the JAX package are held
by tests/test_torch_threefry.py, test_torch_camera.py and test_torch_nee.py.

On the card (marked `gpu`, skipped without one; the file imports no JAX):
every uniform, ball vector and camera ray bit-identical to the plain version
run on the same card, and the launches a render makes. Run them there:

    python -m pytest tests/test_torch_draws.py -q -m gpu
"""

import dataclasses
import math
import types

import numpy as np
import pytest
import torch

from cs397raytracingsp22_tpu_torch.models.camera import Camera, CameraProjectionMode
from cs397raytracingsp22_tpu_torch.ops.kernels import draws
from cs397raytracingsp22_tpu_torch.render import integrator, nee
from cs397raytracingsp22_tpu_torch.scenes import bench_scene, drone_demo
from cs397raytracingsp22_tpu_torch.utils import rng as rnglib
from cs397raytracingsp22_tpu_torch.utils import sampling, threefry

torch.set_num_threads(1)  # several test workers share the cores

# the cameras of the benchmark's two configurations at their cells' sizes
# (scenes/bench_scene.py, scenes/drone_demo.py), a thin lens and an
# orthographic one; aa_sample_count 9 and 100 make the divisions by √n and
# n inexact in float32
LENS_CAM = Camera(eyepoint=(0.3, 1.0, 6.0), view_dir=(0.1, -0.2, -1.0), up=(0.0, 1.0, 0.0),
                  focal_length=0.7, focus_dist=4.0, lens_radius=0.2, screen_width=40,
                  screen_height=24, aa_sample_count=16)
CAMERAS = {
    "bench": lambda: bench_scene.build(512, 512, spp=64, path_depth=8).camera,
    "demo": lambda: drone_demo.build(1024, 1024, spp=64, path_depth=10,
                                     include_meshes=False).camera,
    "lens": lambda: LENS_CAM,
    "lens9": lambda: dataclasses.replace(LENS_CAM, aa_sample_count=9, screen_width=37,
                                         screen_height=23),
    "ortho": lambda: Camera(view_dir=(0.0, -0.3, -1.0), screen_width=24, screen_height=16,
                            projection_mode=CameraProjectionMode.ORTHOGRAPHIC,
                            aa_sample_count=100),
}
SITES = (rnglib.SITE_BOUNCE0 + 9, rnglib.SITE_NEE0 + 7)
KEY = 2**33 + 12345


def _uids(n=3000, seed=0):
    rng = np.random.default_rng(seed)
    u = rng.integers(-(2**31), 2**31, size=n, dtype=np.int64).astype(np.int32)
    u[:4] = [0, 1, -1, 2**31 - 1]
    return torch.from_numpy(u)


def _bits(x: torch.Tensor) -> np.ndarray:
    return x.contiguous().view(torch.int32).cpu().numpy()


def _launches():
    return dict(draws.LAUNCHES)


# ---------------------------------------------------------------- CPU ----


def test_cpu_tensors_take_the_plain_versions():
    before = _launches()
    uids = _uids(64)
    u = draws.counter_uniforms(KEY, uids, SITES[1], 5)
    assert torch.equal(u, threefry.counter_uniforms(KEY, uids, SITES[1], 5))
    ball, uc, uv = draws.bounce_draws(KEY, uids, SITES[0], 3)
    ref = draws.bounce_draws_plain(KEY, uids, SITES[0], 3)
    for a, b in zip((ball, uc, uv), ref):
        assert torch.equal(a, b)
    ids = torch.arange(37, dtype=torch.int32)
    o, d = LENS_CAM.generate_rays(KEY, ids, spp=4, sample_offset=2)
    ro, rd = LENS_CAM.generate_rays_plain(KEY, ids, 4, 2)
    assert torch.equal(o, ro) and torch.equal(d, rd)
    assert _launches() == before
    if not torch.cuda.is_available():
        assert before == {k: 0 for k in draws.LAUNCHES}


@pytest.mark.parametrize("bad", ["int64", "strided", "2d", "cuda_expected"])
def test_launch_checks_raise(bad):
    """What the launches check before they launch, on CPU tensors against
    the device a launch expects."""
    uids = _uids(16)
    dev = torch.device("cpu")
    if bad == "int64":
        uids = uids.to(torch.int64)
    elif bad == "strided":
        uids = _uids(32)[::2]
    elif bad == "2d":
        uids = uids.reshape(4, 4)
    else:
        dev = torch.device("cuda")  # a CPU tensor where the launch's device is CUDA
    with pytest.raises(ValueError):
        draws.check_uids("uids", uids, dev)


@pytest.mark.parametrize("entry", ["camera_rays", "bounce_draws", "counter_uniforms"])
def test_other_devices_raise(entry):
    """A meta tensor: bounce_draws and counter_uniforms take CPU or CUDA
    tensors, camera_rays (which Camera.generate_rays calls only for CUDA
    pixel ids) CUDA tensors alone."""
    uids = torch.zeros(8, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="on CUDA tensors" if entry == "camera_rays"
                       else "CPU or CUDA"):
        if entry == "camera_rays":
            draws.camera_rays(LENS_CAM, KEY, uids, 2)
        elif entry == "bounce_draws":
            draws.bounce_draws(KEY, uids, SITES[0], 0)
        else:
            draws.counter_uniforms(KEY, uids, SITES[1], 4)


def test_camera_rays_launch_refuses_cpu_pixel_ids():
    """The camera launch is CUDA's alone: Camera.generate_rays keeps CPU
    pixel ids on the plain version and never reaches it with them."""
    before = _launches()
    with pytest.raises(ValueError, match="on CUDA tensors"):
        draws.camera_rays(LENS_CAM, KEY, torch.arange(8, dtype=torch.int32), 2)
    assert _launches() == before


@pytest.mark.parametrize("cam", sorted(CAMERAS))
def test_camera_args_are_the_plain_versions_scalars(cam):
    """Each float the launch takes is the float32 that the plain version's
    torch op makes of its Python scalar; each reciprocal is torch's own
    1 / float32(x) for a division by a CPU scalar."""
    camera = CAMERAS[cam]()
    ints, floats = draws.camera_args(camera, 32)
    assert tuple(ints) == draws.CAMERA_INTS and tuple(floats) == draws.CAMERA_FLOATS

    def f32(x):
        return torch.tensor(x, dtype=torch.float32).item()

    n = float(camera.aa_sample_count)
    rootn = math.sqrt(n)
    h, w = camera.screen_height, camera.screen_width
    assert ints == dict(width=w, aa=camera.aa_sample_count, rootn_i=int(rootn), sample_offset=32,
                        ortho=int(camera.projection_mode is CameraProjectionMode.ORTHOGRAPHIC))
    one = torch.ones((), dtype=torch.float32)
    want = dict(n=f32(n), half_rootn=f32(0.5 * rootn), pixel_size=f32(1.0 / float(h)),
                inv_rootn=(one / f32(rootn)).item(), half_n=f32(0.5 * n),
                inv_n=(one / f32(n)).item(), half_w=f32(0.5 * w), half_h_plus=f32(0.5 + 0.5 * h),
                neg_focal=f32(-camera.focal_length), two_pi=f32(sampling.TWO_PI),
                lens_radius=f32(camera.lens_radius), focus_dist=f32(camera.focus_dist))
    for key, value in want.items():
        assert floats[key] == value, key
    rot = camera.rotation(torch.device("cpu"))
    assert [floats[f"rot{j}{k}"] for j in range(3) for k in range(3)] == rot.flatten().tolist()
    assert [floats[f"eye{j}"] for j in range(3)] == [f32(e) for e in camera.eyepoint]


def _kernel_model(camera, key, pixel_ids, spp, offset):
    """csrc/draws.cu's camera_rays_kernel restated in float32 torch ops on
    the CPU, one operation per line of the kernel, from camera_args'
    constants (0-dim float32 tensors)."""
    ints, fl = draws.camera_args(camera, offset)
    c = {k: torch.tensor(v, dtype=torch.float32) for k, v in fl.items()}
    pid = pixel_ids.to(torch.int64)[:, None].expand(-1, spp).reshape(-1)
    sid = (offset + torch.arange(spp, dtype=torch.int64))[None, :].expand(len(pixel_ids), -1)
    sid = sid.reshape(-1)
    uid = (pid * ints["aa"] + sid) & threefry.MASK
    u = threefry.counter_uniforms(key, uid, rnglib.SITE_CAMERA, 4)
    x = (pid % ints["width"]).to(torch.float32)
    y = (pid // ints["width"]).to(torch.float32)
    rand_x, rand_y = torch.floor(u[:, 0] * c["n"]), torch.floor(u[:, 1] * c["n"])
    sub_x = (sid // ints["rootn_i"]).to(torch.float32)
    sub_y = (sid % ints["rootn_i"]).to(torch.float32)
    off_x = ((sub_x - c["half_rootn"]) * c["pixel_size"] * c["inv_rootn"]
             + (rand_x - c["half_n"]) * c["pixel_size"] * c["inv_n"])
    off_y = ((sub_y - c["half_rootn"]) * c["pixel_size"] * c["inv_rootn"]
             + (rand_y - c["half_n"]) * c["pixel_size"] * c["inv_n"])
    cx = c["pixel_size"] * (x - c["half_w"] + 0.5) + off_x
    cy = c["pixel_size"] * (c["half_h_plus"] - y) + off_y
    cz = c["neg_focal"].expand_as(cx)
    theta = c["two_pi"] * u[:, 2]
    rl = torch.sqrt(u[:, 3])
    lx, ly = c["lens_radius"] * (rl * torch.cos(theta)), c["lens_radius"] * (rl * torch.sin(theta))
    lz = c["lens_radius"] * torch.zeros_like(rl)
    cl = torch.sqrt(cx * cx + cy * cy + cz * cz)
    fx, fy, fz = cx / cl * c["focus_dist"], cy / cl * c["focus_dist"], cz / cl * c["focus_dist"]

    def rot(j, a, b, cc):
        return c[f"rot{j}0"] * a + c[f"rot{j}1"] * b + c[f"rot{j}2"] * cc

    o = torch.stack([c[f"eye{j}"] + rot(j, lx, ly, lz) for j in range(3)], dim=-1)
    wx, wy, wz = fx - lx, fy - ly, fz - lz
    wl = torch.sqrt(wx * wx + wy * wy + wz * wz)
    d = torch.stack([rot(j, wx / wl, wy / wl, wz / wl) for j in range(3)], dim=-1)
    return o.reshape(len(pixel_ids), spp, 3), d.reshape(len(pixel_ids), spp, 3)


@pytest.mark.parametrize("cam", ["bench", "demo", "lens"])
@pytest.mark.parametrize("offset", [0, 32])
def test_kernel_arithmetic_matches_plain_on_cpu(cam, offset):
    """The kernel's operation order and constants reproduce the plain
    version bit for bit (cameras whose √n and n are powers of two, where
    the CPU's division and the card's reciprocal multiply agree)."""
    camera = CAMERAS[cam]()
    n_px = camera.screen_width * camera.screen_height
    ids = torch.from_numpy(np.random.default_rng(offset).permutation(n_px)[:97].astype(np.int32))
    o, d = _kernel_model(camera, KEY, ids, 5, offset)
    ro, rd = camera.generate_rays_plain(KEY, ids, 5, offset)
    np.testing.assert_array_equal(_bits(o), _bits(ro))
    np.testing.assert_array_equal(_bits(d), _bits(rd))


# (V sphere volumes, G general volumes): V + G from 0 to 3
VOLS = [(0, 0), (1, 0), (0, 1), (2, 0), (1, 1), (3, 0), (1, 2)]


def _vol_scene(v, g):
    """What the draws read of a scene: its volume-table rows and its number
    of general volumes."""
    return types.SimpleNamespace(vol_center=torch.zeros((v, 3)), n_gvols=g)


@pytest.mark.parametrize("v,g", VOLS)
def test_bounce_draws_columns(v, g):
    uids = _uids(512, seed=v + 7 * g)
    site = rnglib.SITE_BOUNCE0 + 3
    ball, u_choice, u_vol = integrator._bounce_draws(_vol_scene(v, g), KEY, uids, site)
    u = threefry.bounce_uniforms(KEY, uids, site, 4 + v + g)
    assert ball.shape == (512, 3) and u_choice.shape == (512,) and u_vol.shape == (512, v + g)
    np.testing.assert_array_equal(_bits(ball), _bits(sampling.ball_vec_from_uniform(u[:, :3])))
    np.testing.assert_array_equal(_bits(u_choice), _bits(u[:, 3]))
    np.testing.assert_array_equal(_bits(u_vol), _bits(u[:, 4:]))


@pytest.mark.parametrize("v,g", VOLS)
def test_nee_draws_columns(v, g):
    uids = _uids(512, seed=100 + v + 7 * g)
    got = nee.nee_draws(_vol_scene(v, g), KEY, uids, 5)
    want = threefry.counter_uniforms(KEY, uids, rnglib.SITE_NEE0 + 5, 4 + v + g)
    assert got.shape == (512, 4 + v + g)
    np.testing.assert_array_equal(_bits(got), _bits(want))


# --------------------------------------------------------------- card ----


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("m", [4, 5, 6, 7, 8, 11])
def test_counter_uniforms_on_card(cuda, m):
    uids = _uids(70_001, seed=m).to(cuda)
    for site in SITES:
        got = draws.counter_uniforms(KEY, uids, site, m)
        assert got.shape == (uids.shape[0], m) and got.is_cuda
        np.testing.assert_array_equal(_bits(got), _bits(threefry.counter_uniforms(KEY, uids,
                                                                                  site, m)))


@pytest.mark.gpu
@pytest.mark.parametrize("m", [4, 5, 6, 7, 8, 11])
def test_bounce_draws_on_card(cuda, m):
    uids = _uids(70_001, seed=50 + m).to(cuda)
    for site in SITES:
        got = draws.bounce_draws(KEY, uids, site, m - 4)
        want = draws.bounce_draws_plain(KEY, uids, site, m - 4)
        for a, b in zip(got, want):
            assert a.shape == b.shape
            np.testing.assert_array_equal(_bits(a), _bits(b))


@pytest.mark.gpu
@pytest.mark.parametrize("cam", sorted(CAMERAS))
@pytest.mark.parametrize("offset", [0, 32])
def test_generate_rays_on_card(cuda, cam, offset):
    """Every origin and direction bit-identical to the plain version on the
    card."""
    camera = CAMERAS[cam]()
    n_px = camera.screen_width * camera.screen_height
    spp = min(camera.aa_sample_count, 16)
    # one chunk of an image split 16 ways (3 for the small cameras), and the
    # last 1,234 pixels: a launch whose last block is ragged
    ids = torch.arange(0, n_px, 16 if n_px > 4096 else 3, dtype=torch.int32, device=cuda)
    ragged = torch.arange(max(0, n_px - 1234), n_px, dtype=torch.int32, device=cuda)
    for pix in (ids, ragged):
        before = draws.LAUNCHES["camera_rays"]
        o, d = camera.generate_rays(KEY, pix, spp=spp, sample_offset=offset)
        assert draws.LAUNCHES["camera_rays"] == before + 1
        ro, rd = camera.generate_rays_plain(KEY, pix, spp=spp, sample_offset=offset)
        np.testing.assert_array_equal(_bits(o), _bits(ro))
        np.testing.assert_array_equal(_bits(d), _bits(rd))


@pytest.mark.gpu
def test_card_launch_checks_raise(cuda):
    uids = _uids(64).to(cuda)
    for bad in (uids.to(torch.int64), uids[::2], uids.reshape(8, 8)):
        with pytest.raises(ValueError):
            draws.counter_uniforms(KEY, bad, SITES[1], 4)
        with pytest.raises(ValueError):
            draws.bounce_draws(KEY, bad, SITES[0], 2)
    with pytest.raises(ValueError):
        draws.camera_rays(LENS_CAM, KEY, uids[::2], 4)


def _render_counts(scene, cuda, monkeypatch):
    """One render_to_image of `scene` on the card: (draws launches, bounces
    the executors ran, NEE samples they took, chunks)."""
    from cs397raytracingsp22_tpu_torch.render import driver

    calls = {"bounce": 0, "nee": 0}

    def counted(name, fn):
        def wrapper(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapper

    monkeypatch.setattr(integrator, "bounce_update", counted("bounce", integrator.bounce_update))
    monkeypatch.setattr(nee, "direct_light", counted("nee", nee.direct_light))
    before = _launches()
    _, stats = driver.render_to_image(scene, device=cuda, seed=11, verbose=False)
    torch.cuda.synchronize()
    grew = {k: v - before[k] for k, v in draws.LAUNCHES.items()}
    return grew, calls, stats.chunks


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["bench.k1", "bench.nee", "demo.staged"])
def test_render_launch_counts(cuda, cell, monkeypatch):
    """raygen one launch a chunk (16 an image), the bounce draws one a
    bounce of the staged and NEE executors (none under K1, which draws in
    its own loop), NEE's draws one a NEE sample."""
    if cell == "demo.staged":
        scene = drone_demo.build(1024, 1024, spp=64, path_depth=10)
    else:
        scene = bench_scene.build(512, 512, spp=64, path_depth=8)
        if cell == "bench.nee":
            scene = dataclasses.replace(scene, camera=dataclasses.replace(scene.camera, nee=True))
    grew, calls, chunks = _render_counts(scene, cuda, monkeypatch)
    assert chunks == 16 or cell == "demo.staged"
    depth = scene.camera.path_depth
    assert grew["camera_rays"] == chunks
    assert grew["bounce_draws"] == calls["bounce"] == (0 if cell == "bench.k1" else chunks * depth)
    assert grew["counter_uniforms"] == calls["nee"] == (chunks * (depth - 1)
                                                        if cell == "bench.nee" else 0)
