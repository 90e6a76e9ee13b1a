"""K2 (scene intersection) and K3 (big-mesh BVH traversal), the CUDA
kernels of the staged path, against their plain torch versions on the
card. Needs a CUDA device: the tests are marked `gpu` and skip without
one. Run them on a machine with the card:

    python -m pytest tests/test_torch_staged_kernels.py -q

The file imports no JAX; its ray and scene helpers are shared with the
JAX parity tests of tests/test_torch_staged.py and
tests/test_torch_kitchen_sink.py (the kitchen sink's bounce rays: its
textured meshes through K2 and K3, its general volume merged after them).

Tolerance: the same winner — K2's (code, idx), K3's (hit, tri) — on at
least 99.9% of rays (a ray that grazes a triangle edge flips when one
rounding differs), and t, u, v and the normals within rtol 1e-4 / atol
1e-5 where the winners agree. Both kernels are built without FMA
contraction and follow the plain version's operation order. The staged
path as a whole is held to K1's contract (rtol 1e-3, atol 1e-4 on at
least 99.5% of rays, segments within depth × rays outside).
"""

import dataclasses

import numpy as np
import pytest
import torch

from cs397raytracingsp22_tpu_torch.ops import intersect as isect
from cs397raytracingsp22_tpu_torch.ops.kernels import scene_intersect, tri_scan_big
from cs397raytracingsp22_tpu_torch.render import driver, integrator
from cs397raytracingsp22_tpu_torch.scenes import bench_scene, kitchen_sink
from cs397raytracingsp22_tpu_torch.utils.rng import SITE_BOUNCE0
from test_torch_bounce_kernel import assert_paths_match  # tests/ is on sys.path under pytest

MIN_SAME = 0.999
RTOL, ATOL = 1e-4, 1e-5
BIG_TARGET = 9000  # teapot subdivided just beyond the dense budget (8,192)


def teapot_scene(target=None, width=16, height=16, spp=4, path_depth=4):
    """The bench scene with teapot_6k (target None: a dense mesh) or its
    subdivision to `target` triangles (a big mesh)."""
    obj = bench_scene.TEAPOT_6K if target is None else bench_scene.teapot_obj(target)
    return bench_scene.build(width, height, spp=spp, path_depth=path_depth, obj_path=obj)


def scene_rays(n, seed=0):
    """(o, d, t_min, t_max, u_vol) numpy rays inside the bench box: half
    aimed at the teapot's bounds, n/16 axis-parallel (the 0·inf lanes of
    the slab test), the rest in random directions; every 16th ray is dead
    (t_max = 0) and every 16th + 1 has a short window (t_max = 1)."""
    rng = np.random.default_rng(seed)
    o = rng.uniform([-2.4, 0.05, -2.4], [2.4, 4.95, 3.0], (n, 3))
    d = rng.standard_normal((n, 3))
    half = n // 2
    d[:half] = rng.uniform([-1.0, 0.4, -1.4], [1.0, 1.8, 0.2], (half, 3)) - o[:half]
    k = n // 16
    axis = np.zeros((k, 3))
    axis[np.arange(k), rng.integers(0, 3, k)] = rng.choice([-1.0, 1.0], k)
    d[half:half + k] = axis
    t_min = np.full((n,), 0.001, np.float32)
    t_max = np.full((n,), 100.0, np.float32)
    t_max[::16] = 0.0
    t_max[1::16] = 1.0
    u_vol = rng.random((n, 1)).astype(np.float32)
    return o.astype(np.float32), d.astype(np.float32), t_min, t_max, u_vol


def assert_winners_match(win, ref_win, fields, ref_fields, what):
    """The same winner on >= MIN_SAME of rays; where it agrees, every float
    field within RTOL / ATOL and every other field equal (fields: dict
    name → array). Returns the share of rays with the same winner."""
    same = np.ones(win[0].shape, bool)
    for a, b in zip(win, ref_win):
        same &= np.asarray(a) == np.asarray(b)
    assert same.mean() >= MIN_SAME, f"{what}: {(~same).sum()} of {same.size} winners differ"
    for name, a in fields.items():
        a, b = np.asarray(a)[same], np.asarray(ref_fields[name])[same]
        if a.dtype.kind == "f":
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL, err_msg=f"{what} {name}")
        else:
            np.testing.assert_array_equal(a, b, err_msg=f"{what} {name}")
    return float(same.mean())


def k2_compare(out, ref, what="K2"):
    """K2's outputs (t, code, idx, mat, u, v, normal, ff) against its plain
    version's."""
    out = [x.cpu().numpy() for x in out]
    ref = [x.cpu().numpy() for x in ref]
    t, code, idx, mat, u, v, normal, ff = out
    rt, rcode, ridx, rmat, ru, rv, rnormal, rff = ref
    return assert_winners_match((code, idx), (rcode, ridx),
                                dict(t=t, u=u, v=v, mat=mat, normal=normal, ff=ff),
                                dict(t=rt, u=ru, v=rv, mat=rmat, normal=rnormal, ff=rff), what)


def k3_compare(out, ref, what="K3"):
    """K3's outputs (hit, t, tri, u, v) against traverse's."""
    hit, t, tri, u, v = [x.cpu().numpy() for x in out]
    rhit, rt, rtri, ru, rv = [x.cpu().numpy() for x in ref]
    return assert_winners_match((hit, tri), (rhit, rtri), dict(t=t, u=u, v=v),
                                dict(t=rt, u=ru, v=rv), what)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def bounce_rays(sd, cam, bounces):
    """The staged path's rays entering each bounce in `bounces` for the
    camera rays of a 32×32 × 2 spp chunk: (o, d, t_max, u_vol) each."""
    ids = torch.arange(32 * 32, dtype=torch.int32)
    cam = dataclasses.replace(cam, screen_width=32, screen_height=32)
    o, d, uids = driver._gen_chunk_rays(cam, ids, 3, 0, 2, 1)
    thr, rad = torch.ones_like(o), torch.zeros_like(o)
    alive = torch.ones(o.shape[0], dtype=torch.bool)
    out = {}
    for b in range(max(bounces) + 1):
        site = SITE_BOUNCE0 + b
        if b in bounces:
            u_vol = integrator._bounce_draws(sd, 3, uids, site)[2]
            out[b] = (o, d, torch.where(alive, 100.0, 0.0), u_vol)
        o, d, thr, rad, alive, _, _ = integrator.bounce_update(
            sd, o, d, thr, rad, alive, uids, 3, b, 100.0,
            intersect=isect.intersect_scene_plain)
    return out


def _on(dev, *xs):
    return [torch.from_numpy(x).to(dev) for x in xs]


def shadow_rays(n, seed=0):
    """(o, d, t_min, t_max, u_vol) numpy shadow-like rays of the bench box:
    from uniform points toward uniform points near the teapot, the window
    ending at 0.999 of the way (d unnormalised: the aim point at t = 1); every
    third an empty window (t_max = 0 < t_min), as the NEE executor sends a
    vertex that does not shoot."""
    rng = np.random.default_rng(seed)
    o = rng.uniform([-2.4, 0.05, -2.4], [2.4, 4.95, 3.0], (n, 3))
    d = rng.uniform([-1.0, 0.4, -1.4], [1.0, 1.8, 0.2], (n, 3)) - o
    t_min = np.full((n,), 0.001, np.float32)
    t_max = np.full((n,), 0.999, np.float32)
    t_max[::3] = 0.0
    u_vol = rng.random((n, 1)).astype(np.float32)
    return o.astype(np.float32), d.astype(np.float32), t_min, t_max, u_vol


def k2_scene(which):
    """The bench scene with teapot_6k ("dense"), with its teapot subdivided
    to BIG_TARGET triangles ("big"), or config 4 on its stand-in assets
    ("textured": two dense spheres whose materials come from their
    textures, material id -1)."""
    if which == "textured":
        from cs397raytracingsp22_tpu_torch.scenes import textured_spheres

        return textured_spheres.build(16, 16, spp=1, asset_dir=textured_spheres.stand_in_dir())
    return teapot_scene(None if which == "dense" else BIG_TARGET)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [4096, 1, 33, 1000])
@pytest.mark.parametrize("rays", ["scene", "shadow"])
@pytest.mark.parametrize("target", ["dense", "big", "textured"])
def test_k2_matches_plain_on_card(cuda, target, rays, n):
    """K2 against its plain version: the bench scene's dense and big
    teapots and config 4's two textured spheres; rays of the bench box and
    shadow-like rays, a third with empty windows; 4,096 rays, and the edge
    sizes 1, 33 (a tile and one ray) and 1,000 (fewer than the persistent
    grid's threads). The tile ticket is zero after each launch."""
    data = k2_scene(target).compile(device=cuda)
    o, d, t_min, t_max, u_vol = _on(cuda, *(scene_rays(4096) if rays == "scene"
                                            else shadow_rays(4096))[:5])
    if target == "textured":  # config 4's spheres sit elsewhere: aim at them
        c = data.meshes[0].transform[:3, 3]
        d = torch.where(torch.arange(4096, device=cuda)[:, None] % 2 == 0, c - o, d).contiguous()
    o, d, t_min, t_max, u_vol = (x[:n].contiguous() for x in (o, d, t_min, t_max, u_vol))
    before = scene_intersect.LAUNCHES
    out = scene_intersect.scene_intersect_cuda(data, o, d, t_min, t_max, u_vol)
    torch.cuda.synchronize()
    assert scene_intersect.LAUNCHES == before + 1
    cfg = scene_intersect.launch_config(data, n)
    assert 1 <= cfg["grid"] <= cfg["blocks_per_sm"] * cfg["sms"]
    assert scene_intersect.ticket(cuda, torch.cuda.current_stream().cuda_stream).tolist() == [0, 0]
    ref = scene_intersect.scene_intersect_plain(data, o, d, t_min, t_max, u_vol)
    k2_compare(out, ref)
    code = out[1].cpu().numpy()
    dead = (t_max < t_min).cpu().numpy()
    assert (code[dead] == -1).all(), "dead rays must miss"
    if n == 4096 and target != "big":
        assert (code >= 4).sum() > 100, "the dense meshes must take part"
    if target == "textured" and n == 4096:
        assert (out[3][out[1] >= 4] == -1).all(), "texture-synthesized materials carry id -1"


@pytest.mark.gpu
def test_k3_matches_traverse_on_card(cuda):
    data = teapot_scene(BIG_TARGET).compile(device=cuda)
    mesh = data.meshes[0]
    o, d, t_min, t_max, _ = _on(cuda, *scene_rays(4096, seed=1))
    o_obj, d_obj = (x.contiguous() for x in isect.object_rays(mesh, o, d))
    before = tri_scan_big.LAUNCHES
    out = tri_scan_big.tri_scan_big_cuda(mesh, o_obj, d_obj, t_min, t_max)
    torch.cuda.synchronize()
    assert tri_scan_big.LAUNCHES == before + 2  # the screen and the walk
    ref = tri_scan_big.tri_scan_big_plain(mesh, o_obj, d_obj, t_min, t_max)
    k3_compare(out, ref)
    hit = out[0].cpu().numpy()
    assert hit.sum() > 500 and not hit[::16].any()


@pytest.mark.gpu
def test_staged_path_on_card_matches_cpu(cuda):
    scene = teapot_scene(BIG_TARGET)
    ids = torch.arange(16 * 16, dtype=torch.int32)
    o, d, uids = driver._gen_chunk_rays(scene.camera, ids, 5, 0, 4, 1)
    ref, ref_segs = integrator.path_trace_shrink(scene.compile(device="cpu"), o, d, uids, 5, 4,
                                                 100.0)
    data = scene.compile(device=cuda)
    k2, k3 = scene_intersect.LAUNCHES, tri_scan_big.LAUNCHES
    rad, segs = integrator.path_trace_shrink(data, o.to(cuda), d.to(cuda), uids.to(cuda), 5, 4,
                                             100.0)
    torch.cuda.synchronize()
    assert scene_intersect.LAUNCHES - k2 == 4 and tri_scan_big.LAUNCHES - k3 == 2 * 4
    assert float(ref.max()) > 0.0
    assert_paths_match(rad.cpu().numpy(), segs.cpu(), ref.numpy(), ref_segs)


@pytest.mark.gpu
def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    data = teapot_scene(BIG_TARGET).compile(device=cuda)
    o, d, t_min, t_max, u_vol = _on(cuda, *scene_rays(64))
    with pytest.raises(ValueError, match="dtype"):
        scene_intersect.scene_intersect_cuda(data, o.double(), d, t_min, t_max, u_vol)
    with pytest.raises(ValueError, match="shape"):
        scene_intersect.scene_intersect_cuda(data, o, d, t_min[:8], t_max, u_vol)
    with pytest.raises(ValueError, match="contiguous"):
        scene_intersect.scene_intersect_cuda(data, o.t().contiguous().t(), d, t_min, t_max, u_vol)
    mesh = data.meshes[0]
    with pytest.raises(ValueError, match="on"):
        tri_scan_big.tri_scan_big_cuda(mesh, o, d, t_min.cpu(), t_max)
    with pytest.raises(ValueError, match="shape"):
        tri_scan_big.tri_scan_big_cuda(mesh, o, d[:8], t_min, t_max)


@pytest.mark.gpu
def test_kitchen_sink_fused_on_card_matches_plain(cuda):
    """K2 and K3 through intersect_scene_fused on the card against
    intersect_scene_plain on the card: the same valid flag, and on a hit
    the same material type, on >= 99.9% of rays; the hit fields within rtol
    1e-4 / atol 1e-5 there."""
    sd = kitchen_sink.build().compile(device=cuda)
    cam = kitchen_sink.build().camera
    for b, ins in bounce_rays(kitchen_sink.build().compile(device="cpu"), cam, (0, 2)).items():
        o, d, t_max, u_vol = (x.to(cuda) for x in ins)
        k2, k3 = scene_intersect.LAUNCHES, tri_scan_big.LAUNCHES
        fused = isect.intersect_scene_fused(sd, o, d, integrator.PATH_T_MIN, t_max, u_vol)
        assert scene_intersect.LAUNCHES == k2 + 1 and tri_scan_big.LAUNCHES == k3 + 2
        plain = isect.intersect_scene_plain(sd, o, d, integrator.PATH_T_MIN, t_max, u_vol)
        # a miss carries no material: compare the material type where the spec hits
        same = (fused.valid == plain.valid) & (~plain.valid | (fused.mtype == plain.mtype))
        assert float(same.float().mean()) >= 0.999, b
        m = same & plain.valid
        for f in ("t", "point", "normal", "albedo"):
            torch.testing.assert_close(getattr(fused, f)[m], getattr(plain, f)[m], rtol=1e-4,
                                       atol=1e-5, equal_nan=True)


@pytest.mark.gpu
def test_config5_stand_ins_k2_k3_match_plain_on_card(cuda):
    """Config 5 on its stand-in assets (scenes/drone_demo.py): K2 over the
    analytic part, the cube and the drone (dense, their materials
    synthesized from textures), and K3 over the 32,512-triangle sphere,
    each against its plain version on the camera rays of a 32×32 × 2 spp
    chunk (t_max of K3 cut to K2's t, as the staged path does)."""
    from cs397raytracingsp22_tpu_torch.scenes import drone_demo

    scene = drone_demo.build(16, 16, spp=1)
    sd = scene.compile(device=cuda)
    assert [m.tri_verts.shape[0] for m in sd.meshes] == [1536, 12, 32512]
    assert sd.dense_mesh_ids == (0, 1)
    o, d, t_max, u_vol = (x.to(cuda) for x in
                          bounce_rays(scene.compile(device="cpu"), scene.camera, (0,))[0])
    t_min = torch.full_like(t_max, integrator.PATH_T_MIN)
    ins = (o, d, t_min, t_max, u_vol[:, :sd.vol_center.shape[0]].contiguous())
    out = scene_intersect.scene_intersect_cuda(sd, *ins)
    k2_compare(out, scene_intersect.scene_intersect_plain(sd, *ins), "K2 config 5")
    mesh = sd.meshes[2]
    o_obj, d_obj = (x.contiguous() for x in isect.object_rays(mesh, o, d))
    ins3 = (o_obj, d_obj, t_min, torch.minimum(t_max, out[0]).contiguous())
    out3 = tri_scan_big.tri_scan_big_cuda(mesh, *ins3)
    k3_compare(out3, tri_scan_big.tri_scan_big_plain(mesh, *ins3), "K3 config 5")
    assert int(out3[0].sum()) > 0, "camera rays reach the sphere"
