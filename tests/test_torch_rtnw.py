"""The Next Week's final scene (scenes/rtnw_final.py) and the sphere tree
that the mega-bounce kernel (K1) walks in place of its sphere scan
(models/scene.py::sphere_tree, csrc/intersect.cuh::walk_spheres).

On the CPU: the tree's invariants; its plain walk (ops/intersect.py::
walk_spheres) against the linear sphere scan, (t, index) on every ray,
ties to the lowest index included; K1's gate; the committed configuration
and mesh against the scene module's output; the port's CPU render of the
scene, cut to 24² × 4 spp at depth 40, against the benchmark's plain
reference (benchmark/reference/tracer.py).

On the card (marked `gpu`, skipped without one; the file imports no JAX):
K1's rows with the tree bit-identical to K1's rows with its sphere scan
(the gate forced open in the test), and K1 within its parity contract of
the plain version, on the scene's camera rays and bounce-3 rays; a render's
sphere-tree node count. Run them there:

    python -m pytest tests/test_torch_rtnw.py -q -m gpu
"""

import os

import numpy as np
import pytest
import torch

from cs397raytracingsp22_tpu_torch import Lambertian, Scene, Sphere
from cs397raytracingsp22_tpu_torch.models import scene as scene_mod
from cs397raytracingsp22_tpu_torch.ops import intersect as isect
from cs397raytracingsp22_tpu_torch.ops.kernels import bounce
from cs397raytracingsp22_tpu_torch.render import driver, integrator
from cs397raytracingsp22_tpu_torch.scenes import (
    bench_scene, bench_teapot_32k, cornell, drone_demo, kitchen_sink, rtnw_final, teapot,
    textured_spheres,
)
from cs397raytracingsp22_tpu_torch.utils import threefry

torch.set_num_threads(1)  # several test workers share the cores

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T_MIN, T_MAX = integrator.PATH_T_MIN, 20000.0
# K1 against the plain version on the card: rtnw paths run to depth 40, and
# a winner flipped at a grazing hit or a Fresnel draw (K1 contracts
# multiply-adds, the plain version does not) re-rolls the rest of a path, so
# more of them leave rtol / atol than at depth 8 (0.30% and 0.06% of the
# camera and bounce-3 rays on the card); and a path goes on with zero
# throughput after it meets the light quad (albedo 0), where a flip changes
# its length and not its radiance (5.6% of the camera rays end at another
# depth, 1.3% of the segments). chip_smoke.py's RTNW_MIN_FRAC and
# RTNW_SEG_RTOL; PERF.md §6
RTNW_MIN_FRAC, RTNW_SEG_RTOL = 0.99, 0.05


def _compiled(width=24, height=24, spp=4, depth=40, device="cpu"):
    scene = rtnw_final.build(width, height, spp, depth)
    return scene, scene.compile(device=device)


def _spheres(n, seed):
    rng = np.random.default_rng(seed)
    c = rng.uniform(-50.0, 50.0, (n, 3))
    r = rng.uniform(0.5, 6.0, (n, 1))
    return np.concatenate([c, r], axis=1).astype(np.float32)


@pytest.mark.parametrize("n", [64, 100, 257, 1006])
def test_sphere_tree_invariants(n):
    rows = _spheres(n, n)
    tbl = scene_mod.sphere_tree(rows)
    g = scene_mod.sphere_tree_leaves(n)
    leaf = scene_mod.SPHERE_LEAF
    assert g & (g - 1) == 0 and g * leaf >= n > g * leaf // 2 - leaf
    assert tbl.shape == (4 * g + g * leaf + g * leaf // 4, 4)
    reach = np.abs(rows[:, :3]).max(axis=1) + rows[:, 3]
    assert tbl[0, 0] >= reach.max() and tbl[0, 1] == g and tbl[0, 2] == leaf
    lo, hi = tbl[2:4 * g:2, :3], tbl[3:4 * g:2, :3]  # node k at row k - 1
    ids = tbl[8 * g:].reshape(-1).astype(np.int64).reshape(g, leaf)
    slots = tbl[4 * g:8 * g].reshape(g, leaf, 4)
    # every sphere in exactly one leaf, each leaf 2..SPHERE_LEAF spheres,
    # empty slots last, the slots the scene table's rows
    real = ids[ids >= 0]
    assert sorted(real.tolist()) == list(range(n))
    per = (ids >= 0).sum(axis=1)
    assert per.min() >= 2 and per.max() <= leaf
    assert all((ids[k, :per[k]] >= 0).all() and (ids[k, per[k]:] < 0).all() for k in range(g))
    assert np.array_equal(slots[ids >= 0], rows[real])
    # each leaf's box holds its spheres; each inner node's box is its
    # children's exact union
    for k in range(g):
        mine = rows[ids[k, :per[k]]]
        box_lo, box_hi = lo[g + k - 1], hi[g + k - 1]
        assert (box_lo <= mine[:, :3] - mine[:, 3:]).all()
        assert (box_hi >= mine[:, :3] + mine[:, 3:]).all()
    for k in range(1, g):
        assert np.array_equal(lo[k - 1], np.minimum(lo[2 * k - 1], lo[2 * k]))
        assert np.array_equal(hi[k - 1], np.maximum(hi[2 * k - 1], hi[2 * k]))
    # below the threshold no tree
    assert scene_mod.sphere_tree(rows[:scene_mod.SPHERE_TREE_MIN - 1]).shape == (1, 4)


def _rays(sd, n, seed):
    """Rays from the camera's neighbourhood, from inside the sphere cluster
    and from far in the fog, aimed at spheres or anywhere, with direction
    lengths from 0.01 to 2."""
    g = torch.Generator().manual_seed(seed)
    centers = sd.sph_center[:sd.n_spheres]
    o = torch.cat([
        torch.tensor([478.0, 278.0, -600.0]) + 20.0 * torch.randn(n, 3, generator=g),
        torch.tensor([-100.0, 270.0, 395.0]) + 200.0 * torch.rand(n, 3, generator=g),
        (torch.rand(n, 3, generator=g) - 0.5) * 8000.0,
    ])
    aim = centers[torch.randint(0, centers.shape[0], (3 * n,), generator=g)]
    aim = aim + 10.0 * torch.randn(3 * n, 3, generator=g)
    d = torch.where(torch.rand(3 * n, 1, generator=g) < 0.7, aim - o,
                    torch.randn(3 * n, 3, generator=g))
    d = d / d.norm(dim=1, keepdim=True) * (0.01 + 2.0 * torch.rand(3 * n, 1, generator=g))
    return o.contiguous(), d.contiguous()


def _assert_walk_is_scan(sd, o, d):
    walk = isect.walk_spheres(sd, o, d, T_MIN, T_MAX)
    t, idx, valid = isect.intersect_spheres(sd, o, d, T_MIN, T_MAX)
    assert torch.equal(walk.hit, valid)
    assert torch.equal(walk.t, torch.where(valid, t, torch.full_like(t, float("inf"))))
    assert torch.equal(walk.idx, torch.where(valid, idx, torch.zeros_like(idx)))
    return walk


def test_walk_gives_the_scans_nearest_sphere():
    _, sd = _compiled()
    o, d = _rays(sd, 1500, 0)
    walk = _assert_walk_is_scan(sd, o, d)
    assert int(walk.hit.sum()) > 1000
    # the walk tests a few dozen nodes and spheres a ray, not 1,006 spheres
    assert float(walk.spheres.float().mean()) < 60 and float(walk.nodes.float().mean()) < 120


def test_walk_keeps_the_lowest_index_on_ties():
    """Spheres planted twice (and a third time inside another leaf's reach)
    give exactly equal t: the scan keeps the lowest index, and so must the
    walk, whichever leaf it meets first."""
    rows = _spheres(200, 3)
    twins = [5, 17, 80, 150]
    extra = rows[twins]
    white = Lambertian(albedo=(0.73, 0.73, 0.73))
    objs = [Sphere(center=tuple(map(float, r[:3])), radius=float(r[3]), material=white)
            for r in np.concatenate([rows, extra, extra])]
    sd = Scene(camera=rtnw_final.build(4, 4, 1, 1).camera, objects=objs).compile(device="cpu")
    assert sd.sph_tree_leaves and sd.n_spheres == 208
    g = torch.Generator().manual_seed(1)
    target = torch.as_tensor(np.concatenate([extra[:, :3]] * 100))
    o = target + torch.randn(target.shape[0], 3, generator=g) * 80.0
    d = target + torch.randn(target.shape[0], 3, generator=g) - o
    walk = _assert_walk_is_scan(sd, o, d)
    tied = torch.isin(walk.idx, torch.tensor(twins, dtype=torch.int32))
    assert int(tied.sum()) > 100  # the planted twins won, at their first index


def _parent_gate(sd) -> bool:
    """scene_is_simple before the sphere tree: every analytic primitive
    counted against the 128 lanes."""
    if len(sd.dense_mesh_ids) != len(sd.meshes) or sd.n_gvols:
        return False
    if int(sd.mat_type.shape[0]) > 128:
        return False
    if sd.n_spheres + sd.n_planes + sd.n_tris + sd.n_volumes > 128:
        return False
    return all(m.mat_id >= 0 and m.tex_ids[4] < 0 for m in sd.meshes)


SCENES = {
    "cornell": lambda: cornell.build(8, 8, 1),
    "cornell_config3": lambda: cornell.build_config3(8, 8, 1),
    "bench_scene": lambda: bench_scene.build(8, 8, 1),
    "bench_teapot_32k": lambda: bench_teapot_32k.build(8, 8, 1),
    "teapot": lambda: teapot.build(8, 8, 1),
    "kitchen_sink": lambda: kitchen_sink.build(),
    "textured_spheres": lambda: textured_spheres.build(8, 8, 1),
    "drone_demo_analytic": lambda: drone_demo.build(8, 8, 1, include_meshes=False),
    "drone_demo": lambda: drone_demo.build(8, 8, 1),
}


# scenes the gate takes since K1 walks a big mesh's BVH (tests/test_torch_bench32k.py):
# an untextured mesh past the dense budget
BIG_MESH_ON_K1 = {"bench_teapot_32k"}


@pytest.mark.parametrize("name", sorted(SCENES))
def test_gate_unchanged_for_the_other_scenes(name):
    sd = SCENES[name]().compile(device="cpu")
    assert sd.sph_tree_leaves == 0 and sd.ksph_tree.shape == (1, 4)
    assert bounce.scene_is_simple(sd) == (_parent_gate(sd) or name in BIG_MESH_ON_K1)


def test_gate_takes_the_final_scene_and_refuses_what_does_not_fit():
    _, sd = _compiled(8, 8, 1, 4)
    assert sd.n_spheres == 1006 and sd.sph_tree_leaves == 256 and sd.dense_mesh_ids == (0,)
    assert not _parent_gate(sd) and bounce.scene_is_simple(sd)
    # the table less its sphere rows, the superleaf tree, the header and nodes
    assert bounce.k1_staged_bytes(sd) == (4 * ((sd.kscene.numel() - 5 * 1006 + 3) // 4 * 4
                                               + sd.ksl_tree.numel()) + 64 * 256)
    # K4 stages the whole table (K2 the tree in place of the sphere rows:
    # tests/test_torch_rtnw_nee.py)
    assert bounce.staged_bytes(sd) == 4 * ((sd.kscene.numel() + 3) // 4 * 4 + sd.ksl_tree.numel())
    white = Lambertian(albedo=(0.73, 0.73, 0.73))
    big = Scene(camera=rtnw_final.build(4, 4, 1, 1).camera, objects=[
        Sphere(center=(float(i), 0.0, 0.0), radius=0.4, material=white)
        for i in range(16385)]).compile(device="cpu")
    assert bounce.k1_staged_bytes(big) > bounce.MAX_STAGED_BYTES
    assert not bounce.scene_is_simple(big)


def test_committed_files_are_the_scene_modules(tmp_path):
    rtnw_final.write_files(str(tmp_path))
    for rel in (rtnw_final.CONFIG_PATH, rtnw_final.OBJ_PATH):
        with open(os.path.join(ROOT, rel), "rb") as a, open(tmp_path / rel, "rb") as b:
            assert a.read() == b.read(), rel


def test_published_widths():
    desc = rtnw_final.description()
    objs = desc["scene"]["objects"]
    kinds = [o["type"] for o in objs]
    assert kinds.count("sphere") == 1006 and kinds.count("volume") == 2
    assert kinds.count("triangle") == 2 and kinds.count("mesh") == 1
    cam = desc["scene"]["camera"]
    assert (cam["screen_width"], cam["screen_height"], cam["path_depth"]) == (800, 800, 40)
    assert desc["reduced"] == ["aa_sample_count"] and cam["aa_sample_count"] == 64
    assert abs(2 * np.degrees(np.arctan(0.5 / cam["focal_length"])) - 40.0) < 1e-9
    scene = rtnw_final.build(8, 8, 1, 1)
    mesh = [o for o in scene.objects if hasattr(o, "mesh")][0]
    assert mesh.mesh.num_triangles == 4800
    fog = [o for o in scene.objects if getattr(o, "density", None) == 0.0001][0]
    eye = np.asarray(scene.camera.eyepoint)
    assert np.linalg.norm(eye - np.asarray(fog.boundary.center)) < fog.boundary.radius


def test_cpu_render_matches_the_plain_reference():
    """The port's CPU path (render_chunk → K1's plain version,
    integrator.path_trace, on a scene that passes the gate) against the
    benchmark's plain reference on the same seed, ray by ray: K1's parity
    contract, rtol 1e-3 / atol 1e-4 on >= 99.5% of rays and segment totals
    within depth × (rays outside it). Both are float32 torch on the CPU,
    with the same camera rays and draws, so a ray's radiance moves only
    where the two order a sum differently and a hit flips at an edge,
    which re-rolls one path."""
    from benchmark.reference import scene as ref_scene
    from benchmark.reference import tracer

    w, spp, depth, seed = 24, 4, 40, 20260417
    scene, sd = _compiled(w, w, spp, depth)
    assert bounce.scene_is_simple(sd)
    desc = dict(rtnw_final.description()["scene"], camera=rtnw_final.camera_desc(w, w, spp, depth))
    ref = ref_scene.build(desc, {rtnw_final.OBJ_NAME: os.path.join(ROOT, rtnw_final.OBJ_PATH)},
                          "cpu")
    pix = torch.arange(w * w)
    key = threefry.key_words(seed)
    o, d, uids = driver._gen_chunk_rays(scene.camera, pix.to(torch.int32), key, 0, spp, 1)
    stats: dict = {}
    rad, segs = bounce.path_trace_cuda(sd, o, d, uids, key, depth, T_MAX, stats=stats)
    ro, rd, ru = tracer.camera_rays(ref, seed, pix)
    assert torch.equal(o, ro) and torch.equal(d, rd)
    want = tracer.trace(ref, ro, rd, ru, seed, False)
    ok = np.isclose(rad.numpy(), want.numpy(), rtol=1e-3, atol=1e-4).all(axis=1)
    assert ok.mean() >= 0.995, f"{int((~ok).sum())} of {ok.size} rays outside rtol 1e-3 / atol 1e-4"
    ref_segs = []
    tracer.trace(ref, ro, rd, ru, seed, False, stats=ref_segs)
    assert abs(int(segs) - sum(x[0].shape[0] for x in ref_segs)) <= depth * int((~ok).sum())
    assert float(rad.max()) > 0 and int(stats["segs"].max()) > 10  # lit, and deep paths


# ---------------------------------------------------------------- the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _bounce3_rays(sd, o, d, uids, key):
    """The rays entering bounce 3 of the plain path trace from (o, d): the
    live ones, with their uids."""
    n = o.shape[0]
    thr, rad = torch.ones_like(o), torch.zeros_like(o)
    alive = torch.ones((n,), dtype=torch.bool, device=o.device)
    for b in range(3):
        o, d, thr, rad, alive, _, _ = integrator.bounce_update(
            sd, o, d, thr, rad, alive, uids, key, b, T_MAX, intersect=isect.intersect_scene_plain)
    keep = alive.nonzero()[:, 0]
    return o[keep].contiguous(), d[keep].contiguous(), uids[keep].contiguous()


def _chunk0(scene, sd, key, dev):
    cam = scene.camera
    px = driver.chunk_pixels(sd, cam, cam.aa_sample_count)
    n_chunks = -(-cam.screen_width * cam.screen_height // px)
    ids = torch.arange(px, dtype=torch.int32, device=dev) * n_chunks
    return driver._gen_chunk_rays(cam, ids, key, 0, cam.aa_sample_count, 1)


@pytest.mark.gpu
def test_k1_tree_rows_are_the_sphere_scans_on_card(cuda, monkeypatch):
    scene, sd = _compiled(800, 800, 64, 40, device=cuda)
    key = threefry.key_words(99)
    o, d, uids = _chunk0(scene, sd, key, cuda)
    o3, d3, u3 = _bounce3_rays(sd, o, d, uids, key)
    assert o3.shape[0] > o.shape[0] // 4
    # the launches take the tree instantiation
    assert sd.sph_tree_leaves > 0 and bounce.scene_is_simple(sd)
    rows = [bounce.path_trace_cuda(sd, *rays, key, 40, T_MAX)
            for rays in ((o, d, uids), (o3, d3, u3))]
    # the gate forced open: no tree below a million spheres, every sphere
    # counted against lanes enough
    monkeypatch.setattr(scene_mod, "SPHERE_TREE_MIN", 1 << 20)
    monkeypatch.setattr(bounce, "LANES", 4096)
    assert sd.sph_tree_leaves == 0 and bounce.scene_is_simple(sd)
    for (rad, segs), rays in zip(rows, ((o, d, uids), (o3, d3, u3))):
        scan_rad, scan_segs = bounce.path_trace_cuda(sd, *rays, key, 40, T_MAX)
        same = (rad == scan_rad).all(dim=1)
        assert bool(same.all()), f"{int((~same).sum())} of {same.numel()} rows differ"
        assert int(segs) == int(scan_segs)


@pytest.mark.gpu
def test_k1_tree_matches_the_plain_version_on_card(cuda):
    """K1 against the plain version, ray by ray: radiance within rtol 1e-3
    / atol 1e-4 on at least RTNW_MIN_FRAC of the rays, segment totals within
    RTNW_SEG_RTOL (see RTNW_MIN_FRAC for why not depth × the rays outside)."""
    scene, sd = _compiled(800, 800, 64, 40, device=cuda)
    key = threefry.key_words(7)
    o, d, uids = _chunk0(scene, sd, key, cuda)
    idx = torch.arange(0, o.shape[0], 61, device=cuda)
    for rays in ((o[idx], d[idx], uids[idx]), _bounce3_rays(sd, o[idx], d[idx], uids[idx], key)):
        rad, segs = bounce.path_trace_cuda(sd, *rays, key, 40, T_MAX)
        ref_rad, ref_segs = integrator.path_trace(sd, *rays, key, 40, T_MAX)
        assert float(ref_rad.max()) > 0.0 and bool(torch.isfinite(rad).all())
        ok = torch.isclose(rad, ref_rad, rtol=1e-3, atol=1e-4).all(dim=1)
        assert float(ok.float().mean()) >= RTNW_MIN_FRAC, int((~ok).sum())
        assert abs(int(segs) - int(ref_segs)) <= RTNW_SEG_RTOL * int(ref_segs)

