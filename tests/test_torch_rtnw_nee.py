"""The Next Week's final scene under next-event estimation: the sphere tree
on the NEE executor's path (K2's tree route, csrc/scene_intersect.cu::
scene_intersect_tree_kernel, and its plain version, ops/intersect.py::
walk_spheres inside analytic_candidates).

On the CPU: the port's NEE render of a cut-down scene (70 spheres, so the
tree holds; the fog around the camera, the blue medium, the quad light;
24² × 2 spp at depth 40) against the benchmark's plain reference
(benchmark/reference/tracer.py with nee); the plain tree route against the
flat sphere scan, bit for bit, on the NEE executor's bounce rays and shadow
rays (finite windows) and on planted ties; the walk's `stats=` counts; K2's
staged bytes on the tree route; the benchmark's NEE sphere-walk count
(benchmark/reference/nee_sphere_walk.py), a lower bound of the plain
walk's, and its reader `k2_tree_roofline`, which reads nothing without K2.

On the card (marked `gpu`, skipped without one; the file imports no JAX):
K2's tree rows bit-identical to its flat rows on the full scene's NEE
bounce 0 and its shadow rays, with its ground mesh and without (the tree
route's two instantiations), their registers and spills, and a whole NEE
image equal to the flat route's, its K2 launches counted on the tree route. Run them there:

    python -m pytest tests/test_torch_rtnw_nee.py -q -m gpu
"""

import dataclasses
import functools
import os

import numpy as np
import pytest
import torch

from benchmark import cells, port_scene
from benchmark.reference import nee_sphere_walk, tracer
from benchmark.reference import scene as ref_scene
from benchmark.trace import Activity, Trace
from cs397raytracingsp22_tpu_torch import Lambertian, Scene, Sphere, StaticMesh
from cs397raytracingsp22_tpu_torch.models import scene as scene_mod
from cs397raytracingsp22_tpu_torch.ops import intersect as isect
from cs397raytracingsp22_tpu_torch.ops.kernels import bounce, scene_intersect
from cs397raytracingsp22_tpu_torch.render import driver, integrator
from cs397raytracingsp22_tpu_torch.scenes import rtnw_final
from cs397raytracingsp22_tpu_torch.tools import walk_counts
from cs397raytracingsp22_tpu_torch.utils import threefry

torch.set_num_threads(1)  # several test workers share the cores

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEPTH, T_MAX, SEED = 40, 20000.0, 20261019
CLUSTER = 64  # cluster spheres kept: with the six named ones, 70 >= SPHERE_TREE_MIN


def _cut_down(width=24, spp=2, depth=DEPTH):
    """(port Scene, its compile on the CPU, the reference scene, the
    description): the final scene without the ground mesh and with the
    first CLUSTER spheres of the cluster, under NEE."""
    desc = rtnw_final.description()
    objs = [o for o in desc["scene"]["objects"] if o["type"] != "mesh"]
    named = [o for o in objs if not (o["type"] == "sphere" and o["material"] == "white")]
    cluster = [o for o in objs if o["type"] == "sphere" and o["material"] == "white"][:CLUSTER]
    cam = dict(rtnw_final.camera_desc(width, width, spp, depth), nee=True)
    scene_desc = dict(desc["scene"], objects=named + cluster, camera=cam)
    sc = port_scene.build(dict(desc, scene=scene_desc), cam, {})
    return sc, sc.compile(device="cpu"), ref_scene.build(scene_desc, {}, "cpu"), scene_desc


def _flat(monkeypatch):
    """No sphere tree below a million spheres: every route scans."""
    monkeypatch.setattr(scene_mod, "SPHERE_TREE_MIN", 1 << 20)


def test_cut_down_scene_takes_the_tree_under_nee():
    _, sd, _, desc = _cut_down()
    kinds = [o["type"] for o in desc["objects"]]
    assert kinds.count("sphere") == 70 and kinds.count("volume") == 2
    assert kinds.count("triangle") == 2
    assert sd.sph_tree_leaves == 32 and sd.nee_ok


def test_cpu_nee_render_matches_the_plain_reference():
    """The port's NEE executor (path_trace_shrink, nee=True) on the CPU,
    whose intersection walks the sphere tree, against the benchmark's
    plain reference on the same seed, ray by ray: rtol 1e-3 / atol 1e-4
    on >= 99.5% of the rays (K1's parity contract, tests/
    test_torch_rtnw.py), and the images' u8 pixels within 1 level on
    every pixel and 0.05 on average. Both are float32 torch on the CPU with
    the same camera rays and draws, and the executor's plain versions
    follow the reference's formulas, so a ray moves only where a sum is
    ordered otherwise or a winner flips at an edge (which re-rolls the
    rest of one path); on this seed no ray moves."""
    w, spp = 24, 2
    sc, sd, ref, _ = _cut_down(w, spp)
    pix = torch.arange(w * w)
    key = threefry.key_words(SEED)
    o, d, uids = driver._gen_chunk_rays(sc.camera, pix.to(torch.int32), key, 0, spp, 1)
    rad, segs = integrator.path_trace_shrink(sd, o, d, uids, key, DEPTH, T_MAX, nee=True)
    ro, rd, ru = tracer.camera_rays(ref, SEED, pix)
    assert torch.equal(o, ro) and torch.equal(d, rd)
    want = tracer.trace(ref, ro, rd, ru, SEED, True)
    ok = np.isclose(rad.numpy(), want.numpy(), rtol=1e-3, atol=1e-4).all(axis=1)
    assert ok.mean() >= 0.995, f"{int((~ok).sum())} of {ok.size} rays outside rtol 1e-3 / atol 1e-4"
    img = tracer.tonemap(rad.reshape(-1, spp, 3).sum(dim=1) / spp, 2.0).int()
    ref_img = tracer.tonemap(want.reshape(-1, spp, 3).sum(dim=1) / spp, 2.0).int()
    diff = (img - ref_img).abs()
    assert int(diff.max()) <= 1 and float(diff.float().mean()) <= 0.05
    # lit through the fog, deep paths, shadow rays shot
    assert float(rad.max()) > 0 and int(segs) > 4 * o.shape[0]


def _nee_calls(sd, o, d, uids, key):
    """The NEE executor's intersection calls on the CPU, in order: (kind,
    o, d, t_min, t_max, u_vol), kind "bounce" or "shadow" (a bounce's rays,
    then its shadow rays; none after the last bounce)."""
    calls = []

    def recording(scene, o, d, t_min, t_max, u_vol):
        calls.append(("shadow" if len(calls) % 2 else "bounce", o, d, t_min, t_max, u_vol))
        return isect.intersect_scene_plain(scene, o, d, t_min, t_max, u_vol)

    integrator.path_trace_shrink(sd, o, d, uids, key, DEPTH, T_MAX, nee=True, intersect=recording)
    return calls


@functools.lru_cache(maxsize=1)
def _recorded():
    """The cut-down scene's NEE intersection calls on 12² × 2 spp."""
    sc, sd, _, _ = _cut_down(12, 2)
    key = threefry.key_words(SEED + 1)
    o, d, uids = driver._gen_chunk_rays(sc.camera, torch.arange(144, dtype=torch.int32), key, 0,
                                        2, 1)
    return sd, _nee_calls(sd, o, d, uids, key)


def _outputs(sd, call):
    """intersect_scene_plain's HitRecord fields and scene_intersect_plain's
    outputs on one call's rays."""
    _, o, d, t_min, t_max, u_vol = call
    hit = isect.intersect_scene_plain(sd, o, d, t_min, t_max, u_vol)
    k2 = scene_intersect.scene_intersect_plain(sd, o, d, torch.full_like(t_max, t_min), t_max,
                                               u_vol)
    return [getattr(hit, f.name) for f in hit.__dataclass_fields__.values()] + list(k2)


def _assert_bits(a, b):
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y) or bool(((x == y) | (x.isnan() & y.isnan())).all())


@pytest.mark.parametrize("kind", ["bounce", "shadow"])
def test_plain_tree_route_is_the_flat_scan(kind, monkeypatch):
    """Every field of the plain intersection and of K2's plain version,
    bit for bit, with the tree and with the scan, on the NEE executor's
    bounce rays or shadow rays (their finite windows [t_min, t_max), and
    the empty window of a ray that does not shoot) of every bounce."""
    sd, calls = _recorded()
    mine = [c for c in calls if c[0] == kind]
    assert len(mine) >= 30
    if kind == "shadow":
        t_max = torch.cat([c[4] for c in mine])
        assert bool((t_max == 0).any()) and bool(((t_max > 0) & (t_max < 5000.0)).any())
    tree = [_outputs(sd, c) for c in mine]
    _flat(monkeypatch)
    assert sd.sph_tree_leaves == 0
    for c, want in zip(mine, tree):
        _assert_bits(_outputs(sd, c), want)


@pytest.mark.parametrize("window", ["bounce", "shadow"])
def test_plain_tree_route_keeps_the_lowest_index_on_ties(window, monkeypatch):
    """Spheres planted three times give exactly equal t; the scan keeps the
    lowest index, and so does the tree route through the whole plain
    intersection, with the bounce window or with shadow windows that end
    just past the planted spheres (some before them)."""
    rng = np.random.default_rng(3)
    rows = np.concatenate([rng.uniform(-50.0, 50.0, (200, 3)), rng.uniform(0.5, 6.0, (200, 1))],
                          axis=1).astype(np.float32)
    twins = [5, 17, 80, 150]
    white = Lambertian(albedo=(0.73, 0.73, 0.73))
    objs = [Sphere(center=tuple(map(float, r[:3])), radius=float(r[3]), material=white)
            for r in np.concatenate([rows, rows[twins], rows[twins]])]
    sd = Scene(camera=rtnw_final.build(4, 4, 1, 1).camera, objects=objs).compile(device="cpu")
    g = torch.Generator().manual_seed(1)
    target = torch.as_tensor(np.concatenate([rows[twins, :3]] * 100))
    o = target + torch.randn(target.shape[0], 3, generator=g) * 80.0
    d = target + torch.randn(target.shape[0], 3, generator=g) - o
    n = o.shape[0]
    t_max = (torch.full((n,), T_MAX) if window == "bounce"
             else 0.5 + torch.rand(n, generator=g) * 0.6)
    call = (window, o, d, 0.001, t_max, torch.zeros((n, 1)))
    tree = _outputs(sd, call)
    _flat(monkeypatch)
    _assert_bits(_outputs(sd, call), tree)
    won = tree[-6]  # scene_intersect_plain's idx
    assert int(torch.isin(won, torch.tensor(twins, dtype=torch.int32)).sum()) > 50


def test_stats_count_the_walk():
    """intersect_scene_plain's and scene_intersect_plain's stats carry the
    walk's per-ray nodes and spheres (walk_spheres'), a few dozen where
    the scan tests every sphere; zero on a scene without a tree."""
    sd, calls = _recorded()
    per_kind = {}
    for kind, o, d, t_min, t_max, u_vol in calls[:6]:
        st, k2 = {}, {}
        isect.intersect_scene_plain(sd, o, d, t_min, t_max, u_vol, stats=st)
        scene_intersect.scene_intersect_plain(sd, o, d, torch.full_like(t_max, t_min), t_max,
                                              u_vol, stats=k2)
        walk = isect.walk_spheres(sd, o, d, t_min, t_max)
        for s in (st, k2):
            assert torch.equal(s["sph_nodes"], walk.nodes)
            assert torch.equal(s["sph_spheres"], walk.spheres)
        per_kind.setdefault(kind, []).append(walk)
        assert int(walk.nodes.min()) >= 1  # the root, on every ray
    for walks in per_kind.values():
        spheres = torch.cat([w.spheres for w in walks]).float()
        assert 0 < float(spheres.mean()) < sd.n_spheres / 4
    bench = Scene(camera=rtnw_final.build(4, 4, 1, 1).camera, objects=[
        Sphere(center=(0.0, 0.0, -3.0), radius=1.0, material=Lambertian(albedo=(0.5, 0.5, 0.5)))])
    bsd = bench.compile(device="cpu")
    st = {}
    o, d = torch.zeros((4, 3)), torch.tensor([[0.0, 0.0, -1.0]] * 4)
    isect.intersect_scene_plain(bsd, o, d, 0.001, 100.0, torch.zeros((4, 1)), stats=st)
    assert st["sph_nodes"] == 0 and st["sph_spheres"] == 0


def test_k2_staged_bytes_on_the_tree_route(monkeypatch):
    """K2 stages the table from its first 16-byte word past the sphere rows,
    the superleaf tree and the sphere tree's header and nodes on the tree
    route (64 B a leaf), well within a block's shared memory; up to 8,192
    spheres, past which it scans; the scan's route stages what K4 does."""
    sd = rtnw_final.build(8, 8, 1, 4).compile(device="cpu")
    assert sd.sph_tree_leaves == 256
    table = sd.kscene.numel() - (5 * 1006) // 4 * 4
    want = 4 * ((table + 3) // 4 * 4 + sd.ksl_tree.numel()) + 64 * 256
    assert scene_intersect.staged_bytes(sd) == want < bounce.staged_bytes(sd)
    assert want < scene_intersect.SMEM_LIMIT and scene_intersect.route(sd) == (256, want)
    # one layout for K1 and K2: K1 skips the sphere rows exactly
    assert bounce.k1_staged_bytes(sd) == bounce.sph_tree_staged_bytes(sd, 5 * 1006) <= want
    white = Lambertian(albedo=(0.73, 0.73, 0.73))
    for n, leaves in ((8192, 2048), (8193, 0)):
        # 4,096 leaves' nodes (256 KiB) pass a block's shared memory: the
        # scan, whose 20-B rows still fit
        big = Scene(camera=rtnw_final.build(4, 4, 1, 1).camera, objects=[
            Sphere(center=(float(i % 97), float(i // 97), 0.0), radius=0.4, material=white)
            for i in range(n)]).compile(device="cpu")
        assert scene_intersect.route(big)[0] == leaves and big.sph_tree_leaves
        if not leaves:
            assert scene_intersect.staged_bytes(big) == bounce.staged_bytes(big)
        assert scene_intersect.staged_bytes(big) <= scene_intersect.SMEM_LIMIT
    _flat(monkeypatch)
    assert scene_intersect.staged_bytes(sd) == bounce.staged_bytes(sd)
    assert scene_intersect.route(sd)[0] == 0


def test_nee_walk_count_is_a_lower_bound():
    """The benchmark's frozen count (nee_sphere_walk: culling against the
    ray's final nearest hit) of the cut-down scene's NEE paths, bounce rays
    and shadow rays apart, against the plain walk's own counts on the same
    rays (culling against its running best): never above them, and the
    bound's bytes and operations positive."""
    w, spp = 12, 2
    sc, sd, ref, _ = _cut_down(w, spp)
    seed = SEED + 2
    ro, rd, ru = tracer.camera_rays(ref, seed, torch.arange(w * w))
    ref_calls = nee_sphere_walk.nee_calls(ref, ro, rd, ru, seed)
    key = threefry.key_words(seed)
    o, d, uids = driver._gen_chunk_rays(sc.camera, torch.arange(w * w, dtype=torch.int32), key,
                                        0, spp, 1)
    calls = _nee_calls(sd, o, d, uids, key)
    assert len(calls) == len(ref_calls) and tracer.intersect.__name__ == "intersect"
    center, radius, _ = ref.spheres
    tree, g, counts = nee_sphere_walk.sphere_walk.sphere_tree(center.numpy(), radius.numpy())
    tree, counts = torch.as_tensor(tree), torch.as_tensor(counts)
    totals = {}
    for (kind, oc, dc, t_min, t_max, _), (rkind, ro_, rd_, rt_max, t_hit) in zip(calls, ref_calls):
        assert kind == rkind and torch.equal(oc, ro_) and torch.equal(t_max, rt_max)
        live = t_max >= t_min
        walk = isect.walk_spheres(sd, oc, dc, t_min, t_max)
        nd, sp = nee_sphere_walk.sphere_walk.sphere_counts(
            tree, g, counts, oc[live], dc[live], tracer.T_MIN, torch.fmin(t_hit, t_max)[live])
        tot = totals.setdefault(kind, [0, 0, 0, 0])
        tot[0] += int(nd.sum())
        tot[1] += int(sp.sum())
        tot[2] += int(walk.nodes[live].sum())
        tot[3] += int(walk.spheres[live].sum())
    for kind, (nd, sp, walk_nd, walk_sp) in totals.items():
        assert 0 < nd <= walk_nd and 0 < sp <= walk_sp, (kind, nd, walk_nd, sp, walk_sp)
    bound = nee_sphere_walk.k2_tree_image_bound(ref, seed, stride=7)
    assert bound["seconds"] > 0 and bound["ops"] > 0 and bound["bytes"] > 0
    for kind in ("bounce", "shadow"):
        assert bound[kind]["tested"] > 0 and bound[kind]["spheres_per_ray"] > 0


def test_walk_counts_tool_splits_bounce_and_shadow_rays():
    """tools/walk_counts.py --scene rtnw-nee: a bounce's rays then its shadow
    rays, call by call, at 8 × 8 (the shot-free last bounce has none); the
    walk tests a few dozen nodes a ray, not the 1,006 spheres."""
    rows = walk_counts.rtnw_nee_counts(2, "cpu", side=8, spp=4, depth=6)
    kinds = [r["kind"] for r in rows]
    assert kinds[:4] == ["bounce", "shadow", "bounce", "shadow"] and kinds[-1] == "bounce"
    assert [r["bounce"] for r in rows[:4]] == [0, 0, 1, 1] and len(rows) % 2 == 1
    assert rows[0]["rays"] == rows[0]["windows"] == 8
    for r in rows:
        assert r["windows"] <= r["rays"]
        if r["windows"]:
            assert 1 <= r["nodes"] <= r["warp_nodes_max"] and r["spheres"] < 100


def test_k2_tree_roofline_reads_nothing_without_k2():
    ms = 1_000_000
    reader = cells.metric_reader("k2_tree_roofline")
    assert reader.read({"trace": None}) is None
    tr = Trace(activities=[Activity("void bounce_kernel<true, true>(Params)", "kernel", 0,
                                    10 * ms, None)],
               window=(0, 20 * ms), images=1, host_ops=[(0, 20 * ms, "bench.image")])
    assert reader.read({"trace": tr}) is None


def test_new_cells_are_declared():
    """rtnw.nee and cornell.t64: their files, and the metrics BENCHMARK.json
    gives them."""
    for name, config, traffic in (("rtnw.nee", "rtnw_final", "frames.nee"),
                                  ("cornell.t64", "cornell_t64", "frames.path")):
        cell = cells.load_cell(name)
        assert cell.spec["config"] == config and cell.spec["traffic"] == traffic
        assert cell.chips == 1
        e2e, per_layer = cells.cell_metrics(name, ROOT)
        names = {m["name"] for m in per_layer}
        assert {"idle_share", "driver_idle_share"} <= names
        assert ("k2_tree_roofline" in names) == ("intersect_idle_share" in names) == (
            name == "rtnw.nee")
        assert {m["name"] for m in e2e} == {"setup_s", "image_s", "peak_mem_gib"}
    assert cells.load_cell("rtnw.nee").camera["nee"]
    sd = port_scene.build(cells.load_cell("cornell.t64").config,
                          cells.load_cell("cornell.t64").camera, {}).compile(device="cpu")
    assert (sd.n_planes, sd.n_spheres, sd.n_tris, len(sd.meshes)) == (5, 2, 2, 0)
    assert bounce.scene_is_simple(sd) and sd.sph_tree_leaves == 0


# ---------------------------------------------------------------- the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _nee_bounce0(dev, ground=True):
    """The full scene's NEE chunk 0 on the card, or (ground False) the
    scene's without its ground mesh: its bounce-0 inputs and its shadow
    rays, as the executor makes them, each (o, d, t_min, t_max, u_vol) for
    K2."""
    scene = rtnw_final.build(800, 800, 64, DEPTH)
    if not ground:
        scene = dataclasses.replace(scene, objects=[o for o in scene.objects
                                                    if not isinstance(o, StaticMesh)])
    sd = scene.compile(device=dev)
    cam = scene.camera
    key = threefry.key_words(11)
    px = driver.chunk_pixels(sd, cam, cam.aa_sample_count)
    n_chunks = -(-cam.screen_width * cam.screen_height // px)
    ids = torch.arange(px, dtype=torch.int32, device=dev) * n_chunks
    o, d, uids = driver._gen_chunk_rays(cam, ids, key, 0, cam.aa_sample_count, 1)
    calls = []

    def recording(scene_, o, d, t_min, t_max, u_vol):
        n = o.shape[0]
        calls.append((o.contiguous(), d.contiguous(),
                      torch.full((n,), t_min, dtype=torch.float32, device=dev),
                      t_max.contiguous(), u_vol[:, :sd.vol_center.shape[0]].contiguous()))
        return isect.intersect_scene(scene_, o, d, t_min, t_max, u_vol)

    thr, rad = torch.ones_like(o), torch.zeros_like(o)
    alive = torch.ones((o.shape[0],), dtype=torch.bool, device=dev)
    integrator.bounce_update(sd, o, d, thr, rad, alive, uids, key, 0, T_MAX, intersect=recording,
                             do_nee=True)
    return sd, calls


@pytest.mark.gpu
@pytest.mark.parametrize("ground", [True, False])
def test_k2_tree_rows_are_the_flat_rows_on_card(cuda, monkeypatch, ground):
    """With the ground, scene_intersect_tree_kernel<true> (the dense-mesh
    walk) on the benchmark's chunk; without it, <false>, on its chunk of
    1,048,576 rays."""
    sd, calls = _nee_bounce0(cuda, ground)
    assert len(calls) == 2 and calls[0][0].shape[0] == (262144 if ground else 1 << 20)
    assert sd.sph_tree_leaves == 256 and bool(sd.dense_mesh_ids) == ground
    before = scene_intersect.TREE_LAUNCHES
    tree = [scene_intersect.scene_intersect_cuda(sd, *ins) for ins in calls]
    assert scene_intersect.TREE_LAUNCHES == before + 2
    regs, spill = scene_intersect.kernel_attrs(dense=ground, sph_tree=True)
    assert spill == 0, f"K2's tree route spills {spill} B ({regs} registers)"
    _flat(monkeypatch)
    assert sd.sph_tree_leaves == 0
    for ins, rows in zip(calls, tree):
        flat = scene_intersect.scene_intersect_cuda(sd, *ins)
        for name, a, b in zip(("t", "code", "idx", "mat", "u", "v", "normal", "ff"), rows, flat):
            same = (a == b) if a.ndim == 1 else (a == b).all(dim=1)
            assert bool(same.all()), f"{name}: {int((~same).sum())} of {same.numel()} rows differ"


@pytest.mark.gpu
def test_nee_image_is_the_flat_routes_on_card(cuda, monkeypatch):
    scene = rtnw_final.build(160, 160, 16, DEPTH)
    scene = dataclasses.replace(scene, camera=dataclasses.replace(scene.camera, nee=True))
    counts = []
    for flat in (False, True):
        if flat:
            _flat(monkeypatch)
        launches, on_tree = scene_intersect.LAUNCHES, scene_intersect.TREE_LAUNCHES
        img, _ = driver.render_to_image(scene, device=cuda, seed=5, verbose=False)
        counts.append((scene_intersect.LAUNCHES - launches,
                       scene_intersect.TREE_LAUNCHES - on_tree))
        if not flat:
            tree_img = img
    assert np.array_equal(tree_img, img) and tree_img.max() > 0
    (n_tree, on_tree), (n_flat, flat_on_tree) = counts
    assert n_tree == on_tree > 0 and n_flat > 0 and flat_on_tree == 0
