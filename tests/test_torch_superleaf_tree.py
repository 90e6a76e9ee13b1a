"""K1's superleaf tree: the table (models/scene.py::superleaf_tree, packed
as SceneData.ksl_tree) and the walk over it (ops/intersect.py::
walk_dense_mesh, the plain version of csrc/intersect.cuh::scan_dense_mesh,
which K1, K2 and K4 run), against the JAX package's dense scan
(bvh.intersect_tris_scan) and against the flat superleaf scan the walk
replaced.

Scenes: the bench scene's teapot_6k (384 superleaves); the teapot with
every sixth triangle duplicated (7,168 triangles, 448 superleaves: equal t
on two rows, where the lowest row must win); two meshes of random
triangles with 7 and 33 superleaves (neither a power of two, and the
second mesh's nodes start past the first's); one mesh of 8,192 triangles,
the dense budget, whose tree fills the 1,023-node cap.

Tolerances: none. The walk and the flat scan run the same torch
arithmetic, so they agree bit for bit. The JAX scan runs op by op
(jax.disable_jit): jitted, XLA's CPU compiler contracts its multiply-adds
and moves t, u and v in the last bits (on a quarter to a half of the hits
at the teapot); op by op every operation rounds on its own, as in torch
and in K2 (built with -fmad=false).

The `gpu`-marked tests hold K1 and K2 on the card to their plain versions
on the same scenes (K1's and K2's contracts, tests/test_torch_bounce_kernel
.py and tests/test_torch_staged_kernels.py) and check K1's registers,
spills and resident blocks; they skip without a card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cs397raytracingsp22_tpu_torch as T
from cs397raytracingsp22_tpu.ops import bvh as jbvh
from cs397raytracingsp22_tpu_torch.models import scene as tscene
from cs397raytracingsp22_tpu_torch.models import transform as tf
from cs397raytracingsp22_tpu_torch.ops import intersect as tisect
from cs397raytracingsp22_tpu_torch.ops.kernels import bounce, scene_intersect
from cs397raytracingsp22_tpu_torch.ops.kernels.tri_scan import tri_scan_plain
from cs397raytracingsp22_tpu_torch.render import integrator
from cs397raytracingsp22_tpu_torch.scenes import bench_scene, cornell
from cs397raytracingsp22_tpu_torch.utils import obj_loader
# sibling test modules by their bare names (pytest puts tests/ on sys.path)
from test_torch_bounce_kernel import assert_paths_match
from test_torch_staged_kernels import k2_compare, scene_rays

torch.set_num_threads(1)  # several test workers share the cores

T_MIN, T_MAX = 1e-3, 100.0
K1_MAX_REGS, K1_BLOCKS = 96, 5  # 5 blocks of 128 threads (20 warps) in an SM's 65,536 registers


def random_mesh(n_tris: int, seed: int) -> obj_loader.ObjMesh:
    """n_tris random triangles (edges up to 0.3) in [-1, 1]^3, with flat
    vertex normals."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(-1.0, 1.0, (n_tris, 1, 3))
    pos = (a + rng.uniform(-0.3, 0.3, (n_tris, 3, 3)) * [[0.0], [1.0], [1.0]]).reshape(-1, 3)
    pos = pos.astype(np.float32)
    tri = pos.reshape(-1, 3, 3)
    nrm = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    nrm /= np.maximum(np.linalg.norm(nrm, axis=1, keepdims=True), 1e-12)
    return obj_loader.ObjMesh(
        positions=pos, normals=np.repeat(nrm, 3, axis=0).astype(np.float32),
        texcoords=np.zeros((3 * n_tris, 2), np.float32),
        indices=np.arange(3 * n_tris, dtype=np.int32).reshape(-1, 3),
        has_normals=True, has_texcoords=False)


def mesh_scene(meshes, spp=4, path_depth=4) -> T.Scene:
    """The Cornell box (scenes/cornell.py) with `meshes` (ObjMesh, transform)
    added, each a Lambertian StaticMesh."""
    base = cornell.build(width=16, height=16, spp=spp, path_depth=path_depth)
    objs = [T.StaticMesh(m, [None] * 5, T.Lambertian(albedo=(0.6, 0.5, 0.3)), x) for m, x in meshes]
    return T.Scene(camera=base.camera, objects=list(base.objects) + objs)


def _teapot_dup():
    m = obj_loader.load_obj(bench_scene.TEAPOT_6K)
    idx = np.concatenate([m.indices, m.indices[::6]])
    return obj_loader.ObjMesh(positions=m.positions, normals=m.normals,
                              texcoords=m.texcoords, indices=idx, has_normals=m.has_normals,
                              has_texcoords=m.has_texcoords)


_PLACE = tf.translate(0.0, 1.5, -1.0) @ tf.scale(0.8)
SCENES = {
    "teapot_6k": lambda: bench_scene.build(16, 16, spp=4, path_depth=4),
    "teapot_dup": lambda: mesh_scene([(_teapot_dup(), _PLACE)]),
    "two_meshes": lambda: mesh_scene([(random_mesh(100, 1), _PLACE),
                                      (random_mesh(520, 2), tf.translate(0.5, 1.0, 0.0))]),
    "cap": lambda: mesh_scene([(random_mesh(8192, 3), _PLACE)]),
}
# (scene, dense mesh) whose walk is held to the JAX scan
WALKS = [("teapot_6k", 0), ("teapot_dup", 0), ("two_meshes", 0), ("two_meshes", 1)]


@pytest.fixture(scope="module")
def compiled():
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = SCENES[name]().compile(device="cpu")
        return cache[name]

    return get


def object_space_rays(sd, k: int, n: int, seed: int):
    """(o, d) (n, 3) float32 object-space rays at dense mesh k: origins
    around the mesh's box, aimed at points inside it; an eighth with one
    direction component 0.0 or -0.0 and another eighth with two, and of
    each of those, half with the origin on that axis exactly on a face
    of a tree node's box (a leaf or an inner node), where the slab test's
    0 * inf gives NaN."""
    rng = np.random.default_rng(seed)
    tree = tisect.superleaf_tree_rows(sd, k).numpy()
    lo, hi = tree[0, 0:3], tree[0, 4:7]
    ext = hi - lo
    o = lo + ext * rng.uniform(-1.0, 2.0, (n, 3))
    d = lo + ext * rng.uniform(0.0, 1.0, (n, 3)) - o
    m = n // 8
    for r0, n_zero in ((0, 1), (m, 2)):
        rows = np.arange(r0, r0 + m)
        for r in rows:
            axes = rng.choice(3, n_zero, replace=False)
            node = tree[rng.integers(0, tree.shape[0])]
            inside = node[0:3] + (node[4:7] - node[0:3]) * rng.uniform(0.0, 1.0, 3)
            d[r] = inside - o[r]
            d[r, axes] = rng.choice([0.0, -0.0])
            if r % 2 == 0:
                o[r, axes] = node[axes + 4 * rng.integers(0, 2)]  # lo (0:3) or hi (4:7)
    return torch.from_numpy(o.astype(np.float32)), torch.from_numpy(d.astype(np.float32))


def flat_scan(sd, k: int, o, d, t_min, t_max):
    """The scan the walk replaced: every superleaf box of dense mesh k in
    row order against the running best, the 16 rows of each box reached.
    Returns (hit, t, row, u, v, leaves (N, S))."""
    first, s = sd.ksl_ranges[k]
    start = sd.kmesh_ranges[k][0]
    n = o.shape[0]
    inv = 1.0 / d
    best = torch.full((n,), t_max)
    row = torch.full((n,), -1, dtype=torch.int32)
    u, v = torch.zeros((n,)), torch.zeros((n,))
    leaves = torch.zeros((n, s), dtype=torch.bool)
    for g in range(s):
        b = sd.ksl_bounds[first + g]
        leaves[:, g] = tisect._slab(b[:3], b[3:], o, inv, torch.full((n,), t_min), best)
        sel = leaves[:, g].nonzero()[:, 0]
        r0 = start + 16 * g
        hit_l, t_l, tri_l, u_l, v_l = tri_scan_plain(sd.kmesh_tri[r0:r0 + 16], o[sel], d[sel],
                                                     t_min, best[sel], chunk=16)
        idx = sel[hit_l]
        best[idx], row[idx] = t_l[hit_l], 16 * g + tri_l[hit_l]
        u[idx], v[idx] = u_l[hit_l], v_l[hit_l]
    return row >= 0, best, row, u, v, leaves


# ---- the table ----

@pytest.mark.parametrize("s", list(range(1, 40)) + [384, 448, 512])
def test_preorder_meets_every_node_once_and_the_leaves_in_row_order(s):
    """The index arithmetic the kernel shares: the walk's order is a
    preorder of the heap-ordered tree (each node after its parent), holds
    each of the 2s - 1 nodes once, and meets the leaves as superleaves
    0, 1, ..., s - 1."""
    order = tisect.tree_preorder(s)
    assert sorted(order) == list(range(1, 2 * s))
    pos = {j: i for i, j in enumerate(order)}
    assert all(pos[j // 2] < pos[j] for j in order if j > 1)
    assert [tisect.tree_leaf(j, s) for j in order if j >= s] == list(range(s))


@pytest.mark.parametrize("name", sorted(SCENES))
def test_tree_leaves_are_the_superleaf_boxes_and_parents_their_exact_unions(compiled, name):
    sd = compiled(name)
    tree_all = sd.ksl_tree.numpy()
    assert tree_all.dtype == np.float32 and tree_all.shape[1] == tscene.TREE_ROW
    assert tree_all.shape[0] == sum(2 * s - 1 for _, s in sd.ksl_ranges)
    assert (tree_all[:, 3] == 0).all() and (tree_all[:, 7] == 0).all()
    for k, (first, s) in enumerate(sd.ksl_ranges):
        tree = tisect.superleaf_tree_rows(sd, k).numpy()
        lo, hi = tree[:, 0:3], tree[:, 4:7]
        boxes = sd.ksl_bounds[first:first + s].numpy()
        for j in range(s, 2 * s):
            g = tisect.tree_leaf(j, s)
            np.testing.assert_array_equal(lo[j - 1], boxes[g, :3])
            np.testing.assert_array_equal(hi[j - 1], boxes[g, 3:])
        for j in range(1, s):
            np.testing.assert_array_equal(lo[j - 1], np.minimum(lo[2 * j - 1], lo[2 * j]))
            np.testing.assert_array_equal(hi[j - 1], np.maximum(hi[2 * j - 1], hi[2 * j]))
        assert (lo < hi).all()


@pytest.mark.parametrize("name, superleaves", [("teapot_6k", (384,)), ("teapot_dup", (448,)),
                                               ("two_meshes", (7, 33)), ("cap", (512,))])
def test_tree_fits_the_cap(compiled, name, superleaves):
    """The dense budget (8,192 triangles) caps a scene at 512 superleaves:
    at most 1,023 nodes, 32,736 bytes staged beside the scene table."""
    sd = compiled(name)
    assert tuple(s for _, s in sd.ksl_ranges) == superleaves
    assert tscene.TREE_MAX_NODES == 1023
    assert sd.ksl_tree.shape[0] <= tscene.TREE_MAX_NODES
    assert sd.ksl_tree.numel() * 4 <= 32736
    if name == "cap":
        assert sd.ksl_tree.numel() * 4 == 32736


@pytest.mark.parametrize("name", ["teapot_6k", "two_meshes"])
def test_row_table_is_kmesh_tri_in_16_byte_rows(compiled, name):
    """kmesh_tri4, the rows the kernels read as three 16-byte loads:
    kmesh_tri's nine floats, then three zeros."""
    sd = compiled(name)
    rows = sd.kmesh_tri4.numpy()
    assert rows.shape == (sd.kmesh_tri.shape[0], 12) and rows.dtype == np.float32
    np.testing.assert_array_equal(rows[:, :9], sd.kmesh_tri.numpy())
    assert (rows[:, 9:] == 0).all()


def test_pack_refuses_a_tree_beyond_the_cap_and_flat_boxes():
    boxes = np.tile(np.array([[0, 0, 0, 1, 1, 1]], np.float32), (600, 1))
    assert tscene.superleaf_tree(boxes).shape == (1199, tscene.TREE_ROW)
    with pytest.raises(ValueError, match="superleaf tree nodes"):
        tscene.superleaf_trees(boxes, ((0, 600),))
    flat = boxes[:8].copy()
    flat[3, 1] = flat[3, 4]
    with pytest.raises(ValueError, match="flat"):
        tscene.superleaf_trees(flat, ((0, 8),))
    with pytest.raises(ValueError, match="starts"):
        tscene.superleaf_trees(boxes[:8], ((0, 4), (5, 3)))


# ---- the walk ----

@pytest.mark.parametrize("name, k", WALKS)
def test_walk_matches_jax_scan_and_the_flat_scan(compiled, name, k):
    """Bit for bit: the walk against the JAX package's intersect_tris_scan
    over the mesh's triangles, and against the flat scan, which it must
    also match superleaf for superleaf (it enters every superleaf the flat
    cull enters, and no other)."""
    sd = compiled(name)
    o, d = object_space_rays(sd, k, 512, seed=10 + k)
    walk = tisect.walk_dense_mesh(sd, k, o, d, T_MIN, T_MAX)
    verts = sd.meshes[sd.dense_mesh_ids[k]].tri_verts.numpy()
    with jax.disable_jit():
        ref = [np.asarray(x) for x in jbvh.intersect_tris_scan(
            jnp.asarray(o.numpy()), jnp.asarray(d.numpy()), jnp.asarray(verts), T_MIN, T_MAX)]
    for field, a, b in zip(("hit", "t", "row", "u", "v"), walk[:5], ref):
        np.testing.assert_array_equal(a.numpy(), b, err_msg=field)
    flat = flat_scan(sd, k, o, d, T_MIN, T_MAX)
    for field, a, b in zip(("hit", "t", "row", "u", "v", "leaves"), walk[:5] + (walk.leaves,),
                           flat):
        assert torch.equal(a, b), field
    assert torch.equal(walk.tris, 16 * flat[5].sum(dim=1))
    assert int(walk.hit.sum()) > 100
    zero = (d == 0).any(dim=1)
    assert int((zero & walk.hit).sum()) > 5, "rays with zero direction components must hit"
    if name == "teapot_dup":
        # rows at the least t among all rows: the duplicates tie, the lowest wins
        tv = sd.meshes[0].tri_verts
        valid, t, _, _ = tisect.bvhlib.moller_trumbore(o[:, None], d[:, None], tv[:, 0], tv[:, 1],
                                                       tv[:, 2], T_MIN, T_MAX)
        at_best = valid & (t == walk.t[:, None])
        ties = walk.hit & (at_best.sum(dim=1) >= 2)
        assert int(ties.sum()) > 10
        first = at_best.to(torch.int8).argmax(dim=1)
        assert torch.equal(walk.row[ties].long(), first[ties])


def test_walk_tests_one_node_for_rays_that_miss_the_root(compiled):
    sd = compiled("two_meshes")
    o, d = object_space_rays(sd, 1, 256, seed=3)
    away = torch.cat([o, o])
    d_away = torch.cat([-d, d])  # from outside the box away from it, or toward it
    walk = tisect.walk_dense_mesh(sd, 1, away, d_away, T_MIN, T_MAX)
    root = tisect.superleaf_tree_rows(sd, 1)[0]
    miss = ~tisect._slab(root[0:3], root[4:7], away, 1.0 / d_away, torch.full((512,), T_MIN),
                         torch.full((512,), T_MAX))
    assert int(miss.sum()) > 100
    assert bool((walk.nodes[miss] == 1).all()) and bool((walk.tris[miss] == 0).all())
    assert bool((walk.nodes[~miss] >= 3).all()), "a reached root tests both children"


def test_tree_counts_bound_the_walk(compiled):
    """dense_scan_counts, the work behind K1's bound: per live ray the tree
    walk against the final t_hit tests no more nodes than the walk against
    a running best (itself a lower bound on the kernel's, which carries the
    analytic classes' best too) and, on these rays at the teapot, no more
    than the flat scan's boxes; a ray that misses the mesh's root box tests
    one node; both walks reach the superleaves the flat cull reaches."""
    sd = compiled("teapot_6k")
    o, d, t_min, t_max, u_vol = (torch.from_numpy(x) for x in scene_rays(1024, seed=6))
    st = {}
    hit = tisect.intersect_scene_plain(sd, o, d, t_min, t_max, u_vol, stats=st)
    nodes, boxes, tris = st["nodes"], st["boxes"], st["tris"]
    live = t_max >= t_min
    s = sd.ksl_ranges[0][1]
    assert bool((nodes[~live] == 0).all()) and bool((boxes[live] == s).all())
    assert bool((nodes[live] <= boxes[live]).all()) and bool((nodes[live] >= 1).all())
    o_obj, d_obj = tisect.object_rays(sd.meshes[0], o, d)
    far = torch.fmin(hit.t, t_max)
    b = sd.ksl_bounds[:s]
    flat = tisect._slab(b[:, :3], b[:, 3:], o_obj[:, None], (1.0 / d_obj)[:, None],
                        t_min[:, None], far[:, None]) & live[:, None]
    assert torch.equal(tris, 16 * flat.sum(dim=1))
    root = tisect.superleaf_tree_rows(sd, 0)[0]
    miss = live & ~tisect._slab(root[0:3], root[4:7], o_obj, 1.0 / d_obj, t_min, far)
    assert int(miss.sum()) > 100 and bool((nodes[miss] == 1).all())
    walk = tisect.walk_dense_mesh(sd, 0, o_obj, d_obj, t_min, t_max)
    assert bool((nodes[live] <= walk.nodes[live]).all()) and bool((tris <= walk.tris).all())
    assert 1.0 < float(nodes[live].float().mean()) < 0.2 * s


# ---- on the card ----

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["teapot_6k", "teapot_dup", "two_meshes"])
def test_k1_walk_matches_plain_on_card(cuda, name):
    scene = SCENES[name]()
    data = scene.compile(device=cuda)
    o, d = scene.camera.generate_rays(5, torch.arange(128, dtype=torch.int32, device=cuda), spp=4)
    o, d = o.reshape(-1, 3).contiguous(), d.reshape(-1, 3).contiguous()
    uids = torch.arange(512, dtype=torch.int32, device=cuda)
    before = bounce.LAUNCHES
    rad, segs = bounce.path_trace_cuda(data, o, d, uids, 5, 4, scene.camera.max_trace_dist)
    torch.cuda.synchronize()
    assert bounce.LAUNCHES == before + 1
    ref_rad, ref_segs = integrator.path_trace(data, o, d, uids, 5, 4, scene.camera.max_trace_dist)
    assert float(ref_rad.max()) > 0.0
    assert_paths_match(rad.cpu().numpy(), segs.cpu(), ref_rad.cpu().numpy(), ref_segs.cpu())


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["teapot_6k", "teapot_dup", "two_meshes"])
def test_k2_walk_matches_plain_on_card(cuda, name):
    data = SCENES[name]().compile(device=cuda)
    o, d, t_min, t_max, u_vol = (torch.from_numpy(x).to(cuda) for x in scene_rays(4096, seed=8))
    before = scene_intersect.LAUNCHES
    out = scene_intersect.scene_intersect_cuda(data, o, d, t_min, t_max, u_vol)
    torch.cuda.synchronize()
    assert scene_intersect.LAUNCHES == before + 1
    ref = scene_intersect.scene_intersect_plain(data, o, d, t_min, t_max, u_vol)
    k2_compare(out, ref)
    code = out[1].cpu().numpy()
    assert (code >= 4).sum() > 50, "the dense meshes must take part"


@pytest.mark.gpu
def test_k1_keeps_its_occupancy(cuda):
    """No spills, at most K1_MAX_REGS registers, and K1_BLOCKS resident
    blocks an SM with the bench scene's table and tree (24,544 B) staged;
    without a dense mesh K1 leaves the walk out, spills nothing and keeps
    at least the 8 blocks (32 warps) it had before the tree."""
    regs, spill = bounce.kernel_attrs()
    assert spill == 0 and regs <= K1_MAX_REGS, (regs, spill)
    data = SCENES["teapot_6k"]().compile(device=cuda)
    assert bounce.resident_blocks(data) >= K1_BLOCKS
    assert bounce.kernel_attrs(dense=False)[1] == 0
    assert bounce.resident_blocks(cornell.build(8, 8, spp=1).compile(device=cuda)) >= 8
