"""The big-mesh kernel's packed tables and ordered walk (K3's plain
version) on the CPU:

- models/scene.py::mesh_kernel_tables and ops/bvh.py::pack_bvh from both
  BVH builders (the C++ one through utils/native.py and the Python one):
  each child-pair row's boxes are its children's bounds_min / bounds_max,
  the leaf references cover every row once in increasing order, the stack
  depth bounds the walk, and the 48-byte rows hold tri_verts' float32
  edges (bvh_tri4) and tri_table's rows (tri_table4) bit for bit;
- ops/bvh.py::traverse_packed, the walk that csrc/bvh_traverse.cu takes,
  bit for bit against ops/bvh.py::traverse, its spec, on 4,096 camera,
  aimed and scattered rays of the 32,832-triangle bench teapot, and against
  the JAX package's bvh.traverse (jitted; XLA's operation order moves t,
  u, v in the last bits, so tests/test_torch_staged.py's tolerance: the
  same winner on >= 99.9% of rays, t within rtol 1e-5, u, v within atol
  1e-4);
- the edge cases of the ordered walk: duplicated triangles (the largest
  row wins), flat axis-aligned leaves (never culled by their own box),
  zero direction components with the origin on a box face, dead rays, and
  its counts against the threaded walk's on the aimed rays (camera rays
  that barely enter the tree can take more slab tests: the ordered walk
  tests both children of a node it opens, leaves included).

The `gpu`-marked tests hold the kernel to traverse on the card (the
staged kernels' contract) and skip without one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cs397raytracingsp22_tpu.ops import bvh as jbvh
from cs397raytracingsp22_tpu_torch.models import scene as tscene
from cs397raytracingsp22_tpu_torch.ops import bvh as tbvh
from cs397raytracingsp22_tpu_torch.ops import intersect as tisect
from cs397raytracingsp22_tpu_torch.ops.kernels import tri_scan_big
from cs397raytracingsp22_tpu_torch.render import driver as tdriver
from cs397raytracingsp22_tpu_torch.scenes import bench_scene, bench_teapot_32k
from cs397raytracingsp22_tpu_torch.tools.compare_k3 import aimed_rays
# sibling test modules by their bare names (pytest puts tests/ on sys.path)
from test_torch_scene import jax_bench_scene
from test_torch_staged_kernels import k3_compare, scene_rays

torch.set_num_threads(1)  # several test workers share the cores

N_RAYS = 4096
TREE_KEYS = ("bounds_min", "bounds_max", "skip", "leaf_start", "leaf_count")


def mesh_tables(verts: np.ndarray, use_native: bool = True, leaf_size: int = 4) -> dict:
    """The threaded BVH of (NT, 3, 3) verts and the kernel's tables, as the
    scene compile builds them: a dict of numpy arrays holding FlatBVH's
    node arrays, tri_verts and tri_table in BVH order, and
    mesh_kernel_tables' output."""
    flat = tbvh.build_bvh(verts, leaf_size=leaf_size, use_native=use_native)
    rv = verts[flat.tri_order].astype(np.float32)
    m = {k: getattr(flat, k) for k in TREE_KEYS}
    m["tri_verts"] = rv
    m["leaf_size"] = leaf_size
    m["tri_table"] = np.concatenate([rv[:, 0], rv[:, 1] - rv[:, 0], rv[:, 2] - rv[:, 0]], 1)
    m.update(tscene.mesh_kernel_tables(m))
    return m


def walks(m: dict, o, d, t_min, t_max):
    """(traverse's outputs, its stats, traverse_packed's outputs, its stats)
    on numpy rays."""
    o, d, t_min, t_max = (torch.as_tensor(np.asarray(x, np.float32)) for x in (o, d, t_min, t_max))
    t = {k: torch.from_numpy(np.asarray(v)) for k, v in m.items()
         if k not in ("bvh_depth", "leaf_size")}
    st, sp = {}, {}
    ref = tbvh.traverse(o, d, t_min, t_max, *(t[k] for k in TREE_KEYS), t["tri_verts"],
                        m["leaf_size"], stats=st)
    out = tbvh.traverse_packed(o, d, t_min, t_max, t["bvh_nodes"], t["bvh_tri4"],
                               m["bvh_depth"], stats=sp)
    return ref, st, out, sp


def assert_bit_identical(out, ref, what):
    for name, a, b in zip(("hit", "t", "tri", "u", "v"), out, ref):
        assert torch.equal(a, b), f"{what}: {int((a != b).sum())} rays differ in {name}"


@pytest.fixture(scope="module")
def teapot32k():
    """(port scene, its SceneData on the CPU, JAX SceneData) of the 32k
    bench scene at 64² × 1 spp."""
    sc = bench_teapot_32k.build(64, 64, spp=1, path_depth=4)
    assert sc.objects[-1].mesh.indices.shape[0] == 32832
    obj = bench_scene.teapot_obj(bench_teapot_32k.TARGET)
    return sc, sc.compile(device="cpu"), jax_bench_scene(64, 64, spp=1, path_depth=4,
                                                         obj_path=obj).compile()


@pytest.mark.parametrize("use_native", [True, False], ids=["native", "python"])
def test_packed_tables(teapot32k, use_native):
    """Both builders' trees pack: children's boxes and references exact,
    leaves covering the rows once in preorder, the depth the deepest
    leaf's, the rows bit for bit."""
    verts = teapot32k[1].meshes[0].tri_verts.numpy()  # any order: the tree is rebuilt
    m = mesh_tables(verts, use_native)
    nodes, depth = m["bvh_nodes"], m["bvh_depth"]
    refs = nodes.view(np.int32)
    ls, lc, sk = m["leaf_start"], m["leaf_count"], m["skip"]
    nn = sk.shape[0]
    # the tree's nodes by reference: interior node i -> its row, leaf -> code
    code = {}
    rows_seen, leaves = set(), []
    assert refs[0, 3] == 1 and (nodes[0, 0:3] == m["bounds_min"][0]).all()
    assert (nodes[0, 4:7] == m["bounds_max"][0]).all() and (nodes[0, 8:] == 0).all()
    stack = [(0, 1)]  # (preorder node, its row)
    while stack:
        i, row = stack.pop()
        assert row not in rows_seen
        rows_seen.add(row)
        for slot, c in enumerate((i + 1, sk[i + 1])):
            col = 8 * slot
            np.testing.assert_array_equal(nodes[row, col:col + 3], m["bounds_min"][c])
            np.testing.assert_array_equal(nodes[row, col + 4:col + 7], m["bounds_max"][c])
            r = int(refs[row, col + 3])
            if ls[c] >= 0:
                assert r < 0 and ~r >> 4 == ls[c] and ~r & 15 == lc[c]
                leaves.append((c, ls[c], lc[c]))
            else:
                assert r > 0
                stack.append((c, r))
            code[c] = r
    assert rows_seen == set(range(1, nodes.shape[0]))
    leaves.sort()  # preorder
    starts = np.array([s for _, s, _ in leaves])
    counts = np.array([n for _, _, n in leaves])
    assert starts[0] == 0 and (starts[1:] == starts[:-1] + counts[:-1]).all()
    assert starts[-1] + counts[-1] == verts.shape[0]
    # depth: the deepest leaf's interior ancestors (ceil(log2(32832 / 4)))
    level = np.zeros(nn, np.int64)
    for i in np.flatnonzero(ls < 0):
        level[i + 1] = level[sk[i + 1]] = level[i] + 1
    assert depth == level[ls >= 0].max() == 14
    rv = m["tri_verts"]
    np.testing.assert_array_equal(m["bvh_tri4"][:, 0:3], rv[:, 0])
    np.testing.assert_array_equal(m["bvh_tri4"][:, 3:6], rv[:, 1] - rv[:, 0])
    np.testing.assert_array_equal(m["bvh_tri4"][:, 6:9], rv[:, 2] - rv[:, 0])
    np.testing.assert_array_equal(m["tri_table4"][:, :9], m["tri_table"])
    assert not m["bvh_tri4"][:, 9:].any() and not m["tri_table4"][:, 9:].any()
    assert m["bvh_tri4"].dtype == m["tri_table4"].dtype == np.float32


def test_pack_refuses_what_the_walk_cannot_take():
    """pack_bvh raises on leaves out of row order, on leaves beyond 15
    triangles and on a tree that is not binary."""
    rng = np.random.default_rng(0)
    m = mesh_tables(rng.random((40, 3, 3)).astype(np.float32))
    args = [m[k].copy() for k in TREE_KEYS]
    leaves = np.flatnonzero(args[3] >= 0)
    swapped = [a.copy() for a in args]
    swapped[3][leaves[[0, 1]]] = swapped[3][leaves[[1, 0]]]
    with pytest.raises(ValueError, match="increasing order"):
        tbvh.pack_bvh(*swapped)
    big = [a.copy() for a in args]
    big[4][leaves[0]] = 16
    with pytest.raises(ValueError, match="1..15"):
        tbvh.pack_bvh(*big)
    broken = [a.copy() for a in args]
    broken[2][1] = broken[2][0]  # the left child's subtree swallows the right one
    with pytest.raises(ValueError):
        tbvh.pack_bvh(*broken)


def _ray_sets(sc, sd):
    """{name: (o, d, t_min, t_max) numpy object-space rays}: 4,096 camera
    rays, rays aimed at the teapot's box and scattered rays of the room."""
    mesh = sd.meshes[0]
    n = N_RAYS
    o, d, _ = tdriver._gen_chunk_rays(sc.camera, torch.arange(n, dtype=torch.int32), 3, 0, 1, 1)
    out = {}
    t_min = np.full((n,), 1e-3, np.float32)
    t_max = np.full((n,), 100.0, np.float32)
    for name, (ow, dw) in (("camera", (o, d)), ("aimed", aimed_rays(mesh, n, "cpu", seed=5)),
                           ("scattered", tuple(torch.from_numpy(x)
                                               for x in scene_rays(n, seed=6)[:2]))):
        oo, dd = tisect.object_rays(mesh, ow, dw)
        tm = scene_rays(n, seed=6)[3] if name == "scattered" else t_max
        out[name] = (oo.numpy(), dd.numpy(), t_min, tm)
    return out


@pytest.fixture(scope="module")
def ray_sets(teapot32k):
    return _ray_sets(*teapot32k[:2])


@pytest.mark.parametrize("rays", ["camera", "aimed", "scattered"])
def test_packed_walk_matches_traverse(teapot32k, ray_sets, rays):
    """Bit for bit against traverse on the compiled 32k teapot; against the
    JAX traverse within the stated tolerance; no more work on average."""
    sc, sd, jsd = teapot32k
    m = sd.meshes[0]
    o, d, t_min, t_max = (torch.from_numpy(x) for x in ray_sets[rays])
    st, sp = {}, {}
    ref = tri_scan_big.tri_scan_big_plain(m, o, d, t_min, t_max, stats=st)
    out = tri_scan_big.tri_scan_big_packed(m, o, d, t_min, t_max, stats=sp)
    assert_bit_identical(out, ref, rays)
    n_hit = int(out[0].sum())
    assert n_hit > {"camera": 10, "aimed": 1000, "scattered": 300}[rays], n_hit
    if rays == "scattered":
        assert not bool(out[0][::16].any()), "dead rays miss"
    assert int(sp["pushes"].sum()) > 0
    if rays == "aimed":  # the ordered walk does no more work where rays hit
        assert sp["tris"].float().mean() <= st["tris"].float().mean()
        assert sp["boxes"].float().mean() <= st["boxes"].float().mean()
    jm = jsd.meshes[0]
    jax_trav = jax.jit(jbvh.traverse, static_argnums=(10,))
    hj, tj, ij, uj, vj = (np.asarray(x) for x in jax_trav(
        *(jnp.asarray(x.numpy()) for x in (o, d, t_min, t_max)), jm.bounds_min, jm.bounds_max,
        jm.skip, jm.leaf_start, jm.leaf_count, jm.tri_verts, jm.leaf_size))
    ht, tt, it, ut, vt = (x.numpy() for x in out)
    same = (hj == ht) & (ij == it)
    assert same.mean() >= 0.999, f"{(~same).sum()} winner flips against JAX"
    np.testing.assert_allclose(tt[same], tj[same], rtol=1e-5, atol=1e-6)
    for a, b in ((ut, uj), (vt, vj)):
        np.testing.assert_allclose(a[same], b[same], rtol=0.0, atol=1e-4)


def test_round_trip_carries_the_packed_tables(teapot32k):
    """The JAX package's compiled mesh, through scene_data_from_numpy, gets
    the same packed tables as the port's own compile."""
    from test_torch_scene import port_data_from_jax

    _, sd, jsd = teapot32k
    pm, jm = sd.meshes[0], port_data_from_jax(jsd).meshes[0]
    for k in ("bvh_nodes", "bvh_tri4", "tri_table4"):  # bits: leaf references read as NaN
        assert torch.equal(getattr(pm, k).view(torch.int32), getattr(jm, k).view(torch.int32)), k
    assert pm.bvh_depth == jm.bvh_depth == 14


def test_duplicated_triangles_keep_the_largest_row():
    """Every triangle twice: among the two copies' equal t the walk keeps
    the larger row, as the threaded walk's `<=` does."""
    rng = np.random.default_rng(1)
    base = (rng.random((300, 1, 3)) * 2.0 - 1.0 + rng.random((300, 3, 3)) * 0.3)
    verts = np.concatenate([base, base]).astype(np.float32)
    m = mesh_tables(verts)
    n = 2048
    o = rng.uniform(-2.5, 2.5, (n, 3))
    d = rng.uniform(-0.6, 0.6, (n, 3)) - o
    ref, _, out, _ = walks(m, o, d, np.full(n, 1e-3), np.full(n, 100.0))
    assert_bit_identical(out, ref, "duplicates")
    hit, tri = out[0].numpy(), out[2].numpy()
    assert hit.sum() > 300
    copies = {}
    for row, tv in enumerate(m["tri_verts"]):
        copies.setdefault(tv.tobytes(), []).append(row)
    for row in tri[hit]:
        assert row == max(copies[m["tri_verts"][row].tobytes()]), row


def _steps(k=8, seed=4):
    """k × k axis-aligned squares (two triangles each) on a unit grid,
    each at its own height z: built with leaves of 2 triangles, a leaf is
    one square, a flat box, while every interior box spans several
    heights."""
    rng = np.random.default_rng(seed)
    z = rng.permutation(k * k) / (2.0 * k * k)
    tris = []
    for i in range(k):
        for j in range(k):
            x, y, h = float(i), float(j), z[i * k + j]
            p = np.array([[x, y, h], [x + 0.5, y, h], [x + 0.5, y + 0.5, h], [x, y + 0.5, h]])
            tris += [p[[0, 1, 2]], p[[0, 2, 3]]]
    return np.asarray(tris, np.float32)


def test_flat_leaves_are_never_culled():
    """Every leaf box is flat in z, and a ray meeting its square would fail
    its strict slab test; the walk tests the leaf anyway and finds every
    hit of the dense scan."""
    m = mesh_tables(_steps(), leaf_size=2)
    leaf = m["leaf_start"] >= 0
    lo, hi = m["bounds_min"], m["bounds_max"]
    assert (lo[leaf, 2] == hi[leaf, 2]).all() and (lo[~leaf, 2] < hi[~leaf, 2]).all()
    rng = np.random.default_rng(2)
    n = 2048
    o = np.concatenate([rng.uniform(-1.0, 9.0, (n, 2)), rng.uniform(1.0, 3.0, (n, 1))], 1)
    d = np.concatenate([rng.uniform(-0.3, 0.3, (n, 2)), -np.ones((n, 1))], 1)
    ref, _, out, _ = walks(m, o, d, np.full(n, 1e-3), np.full(n, 100.0))
    assert_bit_identical(out, ref, "flat leaves")
    dense = tbvh.intersect_tris_scan(torch.from_numpy(o.astype(np.float32)),
                                     torch.from_numpy(d.astype(np.float32)),
                                     torch.from_numpy(m["tri_verts"]), 1e-3, 100.0)
    assert torch.equal(out[0], dense[0]) and int(out[0].sum()) > 200
    assert torch.equal(out[1][out[0]], dense[1][dense[0]])


def test_axis_rays_from_box_faces_and_dead_rays(teapot32k):
    """Zero direction components with the origin on a box face (the 0·inf
    lanes the slab test washes out), and dead rays (t_max = 0 < t_min),
    which stop at the root."""
    m = teapot32k[1].meshes[0]
    rng = np.random.default_rng(3)
    n = 2048
    nodes = rng.integers(0, m.bounds_min.shape[0], n)
    lo, hi = m.bounds_min.numpy()[nodes], m.bounds_max.numpy()[nodes]
    o = rng.uniform(lo, hi)
    axis = rng.integers(0, 3, n)
    o[np.arange(n), axis] = np.where(rng.random((n, 1)) < 0.5, lo, hi)[np.arange(n), axis]
    d = rng.standard_normal((n, 3))
    d[np.arange(n), axis] = 0.0
    d[: n // 2, (axis[: n // 2] + 1) % 3] = 0.0  # half the rays run along one axis
    t_max = np.full(n, 100.0, np.float32)
    t_max[::8] = 0.0
    o, d, t_min, t_max = (torch.from_numpy(np.asarray(x, np.float32))
                          for x in (o, d, np.full(n, 1e-3), t_max))
    st = {}
    out = tri_scan_big.tri_scan_big_packed(m, o, d, t_min, t_max, stats=st)
    ref = tri_scan_big.tri_scan_big_plain(m, o, d, t_min, t_max)
    assert_bit_identical(out, ref, "axis rays")
    assert int(out[0].sum()) > 100
    assert not bool(out[0][::8].any()) and torch.equal(out[1][::8], t_max[::8])
    assert (st["boxes"][::8] == 1).all() and (st["tris"][::8] == 0).all()
    assert (st["nodes"][::8] == 0).all()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("n", [4096, 4096 + 77, 31], ids=["4096", "not_a_batch", "one_warp"])
def test_k3_on_aimed_rays_on_card(cuda, n):
    """K3 on rays aimed at the 32k teapot (and on counts that are not a
    multiple of the fetch batch) against traverse, with the staged
    kernels' contract, and bit for bit against its step-for-step plain
    version."""
    sd = bench_teapot_32k.build(16, 16, spp=1).compile(device=cuda)
    mesh = sd.meshes[0]
    o, d = aimed_rays(mesh, n, cuda, seed=7)
    o_obj, d_obj = (x.contiguous() for x in tisect.object_rays(mesh, o, d))
    t_min = torch.full((n,), 1e-3, device=cuda)
    t_max = torch.full((n,), 100.0, device=cuda)
    t_max[::16] = 0.0
    before = tri_scan_big.LAUNCHES
    out = tri_scan_big.tri_scan_big_cuda(mesh, o_obj, d_obj, t_min, t_max)
    torch.cuda.synchronize()
    assert tri_scan_big.LAUNCHES == before + 2  # the screen and the walk
    k3_compare(out, tri_scan_big.tri_scan_big_plain(mesh, o_obj, d_obj, t_min, t_max))
    packed = tri_scan_big.tri_scan_big_packed(mesh, o_obj, d_obj, t_min, t_max)
    assert_bit_identical([x.cpu() for x in out], [x.cpu() for x in packed], "K3")
    assert not bool(out[0][::16].any())
    if n >= 4096:
        assert int(out[0].sum()) > n // 10


@pytest.mark.gpu
def test_k3_on_camera_rays_on_card(cuda):
    """K3 on the camera rays of a 64² frame of the 32k teapot against
    traverse, and bit for bit against the step-for-step plain version. Of
    the 32 warps with rays inside the root box, 11 form packets that the
    screen walks itself; the others' rays are listed for the walk."""
    sc = bench_teapot_32k.build(64, 64, spp=4)
    mesh = sc.compile(device=cuda).meshes[0]
    o, d, _ = tdriver._gen_chunk_rays(sc.camera, torch.arange(64 * 64, dtype=torch.int32,
                                                              device=cuda), 3, 0, 4, 1)
    o_obj, d_obj = (x.contiguous() for x in tisect.object_rays(mesh, o, d))
    n = o_obj.shape[0]
    t_min = torch.full((n,), 1e-3, device=cuda)
    t_max = torch.full((n,), 100.0, device=cuda)
    before = tri_scan_big.LAUNCHES
    out = tri_scan_big.tri_scan_big_cuda(mesh, o_obj, d_obj, t_min, t_max)
    torch.cuda.synchronize()
    assert tri_scan_big.LAUNCHES == before + 2  # the screen and the walk
    k3_compare(out, tri_scan_big.tri_scan_big_plain(mesh, o_obj, d_obj, t_min, t_max))
    packed = tri_scan_big.tri_scan_big_packed(mesh, o_obj, d_obj, t_min, t_max)
    assert_bit_identical([x.cpu() for x in out], [x.cpu() for x in packed], "K3")
    assert int(out[0].sum()) > 20
