"""The dense single-mesh scan of the torch port (ops/kernels/tri_scan.py,
K5's plain version tri_scan_plain and the entry point intersect_mesh)
against the JAX package.

Tolerances:
- tri_scan_plain against the JAX tri_scan_pallas (interpret mode on the
  CPU, as tests/test_intersect.py runs it) on the same tri_table: the same
  hits and triangle ids, t, u, v within rtol 1e-5 / atol 1e-6 (the
  kernel's and the port's float orders differ only in XLA's fusion);
- tri_scan_plain against bvh.intersect_tris_scan on a compiled mesh: the
  same winner on at least 99.9% of rays, t within rtol 1e-5 / atol 1e-5
  where it agrees (the scan reads tri_table, whose edges were formed
  before the cast to float32, the other reads tri_verts: from float64
  positions an edge may differ in its last bit, which moves a short t by
  ~1e-6), bit for bit from float32 positions;
- the port's intersect_mesh against the JAX intersect_mesh on the CPU: the
  same hits on at least 99.9% of rays, t within rtol 1e-5 and point and
  normal within rtol 1e-4 / atol 1e-5 where both hit.
tri_table4, the padded rows K5 reads, equals tri_table bit for bit. The
`gpu`-marked tests hold K5 to tri_scan_plain on the card (K2's contract:
the same winner on >= 99.9% of rays, t, u, v within rtol 1e-4 / atol
1e-5), also on ray and row counts that fill no whole block or tile, and
skip without one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cs397raytracingsp22_tpu.ops import intersect as jisect
from cs397raytracingsp22_tpu.ops.pallas.tri_scan import tri_scan_pallas
from cs397raytracingsp22_tpu_torch.models import scene as tscene
from cs397raytracingsp22_tpu_torch.ops import bvh as tbvh
from cs397raytracingsp22_tpu_torch.ops import intersect as tisect
from cs397raytracingsp22_tpu_torch.ops.kernels import tri_scan
from cs397raytracingsp22_tpu_torch.scenes import bench_scene as tbench
# sibling test modules by their bare names (pytest puts tests/ on sys.path)
from test_torch_scene import jax_bench_scene

torch.set_num_threads(1)  # several test workers share the cores

T_MIN, T_MAX = 1e-3, 100.0


def random_table(n_tris=2500, n=256, seed=0):
    """tests/test_intersect.py::test_tri_scan_pallas_middle_tier_parity's
    table and rays: (tri_table (T, 9), o, d) numpy float32."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(-2, 2, (n_tris, 3)).astype(np.float32)
    e1 = rng.uniform(-0.4, 0.4, (n_tris, 3)).astype(np.float32)
    e2 = rng.uniform(-0.4, 0.4, (n_tris, 3)).astype(np.float32)
    table = np.concatenate([a, e1, e2], axis=1)
    o = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    return table, o, d


def mesh_rays(n=512, seed=0):
    """Numpy world rays inside the bench box, half aimed at the teapot."""
    rng = np.random.default_rng(seed)
    o = rng.uniform([-2.4, 0.05, -2.4], [2.4, 4.95, 3.0], (n, 3))
    d = rng.standard_normal((n, 3))
    target = rng.uniform([-0.8, 0.5, -1.2], [0.8, 1.6, 0.0], (n // 2, 3))
    d[: n // 2] = target - o[: n // 2]
    return o.astype(np.float32), d.astype(np.float32)


@pytest.fixture(scope="module")
def bench_scenes():
    return jax_bench_scene().compile(), tbench.build(16, 16, spp=4, path_depth=4).compile(
        device="cpu")


def test_plain_matches_jax_tri_scan_pallas():
    table, o, d = random_table()
    hit_j, t_j, id_j, u_j, v_j = tri_scan_pallas(jnp.asarray(o), jnp.asarray(d),
                                                 jnp.asarray(table), T_MIN, T_MAX)
    hit, t, tri, u, v = tri_scan.tri_scan_plain(torch.from_numpy(table), torch.from_numpy(o),
                                                torch.from_numpy(d), T_MIN, T_MAX)
    hit_j = np.asarray(hit_j)
    np.testing.assert_array_equal(hit.numpy(), hit_j)
    np.testing.assert_array_equal(tri.numpy(), np.asarray(id_j))
    assert int(hit_j.sum()) > 50, "rays must hit"
    assert np.isinf(t.numpy()[~hit_j]).all() and np.isinf(np.asarray(t_j)[~hit_j]).all()
    for a, b in ((t, t_j), (u, u_j), (v, v_j)):
        np.testing.assert_allclose(a.numpy()[hit_j], np.asarray(b)[hit_j], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("chunk", [1, 7, 256, 4096])
def test_plain_chunking_and_bounds(chunk):
    """Every chunking gives the same bits, per-ray bounds act per ray, and
    a hit needs t < t_max strictly."""
    table, o, d = (torch.from_numpy(x) for x in random_table(n_tris=600, n=200, seed=3))
    ref = tri_scan.tri_scan_plain(table, o, d, T_MIN, T_MAX)
    out = tri_scan.tri_scan_plain(table, o, d, T_MIN, T_MAX, chunk=chunk)
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    hit, t = ref[0], ref[1]
    t_max = torch.where(hit, t, torch.full_like(t, T_MAX))
    tight = tri_scan.tri_scan_plain(table, o, d, torch.full_like(t, T_MIN), t_max, chunk=chunk)
    assert not bool(tight[0].any()), "t_max = t of the nearest hit must exclude it"
    assert bool((tight[2] == -1).all()) and bool(torch.isinf(tight[1]).all())


@pytest.mark.parametrize("f64", [False, True])
def test_plain_matches_intersect_tris_scan(f64):
    """On a compiled mesh: with float32 positions the tri_table edges equal
    the tri_verts differences bit for bit; with float64 positions they need
    not, and the two scans still agree within the stated tolerance."""
    rng = np.random.default_rng(11)
    pos = rng.uniform(-1, 1, (300, 3)) * 1.37
    pos = pos if f64 else pos.astype(np.float32)
    idx = rng.integers(0, 300, (800, 3)).astype(np.int32)
    verts = pos[idx]
    rv = verts.astype(np.float32)
    table = np.concatenate([verts[:, 0], verts[:, 1] - verts[:, 0], verts[:, 2] - verts[:, 0]],
                           axis=1).astype(np.float32)  # as models/scene.py::_compile_mesh
    exact = np.array_equal(table[:, 3:6], rv[:, 1] - rv[:, 0])
    assert exact != f64
    o, d = (torch.from_numpy(x) for x in mesh_rays(512, seed=2))
    o = o * 0.3
    hit, t, tri, u, v = tri_scan.tri_scan_plain(torch.from_numpy(table), o, d, T_MIN, T_MAX)
    rhit, rt, rtri, ru, rv_ = tbvh.intersect_tris_scan(o, d, torch.from_numpy(rv), T_MIN, T_MAX)
    same = (hit == rhit) & (tri == rtri)
    assert float(same.float().mean()) >= 0.999 and int(hit.sum()) > 50
    both = same & hit
    np.testing.assert_allclose(t[both].numpy(), rt[both].numpy(), rtol=1e-5, atol=1e-5)
    if not f64:
        assert torch.equal(t[both], rt[both])


def test_intersect_mesh_matches_jax(bench_scenes):
    jsd, tsd = bench_scenes
    o, d = mesh_rays(512)
    fj = jax.jit(lambda o_, d_: jisect.intersect_mesh(jsd.meshes[0], jsd, o_, d_, T_MIN, T_MAX))(
        jnp.asarray(o), jnp.asarray(d))
    ft = tisect.intersect_mesh(tsd.meshes[0], tsd, torch.from_numpy(o), torch.from_numpy(d),
                               T_MIN, T_MAX)
    vj, vt = np.asarray(fj["valid"]), ft["valid"].numpy()
    assert (vj == vt).mean() >= 0.999 and vj.sum() > 100, "the teapot must be hit"
    both = vj & vt
    np.testing.assert_allclose(ft["t"].numpy()[both], np.asarray(fj["t"])[both], rtol=1e-5)
    assert np.isinf(ft["t"].numpy()[~vt]).all()
    for f in ("point", "normal"):
        np.testing.assert_allclose(ft[f].numpy()[both], np.asarray(fj[f])[both], rtol=1e-4,
                                   atol=1e-5, err_msg=f)
    np.testing.assert_array_equal(ft["frontface"].numpy()[both], np.asarray(fj["frontface"])[both])


def test_wrapper_runs_the_plain_scan_on_cpu(bench_scenes):
    """tri_scan_cuda on CPU tensors is tri_scan_plain on the mesh's
    tri_table, for scalar and per-ray bounds, and launches nothing."""
    _, tsd = bench_scenes
    mesh = tsd.meshes[0]
    o, d = (torch.from_numpy(x) for x in mesh_rays(256, seed=4))
    o_obj, d_obj = tisect.object_rays(mesh, o, d)
    before = tri_scan.LAUNCHES
    out = tri_scan.tri_scan_cuda(mesh, o_obj, d_obj, T_MIN, T_MAX)
    out_n = tri_scan.tri_scan_cuda(mesh, o_obj, d_obj, torch.full((256,), T_MIN),
                                   torch.full((256,), T_MAX))
    ref = tri_scan.tri_scan_plain(mesh.tri_table, o_obj, d_obj, T_MIN, T_MAX)
    assert tri_scan.LAUNCHES == before
    for a, b, c in zip(out, out_n, ref):
        assert torch.equal(a, c) and torch.equal(b, c)
    assert int(out[0].sum()) > 20


def test_scene_spec_keeps_the_plain_mesh_scan(bench_scenes, monkeypatch):
    """intersect_scene_plain (the spec that K1's and K2's card checks run on
    CUDA tensors) takes intersect_mesh_plain, never intersect_mesh, which
    sends CUDA tensors to K5."""
    _, tsd = bench_scenes

    def refuse(*args, **kwargs):
        raise AssertionError("intersect_scene_plain reached intersect_mesh")

    monkeypatch.setattr(tisect, "intersect_mesh", refuse)
    monkeypatch.setattr(tri_scan, "tri_scan_cuda", refuse)
    o, d = (torch.from_numpy(x) for x in mesh_rays(64, seed=5))
    hit = tisect.intersect_scene_plain(tsd, o, d, T_MIN, T_MAX, torch.full((64, 1), 0.5))
    assert bool(hit.valid.any())


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _same_winner(out, ref):
    """K2's contract for (hit, t, tri, u, v) against the plain version."""
    out = [x.cpu() for x in out]
    ref = [x.cpu() for x in ref]
    same = (out[0] == ref[0]) & (out[2] == ref[2])
    assert float(same.float().mean()) >= 0.999
    for a, b in zip(out[1:], ref[1:]):
        if a.dtype.is_floating_point:
            hit = same & out[0]
            np.testing.assert_allclose(a[hit].numpy(), b[hit].numpy(), rtol=1e-4, atol=1e-5)


def table_mesh(table: np.ndarray) -> tscene.MeshBlock:
    """A MeshBlock holding only tri_table rows (T, 9) and their padded copy,
    what K5 reads; its BVH fields are inert."""
    nt = table.shape[0]
    return tscene.MeshBlock(
        tri_verts=torch.zeros((nt, 3, 3)), tri_table=torch.from_numpy(table),
        tri_normals=torch.zeros((nt, 3, 3)), tri_uvs=torch.zeros((nt, 3, 2)),
        tri_tangent=torch.zeros((nt, 3)), transform=torch.eye(4), inv_transform=torch.eye(4),
        normal_mat=torch.eye(3), bounds_min=torch.zeros((1, 3)), bounds_max=torch.zeros((1, 3)),
        skip=torch.ones((1,), dtype=torch.int32), leaf_start=torch.zeros((1,), dtype=torch.int32),
        leaf_count=torch.zeros((1,), dtype=torch.int32), bvh_nodes=torch.zeros((1, 16)),
        bvh_tri4=torch.zeros((nt, 12)),
        tri_table4=torch.from_numpy(np.concatenate([table, np.zeros((nt, 3), np.float32)], 1)),
        mat_id=0, tex_ids=(-1,) * 5, has_uv=False, leaf_size=4, bvh_depth=0,
    )


def test_padded_rows_equal_tri_table(bench_scenes):
    """K5 reads tri_table4: tri_table's rows and three zeros, bit for bit,
    for the compiled teapot and for the JAX package's tables."""
    from test_torch_scene import port_data_from_jax

    jsd, tsd = bench_scenes
    for mesh in (tsd.meshes[0], port_data_from_jax(jsd).meshes[0]):
        t4 = mesh.tri_table4
        assert t4.shape == (6144, 12) and t4.dtype == torch.float32 and t4.is_contiguous()
        assert torch.equal(t4[:, :9], mesh.tri_table) and not bool(t4[:, 9:].any())
    assert torch.equal(tsd.meshes[0].tri_table4, port_data_from_jax(jsd).meshes[0].tri_table4)


@pytest.mark.gpu
@pytest.mark.parametrize("n_tris, n, min_hits", [(2500, 4096, 500), (2500, 4097, 500),
                                                 (129, 4097, 50)],
                         ids=["2500x4096", "ragged_rays", "ragged_tiles"])
def test_k5_matches_plain_on_card(cuda, n_tris, n, min_hits):
    """K5 against tri_scan_plain, also where the rays fill no whole block
    (rays a thread, threads a block) and the rows no whole tile."""
    table, o, d = random_table(n_tris=n_tris, n=n, seed=6)
    mesh = table_mesh(table).to(cuda)
    o, d = torch.from_numpy(o).to(cuda), torch.from_numpy(d).to(cuda)
    t_max = torch.full((n,), T_MAX, device=cuda)
    t_max[::16] = 0.0  # dead rays
    before = tri_scan.LAUNCHES
    out = tri_scan.tri_scan_cuda(mesh, o, d, T_MIN, t_max)
    torch.cuda.synchronize()
    assert tri_scan.LAUNCHES == before + 1
    ref = tri_scan.tri_scan_plain(mesh.tri_table, o, d, T_MIN, t_max)
    _same_winner(out, ref)
    assert int(out[0].sum()) > min_hits and not bool(out[0][::16].any())
    assert bool(torch.isinf(out[1][~out[0]]).all())


@pytest.mark.gpu
def test_intersect_mesh_launches_k5_on_card(cuda):
    data = tbench.build(16, 16, spp=4, path_depth=4).compile(device=cuda)
    o, d = (torch.from_numpy(x).to(cuda) for x in mesh_rays(2048, seed=7))
    before = tri_scan.LAUNCHES
    f = tisect.intersect_mesh(data.meshes[0], data, o, d, T_MIN, T_MAX)
    torch.cuda.synchronize()
    assert tri_scan.LAUNCHES == before + 1
    ref = tisect.intersect_mesh_plain(data.meshes[0], data, o, d, T_MIN, T_MAX)
    assert float((f["valid"] == ref["valid"]).float().mean()) >= 0.999
    both = f["valid"] & ref["valid"]
    assert int(both.sum()) > 200
    np.testing.assert_allclose(f["t"][both].cpu().numpy(), ref["t"][both].cpu().numpy(),
                               rtol=1e-4, atol=1e-5)
    with pytest.raises(ValueError, match="on"):
        tri_scan.tri_scan_cuda(data.meshes[0], o, d, T_MIN, torch.full((2048,), T_MAX))
    with pytest.raises(ValueError, match="shape"):
        tri_scan.tri_scan_cuda(data.meshes[0], o, d[:8], T_MIN, T_MAX)
