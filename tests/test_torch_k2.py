"""K2's plain version (ops/kernels/scene_intersect.py::scene_intersect_plain)
against the JAX package's Pallas kernel scene_intersect_pallas, run in
interpret mode on the CPU (which gives it an exact reciprocal), on scenes
built in code with each package's own API from the same description, and
rays made from a numpy seed:

- analytic: spheres, planes, triangles and a sphere-bounded volume with
  its u_vol column;
- one dense mesh (a bumped grid of 288 triangles);
- two dense meshes, one with a material synthesized from its albedo
  texture (material id -1) — a grid of 200 triangles beside the first;
- every scene with dead windows (t_max = 0 < t_min) and shadow-like rays
  (a window ending just short of a point) mixed in.

How the JAX outputs are read. The Pallas kernel scans dense meshes as
Baldwin–Weber rows under a packed min-key: for a mesh winner it reports
(code, local row), and its t, u, v are placeholders. The JAX wrapper
(ops/intersect.py::intersect_scene_fused) re-derives the winner's t, u, v
from its Baldwin–Weber row with an exact division; this test does the
same, in jnp, and compares those. A mesh winner's mat, normal and
frontface are left to the caller by both kernels (the JAX kernel's carry
the analytic candidate's, the port zero), so they are compared on
analytic winners only.

Tolerance: the same (code, idx) on at least 99.9% of rays (Möller–Trumbore
in the port and Baldwin–Weber in JAX round differently, so a ray grazing
an edge can flip); where the winner agrees, t within rtol 1e-5 / atol
1e-6, u and v within atol 1e-4 (the plane equations and MT's cross
products cancel differently), normals within atol 1e-4 (JAX multiplies by
rsqrt, the port divides by sqrt: 1.4e-5 apart on a sphere), mat and
frontface equal; on a miss t is
t_max in both. The launch-shape helpers of the CUDA kernel
(scene_intersect.grid_blocks, the persistent grid, and static_tiles, the
tiles taken by the fixed rule before the ticket) are checked here too:
they run on the host.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cs397raytracingsp22_tpu as jpkg
import cs397raytracingsp22_tpu_torch as tpkg
from cs397raytracingsp22_tpu.ops import intersect as jisect
from cs397raytracingsp22_tpu.ops.pallas.scene_intersect import CODE_MESH0, scene_intersect_pallas
from cs397raytracingsp22_tpu.utils.obj_loader import ObjMesh as JObjMesh
from cs397raytracingsp22_tpu_torch.models import transform as tf
from cs397raytracingsp22_tpu_torch.ops.kernels import scene_intersect
from cs397raytracingsp22_tpu_torch.scenes.kitchen_sink import grid_mesh_arrays
from cs397raytracingsp22_tpu_torch.utils.obj_loader import ObjMesh as TObjMesh

torch.set_num_threads(1)

N_RAYS = 1024
MIN_SAME = 0.999
T_RTOL, T_ATOL = 1e-5, 1e-6
UV_ATOL = 1e-4
N_ATOL = 1e-4

GRID1 = (tf.translate(-0.6, 1.0, -3.0) @ tf.rotate_x(70.0), 12, 0.25)  # 288 triangles
GRID2 = (tf.translate(0.9, 1.4, -2.5) @ tf.rotate_x(80.0) @ tf.scale(0.7), 10, 0.15)  # 200


def _mesh(pkg, obj_cls, spec, textured: bool):
    xf, g, bump = spec
    pos, uv, faces = grid_mesh_arrays(g, bump)
    nrm = np.tile(np.float32([0.0, 1.0, 0.0]), (pos.shape[0], 1))
    m = obj_cls(positions=pos, normals=nrm, texcoords=uv.astype(np.float32),
                indices=faces.astype(np.int32), has_normals=True, has_texcoords=True)
    if textured:
        tex = np.zeros((4, 4, 3), np.uint8)
        tex[::2] = (200, 120, 60)
        tex[1::2] = (60, 120, 200)
        return pkg.StaticMesh(m, [tex, None, None, None, None], None, xf)
    return pkg.StaticMesh(m, [None] * 5, pkg.Lambertian(albedo=(0.7, 0.45, 0.2)), xf)


def build(pkg, obj_cls, kind: str):
    """The scene `kind` in package `pkg` (the JAX package or the port)."""
    objs = [
        pkg.Plane(point=(0.0, 0.0, 0.0), normal=(0.0, 1.0, 0.0),
                  material=pkg.Lambertian(albedo=(0.5, 0.5, 0.5))),
        pkg.Sphere(center=(1.5, 0.8, -4.0), radius=0.8, material=pkg.Metal(albedo=(0.9, 0.9, 0.9),
                                                                           roughness=0.1)),
    ]
    if kind == "analytic":
        objs += [
            pkg.Plane(point=(0.0, 0.0, -7.0), normal=(0.0, 0.0, 1.0),
                      material=pkg.Lambertian(albedo=(0.2, 0.6, 0.2))),
            pkg.Sphere(center=(-1.2, 0.5, -3.0), radius=0.5,
                       material=pkg.Dielectric(idx_of_refraction=1.5)),
            pkg.Triangle(a=(-2.0, 0.2, -5.0), b=(0.0, 2.5, -5.5), c=(2.0, 0.3, -5.0),
                         material=pkg.Lambertian(albedo=(0.8, 0.1, 0.1))),
            pkg.Triangle(a=(-1.0, 2.0, -2.0), b=(1.0, 2.0, -2.0), c=(0.0, 3.0, -2.5),
                         material=pkg.Lambertian(emission=(4.0, 4.0, 4.0))),
            pkg.ConvexVolume(boundary=pkg.Sphere(center=(0.2, 1.0, -3.5), radius=0.9,
                                                 material=pkg.Lambertian()),
                             phase_function=pkg.Isotropic(albedo=(0.9, 0.7, 0.7)), density=0.8),
        ]
    else:
        objs.append(_mesh(pkg, obj_cls, GRID1, textured=False))
        if kind == "two_meshes":
            objs.append(_mesh(pkg, obj_cls, GRID2, textured=True))
    return pkg.Scene(camera=pkg.Camera(), objects=objs)


def rays(n: int, seed: int):
    """(o, d, t_min, t_max, u_vol) numpy rays in front of the camera: half
    aimed at points of the scene's middle, the rest random; every 16th a
    dead window, every 7th a shadow-like window ending at 0.999 of the way
    to its aim point."""
    rng = np.random.default_rng(seed)
    o = rng.uniform([-2.5, 0.1, -1.0], [2.5, 3.5, 1.5], (n, 3))
    aim = rng.uniform([-2.0, 0.0, -5.0], [2.0, 2.5, -2.0], (n, 3))
    d = aim - o
    d[n // 2:] = rng.standard_normal((n - n // 2, 3))
    t_min = np.full((n,), 1e-3)
    t_max = np.full((n,), 100.0)
    t_max[::7] = 0.999  # shadow-like: d runs to the aim point at t = 1
    t_max[::16] = 0.0
    u_vol = rng.random((n, 2))
    return tuple(x.astype(np.float32) for x in (o, d, t_min, t_max, u_vol))


@pytest.fixture(scope="module", params=["analytic", "one_mesh", "two_meshes"])
def case(request):
    kind = request.param
    jsd = build(jpkg, JObjMesh, kind).compile()
    tsd = build(tpkg, TObjMesh, kind).compile(device="cpu")
    return kind, jsd, tsd


def jax_k2(jsd, o, d, t_min, t_max, u_vol):
    """scene_intersect_pallas in interpret mode, with each mesh winner's t,
    u, v re-derived from its Baldwin–Weber row as intersect_scene_fused
    does. Returns numpy (t, code, idx, mat, u, v, normal, ff)."""
    t, code, idx, mat, u, v, normal, ff = scene_intersect_pallas(
        jsd, *(jnp.asarray(x) for x in (o, d, t_min, t_max)),
        jnp.asarray(u_vol[:, :jsd.n_volumes]), block_rows=8, interpret=True)
    oj, dj = jnp.asarray(o), jnp.asarray(d)
    for k, mi in enumerate(jsd.dense_mesh_ids):
        start, _ = jsd.kmesh_ranges[k]
        won = code == CODE_MESH0 + k
        rows = jnp.take(jsd.kmesh_bw, jnp.where(won, start + idx, start), axis=0)
        mo = jisect._transform_point(jsd.meshes[mi].inv_transform, oj)
        md = jisect._transform_vector(jsd.meshes[mi].inv_transform, dj)
        den = rows[:, 0] * md[:, 0] + rows[:, 1] * md[:, 1] + rows[:, 2] * md[:, 2]
        num = rows[:, 3] - (rows[:, 0] * mo[:, 0] + rows[:, 1] * mo[:, 1] + rows[:, 2] * mo[:, 2])
        t_ex = num / jnp.where(den == 0.0, 1.0, den)
        p = mo + t_ex[:, None] * md
        u_ex = rows[:, 4] * p[:, 0] + rows[:, 5] * p[:, 1] + rows[:, 6] * p[:, 2] + rows[:, 7]
        v_ex = rows[:, 8] * p[:, 0] + rows[:, 9] * p[:, 1] + rows[:, 10] * p[:, 2] + rows[:, 11]
        t, u, v = (jnp.where(won, a, b) for a, b in ((t_ex, t), (u_ex, u), (v_ex, v)))
    return tuple(np.asarray(x) for x in (t, code, idx, mat, u, v, normal, ff))


def test_plain_matches_jax_kernel(case):
    kind, jsd, tsd = case
    o, d, t_min, t_max, u_vol = rays(N_RAYS, seed={"analytic": 1, "one_mesh": 2,
                                                    "two_meshes": 3}[kind])
    jt, jcode, jidx, jmat, ju, jv, jn, jff = jax_k2(jsd, o, d, t_min, t_max, u_vol)
    before = scene_intersect.LAUNCHES
    out = scene_intersect.scene_intersect_cuda(tsd, *(torch.from_numpy(x) for x in (
        o, d, t_min, t_max, u_vol)))
    assert scene_intersect.LAUNCHES == before, "CPU tensors run the plain version, no kernel"
    pt, pcode, pidx, pmat, pu, pv, pn, pff = (x.numpy() for x in out)

    # the winners first
    same = (pcode == jcode) & (pidx == jidx)
    assert same.mean() >= MIN_SAME, f"{kind}: {(~same).sum()} of {N_RAYS} winners differ"
    assert (pcode[::16] == -1).all() and (jcode[::16] == -1).all(), "dead rays miss"
    hit = same & (pcode >= 0)
    mesh = hit & (pcode >= CODE_MESH0)
    analytic = hit & (pcode < CODE_MESH0)
    if kind == "analytic":
        for cls in range(4):  # sphere, plane, triangle, volume each win somewhere
            assert (pcode == cls).sum() > 5, f"class {cls} never wins"
    else:
        for k in range(len(tsd.dense_mesh_ids)):
            assert (pcode == CODE_MESH0 + k).sum() > 20, f"dense mesh {k} never wins"
    if kind == "two_meshes":
        assert tsd.meshes[1].mat_id == -1 and (pmat[pcode == CODE_MESH0 + 1] == -1).all()
    assert ((pcode >= 0) & (t_max < 1.0) & (t_max > 0.0)).sum() > 5, "shadow-like rays hit"

    # then t, u, v, normal and frontface where the winners agree
    miss = same & (pcode < 0)
    np.testing.assert_array_equal(pt[miss], t_max[miss])
    np.testing.assert_array_equal(jt[miss], t_max[miss])
    np.testing.assert_allclose(pt[hit], jt[hit], rtol=T_RTOL, atol=T_ATOL, err_msg="t")
    np.testing.assert_allclose(pu[mesh], ju[mesh], rtol=0.0, atol=UV_ATOL, err_msg="u")
    np.testing.assert_allclose(pv[mesh], jv[mesh], rtol=0.0, atol=UV_ATOL, err_msg="v")
    np.testing.assert_array_equal(pu[analytic], 0.0)
    np.testing.assert_array_equal(pv[analytic], 0.0)
    np.testing.assert_allclose(pn[analytic], jn[analytic], rtol=0.0, atol=N_ATOL,
                               err_msg="normal")
    np.testing.assert_array_equal(pff[analytic], jff[analytic].astype(bool))
    np.testing.assert_array_equal(pmat[analytic], jmat[analytic])
    mesh_mat = [tsd.meshes[mi].mat_id for mi in tsd.dense_mesh_ids]
    np.testing.assert_array_equal(pmat[mesh], [mesh_mat[c - CODE_MESH0] for c in pcode[mesh]])
    np.testing.assert_array_equal(pn[mesh], 0.0)
    assert not pff[mesh].any()


@pytest.mark.parametrize("n, per_sm, sms, threads, grid", [
    (1, 8, 132, 128, 1),  # one ray: one block, one tile
    (33, 8, 132, 128, 1),  # two tiles, four warps
    (4096, 8, 132, 128, 32),  # fewer rays than the card's resident threads
    (1_048_576, 8, 132, 128, 1056),  # the NEE chunk: every resident block
    (4_194_304, 6, 132, 256, 792),
    (129, 1, 1, 256, 1),
])
def test_grid_blocks(n, per_sm, sms, threads, grid):
    """The persistent grid: the card's resident blocks, no more than give
    each warp one 32-ray tile, at least one."""
    assert scene_intersect.grid_blocks(n, per_sm, sms, threads) == grid


@pytest.mark.parametrize("n_tiles, n_warps, dense, n_static", [
    (131072, 5280, False, 131072),  # no dense mesh: every tile by the fixed rule, no ticket
    (32768, 4224, True, 12672),  # the NEE chunk: 3 whole rounds, 20,096 tiles from the ticket
    (32768, 20000, True, 20000),  # less than two rounds: the first round alone
    (2, 8, True, 8),  # fewer tiles than warps: no ticket drawn
    (1, 1, True, 1),
])
def test_static_tiles(n_tiles, n_warps, dense, n_static):
    """The tiles warps take by the fixed rule, the rest from the ticket."""
    assert scene_intersect.static_tiles(n_tiles, n_warps, dense) == n_static


def test_grid_blocks_refuses_no_resident_block():
    with pytest.raises(ValueError, match="no block"):
        scene_intersect.grid_blocks(1024, 0, 132, 128)
