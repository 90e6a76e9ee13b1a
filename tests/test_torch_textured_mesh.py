"""Textured meshes in the torch port against the JAX package: the mesh
compile (texcoords, per-triangle tangents with the reference's non-finite
values where the uv determinant is 0, texture bindings, the atlas), the
per-mesh shading resolve (ops/intersect.py::resolve_mesh_hit: texture
sampling, the TBN normal map, the PARAMETERIZED material synthesized from
textures) and the merged resolve of the staged path
(resolve_mesh_winners, the JAX package's _resolve_mesh_winners_merged),
the plain scene intersection against intersect_scene_jnp, the -1 material
id of a texture-synthesized mesh, and the routing away from K1.

The meshes are built in code as tests/test_mesh.py::make_mesh builds
them; the JAX side runs its jnp spec on the CPU. Tolerance of the
resolves: rtol 1e-5, atol 1e-6 (vecmath's cross is jnp.cross in the JAX
package, written out in the port); the intersection: the same winner on
>= 99.9% of rays.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cs397raytracingsp22_tpu import Camera as JCamera
from cs397raytracingsp22_tpu import Lambertian as JLambertian
from cs397raytracingsp22_tpu import Metal as JMetal
from cs397raytracingsp22_tpu import Scene as JScene
from cs397raytracingsp22_tpu import Sphere as JSphere
from cs397raytracingsp22_tpu.ops import intersect as jisect
from cs397raytracingsp22_tpu_torch import Camera, Lambertian, Metal, Scene, Sphere, StaticMesh
from cs397raytracingsp22_tpu_torch.models import materials as tmat
from cs397raytracingsp22_tpu_torch.models.scene import resolve_order
from cs397raytracingsp22_tpu_torch.ops import intersect as tisect
from cs397raytracingsp22_tpu_torch.ops.kernels import bounce as tbounce
from cs397raytracingsp22_tpu_torch.ops.kernels import scene_intersect as tk2
from cs397raytracingsp22_tpu_torch.render import driver as tdriver
from cs397raytracingsp22_tpu_torch.render import integrator as tint
from cs397raytracingsp22_tpu_torch.scenes.kitchen_sink import grid_mesh_arrays
from cs397raytracingsp22_tpu_torch.utils.obj_loader import ObjMesh
from test_mesh import make_mesh as jax_make_mesh
from test_torch_scene import assert_scene_data_equal

torch.set_num_threads(1)
RTOL, ATOL = 1e-5, 1e-6
FIELDS = ("point", "normal", "frontface", "mtype", "albedo", "emission", "roughness",
          "metallic", "ior")


def port_make_mesh(positions, indices, normals, texcoords, material, textures, transform):
    """tests/test_mesh.py::make_mesh for the port."""
    m = ObjMesh(positions=np.asarray(positions, np.float32),
                normals=np.asarray(normals, np.float32),
                texcoords=np.asarray(texcoords, np.float32),
                indices=np.asarray(indices, np.int32), has_normals=True, has_texcoords=True)
    return StaticMesh(m, list(textures), material, transform)


def _img(rng, h, w):
    return rng.integers(0, 256, (h, w, 3)).astype(np.uint8)


def mesh_specs():
    """Four meshes as (positions, faces, normals, uvs, material kind,
    textures, transform): a texture-synthesized, normal-mapped bumpy grid
    with every slot bound; a normal-mapped grid with an explicit material;
    a texture-synthesized grid with only an albedo map; a strip whose uvs
    make zero uv determinants (NaN and inf tangents)."""
    from cs397raytracingsp22_tpu_torch.models import transform as tf

    rng = np.random.default_rng(11)
    specs = []
    for g, bump, kind, slots, xf in (
        (10, 0.3, None, (0, 1, 2, 3, 4), tf.translate(0.0, 0.0, -3.0) @ tf.rotate_x(70.0)),
        (8, 0.2, "lambertian", (4,), tf.translate(-1.5, 0.5, -4.0) @ tf.rotate_x(60.0)),
        (6, 0.1, None, (0,), tf.translate(1.5, 0.3, -3.5) @ tf.rotate_x(75.0) @ tf.scale(0.7)),
    ):
        pos, uv, faces = grid_mesh_arrays(g, bump)
        nrm = pos + rng.normal(0.0, 0.3, pos.shape).astype(np.float32)
        nrm[:, 1] += 1.0
        tex = [None] * 5
        for s in slots:
            tex[s] = _img(rng, int(rng.integers(2, 9)), int(rng.integers(2, 9)))
        specs.append((pos, faces, nrm, uv, kind, tuple(tex), xf))
    pos = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0], [2, 0, 0], [2, 1, 0]], np.float32)
    uv = np.array([[0, 0], [0, 0], [0, 0], [0.5, 0.5], [1, 1], [0.25, 0.25]], np.float32)
    faces = np.array([[0, 1, 2], [1, 3, 2], [1, 4, 3], [4, 5, 3]], np.int32)
    nrm = np.tile([[0.0, 0.0, 1.0]], (6, 1)).astype(np.float32)
    tex = (_img(rng, 4, 4), None, None, None, _img(rng, 3, 5))
    specs.append((pos, faces, nrm, uv, None, tex, tf.translate(-0.5, -0.5, -2.5)))
    return specs


def scenes(extra_last_material: bool = False):
    """(port Scene, JAX Scene) holding the meshes of mesh_specs, and a
    metal sphere whose material is the table's last row when asked."""
    tobjs, jobjs = [], []
    for pos, faces, nrm, uv, kind, tex, xf in mesh_specs():
        tobjs.append(port_make_mesh(pos, faces, nrm, uv, Lambertian(albedo=(0.3, 0.6, 0.2))
                                    if kind else None, tex, xf))
        jobjs.append(jax_make_mesh(pos, faces, normals=nrm, texcoords=uv,
                                   material=JLambertian(albedo=(0.3, 0.6, 0.2)) if kind else None,
                                   textures=tex, transform=xf))
    if extra_last_material:
        tobjs.append(Sphere(center=(0.0, 3.0, -6.0), radius=0.5,
                            material=Metal(albedo=(0.9, 0.1, 0.1), roughness=0.3)))
        jobjs.append(JSphere(center=(0.0, 3.0, -6.0), radius=0.5,
                             material=JMetal(albedo=(0.9, 0.1, 0.1), roughness=0.3)))
    return Scene(camera=Camera(), objects=tobjs), JScene(camera=JCamera(), objects=jobjs)


@pytest.fixture(scope="module")
def compiled():
    tsc, jsc = scenes()
    return tsc.compile(device="cpu"), jsc.compile()


def test_textured_mesh_tables_equal(compiled):
    """Every table bit for bit, NaN and inf tangents in the same places."""
    tsd, jsd = compiled
    assert_scene_data_equal(tsd, jsd)
    assert [m.mat_id < 0 for m in tsd.meshes] == [True, False, True, True]
    assert min(tsd.meshes[0].tex_ids) >= 0 and tsd.meshes[1].tex_ids[:4] == (-1,) * 4
    assert tsd.meshes[1].tex_ids[4] >= 0
    tan = tsd.meshes[3].tri_tangent
    assert bool(torch.isnan(tan).any()) and bool(torch.isinf(tan).any())
    assert bool(torch.isfinite(tsd.meshes[0].tri_tangent).all())


def aimed_rays(n, seed=0):
    """World rays from near the camera toward the meshes' region."""
    rng = np.random.default_rng(seed)
    o = rng.uniform([-0.5, -0.5, 0.5], [0.5, 0.5, 1.5], (n, 3))
    target = rng.uniform([-2.5, -1.0, -4.5], [2.5, 1.5, -2.0], (n, 3))
    return o.astype(np.float32), (target - o).astype(np.float32)


def _close(got: dict, ref: dict, mask=None, what="", rtol=RTOL, atol=ATOL):
    """Every field within rtol / atol (NaN where the other has NaN: a
    normal map over a tangent of a zero uv determinant), the integer and
    bool fields equal."""
    for f in FIELDS:
        a, b = np.asarray(got[f]), np.asarray(ref[f])
        if mask is not None:
            a, b = a[mask], b[mask]
        if a.dtype.kind == "f":
            np.testing.assert_allclose(a, b, rtol=rtol, atol=atol, err_msg=f"{what} {f}")
        else:
            np.testing.assert_array_equal(a, b, err_msg=f"{what} {f}")


def test_resolve_mesh_hit_matches_jax(compiled):
    """Each mesh's hits (JAX's scan on its object-space rays) resolved by
    both packages from the same (t, tri, u, v)."""
    from cs397raytracingsp22_tpu.ops import bvh as jbvh

    tsd, jsd = compiled
    o, d = aimed_rays(2048)
    for k, (tm, jm) in enumerate(zip(tsd.meshes, jsd.meshes)):
        oo, do = (np.asarray(x) for x in (jisect._transform_point(jm.inv_transform, jnp.asarray(o)),
                                          jisect._transform_vector(jm.inv_transform,
                                                                   jnp.asarray(d))))
        hit, t, tri, u, v = (np.asarray(x) for x in jbvh.intersect_tris_scan(
            jnp.asarray(oo), jnp.asarray(do), jm.tri_verts, 0.001, 100.0))
        assert hit.sum() > 50, f"mesh {k}: {hit.sum()} hits"
        ref = jisect.resolve_mesh_hit(jm, jsd, *(jnp.asarray(x) for x in (oo, do, t, tri, u, v)))
        got = tisect.resolve_mesh_hit(tm, tsd, *(torch.from_numpy(np.array(x))
                                                 for x in (oo, do, t, tri, u, v)))
        _close({f: x.numpy() for f, x in got.items()}, ref, hit, f"mesh {k}")


def winner_inputs(tsd, n, seed=0):
    """Random mesh winners: code 4 + k (or an analytic code), a triangle,
    barycentrics inside it, t, and every mesh's object-space rays."""
    rng = np.random.default_rng(seed)
    order = resolve_order(tsd.dense_mesh_ids, len(tsd.meshes))
    code = rng.integers(-1, 4 + len(order), n).astype(np.int32)
    nt = np.array([tsd.meshes[mi].tri_verts.shape[0] for mi in order])
    idx = (rng.random(n) * nt[np.clip(code - 4, 0, len(order) - 1)]).astype(np.int32)
    u = rng.random(n).astype(np.float32)
    v = (rng.random(n) * (1.0 - u)).astype(np.float32)
    t = rng.uniform(0.5, 5.0, n).astype(np.float32)
    o, d = aimed_rays(n, seed + 1)
    return order, code, idx, u, v, t, o, d


def test_merged_resolve_matches_jax_and_per_mesh(compiled):
    """resolve_mesh_winners against the JAX package's merged resolve, and
    bit for bit against the port's per-mesh resolve_mesh_hit."""
    tsd, jsd = compiled
    n = 4096
    order, code, idx, u, v, t, o, d = winner_inputs(tsd, n)
    mat = np.random.default_rng(2).integers(0, tsd.mat_type.shape[0], n).astype(np.int32)
    base = dict(point=np.zeros((n, 3), np.float32), normal=np.ones((n, 3), np.float32),
                frontface=np.zeros(n, bool))
    t_rays = {mi: tisect.object_rays(tsd.meshes[mi], torch.from_numpy(o), torch.from_numpy(d))
              for mi in order}
    got = tisect.resolve_mesh_winners(tsd, t_rays, *(torch.from_numpy(x) for x in (code, t, idx,
                                                                                   u, v)),
                                      {**{k: torch.from_numpy(x) for k, x in base.items()},
                                       "mat": torch.from_numpy(mat)})
    j_rays = {mi: tuple(jnp.asarray(x.numpy()) for x in t_rays[mi]) for mi in order}
    j_base = {**{k: jnp.asarray(x) for k, x in base.items()},
              **jisect._gather_material(jsd, jnp.asarray(mat))}
    ref = jisect._resolve_mesh_winners_merged(
        jsd, order, j_rays, *(jnp.asarray(x) for x in (code, t, idx, u, v)), j_base)
    _close({f: x.numpy() for f, x in got.items()}, ref, what="merged")
    for j, mi in enumerate(order):
        mask = torch.from_numpy(code == 4 + j)
        tri = torch.clamp(torch.from_numpy(idx), 0, tsd.meshes[mi].tri_verts.shape[0] - 1)
        per = tisect.resolve_mesh_hit(tsd.meshes[mi], tsd, *t_rays[mi], torch.from_numpy(t), tri,
                                      torch.from_numpy(u), torch.from_numpy(v))
        for f in FIELDS:
            assert same_bits(got[f][mask], per[f][mask]), (mi, f)
    other = torch.from_numpy((code < 4) | (code >= 4 + len(order)))
    kept = {**{k: torch.from_numpy(x) for k, x in base.items()},
            **tisect._gather_material(tsd, torch.from_numpy(mat))}
    for f in FIELDS:  # non-mesh winners keep their fields, their material by id
        assert same_bits(got[f][other], kept[f][other]), f


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal values, NaN where the other has NaN."""
    return a.shape == b.shape and bool(((a == b) | (a != a) & (b != b)).all())


def test_intersect_scene_plain_matches_jnp(compiled):
    """The same winner (valid, t within rtol 1e-4 / atol 1e-5) on >= 99.9%
    of rays, and the hit fields there within K2's tolerance, rtol 1e-4 /
    atol 1e-5: JAX's jitted scan rounds t, u, v an ulp apart, which moves a
    mapped normal by ~1e-6."""
    tsd, jsd = compiled
    o, d = aimed_rays(4096, seed=3)
    u_vol = np.random.default_rng(4).random((o.shape[0], 1)).astype(np.float32)
    got = tisect.intersect_scene_plain(tsd, *(torch.from_numpy(x) for x in (o, d)), 0.001, 100.0,
                                       torch.from_numpy(u_vol))
    ref = jisect.intersect_scene_jnp(jsd, jnp.asarray(o), jnp.asarray(d), 0.001, 100.0,
                                     jnp.asarray(u_vol))
    rt, jt = got.t.numpy(), np.asarray(ref.t)
    same = (got.valid.numpy() == np.asarray(ref.valid)) & np.isclose(rt, jt, rtol=1e-4, atol=1e-5)
    assert same.mean() >= 0.999, (~same).sum()
    assert got.valid.numpy().mean() > 0.3
    mask = same & got.valid.numpy()
    _close({f: getattr(got, f).numpy() for f in FIELDS}, {f: getattr(ref, f) for f in FIELDS},
           mask, "scene", rtol=1e-4, atol=1e-5)


def test_synthesized_material_id_never_wraps(monkeypatch):
    """K2 (and its plain version) writes a texture-synthesized mesh's
    material id, -1, for its winners. The fused path clips it and resolves
    the mesh: no -1 reaches _gather_material (torch would wrap it to the
    table's last row, here a metal sphere's), and the winners get the
    synthesized PARAMETERIZED material, as the plain spec does."""
    tsc, _ = scenes(extra_last_material=True)
    tsd = tsc.compile(device="cpu")
    assert int(tsd.mat_type[-1]) == tmat.METAL
    o, d = (torch.from_numpy(x) for x in aimed_rays(2048, seed=5))
    u_vol = torch.full((o.shape[0], 1), 0.5)
    k2 = tk2.scene_intersect_plain(tsd, o, d, 0.001, 100.0, u_vol)
    synth_dense = [4 + k for k, mi in enumerate(tsd.dense_mesh_ids) if tsd.meshes[mi].mat_id < 0]
    hits = torch.isin(k2[1], torch.tensor(synth_dense, dtype=torch.int32))
    assert int(hits.sum()) > 50 and bool((k2[3][hits] == -1).all())

    seen = []
    gather = tisect._gather_material

    def checked(scene, mid):
        seen.append(int(mid.min()) if mid.numel() else 0)
        return gather(scene, mid)

    monkeypatch.setattr(tisect, "_gather_material", checked)
    fused = tisect.intersect_scene_fused(tsd, o, d, 0.001, 100.0, u_vol)
    assert seen and min(seen) >= 0
    assert bool((fused.mtype[hits] == tmat.PARAMETERIZED).all())
    assert bool((fused.ior[hits] == 1.5).all())
    monkeypatch.setattr(tisect, "_gather_material", gather)
    plain = tisect.intersect_scene_plain(tsd, o, d, 0.001, 100.0, u_vol)
    m = plain.valid
    for f in FIELDS:
        assert same_bits(getattr(fused, f)[m], getattr(plain, f)[m]), f


def test_scene_is_simple_refuses_normal_maps_and_synthesized_materials(compiled):
    """K1 reads neither textures nor normal maps (JAX bounce.py:285): a
    normal-mapped mesh with an explicit material, or a material synthesized
    from textures, keeps the scene off it; an explicit material with an
    albedo map alone (the map unused) does not."""
    from cs397raytracingsp22_tpu.ops.pallas.bounce import scene_is_simple as jax_simple

    tsd, jsd = compiled
    assert not tbounce.scene_is_simple(tsd) and not jax_simple(jsd)
    specs = mesh_specs()
    for keep, expect in ((1, False), (2, False)):
        pos, faces, nrm, uv, kind, tex, xf = specs[keep]
        mesh = port_make_mesh(pos, faces, nrm, uv, Lambertian() if kind else None, tex, xf)
        sd = Scene(camera=Camera(), objects=[mesh]).compile(device="cpu")
        assert tbounce.scene_is_simple(sd) is expect, keep
    pos, faces, nrm, uv, _, _, xf = specs[1]
    albedo_only = port_make_mesh(pos, faces, nrm, uv, Lambertian(), (_img(np.random.default_rng(0),
                                                                          2, 2),) + (None,) * 4,
                                 xf)
    sd = Scene(camera=Camera(), objects=[albedo_only]).compile(device="cpu")
    assert tbounce.scene_is_simple(sd)


def test_render_chunk_takes_the_staged_path(monkeypatch):
    """render_chunk sends a normal-mapped scene to the staged executor,
    never to K1 (which would ignore the map and exit cleanly)."""
    pos, faces, nrm, uv, _, tex, xf = mesh_specs()[1]
    mesh = port_make_mesh(pos, faces, nrm, uv, Lambertian(), tex, xf)
    light = Sphere(center=(0.0, 4.0, -3.0), radius=1.0,
                   material=Lambertian(albedo=(0, 0, 0), emission=(5.0, 5.0, 5.0)))
    cam = dataclasses.replace(Camera(), screen_width=4, screen_height=4, aa_sample_count=2,
                              path_depth=3)
    sd = Scene(camera=cam, objects=[mesh, light]).compile(device="cpu")

    def refuse(*a, **k):
        raise AssertionError("a normal-mapped scene reached K1")

    calls = []
    shrink = tint.path_trace_shrink
    monkeypatch.setattr(tbounce, "path_trace_cuda", refuse)
    monkeypatch.setattr(tint, "path_trace_shrink",
                        lambda *a, **k: calls.append(1) or shrink(*a, **k))
    rad, segs = tdriver.render_chunk(sd, cam, torch.arange(16, dtype=torch.int32), 0, 0, 2)
    assert calls and rad.shape == (16, 3) and int(segs) >= 32


def test_render_counts_nonfinite_pixels(monkeypatch):
    """A normal map over the strip whose uv determinants are 0 gives its
    hits the reference's NaN normals; a NaN normal counts as no normal
    (the volume's dot term of 1) and its NaN scatter direction misses, so
    the image stays finite: RenderStats.nonfinite_pixels is 0. A chunk
    whose sums hold NaN or inf is counted, pixel by pixel."""
    pos, faces, nrm, uv, _, tex, xf = mesh_specs()[3]
    light = Sphere(center=(0.0, 0.0, 2.0), radius=0.5,
                   material=Lambertian(albedo=(0, 0, 0), emission=(5.0, 5.0, 5.0)))
    cam = dataclasses.replace(Camera(), screen_width=8, screen_height=8, aa_sample_count=2,
                              path_depth=3)
    scene = Scene(camera=cam, objects=[port_make_mesh(pos, faces, nrm, uv, None, tex, xf), light])
    sd = scene.compile(device="cpu")
    o, d, _ = tdriver._gen_chunk_rays(cam, torch.arange(64, dtype=torch.int32), 0, 0, 2, 1)
    hit = tisect.intersect_scene_plain(sd, o, d, 0.001, 100.0, torch.zeros((128, 1)))
    assert int(hit.valid.sum()) > 0 and bool(torch.isnan(hit.normal[hit.valid]).all())
    _, st = tdriver.render_to_image(scene, device="cpu", verbose=False, scene_data=sd)
    assert st.nonfinite_pixels == 0
    chunk = tdriver.render_chunk

    def poisoned(*a, **k):
        rad, segs = chunk(*a, **k)
        rad[:3, 1] = float("nan")
        rad[3, 0] = float("inf")
        return rad, segs

    monkeypatch.setattr(tdriver, "render_chunk", poisoned)
    _, st = tdriver.render_to_image(scene, device="cpu", verbose=False, scene_data=sd,
                                    pixel_chunk=16)
    assert st.nonfinite_pixels == 4 * 4  # four pixels in each of four chunks
