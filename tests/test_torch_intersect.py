"""Scene intersection of the torch port (intersect_scene_plain) against
the JAX package's intersect_scene_jnp on the bench scene with teapot_6k.

Both sides must pick the same winner class and primitive index on at
least 99.9% of rays: a ray that grazes a triangle edge can flip with the
float order of a sum. Where they agree, t is within rtol 1e-5 and the
resolved hit (point, normal, material) matches.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cs397raytracingsp22_tpu.ops import bvh as jbvh
from cs397raytracingsp22_tpu.ops import intersect as jint
from cs397raytracingsp22_tpu.utils import vecmath as jvm
from cs397raytracingsp22_tpu_torch.ops import bvh as tbvh
from cs397raytracingsp22_tpu_torch.ops import intersect as tint
from cs397raytracingsp22_tpu_torch.scenes import bench_scene as tbench
from cs397raytracingsp22_tpu_torch.utils import vecmath as tvm
from tests.test_torch_scene import jax_bench_scene

T_MIN, T_MAX = 0.001, 100.0
torch.set_num_threads(1)  # several test workers share the cores


def _rays(seed=0):
    """256 camera rays and 256 rays from inside the box, numpy."""
    scene = jax_bench_scene(16, 8, spp=2)
    o_c, d_c = scene.camera.generate_rays(seed, jnp.arange(128, dtype=jnp.int32), spp=2)
    rng = np.random.default_rng(seed)
    o_r = rng.uniform([-2.4, 0.05, -2.4], [2.4, 4.95, 3.0], (256, 3))
    d_r = rng.standard_normal((256, 3))
    # half of them aimed at the teapot (centred near (0, 0.75, -0.6))
    target = rng.uniform([-0.8, 0.5, -1.2], [0.8, 1.6, 0.0], (128, 3))
    d_r[:128] = target - o_r[:128]
    o = np.concatenate([np.asarray(o_c).reshape(-1, 3), o_r]).astype(np.float32)
    d = np.concatenate([np.asarray(d_c).reshape(-1, 3), d_r]).astype(np.float32)
    u_vol = rng.random((512, 1)).astype(np.float32)
    return o, d, u_vol


def _class_hits(lib, bvhlib, vm, scene, o, d, u_vol):
    """Per-class nearest (t, valid, index): the four analytic classes, then
    each mesh's object-space scan."""
    per = [
        lib.intersect_spheres(scene, o, d, T_MIN, T_MAX),
        lib.intersect_planes(scene, o, d, T_MIN, T_MAX),
        lib.intersect_triangles(scene, o, d, T_MIN, T_MAX),
        lib.intersect_volumes(scene, o, d, T_MIN, T_MAX, u_vol),
    ]
    for m in scene.meshes:
        o_obj = vm.apply_mat4_point(m.inv_transform, o)
        d_obj = vm.apply_mat4_vector(m.inv_transform, d)
        hit, t, tri, _, _ = bvhlib.intersect_tris_scan(o_obj, d_obj, m.tri_verts, T_MIN, T_MAX)
        per.append((t, tri, hit))
    return [p[0] for p in per], [p[2] for p in per], [p[1] for p in per]


def _winners(ts, valid, idx):
    """(class, index, t) of the nearest hit, from the per-class results."""
    ts = np.stack([np.where(np.asarray(v), np.asarray(t), np.inf) for t, v in zip(ts, valid)], 1)
    cls = np.argmin(ts, 1)
    rows = np.arange(len(cls))
    cls = np.where(np.isfinite(ts[rows, cls]), cls, -1)
    index = np.stack([np.asarray(i) for i in idx], 1)[rows, np.maximum(cls, 0)]
    return cls, np.where(cls >= 0, index, -1), ts[rows, np.maximum(cls, 0)]


@pytest.fixture(scope="module")
def scenes():
    return (jax_bench_scene().compile(),
            tbench.build(16, 16, spp=4, path_depth=4).compile(device="cpu"))


def test_winners_match_jnp(scenes):
    jsd, tsd = scenes
    o, d, u_vol = _rays()
    jax_hits = jax.jit(functools.partial(_class_hits, jint, jbvh, jvm))
    cj, ij, tj = _winners(*jax_hits(jsd, jnp.asarray(o), jnp.asarray(d), jnp.asarray(u_vol)))
    ct, it, tt = _winners(*_class_hits(
        tint, tbvh, tvm, tsd, torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(u_vol)
    ))
    same = (cj == ct) & (ij == it)
    assert same.mean() >= 0.999, f"{(~same).sum()} winner flips"
    assert (cj == 4).sum() > 40, "the teapot must take part"
    hit = same & (cj >= 0)
    np.testing.assert_allclose(tt[hit], tj[hit], rtol=1e-5)


def test_hit_records_match_jnp(scenes):
    jsd, tsd = scenes
    o, d, u_vol = _rays(seed=3)
    hj = jax.jit(jint.intersect_scene_jnp, static_argnums=(3, 4))(
        jsd, jnp.asarray(o), jnp.asarray(d), T_MIN, T_MAX, jnp.asarray(u_vol))
    ht = tint.intersect_scene_plain(tsd, torch.from_numpy(o), torch.from_numpy(d), T_MIN, T_MAX,
                                    torch.from_numpy(u_vol))
    vj, vt = np.asarray(hj.valid), ht.valid.numpy()
    tj, tt = np.asarray(hj.t), ht.t.numpy()
    agree = (vj == vt) & (np.isclose(tt, tj, rtol=1e-5) | (~vj & ~vt))
    assert agree.mean() >= 0.999
    both = agree & vj
    for f in ("point", "normal"):
        np.testing.assert_allclose(getattr(ht, f).numpy()[both], np.asarray(getattr(hj, f))[both],
                                   rtol=1e-4, atol=1e-5, err_msg=f)
    for f in ("frontface", "mtype", "albedo", "emission", "roughness", "metallic", "ior"):
        np.testing.assert_array_equal(getattr(ht, f).numpy()[both],
                                      np.asarray(getattr(hj, f))[both], err_msg=f)


def test_moller_trumbore_matches_jnp():
    rng = np.random.default_rng(7)
    o = rng.standard_normal((256, 1, 3)).astype(np.float32)
    d = rng.standard_normal((256, 1, 3)).astype(np.float32)
    v = rng.standard_normal((3, 1, 64, 3)).astype(np.float32)
    rj = jbvh.moller_trumbore(*[jnp.asarray(x) for x in (o, d, v[0], v[1], v[2])], -10.0, 10.0)
    rt = tbvh.moller_trumbore(*[torch.from_numpy(x) for x in (o, d, v[0], v[1], v[2])], -10.0, 10.0)
    vj, vt = np.asarray(rj[0]), rt[0].numpy()
    assert (vj == vt).mean() >= 0.999
    assert vj.sum() > 100
    both = vj & vt
    for a, b in zip(rj[1:], rt[1:]):
        np.testing.assert_allclose(b.numpy()[both], np.asarray(a)[both], rtol=1e-5, atol=1e-6)
