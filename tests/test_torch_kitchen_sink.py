"""The kitchen-sink scene (scenes/kitchen_sink.py, the JAX package's
tests/test_kitchen_sink.py::kitchen_sink_scene) in the torch port: every
feature class of the staged path at once — a big textured, normal-mapped
mesh (K3), a dense texture-synthesized mesh (K2's walk), a sphere-boundary
and a triangle-boundary volume, a dielectric sphere, a plane and an
emissive sphere.

Held here: the tables equal the JAX package's, also through
scene_data_from_numpy; intersect_scene_fused on CPU tensors (the plain
versions of K2 and K3, the general-volume merge, the merged resolve) bit
for bit against intersect_scene_plain, as the JAX package asserts for its
own two paths; the image, and the NEE image, within 1 u8 of the JAX
package's on >= 99% of subpixels at 12×12 × 2 spp. The fused path on the
card is held to the plain one in tests/test_torch_staged_kernels.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

from cs397raytracingsp22_tpu.render.driver import render_to_image as jax_render
from cs397raytracingsp22_tpu_torch.ops import intersect as tisect
from cs397raytracingsp22_tpu_torch.ops.kernels import bounce as tbounce
from cs397raytracingsp22_tpu_torch.render import driver as tdriver
from cs397raytracingsp22_tpu_torch.render import integrator as tint
from cs397raytracingsp22_tpu_torch.scenes import kitchen_sink
from test_kitchen_sink import kitchen_sink_scene
from test_torch_scene import assert_scene_data_equal, port_data_from_jax
from test_torch_staged_kernels import bounce_rays

torch.set_num_threads(1)
FIELDS = ("t", "point", "normal", "frontface", "mtype", "albedo", "emission", "roughness",
          "metallic", "ior")


@pytest.fixture(scope="module")
def compiled():
    return kitchen_sink.build().compile(device="cpu"), kitchen_sink_scene().compile()


def test_tables_equal(compiled):
    tsd, jsd = compiled
    assert len(tsd.meshes) == 2 and tsd.dense_mesh_ids == (1,)
    assert tsd.meshes[0].tri_verts.shape[0] == 8450 and tsd.meshes[1].tri_verts.shape[0] == 288
    assert tsd.n_gvols == 1 and tsd.n_volumes == 1 and tsd.nee_ok
    assert [m.mat_id for m in tsd.meshes] == [-1, -1] and tsd.meshes[0].tex_ids[4] >= 0
    assert not tbounce.scene_is_simple(tsd)
    assert_scene_data_equal(tsd, jsd)
    from_jax = port_data_from_jax(jsd)
    assert_scene_data_equal(from_jax, jsd)
    for name in ("kscene", "kmesh_res", "kmesh_xfm", "kmesh_tex", "ksl_tree"):
        assert torch.equal(getattr(from_jax, name), getattr(tsd, name)), name


def test_fused_bit_identical_to_plain(compiled):
    """Bounce-0 and bounce-2 rays: every hit field of every valid ray bit
    for bit, with hits on both meshes and the triangle volume among them."""
    tsd, _ = compiled
    cam = kitchen_sink.build().camera
    codes = set()
    for b, (o, d, t_max, u_vol) in bounce_rays(tsd, cam, (0, 2)).items():
        plain = tisect.intersect_scene_plain(tsd, o, d, tint.PATH_T_MIN, t_max, u_vol)
        fused = tisect.intersect_scene_fused(tsd, o, d, tint.PATH_T_MIN, t_max, u_vol)
        assert torch.equal(plain.valid, fused.valid), b
        m = plain.valid
        for f in FIELDS:
            a, c = getattr(plain, f)[m], getattr(fused, f)[m]
            assert bool(((a == c) | (a != a) & (c != c)).all()), (b, f)
        codes |= {int(x) for x in torch.unique(fused.mtype[m])}
    assert {3, 4}.issubset(codes), codes  # synthesized meshes and isotropic volumes


def test_image_matches_jax():
    img, st = tdriver.render_to_image(kitchen_sink.build(), device="cpu", seed=11,
                                      verbose=False)
    ref, _ = jax_render(kitchen_sink_scene(), seed=11, verbose=False)
    diff = np.abs(img.astype(int) - ref.astype(int))
    assert (diff <= 1).mean() >= 0.99, (diff <= 1).mean()
    assert img.max() > 0 and st.chunks == 1


def test_nee_image_matches_jax():
    """The scene's only emitter is a sphere, so NEE applies; the NEE
    executor's image against the JAX package's NEE render."""
    sc = kitchen_sink.build()
    sc = dataclasses.replace(sc, camera=dataclasses.replace(sc.camera, nee=True))
    img, _ = tdriver.render_to_image(sc, device="cpu", seed=5, verbose=False)
    js = kitchen_sink_scene()
    js = dataclasses.replace(js, camera=dataclasses.replace(js.camera, nee=True))
    ref, _ = jax_render(js, seed=5, verbose=False)
    diff = np.abs(img.astype(int) - ref.astype(int))
    assert (diff <= 1).mean() >= 0.99, (diff <= 1).mean()
