"""Phong shading in the torch port (integrator.phong_trace, the driver's
Phong route) against the JAX package's (tests/test_phong.py).

- phong_trace on the scenes of tests/test_phong.py built in code (a
  sphere, a lit floor, the floor shadowed by a sphere, and the driver's
  sphere on a floor), on camera rays and on the rays of those tests:
  colours within rtol 1e-4 / atol 1e-5 of JAX's on >= 99.9% of rays
  (`** 40` and the normalizations may round apart from XLA's);
- the analytic values of tests/test_phong.py: a miss is the background,
  the lit floor is ambient + albedo/π + 0.4, and the shadow is 0.3x;
- render_to_image under Phong: the port's image within 1 u8 of the JAX
  package's on >= 99% of subpixels, mean |diff| <= 0.05, and lit.
The teapot (config 2) is in tests/test_torch_teapot.py. The `gpu` test
holds phong_trace through K2 on the card to its plain version.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cs397raytracingsp22_tpu as J
import cs397raytracingsp22_tpu_torch as T
from cs397raytracingsp22_tpu.render import integrator as jint
from cs397raytracingsp22_tpu.render.driver import render_to_image as jax_render
from cs397raytracingsp22_tpu_torch.ops.intersect import intersect_scene_plain
from cs397raytracingsp22_tpu_torch.render import driver as tdriver
from cs397raytracingsp22_tpu_torch.render import integrator as tint

torch.set_num_threads(1)  # several test workers share the cores

A = 0.6  # the floor's albedo


def objects(P, name):
    floor = P.Plane(point=(0, 0, 0), normal=(0, 1, 0), material=P.Lambertian(albedo=(A, A, A)))
    return {
        "sphere": [P.Sphere(center=(0, 0, -5), radius=1.0, material=P.Lambertian())],
        "floor": [floor],
        "shadowed_floor": [floor, P.Sphere(center=(0, 5, -1), radius=1.0,
                                           material=P.Lambertian())],
        "driver": [P.Sphere(center=(0, 1, 0), radius=1.0,
                            material=P.Lambertian(albedo=(0.8, 0.2, 0.2))),
                   P.Plane(point=(0, 0, 0), normal=(0, 1, 0), material=P.Lambertian())],
    }[name]


def phong_scene(P, name, width=16, height=16, spp=4):
    return P.Scene(
        camera=P.Camera(eyepoint=(0.0, 1.0, 3.0), screen_width=width, screen_height=height,
                        aa_sample_count=spp, shading_mode=P.ShadingMode.PHONG),
        objects=objects(P, name),
        point_light_pos=(2.0, 5.0, 3.0) if name == "driver" else (0.0, 10.0, -1.0),
        ambient=(0.1, 0.1, 0.1),
    )


def both(name, o, d, eye, key=0):
    """(port colours, JAX colours) of phong_trace on the rays o, d."""
    jsd = phong_scene(J, name).compile()
    tsd = phong_scene(T, name).compile(device="cpu")
    o = np.asarray(o, np.float32).reshape(-1, 3)
    d = np.asarray(d, np.float32).reshape(-1, 3)
    uids = np.arange(o.shape[0], dtype=np.int32)
    ref = jint.phong_trace(jsd, jnp.asarray(o), jnp.asarray(d), jnp.asarray(uids),
                           jnp.asarray([key, 0], jnp.uint32), jnp.asarray(eye, jnp.float32), 100.0)
    got = tint.phong_trace(tsd, *(torch.from_numpy(x.copy()) for x in (o, d, uids)), key, eye,
                           100.0)
    return got.numpy(), np.asarray(ref)


@pytest.mark.parametrize("name", ["sphere", "floor", "shadowed_floor", "driver"])
def test_phong_trace_matches_jax(name):
    jscene = phong_scene(J, name)
    o, d = jscene.camera.generate_rays(5, jnp.arange(256, dtype=jnp.int32), spp=4)
    got, ref = both(name, o, d, jscene.camera.eyepoint, key=5)
    assert got.shape == ref.shape == (1024, 3) and np.isfinite(got).all()
    ok = np.isclose(got, ref, rtol=1e-4, atol=1e-5).all(axis=1)
    assert ok.mean() >= 0.999, f"{(~ok).sum()} of {len(ok)} colours differ"
    if name != "sphere":
        assert (ref.max(axis=1) > 0.1).mean() > 0.3, "most rays must shade something"


def test_phong_analytic_values():
    """tests/test_phong.py's three rays on the port."""
    miss, ref = both("sphere", [[0, 0, 0]], [[0, 1, 0]], (0, 0, 0))
    np.testing.assert_allclose(miss[0], 0.0)
    np.testing.assert_array_equal(miss, ref)
    # straight above a floor point under the light: diffuse weight 1, the
    # attenuation albedo/π, specular (1)^40 = 1 → + 0.4
    clear, ref = both("floor", [[0, 1, -1]], [[0, -1, 0]], (0, 1, -1))
    np.testing.assert_allclose(clear[0], 0.1 + A / np.pi + 0.4, rtol=1e-5)
    np.testing.assert_allclose(clear, ref, rtol=1e-6)
    shadow, ref = both("shadowed_floor", [[0, 1, -1]], [[0, -1, 0]], (0, 1, -1))
    np.testing.assert_allclose(shadow[0], 0.3 * clear[0], rtol=1e-5)
    np.testing.assert_allclose(shadow, ref, rtol=1e-6)


def test_phong_render_matches_jax():
    img, stats = tdriver.render_to_image(phong_scene(T, "driver", 8, 8, 4), device="cpu",
                                         seed=2, verbose=False)
    ref, _ = jax_render(phong_scene(J, "driver", 8, 8, 4), seed=2, verbose=False)
    diff = np.abs(img.astype(int) - np.asarray(ref).astype(int))
    assert (diff <= 1).mean() >= 0.99 and diff.mean() <= 0.05
    assert img.shape == (8, 8, 3) and img.mean() > 5
    assert stats.path_segments == 8 * 8 * 4  # the camera rays


@pytest.mark.gpu
def test_phong_trace_on_card_matches_plain():
    """phong_trace through K2 on the card against its plain version:
    K1's contract (rtol 1e-3 / atol 1e-4 on >= 99.5% of rays), two K2
    launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from cs397raytracingsp22_tpu_torch.ops.kernels import scene_intersect
    from cs397raytracingsp22_tpu_torch.scenes import teapot

    dev = torch.device("cuda")
    scene = teapot.build(64, 64, spp=4)
    data = scene.compile(device=dev)
    cam = scene.camera
    o, d, uids = tdriver._gen_chunk_rays(cam, torch.arange(64 * 64, dtype=torch.int32,
                                                           device=dev), 3, 0, 4, 1)
    before = scene_intersect.LAUNCHES
    got = tint.phong_trace(data, o, d, uids, 3, cam.eyepoint, cam.max_trace_dist)
    torch.cuda.synchronize()
    assert scene_intersect.LAUNCHES - before == 2
    ref = tint.phong_trace(data, o, d, uids, 3, cam.eyepoint, cam.max_trace_dist,
                           intersect=intersect_scene_plain)
    ok = torch.isclose(got, ref, rtol=1e-3, atol=1e-4).all(dim=1)
    assert float(ok.float().mean()) >= 0.995 and float(got.max()) > 0.1
