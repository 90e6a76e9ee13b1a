"""The port's open teapot scene (scenes/teapot.py in the port) against the
JAX package's scenes/teapot.py under the path tracer.

- the compiled tables: equal to the JAX scene's, exactly;
- integrator.path_trace on 2,304 camera rays at depth 6: the same segment
  total as the JAX integrator.path_trace, and the same live count entering
  each bounce as the JAX bounce body run one bounce at a time (exact: the
  image is black, so no tolerance on radiance can hide a flip);
- the frame is open: fewer than 10% of the rays live into bounce 2 (what
  the wavefront kernel's compaction is measured on);
- a missing mesh raises;
- under Phong shading (the scene's own mode, BASELINE config 2), the
  port's render_to_image at 16x16 x 2 spp within 1 u8 of the JAX package's
  render of scenes/teapot.py on >= 99% of subpixels, mean |diff| <= 0.05,
  and lit. (The committed golden teapot_phong_16.png was rendered from a
  240-triangle mesh outside the repository, so it is not used here.)
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cs397raytracingsp22_tpu import ShadingMode as JShading
from cs397raytracingsp22_tpu.render import integrator as jint
from cs397raytracingsp22_tpu.utils import rng as jrng
from cs397raytracingsp22_tpu.utils import threefry as jtf
from cs397raytracingsp22_tpu_torch import ShadingMode
from cs397raytracingsp22_tpu_torch.ops.kernels import wavefront
from cs397raytracingsp22_tpu_torch.render import driver as tdriver
from cs397raytracingsp22_tpu_torch.render import integrator as tint
from cs397raytracingsp22_tpu_torch.scenes import teapot as tteapot
from scenes import teapot as jteapot
# sibling test modules by their bare names (pytest puts tests/ on sys.path)
from test_torch_scene import assert_scene_data_equal

torch.set_num_threads(1)  # several test workers share the cores

SIDE, DEPTH = 48, 6


@pytest.fixture(scope="module")
def pair():
    jscene = jteapot.build(SIDE, SIDE, spp=1, shading=JShading.PATH_TRACE)
    tscene = tteapot.build(SIDE, SIDE, spp=1, shading=ShadingMode.PATH_TRACE)
    return jscene, jscene.compile(), tscene, tscene.compile(device="cpu")


def test_teapot_tables_equal_jax(pair):
    _, jsd, tscene, tsd = pair
    assert tsd.dense_mesh_ids == (0,) and tsd.n_planes == 1
    assert tscene.camera.path_depth == DEPTH
    assert_scene_data_equal(tsd, jsd)


def test_teapot_path_trace_matches_jax(pair):
    jscene, jsd, tscene, tsd = pair
    key = 3
    o, d = jscene.camera.generate_rays(key, jnp.arange(SIDE * SIDE, dtype=jnp.int32), spp=1)
    o, d = np.array(o).reshape(-1, 3), np.array(d).reshape(-1, 3)
    n = o.shape[0]
    uids = np.arange(n, dtype=np.int32)
    max_dist = jscene.camera.max_trace_dist
    words = jtf.key_words(key)
    ref_rad, ref_segs = jax.jit(jint.path_trace, static_argnums=(5, 6))(
        jsd, jnp.asarray(o), jnp.asarray(d), jnp.asarray(uids), words, DEPTH, max_dist)
    # the JAX live counts entering each bounce: its bounce body, one at a time
    step = jax.jit(jint._bounce_update, static_argnums=(9,))
    state = (jnp.asarray(o), jnp.asarray(d), jnp.ones((n, 3), jnp.float32),
             jnp.zeros((n, 3), jnp.float32), jnp.ones((n,), bool))
    ref_live = []
    for b in range(DEPTH):
        ref_live.append(int(state[4].sum()))
        out = step(jsd, *state, jnp.asarray(uids), words, jrng.SITE_BOUNCE0 + b, max_dist)
        state = out[:5]
    to = [torch.from_numpy(x) for x in (o, d, uids)]
    rad, segs = tint.path_trace(tsd, *to, key, DEPTH, max_dist)
    st = {}
    wavefront.path_trace_wavefront_plain(tsd, *to, key, DEPTH, max_dist, stats=st)
    assert int(segs) == int(ref_segs) == sum(ref_live)
    assert st["live"].tolist() == ref_live
    assert float(np.asarray(ref_rad).max()) == 0.0 and float(rad.max()) == 0.0, "a black image"
    assert ref_live[0] == n and ref_live[2] < 0.1 * n, f"live entering bounce 2: {ref_live}"


def test_teapot_refuses_a_missing_mesh(tmp_path):
    with pytest.raises(FileNotFoundError):
        tteapot.build(8, 8, spp=1, obj_path=str(tmp_path / "absent.obj"))


def test_teapot_phong_matches_jax():
    from cs397raytracingsp22_tpu.render.driver import render_to_image as jax_render

    scene = tteapot.build(16, 16, spp=2)
    assert scene.camera.shading_mode is ShadingMode.PHONG
    img, stats = tdriver.render_to_image(scene, device="cpu", seed=0, verbose=False)
    ref, _ = jax_render(jteapot.build(16, 16, spp=2), seed=0, verbose=False)
    diff = np.abs(img.astype(int) - np.asarray(ref).astype(int))
    assert (diff <= 1).mean() >= 0.99, f"{(diff > 1).sum()} subpixels off by > 1"
    assert diff.mean() <= 0.05, f"mean |diff| {diff.mean():.4f}"
    assert stats.path_segments == 16 * 16 * 2 and img.mean() > 5
