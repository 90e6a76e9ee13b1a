"""The texture atlas and texture sampling of the torch port against the
JAX package (utils/texture.py, ops/intersect.py::sample_texture and
_sample_texture_dyn): the same atlas bit for bit, dedup and the 1-pixel
placeholder included, and the same texels (texture.rs:26-32: clamp to
[0, 0.999], flip v, truncate, min(size - 1), /255) on uv grids with
corners, out-of-range uv and the v flip. The images are written by the
test, as tests/test_texture.py does."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cs397raytracingsp22_tpu.ops import intersect as jisect
from cs397raytracingsp22_tpu.utils.texture import TextureAtlasBuilder as JaxAtlasBuilder
from cs397raytracingsp22_tpu_torch import Camera, Scene
from cs397raytracingsp22_tpu_torch.ops import intersect as tisect
from cs397raytracingsp22_tpu_torch.utils.texture import TextureAtlasBuilder, load_image
from test_texture import atlas_scene, gradient_image

torch.set_num_threads(1)


def images():
    """A 2×2 corner image, gradients of several shapes, a copy of one of
    them (the same content) and a seeded noise image."""
    corners = np.array([[[255, 0, 0], [0, 255, 0]], [[0, 0, 255], [255, 255, 255]]], np.uint8)
    g = gradient_image(8, 8)
    noise = np.random.default_rng(3).integers(0, 256, (5, 7, 3)).astype(np.uint8)
    return [corners, g, gradient_image(3, 5), g.copy(), noise, gradient_image(1, 1)]


def build_both(imgs):
    tb, jb = TextureAtlasBuilder(), JaxAtlasBuilder()
    return [tb.add(i) for i in imgs], tb.build(), [jb.add(i) for i in imgs], jb.build()


def test_atlas_equals_jax_bit_for_bit():
    tid, tatlas, jid, jatlas = build_both(images())
    assert tid == jid
    assert tid[3] == tid[1]  # the copy packs once
    for f in ("pixels", "offset", "width", "height"):
        a, b = getattr(tatlas, f), getattr(jatlas, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)


def test_atlas_placeholder_and_shape_key():
    _, tatlas, _, jatlas = build_both([])
    assert tatlas.pixels.shape == (1, 3) and not tatlas.pixels.any()
    np.testing.assert_array_equal(tatlas.width, jatlas.width)
    flat = np.arange(24, dtype=np.uint8).reshape(2, 4, 3)
    b = TextureAtlasBuilder()
    assert b.add(flat) != b.add(flat.reshape(4, 2, 3).copy())  # same bytes, other shape


def port_atlas_scene(imgs):
    """An empty compiled scene (CPU) carrying the atlas of imgs."""
    sd = Scene(camera=Camera(), objects=[]).compile(device="cpu")
    b = TextureAtlasBuilder()
    ids = [b.add(i) for i in imgs]
    a = b.build()
    sd = dataclasses.replace(sd, **{f"tex_{k}": torch.from_numpy(getattr(a, k))
                                    for k in ("pixels", "offset", "width", "height")})
    return sd, ids


def uv_grid():
    """Corners, edges, out-of-range uv on both sides and a seeded cloud."""
    edge = np.array([0.0, 0.999, 1.0, 1e-7, 0.5, -0.25, 1.25, 0.9989, 0.12499, 0.125])
    grid = np.stack(np.meshgrid(edge, edge, indexing="ij"), -1).reshape(-1, 2)
    cloud = np.random.default_rng(5).uniform(-0.2, 1.2, (512, 2))
    return np.concatenate([grid, cloud]).astype(np.float32)


def test_sample_texture_matches_jax():
    imgs = images()
    jsd, jids = atlas_scene(imgs)
    tsd, tids = port_atlas_scene(imgs)
    assert jids == tids
    uv = uv_grid()
    for tid in sorted(set(tids)):
        got = tisect.sample_texture(tsd, tid, torch.from_numpy(uv)).numpy()
        ref = np.asarray(jisect.sample_texture(jsd, tid, jnp.asarray(uv)))
        np.testing.assert_array_equal(got, ref, err_msg=f"texture {tid}")


def test_v_flip_and_corners():
    img = images()[0]
    tsd, (tid,) = port_atlas_scene([img])
    uv = torch.tensor([[0.0, 0.999], [0.999, 0.999], [0.0, 0.0], [0.999, 0.0]])
    out = tisect.sample_texture(tsd, tid, uv).numpy()
    np.testing.assert_array_equal(out, [[1, 0, 0], [0, 1, 0], [0, 0, 1], [1, 1, 1]])


def test_sample_texture_dyn_matches_jax():
    """Per-ray bindings: each ray samples the texture its index picks."""
    imgs = images()
    jsd, _ = atlas_scene(imgs)
    tsd, _ = port_atlas_scene(imgs)
    uv = uv_grid()
    pick = np.random.default_rng(9).integers(0, tsd.tex_offset.shape[0], uv.shape[0])
    off, w, h = (getattr(tsd, f"tex_{k}")[torch.from_numpy(pick)]
                 for k in ("offset", "width", "height"))
    got = tisect.sample_texture_dyn(tsd, off, w, h, torch.from_numpy(uv)).numpy()
    jo, jw, jh = (jnp.asarray(x.numpy()) for x in (off, w, h))
    ref = np.asarray(jisect._sample_texture_dyn(jsd, jo, jw, jh, jnp.asarray(uv)))
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("ext", ["png", "jpg"])
def test_load_image_round_trip(tmp_path, ext):
    """A written image loads as (H, W, 3) uint8 (lossless for png); an
    unreadable path loads as None, the reference's graceful miss."""
    from PIL import Image

    from cs397raytracingsp22_tpu.utils.texture import load_image as jax_load

    img = gradient_image(6, 4)
    path = str(tmp_path / f"g.{ext}")
    Image.fromarray(img).save(path)
    got = load_image(path)
    assert got.dtype == np.uint8 and got.shape == (4, 6, 3)
    np.testing.assert_array_equal(got, jax_load(path))
    if ext == "png":
        np.testing.assert_array_equal(got, img)
    assert load_image(str(tmp_path / "absent.png")) is None
