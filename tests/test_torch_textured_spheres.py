"""Config 4 (scenes/textured_spheres.py: earth-textured, normal-mapped
spheres under a defocus-blur camera) in the torch port, on its stand-in
assets, against the JAX package's scenes/textured_spheres.py pointed at
the same files (its ASSET_DIR set on the loaded module, the mesh passed
as mesh_obj).

The stand-ins follow one recipe (the scene's docstring): a UV sphere of
64 × 32 segments with triangle-fan poles, 3,968 triangles (dense: K2's
walk), and four maps from seeded numpy patterns. Held here: the recipe's
counts and its determinism, every texture slot bound with the atlas
holding each map's pixels, the tables bit for bit, and the image (and the
NEE image: the two emissive triangles are the scene's only emitters)
within 1 u8 of the JAX package's on >= 99% of subpixels at 16×16 × 2 spp,
depth 8, lens radius 0.08.
"""

import dataclasses
import filecmp
import os

import numpy as np
import pytest
import torch

import scenes.textured_spheres as jax_config4
from cs397raytracingsp22_tpu.render.driver import render_to_image as jax_render
from cs397raytracingsp22_tpu_torch.ops.kernels import bounce as tbounce
from cs397raytracingsp22_tpu_torch.render import driver as tdriver
from cs397raytracingsp22_tpu_torch.scenes import textured_spheres as config4
from cs397raytracingsp22_tpu_torch.utils.texture import load_image
from test_torch_scene import assert_scene_data_equal

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def assets():
    return config4.stand_in_dir()


def jax_scene(assets, monkeypatch, **kw):
    monkeypatch.setattr(jax_config4, "ASSET_DIR", assets)
    return jax_config4.build(mesh_obj=os.path.join(assets, "obj", "sphere.obj"), **kw)


def test_stand_in_recipe(assets, tmp_path):
    pos, nrm, uv, faces = config4.uv_sphere()
    assert faces.shape == (3968, 3) and pos.shape[0] == uv.shape[0] == 31 * 65 + 128
    np.testing.assert_allclose(np.linalg.norm(pos, axis=1), 1.0, rtol=1e-12)
    assert uv.min() >= 0.0 and uv.max() <= 1.0
    again = config4.write_stand_in_assets(str(tmp_path))
    for rel in ["obj/sphere.obj"] + [f"texture/{m}" for m in config4.MAPS]:
        assert filecmp.cmp(os.path.join(assets, rel), os.path.join(again, rel), shallow=False), rel
    png = load_image(os.path.join(assets, "texture", "normal_test.png"))
    assert png.shape == (256, 256, 3) and int(png[..., 2].min()) > 128  # normals face +z


def test_bindings_and_atlas(assets):
    """Every slot the scene binds holds its map: no missing stand-in
    renders untextured."""
    sd = config4.build(16, 16, spp=2, asset_dir=assets).compile(device="cpu")
    assert sd.dense_mesh_ids == (0, 1) and [m.tri_verts.shape[0] for m in sd.meshes] == [3968] * 2
    maps = [("earthmap.jpg", "normal_test.png"), ("magenta.jpg", "normal_test.jpg")]
    for m, (albedo, normal) in zip(sd.meshes, maps):
        assert m.mat_id == -1 and m.tex_ids[0] >= 0 and m.tex_ids[4] >= 0
        assert m.tex_ids[1:4] == (-1, -1, -1)
        for slot, name in ((0, albedo), (4, normal)):
            img = load_image(os.path.join(assets, "texture", name))
            tid = m.tex_ids[slot]
            assert (int(sd.tex_height[tid]), int(sd.tex_width[tid])) == img.shape[:2]
            off = int(sd.tex_offset[tid])
            np.testing.assert_array_equal(
                sd.tex_pixels[off:off + img.shape[0] * img.shape[1]].numpy(), img.reshape(-1, 3))
    assert int(sum((~torch.isfinite(m.tri_tangent)).any(dim=1).sum() for m in sd.meshes)) == 0
    assert sd.nee_ok and sd.n_lt_tri == 2 and not tbounce.scene_is_simple(sd)


def test_tables_equal(assets, monkeypatch):
    port = config4.build(16, 16, spp=2, asset_dir=assets).compile(device="cpu")
    assert_scene_data_equal(port, jax_scene(assets, monkeypatch, width=16, height=16,
                                            spp=2).compile())


@pytest.mark.parametrize("nee", [False, True])
def test_image_matches_jax(assets, monkeypatch, nee):
    sc = config4.build(16, 16, spp=2, asset_dir=assets)
    js = jax_scene(assets, monkeypatch, width=16, height=16, spp=2)
    if nee:
        sc = dataclasses.replace(sc, camera=dataclasses.replace(sc.camera, nee=True))
        js = dataclasses.replace(js, camera=dataclasses.replace(js.camera, nee=True))
    assert sc.camera.lens_radius == 0.08 and sc.camera.path_depth == 8
    img, _ = tdriver.render_to_image(sc, device="cpu", seed=3, verbose=False)
    ref, _ = jax_render(js, seed=3, verbose=False)
    diff = np.abs(img.astype(int) - ref.astype(int))
    assert (diff <= 1).mean() >= 0.99, (diff <= 1).mean()
    assert img.max() > 0


def test_cli_renders_config4(assets, tmp_path):
    """The CLI takes the scene script and an explicit asset directory."""
    from PIL import Image

    from cs397raytracingsp22_tpu_torch import cli

    out = tmp_path / "config4.png"
    cli.main([config4.__file__, "-o", str(out), "--width", "4", "--height", "4", "--spp", "1",
              "--device", "cpu", "--set", f"asset_dir={assets}", "-q"])
    with Image.open(out) as im:
        assert im.size == (4, 4)
