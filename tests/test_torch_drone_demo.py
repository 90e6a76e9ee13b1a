"""Config 5 (scenes/drone_demo.py, the reference's demo scene) in the torch
port against the JAX package's scenes/drone_demo.py.

Without its meshes the scene is analytic and runs on the mega-bounce
kernel; with the stand-in assets (the port's scene docstring) it takes the
staged path with a big mesh (the sphere) and two dense ones (the cube and
the drone, their materials synthesized from textures). The JAX scene reads
its files from its module's ASSET_DIR, which the tests point at the same
stand-in directory. Held here: the tables bit for bit, the images within
1 u8 of the JAX package's on >= 99% of subpixels with a mean |diff| <=
0.05 u8, a missing OBJ raising with its path, and the stand-ins' counts.
"""

import os

import numpy as np
import pytest
import torch

import scenes.drone_demo as jax_config5
from cs397raytracingsp22_tpu.render.driver import render_to_image as jax_render
from cs397raytracingsp22_tpu_torch.ops.kernels import bounce as tbounce
from cs397raytracingsp22_tpu_torch.render import driver as tdriver
from cs397raytracingsp22_tpu_torch.scenes import drone_demo as config5
from cs397raytracingsp22_tpu_torch.utils.obj_loader import load_obj
from test_torch_scene import assert_scene_data_equal, port_data_from_jax

torch.set_num_threads(1)

# the sphere just over the dense budget (96 × 48 segments: 9,024 triangles),
# so it still takes the big-mesh route at a CPU test's cost
SMALL_LON, SMALL_LAT = 96, 48


@pytest.fixture(scope="module")
def small_assets(tmp_path_factory):
    return config5.write_stand_in_assets(str(tmp_path_factory.mktemp("config5")),
                                         lon=SMALL_LON, lat=SMALL_LAT)


def jax_scene(monkeypatch, asset_dir=None, **kw):
    if asset_dir is not None:
        monkeypatch.setattr(jax_config5, "ASSET_DIR", asset_dir)
    return jax_config5.build(**kw)


def assert_images_agree(img, ref):
    diff = np.abs(img.astype(int) - ref.astype(int))
    assert (diff <= 1).mean() >= 0.99, (diff <= 1).mean()
    assert diff.mean() <= 0.05, diff.mean()
    assert img.max() > 0


def test_analytic_part_matches_jax(monkeypatch):
    """include_meshes=False: tables equal, K1's scene, the image within 1 u8."""
    kw = dict(width=16, height=16, spp=4, path_depth=4, include_meshes=False)
    sc = config5.build(**kw)
    port = sc.compile(device="cpu")
    jsd = jax_scene(monkeypatch, **kw).compile()
    assert_scene_data_equal(port, jsd)
    assert_scene_data_equal(port_data_from_jax(jsd), jsd)
    assert tbounce.scene_is_simple(port) and not port.meshes
    assert (port.n_spheres, port.n_planes, port.n_tris, port.n_volumes) == (17, 1, 2, 2)
    assert port.point_light_pos.tolist() == [0.0, 1.0, 5.0]
    img, _ = tdriver.render_to_image(sc, device="cpu", seed=0, verbose=False)
    ref, _ = jax_render(jax_scene(monkeypatch, **kw), seed=0, verbose=False)
    assert_images_agree(img, ref)


def test_stand_ins_match_jax(small_assets, monkeypatch):
    """The stand-ins with a 9,024-triangle sphere: tables equal, the sphere
    a big mesh, the drone and cube dense with materials synthesized from
    textures (the drone's five slots empty), the image within 1 u8."""
    kw = dict(width=8, height=8, spp=2, path_depth=3)
    sc = config5.build(asset_dir=small_assets, **kw)
    port = sc.compile(device="cpu")
    js = jax_scene(monkeypatch, small_assets, **kw)
    assert_scene_data_equal(port, js.compile())
    assert [m.tri_verts.shape[0] for m in port.meshes] == [1536, 12, 9024]
    assert port.dense_mesh_ids == (0, 1) and not tbounce.scene_is_simple(port)
    assert [m.mat_id for m in port.meshes] == [-1, -1, -1]
    assert port.meshes[0].tex_ids == (-1,) * 5
    assert all(m.tex_ids[0] >= 0 and m.tex_ids[4] >= 0 for m in port.meshes[1:])
    img, st = tdriver.render_to_image(sc, device="cpu", seed=0, verbose=False)
    ref, _ = jax_render(js, seed=0, verbose=False)
    assert st.nonfinite_pixels == 0
    assert_images_agree(img, ref)


def test_missing_obj_raises(small_assets, tmp_path):
    os.makedirs(tmp_path / "obj")
    for name in ("drone.obj", "cube.obj"):
        os.symlink(os.path.join(small_assets, "obj", name), tmp_path / "obj" / name)
    with pytest.raises(FileNotFoundError, match="sphere.obj") as err:
        config5.build(8, 8, spp=1, asset_dir=str(tmp_path))
    assert str(tmp_path) in str(err.value)
    config5.build(8, 8, spp=1, asset_dir=str(tmp_path), include_meshes=False)  # needs no file


def test_stand_in_counts():
    """The default stand-ins have the reference files' counts: the sphere
    16,258 positions and 16,384 faces (32,512 triangles once loaded), the
    cube 8 and 12, the drone a dense mesh of quads and triangles; no
    Drone_*.tga written."""
    d = config5.stand_in_dir()

    def count(name, tag):
        with open(os.path.join(d, "obj", name)) as f:
            return sum(1 for line in f if line.startswith(tag + " "))

    assert (count("sphere.obj", "v"), count("sphere.obj", "vt"), count("sphere.obj", "f")) == \
        (16258, 16639, 16384)
    sphere = load_obj(os.path.join(d, "obj", "sphere.obj"))
    assert sphere.num_triangles == 32512 and sphere.num_vertices == 16639
    assert (count("cube.obj", "v"), count("cube.obj", "f")) == (8, 12)
    assert load_obj(os.path.join(d, "obj", "cube.obj")).num_triangles == 12
    with open(os.path.join(d, "obj", "drone.obj")) as f:
        sides = {len(line.split()) - 1 for line in f if line.startswith("f ")}
    assert sides == {3, 4} and count("drone.obj", "f") == 896
    assert load_obj(os.path.join(d, "obj", "drone.obj")).num_triangles == 1536
    assert sorted(os.listdir(os.path.join(d, "texture"))) == sorted(config5.MAPS)
    assert not any(n.startswith("Drone_") for n in os.listdir(os.path.join(d, "texture")))
