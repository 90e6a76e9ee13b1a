"""The port's tools (cs397raytracingsp22_tpu_torch/tools/) against the JAX
package's tools/ of the same name, on the CPU.

- preview_checkpoint: the PNG equal to the JAX tool's, byte for byte in
  its pixels, on a checkpoint that each package's render_to_image wrote
  and on the JAX test's synthetic file; a wrong resolution returns 1.
- compare_reference_render: region_means equal to the JAX tool's on a
  seeded image; an image passes against itself and its 2/π-scaled copy
  fails (the bug-detection arm of tests/test_reference_parity.py).
- make_artifacts: the recipes are the JAX RECIPES with `_tpu` turned into
  `_h100`, with the same default skips; a recipe rendered small into a
  temporary directory; an output directory inside artifacts/ refused.
- bench_teapot_6k: the threshold sends the 6k teapot to the staged route,
  the default keeps it dense, and a threshold beyond the superleaf trees'
  cap is refused.
- bench_config4_e2e: a tiny CPU run returns its JSON fields.
"""

import importlib.util
import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from cs397raytracingsp22_tpu.render import driver as jdriver
from cs397raytracingsp22_tpu_torch.render import driver as tdriver
from cs397raytracingsp22_tpu_torch.scenes import cornell as tcornell
from cs397raytracingsp22_tpu_torch.tools import bench_config4_e2e, bench_teapot_6k
from cs397raytracingsp22_tpu_torch.tools import compare_reference_render as tcompare
from cs397raytracingsp22_tpu_torch.tools import make_artifacts as tmake
from cs397raytracingsp22_tpu_torch.tools import preview_checkpoint as tpreview
from scenes import cornell as jcornell

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_jax_tool(name):
    spec = importlib.util.spec_from_file_location(f"jax_{name}",
                                                  os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def png(path):
    with Image.open(path) as im:
        return np.asarray(im)


def checkpoint_of(driver, scene, path):
    driver.render_to_image(scene, seed=0, verbose=False, checkpoint_path=path, spp_chunk=2,
                           **({"device": "cpu"} if driver is tdriver else {}))
    return path


@pytest.mark.parametrize("source", ["torch", "jax", "synthetic"])
def test_preview_checkpoint_matches_jax_tool(tmp_path, source):
    w, h = (8, 6) if source != "synthetic" else (64, 48)
    ck = str(tmp_path / "ck.npz")
    if source == "synthetic":  # tests/test_tools.py's file
        accum = np.random.default_rng(0).uniform(0, 4, (64 * 48, 3))
        np.savez(ck, accum=accum, spp_done=np.int64(4), seed=np.int64(0))
    else:
        mod, driver = (tcornell, tdriver) if source == "torch" else (jcornell, jdriver)
        checkpoint_of(driver, mod.build(width=w, height=h, spp=4, path_depth=3), ck)
    jax_tool = load_jax_tool("preview_checkpoint")
    assert jax_tool.main(["preview", ck, str(tmp_path / "jax.png"), str(w), str(h)]) == 0
    assert tpreview.main([ck, str(tmp_path / "port.png"), str(w), str(h)]) == 0
    ours, theirs = png(tmp_path / "port.png"), png(tmp_path / "jax.png")
    assert ours.shape == (h, w, 3) and ours.dtype == np.uint8
    np.testing.assert_array_equal(ours, theirs)
    assert tpreview.main([ck, str(tmp_path / "bad.png"), str(w + 1), str(h)]) == 1
    assert not os.path.exists(tmp_path / "bad.png")


def test_preview_is_the_renders_tonemap(tmp_path):
    """A finished render's checkpoint previews (at the scene's gamma) as the
    render's own image."""
    scene = tcornell.build(width=8, height=8, spp=4, path_depth=3)
    ck = str(tmp_path / "ck.npz")
    img, _ = tdriver.render_to_image(scene, device="cpu", seed=0, verbose=False,
                                     checkpoint_path=ck, spp_chunk=2)
    prev, spp_done = tpreview.preview(ck, 8, 8, scene.camera.gamma)
    assert spp_done == 4
    np.testing.assert_array_equal(prev, img)


def test_region_means_and_compare():
    jax_tool = load_jax_tool("compare_reference_render")
    assert tcompare.REGIONS == jax_tool.REGIONS and tcompare.TOLERANCE == jax_tool.TOLERANCE
    img = np.random.default_rng(12).integers(0, 256, (96, 128, 3), dtype=np.uint8)
    ours, theirs = tcompare.region_means(img), jax_tool.region_means(img)
    for k in tcompare.REGIONS:
        np.testing.assert_array_equal(ours[k], theirs[k])
    assert tcompare.passed(tcompare.compare(img, img, verbose=False))
    dim = (img.astype(np.float64) * (2.0 / np.pi)).astype(np.uint8)
    res = tcompare.compare(dim, img, verbose=False)
    assert not tcompare.passed(res)
    assert all(not ok for *_, ok, _ in res.values())
    # a region reported but not gated does not fail the image
    assert tcompare.passed(tcompare.compare(dim, img, gate=(), verbose=False))
    with pytest.raises(ValueError, match="unknown regions"):
        tcompare.compare(img, img, gate=("nowhere",), verbose=False)


def test_compare_main(tmp_path):
    img = np.random.default_rng(3).integers(0, 256, (32, 32, 3), dtype=np.uint8)
    Image.fromarray(img).save(tmp_path / "a.png")
    Image.fromarray((img // 2).astype(np.uint8)).save(tmp_path / "b.png")
    assert tcompare.main([str(tmp_path / "a.png"), "--reference", str(tmp_path / "a.png")]) == 0
    assert tcompare.main([str(tmp_path / "b.png"), "--reference", str(tmp_path / "a.png")]) == 1


def test_make_artifacts_recipes():
    jax_tool = load_jax_tool("make_artifacts")
    assert sorted(tmake.RECIPES) == sorted(n.replace("_tpu", "_h100") for n in jax_tool.RECIPES)
    assert tmake.DEFAULT_SKIP == {n.replace("_tpu", "_h100") for n in jax_tool.DEFAULT_SKIP}
    for name, (mod, fn, kwargs) in jax_tool.RECIPES.items():
        port_mod, port_fn, port_kwargs = tmake.RECIPES[name.replace("_tpu", "_h100")]
        assert port_kwargs == kwargs, name
        assert (port_mod, port_fn) == (("bench_scene", "build") if mod == "bench"
                                       else (mod.split(".")[-1], fn)), name
        assert os.path.exists(tmake.committed(name.replace("_tpu", "_h100")))


def test_make_artifacts_renders_and_refuses_artifacts_dir(tmp_path, capsys):
    out = tmake.run(["config1_cornell_h100.png", "config5_demo_h100.png"], str(tmp_path),
                    device="cpu", overrides=dict(width=8, height=8, spp=1))
    row = out["config1_cornell_h100.png"]
    assert png(row["path"]).shape == (8, 8, 3)
    assert "shape" in row["agreement"]  # an 8x8 image is not held to the 256² render
    assert "stand-in" in out["config5_demo_h100.png"]["inputs_differ"]
    assert "not compared: rendered on stand-in assets" in capsys.readouterr().out
    a = np.zeros((4, 4, 3), np.uint8)
    b = a.copy()
    b[0, 0, 0] = 3
    assert tmake.agreement(a, b) == dict(within_1=47 / 48, mean_abs=3 / 48, max_abs=3)
    for bad in (tmake.ARTIFACTS, os.path.join(tmake.ARTIFACTS, "sub")):
        with pytest.raises(ValueError, match="committed renders"):
            tmake.run(["config1_cornell_h100.png"], bad, device="cpu",
                      overrides=dict(width=4, height=4, spp=1))
    assert not os.path.exists(os.path.join(tmake.ARTIFACTS, "sub"))
    assert not os.path.exists(os.path.join(tmake.ARTIFACTS, "config1_cornell_h100.png"))


def test_bench_teapot_6k_threshold(capsys):
    frame = dict(width=4, height=4, spp=1, path_depth=2)
    scene = bench_teapot_6k.scene_for(6144, frame)
    assert bench_teapot_6k.compile_route(scene, "cpu")[1] == "dense"
    assert bench_teapot_6k.compile_route(scene, "cpu", 512)[1] == "bvh"
    rows = bench_teapot_6k.run("cpu", sizes=(6144,), dense_max_tris=512, frame=frame, reps=1)
    assert [(r["tris"], r["route"], r["threshold"]) for r in rows] == [(6144, "bvh", 512)]
    assert rows[0]["segments"] > 0 and rows[0]["mrays"] > 0
    line = capsys.readouterr().out.strip().splitlines()
    assert json.loads(line[-1]) == {"crossover_tris": None}
    assert bench_teapot_6k.crossover([
        dict(tris=9000, route="dense", least_s=1.0), dict(tris=9000, route="bvh", least_s=0.5),
        dict(tris=6144, route="dense", least_s=0.5), dict(tris=6144, route="bvh", least_s=1.0),
    ]) == 9000


def test_bench_teapot_6k_refuses_beyond_the_tree_cap():
    """9,000 triangles as one dense mesh need 1,125 superleaf-tree nodes,
    more than the 1,023 K1 stages: the dense route is refused."""
    frame = dict(width=4, height=4, spp=1, path_depth=2)
    scene = bench_teapot_6k.scene_for(9000, frame)
    with pytest.raises(ValueError, match="superleaf tree nodes"):
        bench_teapot_6k.compile_route(scene, "cpu", 9008)  # 9,000 rows padded to 16
    assert bench_teapot_6k.compile_route(scene, "cpu")[1] == "bvh"


def test_bench_config4_e2e_on_cpu():
    out = bench_config4_e2e.run("config4", spp=1, device="cpu", width=4, verbose=False)
    assert out["metric"] == "config4_e2e_mrays" and out["device"] == "cpu"
    assert out["stand_ins"] and out["width"] == 4 and out["depth"] == 8
    assert out["segments"] > 0 and out["wall_s"] > 0 and out["nonfinite_pixels"] == 0
    assert bench_config4_e2e.SCENES["config5"] == ("drone_demo", 1024, 64)


def test_tools_refuse_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_config4_e2e.run("config4", spp=1, width=4, verbose=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_teapot_6k.main(["6144"])
