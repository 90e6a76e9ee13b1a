"""The torch port's render_to_image on the CPU against the committed
goldens (rendered by the JAX package at seed 42, tools/make_goldens.py),
and the chunking contract.

Goldens: within 1 u8 on at least 99% of subpixels, mean |diff| at most
0.05 u8 — the per-pixel sample sum runs in another float order, which can
tip a value across a quantization step, and a winner flip re-rolls a
path. Chunking: two pixel-chunk sizes give the same image exactly (the
RNG follows ray content, not position).
"""

import os

import numpy as np
import pytest
import torch
from PIL import Image

from cs397raytracingsp22_tpu_torch.render.driver import render_to_image, save_png
from cs397raytracingsp22_tpu_torch.scenes import cornell

torch.set_num_threads(1)  # several test workers share the cores

GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens")
# the configs of tools/make_goldens.py
CONFIGS = {
    "cornell_16": lambda: cornell.build(width=16, height=16, spp=8, path_depth=4),
    "cornell_metal_glass_16": lambda: cornell.build_config3(width=16, height=16, spp=8,
                                                            path_depth=4),
}


def assert_golden(img: np.ndarray, name: str) -> None:
    golden = np.asarray(Image.open(os.path.join(GOLDEN_DIR, f"{name}.png")).convert("RGB"))
    assert img.shape == golden.shape and img.dtype == np.uint8
    diff = np.abs(img.astype(int) - golden.astype(int))
    assert (diff <= 1).mean() >= 0.99, f"{name}: {(diff > 1).sum()} subpixels off by > 1"
    assert diff.mean() <= 0.05, f"{name}: mean |diff| {diff.mean():.4f}"


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_golden(name, tmp_path):
    img, stats = render_to_image(CONFIGS[name](), device="cpu", seed=42, verbose=False)
    assert_golden(img, name)
    assert stats.path_segments > 16 * 16 * 8
    path = tmp_path / f"{name}.png"
    save_png(img, str(path))
    np.testing.assert_array_equal(np.asarray(Image.open(path)), img)


def test_chunk_sizes_give_the_same_image():
    scene = cornell.build_config3(width=12, height=10, spp=4, path_depth=3)
    whole, s1 = render_to_image(scene, device="cpu", seed=5, verbose=False)
    chunked, s2 = render_to_image(scene, device="cpu", seed=5, pixel_chunk=16, verbose=False)
    spp_split, s3 = render_to_image(scene, device="cpu", seed=5, pixel_chunk=32, spp_chunk=4,
                                    verbose=False)
    assert s1.chunks == 1 and s2.chunks == 8
    np.testing.assert_array_equal(chunked, whole)
    np.testing.assert_array_equal(spp_split, whole)
    # padding pixels of a ragged last chunk are traced too (and dropped)
    assert s1.path_segments <= s2.path_segments and s1.path_segments <= s3.path_segments


def test_path_samples_chains_match_jax():
    """path_samples > 1 traces that many chains per camera sample."""
    from cs397raytracingsp22_tpu.render.driver import render_to_image as jax_render
    from scenes import cornell as jcornell

    kw = dict(width=8, height=8, spp=2, path_depth=3, path_samples=2)
    img, stats = render_to_image(cornell.build(**kw), device="cpu", seed=3, verbose=False)
    ref, ref_stats = jax_render(jcornell.build(**kw), seed=3, verbose=False)
    diff = np.abs(img.astype(int) - np.asarray(ref).astype(int))
    assert (diff <= 1).mean() >= 0.99 and diff.mean() <= 0.05
    assert stats.path_segments == int(ref_stats.path_segments) == 8 * 8 * 2 * 2 * 3


def test_cuda_device_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        render_to_image(CONFIGS["cornell_16"](), device="cuda", verbose=False)


def test_cli_renders_and_refuses_unported_flags(tmp_path):
    """The CLI renders; --nee and --checkpoint render (NEE's shadow rays
    add segments beyond the path's, a checkpoint is written); --mesh and
    --distributed (multi-device) are refused."""
    import json

    from cs397raytracingsp22_tpu_torch import cli

    scene = os.path.join(os.path.dirname(cornell.__file__), "cornell.py")
    out, stats = tmp_path / "o.png", tmp_path / "s.json"
    base = [scene, "-o", str(out), "--width", "8", "--height", "8", "--spp", "2", "--depth", "2",
            "--device", "cpu", "--stats-json", str(stats), "-q"]
    assert cli.main(base) == 0
    assert np.asarray(Image.open(out)).shape == (8, 8, 3)
    plain = json.loads(stats.read_text())
    assert plain["path_depth"] == 2
    for flag in (["--nee"], ["--checkpoint", str(tmp_path / "c.npz")], ["--mesh", "2x1"],
                 ["--distributed"]):
        if flag[0] in ("--mesh", "--distributed"):
            with pytest.raises(SystemExit, match="not ported"):
                cli.main([scene, "--device", "cpu", *flag])
            continue
        assert cli.main(base + flag) == 0
        assert np.asarray(Image.open(out)).shape == (8, 8, 3)
        got = json.loads(stats.read_text())
        if flag[0] == "--nee":
            assert got["path_segments"] > plain["path_segments"]
        else:
            assert (tmp_path / "c.npz").exists()
            assert got["path_segments"] == plain["path_segments"]


def test_cli_renders_a_phong_scene(tmp_path):
    """The teapot scene shades by Phong (its camera's mode): a lit image."""
    from cs397raytracingsp22_tpu_torch import cli
    from cs397raytracingsp22_tpu_torch.scenes import teapot

    out = tmp_path / "t.png"
    assert cli.main([teapot.__file__, "-o", str(out), "--width", "8", "--height", "8", "--spp",
                     "1", "--device", "cpu", "-q"]) == 0
    assert np.asarray(Image.open(out)).mean() > 5


def test_cli_renders_the_32k_bench_scene_by_default(tmp_path):
    """Without a scene script the CLI renders scenes/bench_teapot_32k.py
    (through the staged path: its teapot is a big mesh)."""
    import json

    from cs397raytracingsp22_tpu_torch import cli

    out, stats = tmp_path / "o.png", tmp_path / "s.json"
    assert cli.DEFAULT_SCENE.endswith("bench_teapot_32k.py")
    assert cli.main(["-o", str(out), "--width", "8", "--height", "8", "--spp", "1", "--depth", "2",
                     "--device", "cpu", "--stats-json", str(stats), "-q"]) == 0
    assert np.asarray(Image.open(out)).shape == (8, 8, 3)
    assert json.loads(stats.read_text())["path_segments"] > 8 * 8
