"""The torch port's render_to_image on the CPU against the committed
goldens (rendered by the JAX package at seed 42, tools/make_goldens.py),
the chunking contract, the retry of a chunk that ran out of device
memory, the stats' compile and steady windows, and the CLI (its --mesh
runs spawn gloo ranks, each run under the 120 s bound of
tests/test_torch_sharding.py::run_bounded).

Goldens: within 1 u8 on at least 99% of subpixels, mean |diff| at most
0.05 u8 — the per-pixel sample sum runs in another float order, which can
tip a value across a quantization step, and a winner flip re-rolls a
path. Chunking: two pixel-chunk sizes give the same image exactly (the
RNG follows ray content, not position).
"""

import os
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from cs397raytracingsp22_tpu_torch.parallel import multihost
from cs397raytracingsp22_tpu_torch.render.driver import render_to_image, save_png
from cs397raytracingsp22_tpu_torch.scenes import cornell
from tests.test_torch_sharding import ROOT, run_bounded

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
    add segments beyond the path's, a checkpoint is written); --mesh
    renders over gloo ranks it spawns and --distributed joins a group (a
    world of one here), each giving the plain image bit for bit with
    n_sp = 1; a mesh larger than the visible cards is refused."""
    import json

    from cs397raytracingsp22_tpu_torch import cli

    scene = os.path.join(os.path.dirname(cornell.__file__), "cornell.py")
    out, stats = tmp_path / "o.png", tmp_path / "s.json"
    base = [scene, "-o", str(out), "--width", "8", "--height", "8", "--spp", "2", "--depth", "2",
            "--device", "cpu", "--stats-json", str(stats), "-q"]
    assert cli.main(base) == 0
    plain_img = np.asarray(Image.open(out))
    assert plain_img.shape == (8, 8, 3)
    plain = json.loads(stats.read_text())
    assert plain["path_depth"] == 2 and plain["device_count"] == 1
    for flag in (["--nee"], ["--checkpoint", str(tmp_path / "c.npz")], ["--mesh", "2x1"],
                 ["--distributed", "--coordinator", f"127.0.0.1:{multihost.free_port()}",
                  "--num-processes", "1", "--process-id", "0"]):
        if flag[0] == "--mesh":
            (rc, log), = run_bounded([cli_command(base + flag)], ROOT, tmp_path)[0]
            assert rc == 0, log[-4000:]
        else:
            assert cli.main(base + flag) == 0
        assert np.asarray(Image.open(out)).shape == (8, 8, 3)
        got = json.loads(stats.read_text())
        if flag[0] == "--nee":
            assert got["path_segments"] > plain["path_segments"]
        elif flag[0] == "--checkpoint":
            assert (tmp_path / "c.npz").exists()
            assert got["path_segments"] == plain["path_segments"]
        else:
            np.testing.assert_array_equal(np.asarray(Image.open(out)), plain_img)
            assert got["path_segments"] == plain["path_segments"]
            assert got["device_count"] == (2 if flag[0] == "--mesh" else 1)
    n = torch.cuda.device_count() + 1
    with pytest.raises(SystemExit, match=f"mesh {n}x1 needs {n} devices, have {n - 1}"):
        cli.main([scene, "--mesh", f"{n}x1"])


def cli_command(argv):
    return [sys.executable, "-m", "cs397raytracingsp22_tpu_torch.cli", *argv]


def test_cli_mesh_2x2_matches_plain_at_half_the_spp_chunk(tmp_path):
    """--mesh 2x2 --spp-chunk 4 --device cpu (four gloo ranks the CLI
    spawns) writes, from rank 0 only, the plain run's image at --spp-chunk
    2, bit for bit."""
    import json

    from cs397raytracingsp22_tpu_torch import cli

    scene = os.path.join(os.path.dirname(cornell.__file__), "cornell.py")
    base = [scene, "--width", "16", "--height", "16", "--spp", "8", "--depth", "3",
            "--device", "cpu", "-q"]
    assert cli.main(base + ["-o", str(tmp_path / "p.png"), "--spp-chunk", "2"]) == 0
    (rc, log), = run_bounded([cli_command(base + [
        "-o", str(tmp_path / "m.png"), "--spp-chunk", "4", "--mesh", "2x2",
        "--stats-json", str(tmp_path / "m.json")])], ROOT, tmp_path)[0]
    assert rc == 0, log[-4000:]
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "m.png")),
                                  np.asarray(Image.open(tmp_path / "p.png")))
    got = json.loads((tmp_path / "m.json").read_text())
    assert got["device_count"] == 4 and got["compile_seconds"] > 0


def test_cli_pixel_chunk(tmp_path):
    """--pixel-chunk sets the chunk: 48-pixel chunks of an 8x8 image give
    the same image, and trace the ragged tail's padding too."""
    import json

    from cs397raytracingsp22_tpu_torch import cli

    scene = os.path.join(os.path.dirname(cornell.__file__), "cornell.py")
    base = [scene, "--width", "8", "--height", "8", "--spp", "2", "--depth", "2",
            "--device", "cpu", "-q"]
    segs = []
    for name, extra in (("a", []), ("b", ["--pixel-chunk", "48"])):
        assert cli.main(base + ["-o", str(tmp_path / f"{name}.png"), "--stats-json",
                                str(tmp_path / f"{name}.json")] + extra) == 0
        segs.append(json.loads((tmp_path / f"{name}.json").read_text())["path_segments"])
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "a.png")),
                                  np.asarray(Image.open(tmp_path / "b.png")))
    assert segs[1] > segs[0]  # 2 chunks of 48: 32 padding pixels traced


def test_retry_after_out_of_memory(monkeypatch):
    """A chunk that runs out of device memory is run again (the same
    image, one more call); any other error is raised at once."""
    from cs397raytracingsp22_tpu_torch.render import driver

    scene = cornell.build(width=8, height=8, spp=2, path_depth=2)
    whole, _ = render_to_image(scene, device="cpu", seed=1, verbose=False)
    real = driver.render_chunk
    for error, expect_calls in ((torch.cuda.OutOfMemoryError("CUDA out of memory"), 2),
                                (RuntimeError("launch failed"), 1)):
        calls = []

        def chunk(*a, _error=error, **k):
            calls.append(1)
            if len(calls) == 1:
                raise _error
            return real(*a, **k)

        monkeypatch.setattr(driver, "render_chunk", chunk)
        if isinstance(error, torch.cuda.OutOfMemoryError):
            img, _ = render_to_image(scene, device="cpu", seed=1, verbose=False)
            np.testing.assert_array_equal(img, whole)
        else:
            with pytest.raises(RuntimeError, match="launch failed"):
                render_to_image(scene, device="cpu", seed=1, verbose=False)
        assert len(calls) == expect_calls


def test_render_stats_steady_and_compile(capsys):
    """The first chunk is the compile window, the later ones the steady
    window, whose rates the stats report; one chunk has no steady window
    and its rates come from the wall time. A verbose render prints its
    progress after the first chunk and then every SYNC_EVERY chunks."""
    from cs397raytracingsp22_tpu_torch.render.driver import SYNC_EVERY

    scene = cornell.build_config3(width=12, height=10, spp=4, path_depth=3)
    _, one = render_to_image(scene, device="cpu", seed=5, verbose=False)
    assert one.chunks == 1 and one.steady_seconds == 0 and one.device_count == 1
    assert one.compile_seconds > 0
    assert one.segment_mrays_per_sec == one.path_segments / one.wall_seconds / 1e6
    capsys.readouterr()
    _, st = render_to_image(scene, device="cpu", seed=5, pixel_chunk=8)
    progress = capsys.readouterr().out.count("\r[render] chunk ")
    assert progress == 1 + (st.chunks - 1) // SYNC_EVERY == 2
    first_px = 8  # chunk 0 of 15 holds pixels 0, 15, ..., 105
    assert st.chunks == 15 and st.compile_seconds > 0 and st.steady_seconds > 0
    assert st.steady_primary == st.primary_rays - first_px * 4
    assert 0 < st.steady_segments < st.path_segments == one.path_segments
    assert st.compile_seconds + st.steady_seconds <= st.wall_seconds
    assert st.primary_mrays_per_sec == st.steady_primary / st.steady_seconds / 1e6


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
    (on K1, which walks its big mesh's BVH)."""
    import json

    from cs397raytracingsp22_tpu_torch import cli

    out, stats = tmp_path / "o.png", tmp_path / "s.json"
    assert cli.DEFAULT_SCENE.endswith("bench_teapot_32k.py")
    assert cli.main(["-o", str(out), "--width", "8", "--height", "8", "--spp", "1", "--depth", "2",
                     "--device", "cpu", "--stats-json", str(stats), "-q"]) == 0
    assert np.asarray(Image.open(out)).shape == (8, 8, 3)
    assert json.loads(stats.read_text())["path_segments"] > 8 * 8
