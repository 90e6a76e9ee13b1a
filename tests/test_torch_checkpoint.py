"""Checkpoint and resume in the torch port's driver, and across packages.

A checkpoint is the `.npz` the JAX package's render_to_image writes after
every spp chunk: `accum` (the per-pixel HDR sum in raster order,
float64), `spp_done`, `seed` and `nee`. Each package must resume the
other's:
- a render killed after its first spp chunk (the chunk call raises) leaves
  a checkpoint at half the spp; the other package resumes it, and the
  image is within 1 u8 of that package's uninterrupted render on every
  subpixel, with only the remaining samples traced;
- the port's own checkpoint of a finished render resumes to the same image
  bit for bit, tracing nothing;
- a checkpoint of more samples than the render asks for, or of the other
  `nee` setting, raises.
"""

import dataclasses

import numpy as np
import pytest
import torch

from cs397raytracingsp22_tpu.render import driver as jdriver
from cs397raytracingsp22_tpu_torch import cli
from cs397raytracingsp22_tpu_torch.render import driver as tdriver
from cs397raytracingsp22_tpu_torch.scenes import cornell as tcornell
from scenes import cornell as jcornell

torch.set_num_threads(1)  # several test workers share the cores

SIDE, SPP, HALF = 8, 4, 2


def scenes(nee: bool):
    """(JAX scene, port scene): Cornell config 3, 8x8 at 4 spp, depth 2."""
    out = []
    for mod in (jcornell, tcornell):
        sc = mod.build_config3(width=SIDE, height=SIDE, spp=SPP, path_depth=2)
        out.append(dataclasses.replace(sc, camera=dataclasses.replace(sc.camera, nee=nee)))
    return out


def render(pkg, scene, **kw):
    if pkg is tdriver:
        kw["device"] = "cpu"
    return pkg.render_to_image(scene, seed=5, spp_chunk=HALF, verbose=False, **kw)


def killed_render(pkg, scene, ckpt, monkeypatch):
    """Render with a checkpoint until the first chunk of the second spp
    chunk, where the chunk call raises: the file then holds HALF spp."""
    real, calls = pkg.render_chunk, []

    def chunk(*a, **k):
        calls.append(1)
        if len(calls) > 1:
            raise RuntimeError("killed")
        return real(*a, **k)

    with monkeypatch.context() as m:
        m.setattr(pkg, "render_chunk", chunk)
        with pytest.raises(RuntimeError, match="killed"):
            render(pkg, scene, checkpoint_path=ckpt)
    with np.load(ckpt) as f:
        assert int(f["spp_done"]) == HALF and f["accum"].dtype == np.float64
        assert f["accum"].shape == (SIDE * SIDE, 3) and int(f["seed"]) == 5


@pytest.mark.parametrize("nee", [False, True], ids=["path", "nee"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_resume_the_other_packages_checkpoint(writer, nee, tmp_path, monkeypatch):
    jscene, tscene = scenes(nee)
    ckpt = str(tmp_path / "accum.npz")
    if writer == "jax":
        killed_render(jdriver, jscene, ckpt, monkeypatch)
        reader, scene = tdriver, tscene
    else:
        killed_render(tdriver, tscene, ckpt, monkeypatch)
        reader, scene = jdriver, jscene
    with np.load(ckpt) as f:
        assert int(f["nee"]) == int(nee)
    whole, _ = render(reader, scene)
    resumed, stats = render(reader, scene, checkpoint_path=ckpt)
    assert stats.primary_rays == SIDE * SIDE * (SPP - HALF)
    diff = np.abs(np.asarray(resumed).astype(int) - np.asarray(whole).astype(int))
    assert diff.max() <= 1, f"{(diff > 1).sum()} subpixels off by > 1"
    assert np.asarray(whole).mean() > 2.0
    with np.load(ckpt) as f:
        assert int(f["spp_done"]) == SPP


def test_port_checkpoint_round_trip(tmp_path):
    _, scene = scenes(False)
    ckpt = str(tmp_path / "accum")  # ".npz" is added
    whole, _ = render(tdriver, scene)
    with_ckpt, _ = render(tdriver, scene, checkpoint_path=ckpt)
    np.testing.assert_array_equal(with_ckpt, whole)
    resumed, stats = render(tdriver, scene, checkpoint_path=ckpt)
    np.testing.assert_array_equal(resumed, whole)
    assert stats.primary_rays == 0 and stats.chunks == 0


def test_checkpoint_refusals(tmp_path):
    """spp_done beyond the render's spp, and a flipped nee, raise; a
    checkpoint of another seed or image size is not resumed."""
    jscene, tscene = scenes(False)
    ckpt = str(tmp_path / "accum.npz")
    render(jdriver, jscene, checkpoint_path=ckpt)  # spp_done 4, nee 0
    fewer = dataclasses.replace(tscene, camera=dataclasses.replace(tscene.camera,
                                                                   aa_sample_count=HALF))
    with pytest.raises(ValueError, match="holds 4 spp"):
        render(tdriver, fewer, checkpoint_path=ckpt)
    flipped = dataclasses.replace(tscene, camera=dataclasses.replace(
        tscene.camera, nee=True, aa_sample_count=2 * SPP))
    with pytest.raises(ValueError, match="nee"):
        render(tdriver, flipped, checkpoint_path=ckpt)
    _, stats = tdriver.render_to_image(tscene, device="cpu", seed=6, spp_chunk=HALF,
                                       checkpoint_path=ckpt, verbose=False)
    assert stats.primary_rays == SIDE * SIDE * SPP  # another seed: rendered anew


def test_cli_checkpoint_resumes(tmp_path):
    """--checkpoint through the CLI: a second run resumes the finished
    render and traces nothing."""
    import json
    import os

    scene = os.path.join(os.path.dirname(tcornell.__file__), "cornell.py")
    ckpt, stats = tmp_path / "c.npz", tmp_path / "s.json"
    args = [scene, "-o", str(tmp_path / "o.png"), "--width", "8", "--height", "8", "--spp", "2",
            "--depth", "2", "--spp-chunk", "1", "--device", "cpu", "--checkpoint", str(ckpt),
            "--stats-json", str(stats), "-q"]
    assert cli.main(args) == 0 and ckpt.exists()
    assert json.loads(stats.read_text())["primary_rays"] == 8 * 8 * 2
    assert cli.main(args) == 0
    assert json.loads(stats.read_text())["primary_rays"] == 0
