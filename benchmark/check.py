"""How `correct` is decided: the timed images against the plain reference.

After the window has closed, a sample drawn from the run's seed of the
images it finished (`images` of the cell's check) and of their pixels
(`pixels` a sampled image) is rendered again by the plain reference
(benchmark/reference), from the configuration and the image's seed
alone, and the renderer's u8 pixels are compared with the reference's:

- `mean_abs_u8`: the mean |renderer − reference| over the sampled
  sub-pixels, in u8 levels;
- `share_off_u8`: the share of sampled sub-pixels that differ by more than
  OFF_U8 levels, in %.

Each has a limit in the cell's file (`check.limits`), set from the
readings in PERF.md: above what sound runs read on a dozen seeds and below
what the control (the reference itself in bfloat16) reads. A run is
correct when both numbers are at or under their limits.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark import cells
from benchmark.reference import scene as ref_scene
from benchmark.reference import tracer

OFF_U8 = 2
NUMBERS = ("mean_abs_u8", "share_off_u8")


def image_seed(seed: int, index: int) -> int:
    """The seed of image `index` of a run: each image its own stream, so no
    cache can stand in for the work."""
    return seed * (1 << 20) + index


def picks(cell: cells.Cell, seed: int, indices: list) -> list:
    """[(image index, pixel ids)]: the sampled images among `indices` (the
    finished ones) and their sampled pixels, drawn from the seed."""
    spec = cell.spec["check"]
    cam = cell.camera
    n_px = cam["screen_width"] * cam["screen_height"]
    rng = np.random.default_rng([seed & 0xFFFFFFFFFFFF, 7])
    chosen = sorted(rng.choice(len(indices), min(spec["images"], len(indices)), replace=False))
    return [(indices[i], np.sort(rng.choice(n_px, min(spec["pixels"], n_px), replace=False)))
            for i in chosen]


def reference_scene(cell: cells.Cell, device, dtype=torch.float32):
    desc = dict(cell.config["scene"], camera=cell.camera)
    return ref_scene.build(desc, cells.files_of(cell.config), device, dtype)


def reference_pixels(scene, seed: int, index: int, pixels: np.ndarray, device) -> np.ndarray:
    ids = torch.as_tensor(pixels, dtype=torch.int64, device=device)
    return tracer.render_pixels(scene, image_seed(seed, index), ids).cpu().numpy()


def numbers(got: list, want: list) -> dict:
    """The compared numbers of u8 pixel lists (renderer, reference)."""
    g = np.concatenate([x.reshape(-1) for x in got]).astype(np.int64)
    w = np.concatenate([x.reshape(-1) for x in want]).astype(np.int64)
    diff = np.abs(g - w)
    return {"mean_abs_u8": float(diff.mean()),
            "share_off_u8": float(100.0 * (diff > OFF_U8).mean())}


def judge(cell: cells.Cell, seed: int, images: dict, device) -> tuple[bool, dict]:
    """(correct, {number: {"value", "limit"}}) of a run's images
    ({index: (H, W, 3) uint8})."""
    scene = reference_scene(cell, device)
    got, want = [], []
    for index, pixels in picks(cell, seed, sorted(images)):
        got.append(images[index].reshape(-1, 3)[pixels])
        want.append(reference_pixels(scene, seed, index, pixels, device))
    vals = numbers(got, want)
    limits = cell.spec["check"]["limits"]
    out = {k: {"value": vals[k], "limit": float(limits[k])} for k in NUMBERS}
    return all(v["value"] <= v["limit"] for v in out.values()), out
