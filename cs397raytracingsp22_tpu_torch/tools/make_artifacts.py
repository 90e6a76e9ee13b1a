"""Render the repository's artifact recipes with the port (mirrors the JAX
package's tools/make_artifacts.py) and hold each image to the committed
JAX render of the same recipe.

    python -m cs397raytracingsp22_tpu_torch.tools.make_artifacts [NAME ...]
        [--out-dir DIR] [--asset-dir D] [--device cpu]

One recipe a file (scene builder, resolution, spp; seed 0), named as the
JAX recipe with `_tpu` turned into `_h100`. Without names every recipe but
DEFAULT_SKIP renders (the full-spec config 4 and config 5 are opt-in by
name). Images go to `--out-dir` (build/artifacts/ by default), never into
artifacts/, whose `_tpu.png` files are the JAX package's renders: an
output directory inside it is refused.

For each image the tool prints the render's stats and its agreement with
the committed `<recipe>_tpu.png`: the share of subpixels within 1 u8 and
the mean |diff| (images are a pure function of scene and seed, so the two
packages' renders of the same inputs agree to rounding). Configs 4 and 5
render their stand-in assets unless `--asset-dir` names the real ones
(obj/ and texture/ of the reference checkout); on the stand-ins the
inputs differ from the JAX render's and the tool says so instead. The
bench frame's JAX recipe reads its teapot from the reference checkout
(240 triangles) where the port's pins assets/teapot_6k.obj; its agreement
is printed with that note. `run(overrides=...)` renders every recipe at
another size, for a rehearsal on the CPU.
"""

from __future__ import annotations

import argparse
import importlib
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
ARTIFACTS = os.path.join(ROOT, "artifacts")
DEFAULT_OUT = os.path.join(ROOT, "build", "artifacts")
_SCENES = "cs397raytracingsp22_tpu_torch.scenes."

RECIPES = {
    # name: (scene module, builder, kwargs)
    "config1_cornell_h100.png": ("cornell", "build", dict(width=256, height=256, spp=16)),
    "config2_teapot_phong_h100.png": ("teapot", "build", dict(width=256, height=256)),
    "config3_metal_glass_h100.png": ("cornell", "build_config3",
                                     dict(width=256, height=256, spp=64)),
    "config3_metal_glass_512_h100.png": ("cornell", "build_config3",
                                         dict(width=512, height=512, spp=64)),
    "config4_textured_h100.png": ("textured_spheres", "build", dict(width=256, height=256, spp=32)),
    "config5_demo_h100.png": ("drone_demo", "build", dict(width=128, height=128, spp=16)),
    "bench_cornell_teapot_512_h100.png": ("bench_scene", "build",
                                          dict(width=512, height=512, spp=64)),
    # BASELINE config 5 at its spec: 1024² x 1000 spp, depth 10 (opt-in)
    "config5_demo_1024_1000spp_h100.png": ("drone_demo", "build",
                                           dict(width=1024, height=1024, spp=1000)),
    # BASELINE config 4 at its spec resolution (opt-in)
    "config4_textured_512_h100.png": ("textured_spheres", "build",
                                      dict(width=512, height=512, spp=64)),
}

DEFAULT_SKIP = {"config5_demo_1024_1000spp_h100.png", "config4_textured_512_h100.png"}

# the scenes whose meshes and maps come from asset_dir (stand-ins without one)
ASSET_SCENES = ("textured_spheres", "drone_demo")
BENCH_NOTE = ("the JAX recipe's teapot is the reference checkout's teapot.obj (240 triangles), "
              "the port's assets/teapot_6k.obj")


def committed(name: str) -> str:
    """The committed JAX render of recipe `name`."""
    return os.path.join(ARTIFACTS, name.replace("_h100.png", "_tpu.png"))


def agreement(img: np.ndarray, ref: np.ndarray) -> dict:
    """Share of subpixels within 1 u8 and mean |diff| of two u8 images."""
    if img.shape != ref.shape:
        return dict(shape=img.shape, ref_shape=ref.shape)
    diff = np.abs(img.astype(np.int32) - ref.astype(np.int32))
    return dict(within_1=float((diff <= 1).mean()), mean_abs=float(diff.mean()),
                max_abs=int(diff.max()))


def build_scene(name: str, asset_dir: str | None = None, overrides: dict | None = None):
    mod, fn, kwargs = RECIPES[name]
    kwargs = dict(kwargs, **(overrides or {}))
    if mod in ASSET_SCENES:
        kwargs["asset_dir"] = asset_dir
    return getattr(importlib.import_module(_SCENES + mod), fn)(**kwargs)


def check_out_dir(out_dir: str) -> str:
    """out_dir, made; refused inside artifacts/ (the JAX package's renders)."""
    real, arts = os.path.realpath(out_dir), os.path.realpath(ARTIFACTS)
    if real == arts or real.startswith(arts + os.sep):
        raise ValueError(f"{out_dir} is inside {ARTIFACTS}, which holds the JAX package's "
                         "committed renders; write the port's elsewhere")
    os.makedirs(out_dir, exist_ok=True)
    return out_dir


def run(names=None, out_dir: str = DEFAULT_OUT, device="cuda", asset_dir: str | None = None,
        overrides: dict | None = None, verbose: bool = True) -> dict:
    """Render each recipe into out_dir; returns {name: {"path", "stats",
    "agreement" or "inputs_differ", "note"}}."""
    from PIL import Image

    from cs397raytracingsp22_tpu_torch.render.driver import render_to_image, save_png

    names = list(names or [n for n in RECIPES if n not in DEFAULT_SKIP])
    unknown = [n for n in names if n not in RECIPES]
    if unknown:
        raise ValueError(f"unknown recipes {unknown}; known: {list(RECIPES)}")
    check_out_dir(out_dir)
    out = {}
    for name in names:
        scene = build_scene(name, asset_dir, overrides)
        img, stats = render_to_image(scene, device=device, seed=0, verbose=False)
        path = os.path.join(out_dir, name)
        save_png(img, path)
        row = dict(path=path, stats=stats, note=None)
        stand_in = RECIPES[name][0] in ASSET_SCENES and asset_dir is None
        if stand_in:
            row["inputs_differ"] = "rendered on stand-in assets; the JAX render used the real ones"
        elif os.path.exists(committed(name)):
            with Image.open(committed(name)) as im:
                row["agreement"] = agreement(img, np.asarray(im.convert("RGB")))
            if RECIPES[name][0] == "bench_scene":
                row["note"] = BENCH_NOTE
        else:
            row["inputs_differ"] = f"no committed {os.path.basename(committed(name))}"
        out[name] = row
        if verbose:
            print(f"{name}: {stats.summary()}; image mean {img.mean():.2f}; " + describe(row),
                  flush=True)
    return out


def describe(row: dict) -> str:
    if "inputs_differ" in row:
        return f"not compared: {row['inputs_differ']}"
    a = row["agreement"]
    if "within_1" not in a:
        return f"not compared: shape {a['shape']} against the committed {a['ref_shape']}"
    note = f" ({row['note']})" if row["note"] else ""
    return (f"against the committed JAX render: {a['within_1']:.4%} of subpixels within 1 u8, "
            f"mean |diff| {a['mean_abs']:.4f}, max {a['max_abs']}{note}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("names", nargs="*", help=f"recipes (default: all but {sorted(DEFAULT_SKIP)})")
    p.add_argument("--out-dir", default=DEFAULT_OUT)
    p.add_argument("--asset-dir", help="obj/ and texture/ of configs 4 and 5 (default: stand-ins)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    run(args.names, args.out_dir, args.device, args.asset_dir)
    return 0


if __name__ == "__main__":
    sys.exit(main())
