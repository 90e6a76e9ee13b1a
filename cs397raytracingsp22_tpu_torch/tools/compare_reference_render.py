"""Config 5's region means against a reference render of the demo scene
(mirrors the JAX package's tools/compare_reference_render.py).

The demo scene (tracing.rs:354-548) has no bit-exact ground truth: the
reference renders it with an ambient RNG. What compares is the mean
brightness of regions of the frame: the 15-sphere grid, the emissive
sphere, the magenta mesh sphere, the green cube, the glass and subsurface
corner and a floor strip. An estimator-convention fault (a pdf factor,
emission counted twice, a gamma) moves them by tens of u8.

    python -m cs397raytracingsp22_tpu_torch.tools.compare_reference_render [IMAGE]
        [--reference REF] [--render W SPP [--seed S] [--no-meshes | --asset-dir D]
        [--out PNG]] [--regions a,b,c] [--device cpu]

IMAGE (or, with `--render W SPP`, config 5 rendered at W² × SPP, depth 10,
seed S (0), on the card first; `--asset-dir` names the meshes and maps,
the stand-ins of scenes/drone_demo.py otherwise; `--no-meshes` renders the
analytic part alone) is held to REF, by default the JAX
package's full-spec render artifacts/config5_demo_1024_1000spp_tpu.png
(the reference's own render.png is not in the repository). `--regions`
gates only the regions named; the others are printed. Exits 1 when a gated
region is beyond its tolerance.

On the stand-ins, `magenta_sphere` and `green_cube` hold stand-in meshes
and maps, and `right_floor` takes the drone's spill: a render on the
stand-ins or without meshes (`--render` without `--asset-dir`) is gated on `sphere_grid`,
`cyan_emitter` and `glass_area` (STAND_IN_GATE) unless `--regions` says
otherwise; any other image on every region.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DEFAULT_REFERENCE = os.path.join(ROOT, "artifacts", "config5_demo_1024_1000spp_tpu.png")

# fractional (x0, x1, y0, y1) regions of the demo frame, away from the drone
REGIONS = {
    "sphere_grid":    (0.12, 0.86, 0.02, 0.40),
    "cyan_emitter":   (0.82, 0.99, 0.42, 0.58),
    "magenta_sphere": (0.72, 0.99, 0.66, 0.97),
    "green_cube":     (0.00, 0.26, 0.70, 1.00),
    "glass_area":     (0.00, 0.18, 0.40, 0.62),
    "right_floor":    (0.78, 1.00, 0.58, 0.66),
}

# the largest channel's |difference| of the region means (u8) that passes;
# right_floor has more room for the drone's emission map's spill
TOLERANCE = {k: 6.0 for k in REGIONS}
TOLERANCE["right_floor"] = 8.0

# the regions that stand-in assets leave as the reference has them
STAND_IN_GATE = ("sphere_grid", "cyan_emitter", "glass_area")


def region_means(img: np.ndarray) -> dict:
    img = img.astype(np.float64)
    h, w, _ = img.shape
    return {
        k: img[int(y0 * h):int(y1 * h), int(x0 * w):int(x1 * w)].mean(axis=(0, 1))
        for k, (x0, x1, y0, y1) in REGIONS.items()
    }


def compare(img: np.ndarray, ref_img: np.ndarray, gate=None, verbose: bool = True) -> dict:
    """img against ref_img, region by region: {region: (ref mean, img mean,
    largest channel |delta|, within tolerance, gated)}. gate: the regions
    whose tolerance counts (all when None). The two images may differ in
    size: the regions are fractions of the frame."""
    gate = set(REGIONS if gate is None else gate)
    unknown = gate - set(REGIONS)
    if unknown:
        raise ValueError(f"unknown regions {sorted(unknown)}; known: {list(REGIONS)}")
    rstats, ostats = region_means(ref_img), region_means(img)
    out = {}
    for k in REGIONS:
        delta = float(np.max(np.abs(rstats[k] - ostats[k])))
        ok = delta <= TOLERANCE[k]
        out[k] = (rstats[k], ostats[k], delta, ok, k in gate)
        if verbose:
            mark = ("ok " if ok else "FAIL") if k in gate else "info"
            print(f"[{mark}] {k:15s} ref={np.round(rstats[k], 1)} ours={np.round(ostats[k], 1)} "
                  f"maxdelta={delta:.2f} (tol {TOLERANCE[k]})")
    return out


def passed(results: dict) -> bool:
    return all(ok for *_, ok, gated in results.values() if gated)


def load_png(path: str) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("image", nargs="?", help="the image to hold to the reference")
    p.add_argument("--reference", default=DEFAULT_REFERENCE)
    p.add_argument("--render", nargs=2, type=int, metavar=("W", "SPP"),
                   help="render config 5 at W² x SPP, depth 10, first")
    p.add_argument("--seed", type=int, default=0, help="the render's seed")
    p.add_argument("--no-meshes", action="store_true", help="render the analytic part alone")
    p.add_argument("--asset-dir", help="config 5's obj/ and texture/ (default: the stand-ins)")
    p.add_argument("--out", default=os.path.join(ROOT, "build", "compare_reference_render.png"),
                   help="where --render writes its image")
    p.add_argument("--regions", help="comma-separated regions to gate (default: all)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if args.render:
        from cs397raytracingsp22_tpu_torch.render.driver import render_to_image, save_png
        from cs397raytracingsp22_tpu_torch.scenes import drone_demo

        w, spp = args.render
        scene = drone_demo.build(width=w, height=w, spp=spp, asset_dir=args.asset_dir,
                                 include_meshes=not args.no_meshes)
        img, stats = render_to_image(scene, device=args.device, seed=args.seed, verbose=True)
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        save_png(img, args.out)
        print(f"[compare] rendered {args.out}: {stats.summary()}")
    elif args.image:
        img = load_png(args.image)
    else:
        p.error("give an IMAGE or --render W SPP")
    print(f"[compare] against {args.reference}")
    gate = args.regions.split(",") if args.regions else None
    if gate is None and args.render and not args.asset_dir:
        gate = STAND_IN_GATE
    print(f"[compare] gated: {', '.join(gate or REGIONS)}")
    return 0 if passed(compare(img, load_png(args.reference), gate)) else 1


if __name__ == "__main__":
    sys.exit(main())
