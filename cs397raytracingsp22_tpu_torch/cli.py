"""Command-line renderer for the port:

    python -m cs397raytracingsp22_tpu_torch.cli [scene.py] -o out.png

A scene is any Python file exposing `build(**overrides) -> Scene` that
builds with this package; without one, the bench scene with its
32,832-triangle teapot (scenes/bench_teapot_32k.py) renders. Renders on
the GPU by default; `--device cpu` runs the plain torch version. A scene
shades as its camera says (path tracing, or Phong shading with hard
shadows); `--nee` turns on next-event estimation (render/nee.py);
`--checkpoint PATH` keeps the HDR accumulator in PATH after every spp
chunk (`--spp-chunk`) and resumes from it. Options of the JAX CLI that the
port does not have yet raise a clear error instead of being ignored.
"""

from __future__ import annotations

import argparse
import ast
import dataclasses
import importlib.util
import json
import os
import sys

DEFAULT_SCENE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "scenes",
                             "bench_teapot_32k.py")

_NOT_PORTED = {
    "mesh": "--mesh (multi-device rendering)",
    "distributed": "--distributed (multi-host rendering)",
}


def load_scene_module(path: str):
    spec = importlib.util.spec_from_file_location("user_scene", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    if not hasattr(mod, "build"):
        raise SystemExit(f"{path} must define build(**overrides) -> Scene")
    return mod


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="PyTorch + CUDA path tracer")
    p.add_argument("scene", nargs="?", default=DEFAULT_SCENE,
                   help="scene script exposing build(**overrides) (default: %(default)s)")
    p.add_argument("-o", "--output", default="render.png")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--width", type=int)
    p.add_argument("--height", type=int)
    p.add_argument("--spp", type=int)
    p.add_argument("--depth", type=int, help="path depth (bounces)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--stats-json", help="write render stats to this path")
    p.add_argument(
        "--set", action="append", default=[], metavar="KEY=VALUE", dest="set_overrides",
        help="extra build(**overrides) kwarg, repeatable; VALUE is parsed as a "
        "Python literal, else kept as a string",
    )
    p.add_argument("--checkpoint", help="HDR accumulator checkpoint (.npz) for resume")
    p.add_argument("--spp-chunk", type=int, help="samples per accumulation (and checkpoint) chunk")
    p.add_argument("--nee", action="store_true",
                   help="next-event estimation (explicit light sampling): the same converged "
                   "image at equal depth, less noise on small-light scenes (render/nee.py)")
    p.add_argument("--mesh", help="not ported yet")
    p.add_argument("--distributed", action="store_true", help="not ported yet")
    p.add_argument("-q", "--quiet", action="store_true")
    args = p.parse_args(argv)

    for key, what in _NOT_PORTED.items():
        if getattr(args, key):
            raise SystemExit(f"{what} is not ported to the torch package yet")

    overrides = {}
    for key in ("width", "height", "spp"):
        if getattr(args, key):
            overrides[key] = getattr(args, key)
    if args.depth:
        overrides["path_depth"] = args.depth
    for kv in args.set_overrides:
        key, eq, value = kv.partition("=")
        if not eq or not key:
            raise SystemExit(f"--set expects KEY=VALUE, got {kv!r}")
        try:
            overrides[key] = ast.literal_eval(value)
        except (ValueError, SyntaxError):
            overrides[key] = value

    scene = load_scene_module(args.scene).build(**overrides)
    if args.nee:
        scene = dataclasses.replace(scene, camera=dataclasses.replace(scene.camera, nee=True))

    from cs397raytracingsp22_tpu_torch.render.driver import render_and_save

    _, stats = render_and_save(scene, args.output, device=args.device, seed=args.seed,
                               spp_chunk=args.spp_chunk, checkpoint_path=args.checkpoint,
                               verbose=not args.quiet)
    if not args.quiet:
        print(f"[cli] wrote {args.output}")
    if args.stats_json:
        with open(args.stats_json, "w") as f:
            json.dump(
                {
                    "width": stats.width,
                    "height": stats.height,
                    "spp": stats.spp,
                    "path_depth": stats.path_depth,
                    "device": stats.device,
                    "wall_seconds": stats.wall_seconds,
                    "primary_rays": stats.primary_rays,
                    "path_segments": stats.path_segments,
                    "primary_mrays_per_sec": stats.primary_mrays_per_sec,
                    "segment_mrays_per_sec": stats.segment_mrays_per_sec,
                },
                f,
                indent=2,
            )
    return 0


if __name__ == "__main__":
    sys.exit(main())
