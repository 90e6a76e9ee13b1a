"""Config 4 (or config 5) end to end through render_to_image (mirrors the
JAX package's tools/bench_config4_e2e.py).

    python -m cs397raytracingsp22_tpu_torch.tools.bench_config4_e2e [SPP] [PIXEL_CHUNK]
        [--scene config4|config5] [--asset-dir D] [--device cpu]

config4: scenes/textured_spheres.py at 512² × SPP (32 by default, the
spec), depth 8, lens radius 0.08; config5: scenes/drone_demo.py at 1024² ×
SPP (64 by default; the spec is 1000), depth 10. Both on their stand-in
assets unless `--asset-dir` names the real ones. One cold render (the
kernels' first load, the allocator's warm-up), then two warm ones, each
image equal to the cold one bit for bit (or the tool fails); prints each
run's stats and one JSON line: the least warm wall time, the Mrays/s of
segments over it and over the steady window (the chunks after the
first), the chunks and the card's name.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

SCENES = {
    # name: (scene module, width = height, default spp)
    "config4": ("textured_spheres", 512, 32),
    "config5": ("drone_demo", 1024, 64),
}


def build(scene: str, spp: int | None = None, asset_dir: str | None = None, width: int | None = None):
    import importlib

    mod, w, default_spp = SCENES[scene]
    w = width or w
    return importlib.import_module(f"cs397raytracingsp22_tpu_torch.scenes.{mod}").build(
        width=w, height=w, spp=spp or default_spp, asset_dir=asset_dir)


def run(scene: str = "config4", spp: int | None = None, pixel_chunk: int | None = None,
        asset_dir: str | None = None, device="cuda", width: int | None = None,
        verbose: bool = True) -> dict:
    """Cold render, two warm ones; returns the JSON line's fields."""
    import torch

    from cs397raytracingsp22_tpu_torch.render.driver import render_to_image

    sc = build(scene, spp, asset_dir, width)
    data = sc.compile(device=device)

    def render():
        return render_to_image(sc, device=device, seed=0, verbose=False, scene_data=data,
                               pixel_chunk=pixel_chunk)

    img0, st0 = render()
    if verbose:
        print(f"cold: {st0.summary()}", flush=True)
    warm = []
    for i in range(2):
        img, st = render()
        if not np.array_equal(img, img0):
            raise AssertionError(f"warm render {i} differs from the cold one")
        warm.append(st)
        if verbose:
            print(f"warm{i}: wall {st.wall_seconds:.4f}s segs {st.path_segments} "
                  f"{st.path_segments / st.wall_seconds / 1e6:.2f} Mrays/s "
                  f"(steady {st.segment_mrays_per_sec:.2f})", flush=True)
    best = min(warm, key=lambda s: s.wall_seconds)
    cam = sc.camera
    out = dict(metric=f"{scene}_e2e_mrays", width=cam.screen_width, spp=cam.aa_sample_count,
               depth=cam.path_depth, stand_ins=asset_dir is None, chunks=best.chunks,
               cold_s=st0.wall_seconds, wall_s=best.wall_seconds,
               segments=best.path_segments,
               mrays_whole_wall=best.path_segments / best.wall_seconds / 1e6,
               mrays_steady=best.segment_mrays_per_sec,
               nonfinite_pixels=best.nonfinite_pixels,
               device=(torch.cuda.get_device_name(0) if torch.device(device).type == "cuda"
                       else "cpu"))
    if verbose:
        print(json.dumps(out), flush=True)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("spp", nargs="?", type=int)
    p.add_argument("pixel_chunk", nargs="?", type=int)
    p.add_argument("--scene", choices=sorted(SCENES), default="config4")
    p.add_argument("--asset-dir")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    run(args.scene, args.spp, args.pixel_chunk, args.asset_dir, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
