"""Time whole frames of this checkout against other checkouts of the
package, on the card: the check for a change to the driver, or to the glue
of the staged, NEE, Phong or textured paths (the host code around K1, K2
and K3), that should leave their speed as it was.

    python -m cs397raytracingsp22_tpu_torch.tools.compare_frames OTHER_ROOT [OTHER_ROOT ...]

Each OTHER_ROOT is the root of another checkout (for example a parent
commit unpacked with `git archive <commit> | tar -x -C build/parent`).
Each checkout renders in a process of its own, which runs this file and
imports the package from that root, in turns: the others, this one, this
one, the others (`--rounds` times). `--frames` picks frames of FRAMES,
`--size` and `--spp` shrink them and `--device cpu` runs the plain
versions, for a rehearsal without the card.
A process renders each frame through render_to_image (seed 0, not
verbose) once to warm up, then `--reps` times (2 by default), and prints a
JSON line a frame: the seconds of each image, segments, chunks and the
image's u8 mean. Then the table, with the card's nvidia-smi name and power
limit: for each frame and checkout the mean, median and least seconds per
image over all its turns, and this checkout's median and least over each
other's. The host noise of a shared machine only ever adds time, so the
least of many images is the steadiest figure of what the code costs.

`--frames k2host` (not in the default set) times the host side of the
scene-intersection wrapper instead of a frame: K2_CALLS calls of
`scene_intersect_cuda` on 1,024 camera rays of the bench scene, then one
wait for the card; its "seconds" are those of K2_CALLS calls, a figure
that the NEE, Phong and config-4 frames (host-bound) pay 240, 32 and 64
calls of an image.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import subprocess
import sys

# frame → (scene module, build kwargs, NEE)
FRAMES = {
    "bench": ("bench_scene", dict(width=512, height=512, spp=64, path_depth=8), False),
    "32k": ("bench_teapot_32k", dict(width=512, height=512, spp=64, path_depth=8), False),
    "phong": ("teapot", dict(width=512, height=512, spp=64), False),
    "nee": ("bench_scene", dict(width=512, height=512, spp=64, path_depth=8), True),
    "config4": ("textured_spheres", dict(width=512, height=512, spp=32), False),
}
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
K2_CALLS = 1000


def k2_host(device: str, reps: int) -> dict:
    """The "k2host" line: the seconds of K2_CALLS wrapper calls, reps times."""
    import time

    import torch

    from cs397raytracingsp22_tpu_torch.ops.kernels import scene_intersect
    from cs397raytracingsp22_tpu_torch.render import driver, integrator
    from cs397raytracingsp22_tpu_torch.scenes import bench_scene

    sc = bench_scene.build(32, 32, spp=1, path_depth=8)
    sd = sc.compile(device=device)
    o, d, _ = driver._gen_chunk_rays(sc.camera, torch.arange(1024, dtype=torch.int32,
                                                             device=device), 0, 0, 1, 1)
    ins = (o.contiguous(), d.contiguous(),
           torch.full((1024,), integrator.PATH_T_MIN, device=device),
           torch.full((1024,), 100.0, device=device),
           torch.full((1024, max(1, sd.n_volumes)), 0.5, device=device))
    wait = torch.cuda.synchronize if device != "cpu" else (lambda: None)
    scene_intersect.scene_intersect_cuda(sd, *ins)
    wait()
    seconds = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(K2_CALLS):
            scene_intersect.scene_intersect_cuda(sd, *ins)
        wait()
        seconds.append(time.perf_counter() - t0)
    return dict(frame="k2host", seconds=seconds, segments=0, chunks=K2_CALLS, u8_mean=0.0)


def child(device: str, frames: list, reps: int, size: int | None, spp: int | None) -> None:
    """Render each frame on `device`, one JSON line a frame."""
    import importlib

    from cs397raytracingsp22_tpu_torch.render import driver

    for name in frames:
        if name == "k2host":
            print(json.dumps(k2_host(device, reps)), flush=True)
            continue
        module, kw, nee = FRAMES[name]
        kw = dict(kw, **({"width": size, "height": size} if size else {}),
                  **({"spp": spp} if spp else {}))
        scenes = importlib.import_module("cs397raytracingsp22_tpu_torch.scenes." + module)
        scene = scenes.build(**kw)
        if nee:
            scene = dataclasses.replace(scene, camera=dataclasses.replace(scene.camera, nee=True))
        data = scene.compile(device=device)
        render = lambda: driver.render_to_image(  # noqa: E731
            scene, device=device, seed=0, verbose=False, scene_data=data)
        render()  # warm
        runs = [render() for _ in range(reps)]
        img, st = runs[0]
        print(json.dumps(dict(frame=name, seconds=[s.wall_seconds for _, s in runs],
                              segments=st.path_segments, chunks=st.chunks,
                              u8_mean=float(img.mean()))), flush=True)


def run_in(root: str, args) -> list[dict]:
    """child() in a process that runs this file and imports the package
    from root."""
    cmd = [sys.executable, os.path.abspath(__file__), "--child", root, "--device", args.device,
           "--frames", ",".join(args.frames), "--reps", str(args.reps)]
    cmd += ["--size", str(args.size)] if args.size else []
    cmd += ["--spp", str(args.spp)] if args.spp else []
    out = subprocess.run(cmd, cwd=root, capture_output=True, text=True)
    if out.returncode:
        raise RuntimeError(f"the frames of {root} failed:\n{out.stderr[-4000:]}")
    return [json.loads(line) for line in out.stdout.splitlines() if line.startswith("{")]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("others", nargs="*", help="roots of other checkouts")
    p.add_argument("--device", default="cuda")
    p.add_argument("--size", type=int, help="width and height of every frame")
    p.add_argument("--spp", type=int)
    p.add_argument("--frames", type=lambda x: x.split(","), default=list(FRAMES),
                   help="comma-separated frames of FRAMES (default: all)")
    p.add_argument("--reps", type=int, default=2, help="timed images a frame and process")
    p.add_argument("--rounds", type=int, default=1, help="rounds of turns")
    p.add_argument("--child", help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.child:  # the package of that root renders
        sys.path.insert(0, args.child)
        child(args.device, args.frames, args.reps, args.size, args.spp)
        return 0
    roots = [os.path.abspath(r) for r in args.others]
    turns = (roots + [ROOT, ROOT] + roots) * args.rounds
    results: dict = {}
    for root in turns:
        label = "this checkout" if root == ROOT else root
        for line in run_in(root, args):
            print(f"[compare-frames] {label}: {json.dumps(line)}", flush=True)
            results.setdefault(line["frame"], {}).setdefault(label, []).extend(line["seconds"])
    if args.device != "cpu":
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True).stdout.strip()
        print(f"[compare-frames] {smi}")
    for frame, by_label in results.items():
        mine = by_label.get("this checkout", [])
        for label, secs in by_label.items():
            line = (f"[compare-frames] {frame}: {label}: {len(secs)} images, mean "
                    f"{statistics.mean(secs):.4f}, median {statistics.median(secs):.4f}, least "
                    f"{min(secs):.4f} s an image")
            if label != "this checkout" and mine:
                line += (f"; this checkout ÷ it: median "
                         f"{statistics.median(mine) / statistics.median(secs):.4f}x, least "
                         f"{min(mine) / min(secs):.4f}x")
            print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
