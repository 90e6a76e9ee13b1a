"""Time whole frames of this checkout against other checkouts of the
package, on the card: the check for a change to the glue of the staged,
NEE or Phong paths (the host code around K2 and K3) that should leave
their speed as it was.

    python -m cs397raytracingsp22_tpu_torch.tools.compare_frames OTHER_ROOT [OTHER_ROOT ...]

Each OTHER_ROOT is the root of another checkout (for example a parent
commit unpacked with `git archive <commit> | tar -x -C build/parent`).
Each checkout renders in a process of its own, which runs this file and
imports the package from that root, in turns: the others, this one, this
one, the others. `--size` and `--spp` shrink the frames and `--device
cpu` runs the plain versions, for a rehearsal without the card.
A process renders each frame of FRAMES through render_to_image (seed 0)
once to warm up, then twice, and prints a JSON line a frame: seconds per
image (the mean of the two), segments, chunks and the image's u8 mean.
Then the table: each checkout's mean seconds per frame over its turns,
with the card's nvidia-smi name and power limit.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys

# frame → (scene module, build kwargs, NEE)
FRAMES = {
    "32k": ("bench_teapot_32k", dict(width=512, height=512, spp=64, path_depth=8), False),
    "phong": ("teapot", dict(width=512, height=512, spp=64), False),
    "nee": ("bench_scene", dict(width=512, height=512, spp=64, path_depth=8), True),
}
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def child(device: str, size: int | None, spp: int | None) -> None:
    """Render each frame on `device`, one JSON line a frame."""
    import importlib

    from cs397raytracingsp22_tpu_torch.render import driver

    for name in FRAMES:
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
        runs = [render() for _ in range(2)]
        img, st = runs[0]
        print(json.dumps(dict(frame=name, seconds=sum(s.wall_seconds for _, s in runs) / 2,
                              segments=st.path_segments, chunks=st.chunks,
                              u8_mean=float(img.mean()))), flush=True)


def run_in(root: str, args) -> list[dict]:
    """child() in a process that runs this file and imports the package
    from root."""
    cmd = [sys.executable, os.path.abspath(__file__), "--child", root, "--device", args.device]
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
    p.add_argument("--child", help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.child:  # the package of that root renders
        sys.path.insert(0, args.child)
        child(args.device, args.size, args.spp)
        return 0
    roots = [os.path.abspath(r) for r in args.others]
    turns = roots + [ROOT, ROOT] + roots
    results: dict = {}
    for root in turns:
        label = "this checkout" if root == ROOT else root
        for line in run_in(root, args):
            print(f"[compare-frames] {label}: {json.dumps(line)}", flush=True)
            results.setdefault((label, line["frame"]), []).append(line["seconds"])
    if args.device != "cpu":
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True).stdout.strip()
        print(f"[compare-frames] {smi}")
    for (label, frame), secs in results.items():
        print(f"[compare-frames] {frame}: {label}: {sum(secs) / len(secs):.4f} s per image "
              f"(turns: {', '.join(f'{s:.4f}' for s in secs)})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
