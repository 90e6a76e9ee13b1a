"""The control of `correct`: the reference in bfloat16 in the renderer's place.

    python3 -m benchmark.control --workload <cell> --seeds <n> [<n> ...] [--pixels P]

For each seed it takes the pixel sample a run of that seed would compare
(benchmark/check.py, over images 0 .. images - 1 of the cell's check),
renders it with the plain reference twice, in float32 (the
configuration's precision) and in bfloat16 (the nearest precision below),
and prints the compared numbers of the bfloat16 pixels against the
float32 ones, one JSON line a seed. A limit has to sit below what this
reads: a run whose numbers reach it is not correct. The benchmark's own
runs never run it; it runs on the chip at the cell's own size, and at a
small size in benchmark/tests.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from benchmark import cells, check


def control(cell, seed: int, device) -> dict:
    """The compared numbers of the bfloat16 reference against the float32
    one on the pixel sample of a run of `seed`."""
    exact = check.reference_scene(cell, device)
    low = check.reference_scene(cell, device, torch.bfloat16)
    got, want = [], []
    for index, pixels in check.picks(cell, seed, list(range(cell.spec["check"]["images"]))):
        want.append(check.reference_pixels(exact, seed, index, pixels, device))
        got.append(check.reference_pixels(low, seed, index, pixels, device))
    return check.numbers(got, want)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: needs a CUDA device", file=sys.stderr)
        return 2
    cell = cells.load_cell(args.workload)
    for seed in args.seeds:
        print(json.dumps({"workload": args.workload, "seed": seed,
                          **control(cell, seed, torch.device("cuda", 0))}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
