"""Issue-rate probe P2 on the card: the FMA rate against the size of a
loop body.

The port of the JAX package's tools/vpu_peak_shape.py, with its printed
lines. Each thread of csrc/vpu_peak.cu (one an element of 131,072 × 128
floats) runs a `#pragma unroll 1` loop of `steps` iterations whose body
holds u rounds of 8 independent `v = v*v + 0.4` FMAs; every pair does the
same 8 × 4,096 FMAs an element, so the rates show what the loop's own
instructions and the body's size cost. Times are CUDA events over 10
launches after a warm one.

    python -m cs397raytracingsp22_tpu_torch.tools.vpu_peak_shape
"""

from __future__ import annotations

import sys

import torch

from cs397raytracingsp22_tpu_torch.models.scene import resolve_device
from cs397raytracingsp22_tpu_torch.ops.kernels import vpu_peak
from cs397raytracingsp22_tpu_torch.tools import timing

ROWS, LANES, CHAINS = 64, 128, 8
N_ROWS = 2048 * ROWS
# (rounds a body, iterations): 8 × 4,096 FMAs an element in each
PAIRS = ((1, 4096), (8, 512), (48, 85), (176, 23), (512, 8))


def run(u: int, steps: int, reps: int = 10, device="cuda", n_rows: int = N_ROWS):
    """Time one body size; returns (seconds a launch, FMAs a launch).
    device="cpu" runs the plain version at n_rows × 128."""
    device = resolve_device(device)
    x = torch.full((n_rows, LANES), 0.3, dtype=torch.float32, device=device)
    wall = timing.seconds(lambda: vpu_peak.looped_cuda(x, u, steps), reps, device)
    ops = x.numel() * CHAINS * u * steps
    print(f"body={CHAINS*u:5d} FMAs x {steps:4d} iters: {wall*1e3:7.2f} ms -> "
          f"{ops/wall/1e12:.3f} T FMA/s", flush=True)
    return wall, ops


def main(argv=None) -> int:
    device = resolve_device("cuda")
    print(f"device: {timing.nvidia_smi()} ({timing.clock_label(device)})", flush=True)
    for u, steps in PAIRS:
        run(u, steps, device=device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
