"""Table-load probe P3 on the card: what a uniform table load costs inside
an FMA chain, from each of the three places such a table can live.

The port of the JAX package's tools/vpu_peak_smem.py, with its printed
lines. Each thread of csrc/vpu_peak.cu (one an element of 131,072 × 128
floats) runs 512 loop steps of 8 chains `v = v*v + c`. The control has c =
0.4; the others read a fresh c = coefs[step * 8 + chain] from a 4,096-float
table, the same address across the warp, held in shared memory (staged
once a 1,024-thread block, as K1 and K2 keep their scene tables), in
__constant__ memory, or in device memory read through the read-only cache
(`__ldg`, as K3 and K5 read their rows). The time above the control,
divided by the one load an FMA, is the load's cost in FMA issue slots.
Times are CUDA events over 10 launches after a warm one.

    python -m cs397raytracingsp22_tpu_torch.tools.vpu_peak_smem
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from cs397raytracingsp22_tpu_torch.models.scene import resolve_device
from cs397raytracingsp22_tpu_torch.ops.kernels import vpu_peak
from cs397raytracingsp22_tpu_torch.tools import timing

ROWS, LANES, CHAINS = 64, 128, 8
N_ROWS = 2048 * ROWS
STEPS = 512
MEMORIES = ("shared", "constant", "ldg")


def coefficients(device) -> torch.Tensor:
    """The tool's table: 4,096 uniform floats in [0, 1) from numpy seed 0."""
    table = np.random.default_rng(0).random(STEPS * CHAINS, dtype=np.float32)
    return torch.from_numpy(table).to(device)


def run(memory: str, reps: int = 10, device="cuda", n_rows: int = N_ROWS, steps: int = STEPS):
    """Time the chains with the addend from `memory` ("const": the control);
    returns seconds a launch. device="cpu" runs the plain version at
    n_rows × 128."""
    device = resolve_device(device)
    x = torch.full((n_rows, LANES), 0.3, dtype=torch.float32, device=device)
    coefs = coefficients(device)
    wall = timing.seconds(lambda: vpu_peak.table_cuda(x, coefs, steps, memory), reps, device)
    ops = x.numel() * CHAINS * steps
    tag = "fma only (fori)" if memory == "const" else f"fma+{memory}-load"
    print(f"{tag}: wall={wall*1e3:7.2f} ms -> {ops/wall/1e12:.3f} T FMA/s", flush=True)
    return wall


def main(argv=None) -> int:
    device = resolve_device("cuda")
    print(f"device: {timing.nvidia_smi()} ({timing.clock_label(device)})", flush=True)
    w0 = run("const", device=device)
    for memory in MEMORIES:
        w1 = run(memory, device=device)
        print(f"{memory} load cost: {(w1-w0)/w0*100:.1f}% -> per-load slot cost ≈ "
              f"{(w1/w0-1):.2f} of an FMA slot", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
