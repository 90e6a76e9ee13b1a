"""Issue-rate probe P1 on the card: straight-line chains of FP32 FMAs,
FP32 multiplies, INT32 ALU ops, or FP32 and INT32 interleaved.

The port of the JAX package's tools/vpu_peak.py, with its arguments and
printed lines. Each thread of csrc/vpu_peak.cu (one an element of a
131,072 × 128 float32 array, all 0.3) runs 8 independent chains of
`unroll` straight-line steps:

  fma   v = v*v + 0.4               one FMA a step (the scans' float mix)
  mul   v = v*v                     one multiply
  i32   v = (v & 0x7FFFFFF1) + 12345   two integer ops
  both  4 chains of fma and 4 of (v ^ 0x5A5A5A5) + 12345: whether float
        and integer ops overlap (a rate above both the fma and the i32
        rate) or share one limit

and reports lane-ops/s (an FMA is one lane-op; TFLOP/s are twice the fma
rate). Each mix runs at unroll // 4 and at unroll; the slope between the
two (the marginal rate) removes the fixed cost of a launch and of moving
x and out. Times are CUDA events over `reps` launches after a warm one.
A straight-line body at unroll 1024 is ~8,200 instructions, more than the
instruction caches hold; compare it with the looped body of
tools/vpu_peak_shape.py.

    python -m cs397raytracingsp22_tpu_torch.tools.vpu_peak [unroll] [reps] [mixes]

unroll: 1024 (default; the kernel is built for unrolls 4, 12, 256 and
1024, and the tool needs unroll and unroll // 4); reps: 10 (default);
mixes: fma,i32,both (default), or any of fma, mul, i32, both.
"""

from __future__ import annotations

import sys

import torch

from cs397raytracingsp22_tpu_torch.models.scene import resolve_device
from cs397raytracingsp22_tpu_torch.ops.kernels import vpu_peak
from cs397raytracingsp22_tpu_torch.tools import timing

ROWS, LANES = 64, 128
N_ROWS = 2048 * ROWS  # 16,777,216 elements


def lane_ops(mix: str, unroll: int, n: int) -> int:
    """Lane-ops of one launch over n elements: fma and mul 1 a chain and
    step, i32 2 (and, add), both 12 a step across its 8 chains."""
    per_step = {"fma": 8, "mul": 8, "i32": 16, "both": 12}[mix]
    return n * per_step * unroll


def run(mix: str, unroll: int, reps: int = 10, device="cuda", n_rows: int = N_ROWS):
    """Time one mix at one unroll; returns (seconds a launch, lane-ops a
    launch). device="cpu" runs the plain version at n_rows × 128."""
    device = resolve_device(device)
    x = torch.full((n_rows, LANES), 0.3, dtype=torch.float32, device=device)
    wall = timing.seconds(lambda: vpu_peak.chain_cuda(x, mix, unroll), reps, device)
    ops = lane_ops(mix, unroll, x.numel())
    print(f"{mix:4s} unroll={unroll:5d} wall={wall*1e3:8.2f} ms  lane-ops={ops/1e9:7.2f}G  "
          f"-> {ops/wall/1e12:.3f} Tops/s", flush=True)
    return wall, ops


def marginal(mix: str, unroll: int, reps: int = 10, device="cuda", n_rows: int = N_ROWS):
    """run() at unroll // 4 and unroll; returns (marginal lane-ops/s, the
    two (seconds, lane-ops) pairs)."""
    w1, o1 = run(mix, unroll // 4, reps, device, n_rows)
    w2, o2 = run(mix, unroll, reps, device, n_rows)
    rate = (o2 - o1) / (w2 - w1)
    print(f"{mix:4s} marginal issue rate: {rate/1e12:.3f} Tops/s", flush=True)
    return rate, (w1, o1), (w2, o2)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    unroll = int(argv[0]) if len(argv) > 0 else 1024
    reps = int(argv[1]) if len(argv) > 1 else 10
    mixes = argv[2].split(",") if len(argv) > 2 else ("fma", "i32", "both")
    device = resolve_device("cuda")
    print(f"device: {timing.nvidia_smi()} ({timing.clock_label(device)})", flush=True)
    for mix in mixes:
        marginal(mix, unroll, reps, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
