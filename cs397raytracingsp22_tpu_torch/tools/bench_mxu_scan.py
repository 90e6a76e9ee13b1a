"""The Baldwin–Weber scan probe P5 on the card: the nearest hit of 256
triangles for 64 × 8,192 rays, on the SIMT cores against the tensor cores.

The port of the JAX package's tools/bench_mxu_scan.py, with its scene,
its parity line and its rates. Seed 0: 256 triangles of up to ±0.3 around
centres in [-1.5, 1.5]³, rays from [-3, 3]³ in normal directions. Both
kernels of csrc/bw_scan.cu return the packed min-key per ray:
  scalar  one thread a ray, the Baldwin–Weber rows in shared memory;
  mma     the six dot products of each (triangle, ray) pair as mma.sync
          m16n8k8 TF32 tiles, then the reject test and the min on the
          accumulators (t keeps 11 mantissa bits in the key).
Parity decodes each winner's t (the mma key's low 12 bits dropped) and
prints the hit agreement, the hit fraction and the p99 of t's relative
difference where both hit. Rates are CUDA events over 10 launches after a
warm one, in Mrays/s and Gtri-tests/s.

    python -m cs397raytracingsp22_tpu_torch.tools.bench_mxu_scan
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from cs397raytracingsp22_tpu_torch.models.scene import baldwin_weber_rows, resolve_device
from cs397raytracingsp22_tpu_torch.ops.kernels import bw_scan
from cs397raytracingsp22_tpu_torch.tools import timing

G = 256          # triangles
ROWS, LANES = 64, 128
N = ROWS * LANES  # rays a block of the JAX tool's grid
NBLK = 64


def scene(seed: int = 0, nblk: int = NBLK):
    """(tris (G, 3, 3), o (nblk·N, 3), d (nblk·N, 3)) numpy float32, drawn as
    the JAX tool draws them."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-1.5, 1.5, (G, 1, 3))
    tris = (centers + rng.uniform(-0.3, 0.3, (G, 3, 3))).astype(np.float32)
    o = rng.uniform(-3, 3, (nblk * N, 3)).astype(np.float32)
    d = rng.normal(size=(nblk * N, 3)).astype(np.float32)
    return tris, o, d


def inputs(device, seed: int = 0, nblk: int = NBLK) -> dict:
    """Both kernels' operands on `device`: bw (G, 12), lhs_o, lhs_d (3G, 4),
    o4, d4 (4, nblk·N)."""
    tris, o, d = scene(seed, nblk)
    bw = torch.from_numpy(baldwin_weber_rows(tris)).to(device)
    lhs_o, lhs_d = bw_scan.mma_operands(bw)
    o4, d4 = bw_scan.ray_planes(torch.from_numpy(o).to(device), torch.from_numpy(d).to(device))
    return dict(bw=bw, lhs_o=lhs_o, lhs_d=lhs_d, o4=o4, d4=d4)


def parity(key_scalar: torch.Tensor, key_mma: torch.Tensor) -> dict:
    """The JAX tool's parity of the two keys: hit agreement, the scalar hit
    fraction, and t's relative difference (p99) where both hit."""
    hit_s, ts = bw_scan.hit_t(key_scalar, mma=False)
    hit_m, tm = bw_scan.hit_t(key_mma, mma=True)
    both = hit_s & hit_m
    rel = ((ts[both] - tm[both]).abs() / ts[both].clamp(min=1e-6)).double()
    out = dict(agree=float((hit_s == hit_m).double().mean()),
               hit_frac=float(hit_s.double().mean()),
               rel_p99=float(torch.quantile(rel.cpu(), 0.99)) if rel.numel() else 0.0)
    print(f"hit agree: {out['agree']:.5f}; hit frac {out['hit_frac']:.3f}; t rel diff p99 "
          f"{out['rel_p99']:.2e}", flush=True)
    return out


def run(device="cuda", nblk: int = NBLK, reps: int = 10) -> dict:
    """Parity and both rates; device="cpu" runs the plain versions (nblk
    small, for a rehearsal). Returns the keys, the parity, and per kernel
    (seconds a launch, Mrays/s)."""
    device = resolve_device(device)
    a = inputs(device, nblk=nblk)
    calls = {
        "scalar": lambda: bw_scan.bw_scan_cuda(a["bw"], a["o4"], a["d4"]),
        "mma": lambda: bw_scan.bw_mma_cuda(a["lhs_o"], a["lhs_d"], a["o4"], a["d4"]),
    }
    keys = {name: fn() for name, fn in calls.items()}
    out = dict(keys=keys, parity=parity(keys["scalar"], keys["mma"]), rays=nblk * N)
    for name, fn in calls.items():
        dt = timing.seconds(fn, reps, device)
        rate = nblk * N / dt / 1e6
        out[name] = (dt, rate)
        print(f"{name:6s}: {dt*1e3:7.2f} ms  {rate:8.1f} Mrays/s over {G} tris  "
              f"({rate*G/1e3:.1f} Gtri-tests/s)", flush=True)
    return out


def main(argv=None) -> int:
    device = resolve_device("cuda")
    print(f"device: {timing.nvidia_smi()} ({timing.clock_label(device)})", flush=True)
    run(device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
