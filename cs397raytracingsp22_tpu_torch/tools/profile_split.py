"""Where does the bench frame's time go, and what do the candidate
primitives cost on the card: the port of the JAX package's
tools/profile_split.py, with its four sections and printed lines.

1. Scene/depth split: the bench scene (scenes/bench_scene.py, teapot_6k)
   at 512² × 64 spp through render_chunk (K1), one chunk of 16,777,216
   rays: full at depth 8, without the teapot at depth 8 (the StaticMesh
   dropped from the scene's objects), full at depth 1 and 2. Mean of 2
   after a warm run, CUDA events.
2. torch.sort of int32 keys with 1, 6 and 14 float32 value columns (one
   sort, then one gather a column) at 2M and 16M rays: the cost of a
   ray-coherence reordering.
3. torch.argsort plus a gather of 14 columns.
4. P4 (csrc/dtype_rate.cu): 2,000 rounds of y = y*y + 1; y = y - y*x in
   float32 and in packed bfloat16 over the JAX tool's (512, 128) block,
   and over a block that fills the card; each line gives the threads
   launched against the card's resident threads (132 SMs × 2,048), since
   the tool's 65,536 elements leave most of the card idle.

    python -m cs397raytracingsp22_tpu_torch.tools.profile_split
"""

from __future__ import annotations

import dataclasses
import sys

import torch

from cs397raytracingsp22_tpu_torch import StaticMesh
from cs397raytracingsp22_tpu_torch.models.scene import resolve_device
from cs397raytracingsp22_tpu_torch.ops.kernels import dtype_rate
from cs397raytracingsp22_tpu_torch.render import driver
from cs397raytracingsp22_tpu_torch.scenes import bench_scene
from cs397raytracingsp22_tpu_torch.tools import timing
from cs397raytracingsp22_tpu_torch.utils import threefry

LANES = 128
P4_ROWS = (512, 65536)  # the JAX tool's block; one that fills the card
P4_ITERS = 2000
SORT_SIZES = (1 << 21, 1 << 24)
SPLITS = (("full depth8", True, 8), ("no-teapot depth8", False, 8), ("full depth1", True, 1),
          ("full depth2", True, 2))


def timed_render(scene, device, spp: int = 64, reps: int = 2):
    """One chunk of render_chunk as the JAX tool times it (at most 2**24
    rays); returns (seconds, segments, Mrays/s)."""
    data = scene.compile(device=device)
    cam = scene.camera
    n_px = cam.screen_width * cam.screen_height
    chunk_px = min(n_px, max(1, (1 << 24) // spp))
    ids = torch.arange(chunk_px, dtype=torch.int32, device=device)
    key = threefry.key_words(0)
    segs = driver.render_chunk(data, cam, ids, key, 0, spp, 1)[1]
    wall = timing.seconds(lambda: driver.render_chunk(data, cam, ids, key, 0, spp, 1), reps,
                          device)
    segs = float(segs)
    return wall, segs, segs / wall / 1e6


def split_section(device, width: int = 512, spp: int = 64) -> dict:
    print("== scene/depth split ==", flush=True)
    out = {}
    for name, teapot, depth in SPLITS:
        sc = bench_scene.build(width, width, spp=spp, path_depth=depth)
        if not teapot:
            sc = dataclasses.replace(sc, objects=[o for o in sc.objects
                                                  if not isinstance(o, StaticMesh)])
        wall, segs, mrays = out[name] = timed_render(sc, device, spp)
        print(f"{name:20s} wall={wall:.3f}s segs={segs/1e6:.1f}M rate={mrays:.1f} Mrays/s",
              flush=True)
    return out


def _keys_and_values(n: int, nvals: int, device):
    g = torch.Generator(device=device).manual_seed(0)
    k = torch.randint(0, 1 << 30, (n,), dtype=torch.int32, device=device, generator=g)
    vals = [torch.arange(n, dtype=torch.float32, device=device) * (i + 1) for i in range(nvals)]
    return k, vals


def sort_section(device, sizes=SORT_SIZES) -> dict:
    print("== torch.sort cost (key + V values) ==", flush=True)
    out = {}
    for n in sizes:
        for nvals in (1, 6, 14):
            k, vals = _keys_and_values(n, nvals, device)

            def srt():
                perm = torch.sort(k).indices
                return [v[perm] for v in vals]

            out[(n, nvals)] = wall = timing.seconds(srt, 3, device)
            print(f"sort n={n >> 20}M vals={nvals:2d}: {wall*1e3:8.2f} ms", flush=True)
    return out


def argsort_section(device, sizes=SORT_SIZES) -> dict:
    print("== argsort+take (gather) cost ==", flush=True)
    out = {}
    for n in sizes:
        k, vals = _keys_and_values(n, 14, device)

        def ag():
            perm = torch.argsort(k)
            return [v[perm] for v in vals]

        out[n] = wall = timing.seconds(ag, 3, device)
        print(f"argsort+take n={n >> 20}M vals=14: {wall*1e3:8.2f} ms", flush=True)
    return out


def dtype_section(device, rows=P4_ROWS, iters: int = P4_ITERS, reps: int = 20) -> dict:
    """P4 in float32 and bfloat16 at each row count; returns {(rows, dtype):
    (seconds, operations)}."""
    print("== bf16 vs f32 element-wise in a hand-written kernel ==", flush=True)
    out = {}
    capacity = timing.resident_threads(device)
    for r in rows:
        for dtype in dtype_rate.DTYPES:
            x = torch.ones((r, LANES), dtype=dtype, device=device) * 0.5
            wall = timing.seconds(lambda: dtype_rate.dtype_rate_cuda(x, iters), reps, device)
            ops = r * LANES * iters * dtype_rate.OPS_PER_ROUND
            out[(r, dtype)] = (wall, ops)
            occ = (f"{dtype_rate.threads(x)} threads of {capacity} resident"
                   if capacity else "plain version on the CPU")
            print(f"{str(dtype).removeprefix('torch.')} ({r}, {LANES}): {wall*1e3:.4f} ms -> "
                  f"{ops/wall/1e12:.2f} Tops/s ({occ})", flush=True)
    return out


def run(device="cuda", width: int = 512, spp: int = 64, sort_sizes=SORT_SIZES,
        p4_rows=P4_ROWS, p4_iters: int = P4_ITERS) -> dict:
    """All four sections; device="cpu" runs the plain versions at the sizes
    given (for a rehearsal, not a measurement)."""
    device = resolve_device(device)
    return dict(split=split_section(device, width, spp), sort=sort_section(device, sort_sizes),
                argsort=argsort_section(device, sort_sizes),
                dtype=dtype_section(device, p4_rows, p4_iters))


def main(argv=None) -> int:
    device = resolve_device("cuda")
    print(f"device: {timing.nvidia_smi()} ({timing.clock_label(device)})", flush=True)
    run(device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
