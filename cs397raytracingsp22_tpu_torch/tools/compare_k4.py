"""Hold this checkout's wavefront kernel (K4) against K4 built from other
source trees, on the card: rows that differ, live counts, registers and
times in turns, on the three frames K4 is measured on.

    python -m cs397raytracingsp22_tpu_torch.tools.compare_k4 CSRC [CSRC ...]

Each CSRC is a csrc/ directory: a parent commit's, unpacked with
`git archive <commit> cs397raytracingsp22_tpu_torch/csrc`, or an edited
copy of this checkout's (a design variant). Every build uses this
checkout's nvcc flags (ops/kernels/_build.py). A K4 whose source has no
rt_wavefront_occupancy is the design before compaction moved into the
kernel: it steps every row in place and leaves the partition to the host,
so it runs under that design's host loop, carried here (`parent_path`:
pack the rows, per bounce one launch over the full width and a torch
stable_partition, un-permute at the end). The others run under this
checkout's wrapper, path_trace_wavefront.

Frames: the bench frame (scenes/bench_scene.py, 512² × 64 spp, depth 8:
16,777,216 rays), chunk 0 of the Cornell time-to-64spp render
(scenes/cornell.py, depth 10, the rays render_to_image makes with seed 0)
and the open teapot frame (scenes/teapot.py under the path tracer, 512² ×
64 spp, depth 6), each through K1 as well. Printed: the card's nvidia-smi
name and power limit; each build's registers and spills; per frame
the rows of radiance that differ from this checkout's bit for bit (the
first few with both rows' bits), the segments and the live rays entering
each bounce; then each build's and K1's milliseconds a frame by CUDA
events, in turns (K1, this checkout, the others, then back, twice), after
a warm frame.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import os
import statistics
import subprocess

import torch

from cs397raytracingsp22_tpu_torch import ShadingMode
from cs397raytracingsp22_tpu_torch.ops.kernels import _build, bounce, wavefront
from cs397raytracingsp22_tpu_torch.render import driver, integrator
from cs397raytracingsp22_tpu_torch.scenes import bench_scene, cornell, teapot
from cs397raytracingsp22_tpu_torch.utils import threefry

SIDE, SPP = 512, 64

# the launch of the design before this one: rt_wavefront_launch(rows, alive,
# n, depth, last, then the 17 arguments that end this checkout's: k0, k1,
# t_min, t_max, the scene tables and counts, stream)
_PARENT_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 3 + \
    wavefront._ARGTYPES[-17:]


def frames(dev) -> dict:
    """name -> (scene data, o, d, uids, rng key, depth, max_trace_dist)."""
    out = {}
    sc = bench_scene.build(SIDE, SIDE, spp=SPP, path_depth=8)
    ids = torch.arange(SIDE * SIDE, dtype=torch.int32, device=dev)
    out["bench frame"] = (sc.compile(device=dev), *driver._gen_chunk_rays(
        sc.camera, ids, 0, 0, SPP, 1), 0, 8, 100.0)
    sc = cornell.build(width=SIDE, height=SIDE, spp=SPP, path_depth=10)
    data = sc.compile(device=dev)
    cam, key = sc.camera, threefry.key_words(0)
    px = driver.chunk_pixels(data, cam, cam.aa_sample_count)
    ids = torch.arange(px, dtype=torch.int32, device=dev) * ((SIDE * SIDE + px - 1) // px)
    out["Cornell chunk"] = (data, *driver._gen_chunk_rays(cam, ids, key, 0, SPP, 1), key,
                            cam.path_depth, cam.max_trace_dist)
    sc = teapot.build(SIDE, SIDE, spp=SPP, shading=ShadingMode.PATH_TRACE)
    ids = torch.arange(SIDE * SIDE, dtype=torch.int32, device=dev)
    out["open teapot frame"] = (sc.compile(device=dev), *driver._gen_chunk_rays(
        sc.camera, ids, 0, 0, SPP, 1), 0, sc.camera.path_depth, sc.camera.max_trace_dist)
    return out


def parent_path(lib: ctypes.CDLL, data, o, d, uids, key, depth: int, max_dist: float,
                stats: dict | None = None):
    """The host loop of K4 before compaction moved into the kernel: rows and
    alive packed, per bounce one launch over every row (updated in place),
    then a stable dead-last partition in torch, and the radiance
    un-permuted at the end. Returns (radiance, segments)."""
    lib.rt_wavefront_launch.argtypes = _PARENT_ARGTYPES
    lib.rt_wavefront_launch.restype = ctypes.c_int
    k0, k1 = threefry.key_pair(key)
    rows, alive = wavefront.pack_state(o, d, uids)
    n = o.shape[0]
    live = []
    for b in range(depth):
        live.append(alive.sum(dtype=torch.int64))
        rc = lib.rt_wavefront_launch(
            rows.data_ptr(), alive.data_ptr(), n, b, int(b == depth - 1), k0, k1,
            integrator.PATH_T_MIN, max_dist, data.kscene.data_ptr(), int(data.kscene.numel()),
            data.n_spheres, data.n_planes, data.n_tris, data.n_volumes,
            int(data.mat_type.shape[0]), len(data.dense_mesh_ids), data.kmesh_tri4.data_ptr(),
            data.kmesh_nrm.data_ptr(), data.ksl_tree.data_ptr(), int(data.ksl_tree.numel()),
            torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"the parent's K4 failed to launch with CUDA error {rc}")
        if b < depth - 1:
            rows, alive = wavefront.stable_partition(alive, rows)
    live = torch.stack(live)
    if stats is not None:
        stats["live"] = live
    return wavefront.radiance_in_caller_order(rows), live.sum()


@contextlib.contextmanager
def _using(lib: ctypes.CDLL):
    """path_trace_wavefront launches `lib`'s kernel inside the block."""
    saved = _build._libs.get("wavefront")
    _build._libs["wavefront"] = lib
    try:
        yield
    finally:
        _build._libs["wavefront"] = saved


class Build:
    """K4 built from one csrc/ directory."""

    def __init__(self, csrc: str, index: int):
        self.name = csrc
        src = os.path.join(os.path.abspath(csrc), "wavefront.cu")
        with open(src) as f:
            self.parent = "rt_wavefront_occupancy" not in f.read()
        out_dir = os.path.join(_build.BUILD_DIR, "compare_k4")
        os.makedirs(out_dir, exist_ok=True)
        self.path = os.path.join(out_dir, f"libwavefront-{index}.so")
        # the kernel includes its csrc/ tree's headers, not this checkout's
        self.proc = subprocess.Popen(
            [_build.nvcc_path(), *_build._flags("wavefront"), "-o", self.path, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    def wait(self) -> None:
        self.log = self.proc.communicate()[0]
        if self.proc.returncode != 0:
            raise RuntimeError(f"nvcc failed to build {self.name} wavefront.cu:\n{self.log}")
        self.lib = ctypes.CDLL(self.path)

    def run(self, frame, stats=None):
        data, o, d, uids, key, depth, max_dist = frame
        if self.parent:
            return parent_path(self.lib, data, o, d, uids, key, depth, max_dist, stats)
        with _using(self.lib):
            return wavefront.path_trace_wavefront(data, o, d, uids, key, depth, max_dist,
                                                  stats=stats)


class This:
    name = "this checkout"

    @staticmethod
    def run(frame, stats=None):
        data, o, d, uids, key, depth, max_dist = frame
        return wavefront.path_trace_wavefront(data, o, d, uids, key, depth, max_dist,
                                              stats=stats)


class K1:
    name = "K1"

    @staticmethod
    def run(frame, stats=None):
        data, o, d, uids, key, depth, max_dist = frame
        return bounce.path_trace_cuda(data, o, d, uids, key, depth, max_dist, stats=stats)


def _ptxas(log: str) -> str:
    lines = [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
    return " | ".join(lines) or "no ptxas output"


def _bits(row) -> str:
    return "[" + " ".join(f"{int(x):#010x}" for x in row.cpu().view(torch.int32)) + "]"


def ms_in_turns(runners, frame, reps: int = 3) -> dict:
    """name -> four means of `reps` frames by CUDA events, in turns (the
    runners, then back, twice), each after a warm frame."""
    ms = {r.name: [] for r in runners}
    for r in runners + runners[::-1] + runners + runners[::-1]:
        r.run(frame)
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            r.run(frame)
        end.record()
        torch.cuda.synchronize()
        ms[r.name].append(start.elapsed_time(end) / reps)
    return ms


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("csrc", nargs="+", help="csrc/ directories to build K4 from")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("compare_k4: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(f"device: {smi}", flush=True)
    builds = [Build(s, i) for i, s in enumerate(args.csrc)]
    _build.build_all(("wavefront", "bounce"))
    for b in builds:
        b.wait()
    print("this checkout: " + ", ".join(
        f"{'dense' if dense else 'no mesh'}{' last' if last else ''} "
        f"{'{} registers, {} B local'.format(*wavefront.kernel_attrs(dense, last))}"
        for dense in (True, False) for last in (False, True)), flush=True)
    for b in builds:
        print(f"{b.name}{' (host partition)' if b.parent else ''}: {_ptxas(b.log)}", flush=True)

    dev = torch.device("cuda")
    everyone = [K1, This] + builds
    for what, frame in frames(dev).items():
        n = frame[1].shape[0]
        st = {}
        ref, ref_segs = This.run(frame, st)
        k1_st = {}
        _, k1_segs = K1.run(frame, k1_st)
        k1_live = [int((k1_st["segs"] > b).sum()) for b in range(frame[5])]
        print(f"{what} ({n} rays, depth {frame[5]}): this checkout {int(ref_segs)} segments, "
              f"live entering each bounce {st['live'].tolist()}, tiles walked "
              f"{st['tiles'].tolist()}; K1 {int(k1_segs)} segments, live {k1_live}", flush=True)
        for b in builds:
            bst = {}
            rad, segs = b.run(frame, bst)
            diff = (rad != ref).any(dim=1)
            rows = diff.nonzero()[:8, 0].tolist()
            print(f"  {b.name}: {int(diff.sum())} rows differ from this checkout's, bit for bit; "
                  f"first rows {rows}; {int(segs)} segments, live {bst['live'].tolist()}",
                  flush=True)
            for i in rows[:4]:
                print(f"    row {i}: this checkout {_bits(ref[i])}; {b.name} {_bits(rad[i])}",
                      flush=True)
        del ref
        ms = ms_in_turns(everyone, frame)
        k1_med = statistics.median(ms["K1"])
        for name, t in ms.items():
            med = statistics.median(t)
            print(f"{what} {name}: {', '.join(f'{x:.4f}' for x in t)} ms a frame, median "
                  f"{med:.4f} ms ({med / k1_med:.3f}x K1)", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
