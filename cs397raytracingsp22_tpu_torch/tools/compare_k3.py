"""Hold this checkout's big-mesh traversal kernel (K3) and dense-mesh scan
(K5) against the same kernels built from other source trees, on the card:
rows that differ, registers and times in turns.

    python -m cs397raytracingsp22_tpu_torch.tools.compare_k3 CSRC [CSRC ...]

Each CSRC is a csrc/ directory: a parent commit's, unpacked with
`git archive <commit> cs397raytracingsp22_tpu_torch/csrc`, or an edited
copy of this checkout's (a design variant). Every build uses this
checkout's nvcc flags (ops/kernels/_build.py). A K3 whose source lacks rt_bvh_traverse_config walks the threaded BVH arrays and is
launched with that older argument list; a K5 whose source lacks tri4 reads
the (NT, 9) tri_table.

Inputs: the 32,832-triangle bench teapot (scenes/bench_teapot_32k.py) on
4,194,304 object-space rays, chunk 0's camera rays at bounce 0, the same
rays after two bounces of the staged path (dead ones with t_max = 0) and
rays aimed at the teapot's box (`aimed_rays`), each with t_max cut to the
scene-intersection kernel's t, as the staged path calls K3; K5 on chunk 0
of 4 of the 6k bench frame's camera rays (4,194,304) against teapot_6k.
Printed: the card's nvidia-smi name and power limit; each build's ptxas
registers and spills and K3's resident blocks; the rows of each output
that differ, bit for bit, from this checkout's build, the first few with
their inputs and both outputs as float32 bits; and each build's
milliseconds a launch by CUDA events, in turns (this checkout, the others,
then back, twice), after a warm launch.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import os
import statistics
import subprocess

import torch

from cs397raytracingsp22_tpu_torch.ops import intersect as isect
from cs397raytracingsp22_tpu_torch.ops.kernels import _build, scene_intersect, tri_scan, tri_scan_big
from cs397raytracingsp22_tpu_torch.render import driver, integrator
from cs397raytracingsp22_tpu_torch.scenes import bench_scene, bench_teapot_32k
from cs397raytracingsp22_tpu_torch.utils import threefry
from cs397raytracingsp22_tpu_torch.utils import vecmath as vm

SIDE, SPP = 512, 64  # the bench frame
MAX_DIST = 100.0


def aimed_rays(mesh, n: int, dev, seed: int = 0):
    """n world rays of the bench scene that aim at a big mesh: from uniform
    points of the room (the box of tests/test_torch_staged_kernels.py::
    scene_rays) toward uniform points of the mesh's world-space root box."""
    g = torch.Generator(device=dev).manual_seed(seed)
    sel = torch.tensor([[x, y, z] for x in (0, 1) for y in (0, 1) for z in (0, 1)],
                       dtype=torch.float32, device=dev)
    corners = vm.apply_mat4_point(mesh.transform,
                                  mesh.bounds_min[0] * (1.0 - sel) + mesh.bounds_max[0] * sel)
    lo, hi = corners.amin(dim=0), corners.amax(dim=0)
    room_lo = torch.tensor([-2.4, 0.05, -2.4], device=dev)
    room_hi = torch.tensor([2.4, 4.95, 3.0], device=dev)
    o = room_lo + (room_hi - room_lo) * torch.rand((n, 3), generator=g, device=dev)
    d = lo + (hi - lo) * torch.rand((n, 3), generator=g, device=dev) - o
    return o.contiguous(), d.contiguous()


def k3_inputs(data, o, d, alive=None) -> tuple:
    """(o, d, t_min, t_max) in the big mesh's object space, t_max cut to
    K2's t (and 0 where `alive` is false), as
    ops/intersect.py::intersect_scene_fused calls K3."""
    n = o.shape[0]
    t_min = torch.full((n,), integrator.PATH_T_MIN, device=o.device)
    t_max = torch.full_like(t_min, MAX_DIST)
    if alive is not None:
        t_max = torch.where(alive, t_max, torch.zeros_like(t_max))
    u_vol = torch.full((n, data.vol_center.shape[0]), 0.5, device=o.device)
    t2 = scene_intersect.scene_intersect_cuda(data, o, d, t_min, t_max, u_vol)[0]
    o_obj, d_obj = (x.contiguous() for x in isect.object_rays(data.meshes[0], o, d))
    return o_obj, d_obj, t_min, torch.minimum(t_max, t2)


def _launch_threaded(lib, mesh, o, d, t_min, t_max):
    """K3 of the threaded walk: rt_bvh_traverse_launch(o, d, t_min, t_max,
    n, bmin, bmax, skip, leaf_start, leaf_count, nn, tri_verts, hit, t,
    tri, u, v, stream)."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.rt_bvh_traverse_launch.argtypes = [p, p, p, p, i, p, p, p, p, p, i, p] + [p] * 6
    lib.rt_bvh_traverse_launch.restype = i
    n = o.shape[0]
    out = _outputs(n, o.device)
    rc = lib.rt_bvh_traverse_launch(
        o.data_ptr(), d.data_ptr(), t_min.data_ptr(), t_max.data_ptr(), n,
        mesh.bounds_min.data_ptr(), mesh.bounds_max.data_ptr(), mesh.skip.data_ptr(),
        mesh.leaf_start.data_ptr(), mesh.leaf_count.data_ptr(), mesh.bounds_min.shape[0],
        mesh.tri_verts.data_ptr(), *(x.data_ptr() for x in out),
        torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"the threaded-walk K3 failed to launch with CUDA error {rc}")
    return out


def _launch_k5_rows9(lib, mesh, o, d, t_min, t_max):
    """K5 reading the (NT, 9) tri_table: rt_tri_scan_launch(o, d, t_min,
    t_max, n, tri_table, nt, hit, t, tri, u, v, stream)."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.rt_tri_scan_launch.argtypes = [p, p, p, p, i, p, i] + [p] * 6
    lib.rt_tri_scan_launch.restype = i
    n = o.shape[0]
    out = _outputs(n, o.device)
    rc = lib.rt_tri_scan_launch(
        o.data_ptr(), d.data_ptr(), t_min.data_ptr(), t_max.data_ptr(), n,
        mesh.tri_table.data_ptr(), mesh.tri_table.shape[0], *(x.data_ptr() for x in out),
        torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"the 9-float-row K5 failed to launch with CUDA error {rc}")
    return out


def _outputs(n, dev):
    return (torch.empty((n,), dtype=torch.bool, device=dev),
            torch.empty((n,), dtype=torch.float32, device=dev),
            torch.empty((n,), dtype=torch.int32, device=dev),
            torch.empty((n,), dtype=torch.float32, device=dev),
            torch.empty((n,), dtype=torch.float32, device=dev))


@contextlib.contextmanager
def _using(name: str, lib: ctypes.CDLL):
    """The package's wrapper for kernel `name` launches `lib` inside the block."""
    saved = _build._libs.get(name)
    _build._libs[name] = lib
    try:
        yield
    finally:
        _build._libs[name] = saved


class Build:
    """K3 and K5 built from one csrc/ directory."""

    def __init__(self, csrc: str, index: int):
        self.name = csrc
        out_dir = os.path.join(_build.BUILD_DIR, "compare_k3")
        os.makedirs(out_dir, exist_ok=True)
        self.jobs, self.libs, self.logs, self.new = {}, {}, {}, {}
        for kname, marker in (("bvh_traverse", "rt_bvh_traverse_config"), ("tri_scan", "tri4")):
            src = os.path.join(os.path.abspath(csrc), f"{kname}.cu")
            with open(src) as f:
                self.new[kname] = marker in f.read()
            path = os.path.join(out_dir, f"lib{kname}-{index}.so")
            self.jobs[kname] = (path, subprocess.Popen(
                [_build.nvcc_path(), *_build._flags(kname), "-o", path, src],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))

    def wait(self) -> None:
        for kname, (path, proc) in self.jobs.items():
            self.logs[kname] = proc.communicate()[0]
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed to build {self.name} {kname}.cu:\n"
                                   f"{self.logs[kname]}")
            self.libs[kname] = ctypes.CDLL(path)

    def k3(self, mesh, ins):
        lib = self.libs["bvh_traverse"]
        if not self.new["bvh_traverse"]:
            return _launch_threaded(lib, mesh, *ins)
        with _using("bvh_traverse", lib):
            return tri_scan_big.tri_scan_big_cuda(mesh, *ins)

    def k5(self, mesh, ins):
        lib = self.libs["tri_scan"]
        if not self.new["tri_scan"]:
            return _launch_k5_rows9(lib, mesh, *ins)
        with _using("tri_scan", lib):
            return tri_scan.tri_scan_cuda(mesh, *ins)


def _bits(values) -> str:
    """Tensors' elements as hex float32 bits (and other dtypes as they are)."""
    out = []
    for v in values:
        v = v.reshape(-1).cpu()
        out.append(" ".join(f"{int(x):#010x}" for x in v.view(torch.int32)) if v.is_floating_point()
                   else " ".join(str(int(x)) for x in v))
        out[-1] = f"[{out[-1]}]"
    return " ".join(out)


def _ptxas(log: str) -> str:
    lines = [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
    return " | ".join(lines) or "no ptxas output"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("csrc", nargs="+", help="csrc/ directories to build K3 and K5 from")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("compare_k3: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(f"device: {smi}", flush=True)
    builds = [Build(s, i) for i, s in enumerate(args.csrc)]
    _build.build_all(("bvh_traverse", "tri_scan", "scene_intersect"))
    for b in builds:
        b.wait()

    class This:  # this checkout's package build
        name = "this checkout"

        @staticmethod
        def k3(mesh, ins):
            return tri_scan_big.tri_scan_big_cuda(mesh, *ins)

        @staticmethod
        def k5(mesh, ins):
            return tri_scan.tri_scan_cuda(mesh, *ins)

    dev = torch.device("cuda")
    sc32 = bench_teapot_32k.build(SIDE, SIDE, spp=SPP, path_depth=8)
    sd32 = sc32.compile(device=dev)
    mesh32 = sd32.meshes[0]
    key = threefry.key_words(0)
    px = driver.chunk_pixels(sd32, sc32.camera, SPP)
    ids = torch.arange(px, dtype=torch.int32, device=dev) * ((SIDE * SIDE + px - 1) // px)
    o, d, uid = driver._gen_chunk_rays(sc32.camera, ids, key, 0, SPP, 1)
    bounce0 = k3_inputs(sd32, o.contiguous(), d.contiguous())
    thr, rad = torch.ones_like(o), torch.zeros_like(o)
    alive = torch.ones((o.shape[0],), dtype=torch.bool, device=dev)
    for b in range(2):  # as chip_smoke.py's staged parity phase
        o, d, thr, rad, alive, _, _ = integrator.bounce_update(
            sd32, o, d, thr, rad, alive, uid, key, b, MAX_DIST, intersect=isect.intersect_scene)
    bounce2 = k3_inputs(sd32, o.contiguous(), d.contiguous(), alive)
    del thr, rad, alive
    aimed = k3_inputs(sd32, *aimed_rays(mesh32, o.shape[0], dev))
    del o, d
    sc6 = bench_scene.build(SIDE, SIDE, spp=SPP, path_depth=8)
    sd6 = sc6.compile(device=dev)
    mesh6 = sd6.meshes[sd6.dense_mesh_ids[0]]
    ids = torch.arange(SIDE * SIDE // 4, dtype=torch.int32, device=dev) * 4
    o, d, _ = driver._gen_chunk_rays(sc6.camera, ids, key, 0, SPP, 1)
    o5, d5 = (x.contiguous() for x in isect.object_rays(mesh6, o, d))
    k5_in = (o5, d5, torch.full((o5.shape[0],), integrator.PATH_T_MIN, device=dev),
             torch.full((o5.shape[0],), MAX_DIST, device=dev))
    del o, d

    cfg = tri_scan_big.launch_config(mesh32)
    print(f"this checkout: K3 {_ptxas(_build.BUILD_INFO['bvh_traverse']['log'])}; {cfg}, stack "
          f"depth {mesh32.bvh_depth}; K5 {_ptxas(_build.BUILD_INFO['tri_scan']['log'])}")
    for b in builds:
        extra = ""
        if b.new["bvh_traverse"]:
            with _using("bvh_traverse", b.libs["bvh_traverse"]):
                extra = f"; {tri_scan_big.launch_config(mesh32)}"
        print(f"{b.name}: K3 {_ptxas(b.logs['bvh_traverse'])}"
              f"{'' if b.new['bvh_traverse'] else ' (threaded walk)'}{extra}; K5 "
              f"{_ptxas(b.logs['tri_scan'])}{'' if b.new['tri_scan'] else ' (9-float rows)'}",
              flush=True)

    cases = (("K3 bounce 0", "k3", mesh32, bounce0, 20), ("K3 bounce 2", "k3", mesh32, bounce2, 10),
             ("K3 aimed", "k3", mesh32, aimed, 10),
             ("K5", "k5", mesh6, k5_in, 2))
    everyone = [This] + builds
    for what, fn, mesh, ins, _ in cases:
        ref = getattr(This, fn)(mesh, ins)
        print(f"{what}: this checkout {int(ref[0].sum())} hits of {ins[0].shape[0]} rays")
        for b in builds:
            out = getattr(b, fn)(mesh, ins)
            diff = torch.zeros_like(ref[0])
            for a, r in zip(out, ref):
                diff |= a != r
            rows = diff.nonzero()[:8, 0].tolist()
            print(f"  {b.name}: {int(diff.sum())} rows differ from this checkout's, bit for bit; "
                  f"first rows {rows}", flush=True)
            for i in rows[:4]:
                print(f"    row {i}: o, d, t_min, t_max {_bits(x[i] for x in ins)}; this "
                      f"checkout (hit, t, tri, u, v) {_bits(x[i] for x in ref)}; {b.name} "
                      f"{_bits(x[i] for x in out)}", flush=True)
    for what, fn, mesh, ins, reps in cases:
        ms = {b.name: [] for b in everyone}
        for b in everyone + everyone[::-1] + everyone + everyone[::-1]:
            run = getattr(b, fn)
            run(mesh, ins)
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                run(mesh, ins)
            end.record()
            torch.cuda.synchronize()
            ms[b.name].append(start.elapsed_time(end) / reps)
        for name, t in ms.items():
            print(f"{what} {name}: {', '.join(f'{x:.4f}' for x in t)} ms a launch, median "
                  f"{statistics.median(t):.4f} ms", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
