"""Hold this checkout's mega-bounce kernel (K1) against K1 built from
other source trees, on the card: the check for a change to csrc/bounce.cu
or the headers it includes that should leave K1's registers, bits and
speed as they were.

    python -m cs397raytracingsp22_tpu_torch.tools.compare_k1 OTHER_CSRC [OTHER_CSRC ...]

Each OTHER_CSRC is a csrc/ directory, for example a parent commit's,
unpacked with `git archive <commit> cs397raytracingsp22_tpu_torch/csrc`.
A K1 whose rt_bounce_launch takes the flat superleaf boxes (ksl_bounds)
where this checkout's takes the superleaf tree (ksl_tree and its length)
is launched with that older argument list, one without the sphere tree
(no `sph_leaves` in bounce.cu) without its two arguments, and one that
counts the sphere tree's node tests (`sph_tests` in bounce.cu) with a
counter of its own, and one without the big-mesh walk (no `big_nodes` in
bounce.cu) without its five arguments; the lists are told apart by the
source. Every build uses this checkout's
nvcc flags (ops/kernels/_build.py). The
bench frame (scenes/bench_scene.py, 512² × 64 spp, depth 8: one launch of
16,777,216 rays) runs through each build. Printed: each build's
registers and spills, the rows whose radiance differs from this
checkout's build, bit for bit (with the first few of their indices), and
each build's milliseconds a frame by
CUDA events, timed in turns (four runs of three frames each, after a warm
frame), with the card's nvidia-smi name and power limit.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import os
import statistics
import subprocess

import torch

from cs397raytracingsp22_tpu_torch.ops.kernels import _build, bounce
from cs397raytracingsp22_tpu_torch.render import driver, integrator
from cs397raytracingsp22_tpu_torch.scenes import bench_scene
from cs397raytracingsp22_tpu_torch.utils import threefry


# rt_bounce_launch's arguments up to sph_leaves, which every list since the
# sphere tree shares; the stream comes last in each
_TO_SPH_LEAVES = bounce._ARGTYPES[:25]


@contextlib.contextmanager
def _using(lib: ctypes.CDLL):
    """bounce.path_trace_cuda launches `lib`'s kernel inside the block."""
    saved = _build._libs.get("bounce")
    _build._libs["bounce"] = lib
    try:
        yield
    finally:
        _build._libs["bounce"] = saved


def _launch_flat(lib: ctypes.CDLL, data, o, d, uids, depth: int, max_dist: float):
    """bounce.path_trace_cuda for a K1 of the flat superleaf scan, whose
    rt_bounce_launch ends (..., mesh_tri, mesh_nrm, sl, stream) with sl the
    (NSL, 6) ksl_bounds rows. Returns the radiance."""
    lib.rt_bounce_launch.argtypes = _TO_SPH_LEAVES[:-3] + [ctypes.c_void_p]
    lib.rt_bounce_launch.restype = ctypes.c_int
    n = o.shape[0]
    k0, k1 = threefry.key_pair(0)
    rad = torch.empty((n, 3), dtype=torch.float32, device=o.device)
    segs = torch.empty((n,), dtype=torch.int32, device=o.device)
    rc = lib.rt_bounce_launch(
        o.data_ptr(), d.data_ptr(), uids.data_ptr(), n, rad.data_ptr(), segs.data_ptr(), k0, k1,
        depth, integrator.PATH_T_MIN, max_dist, data.kscene.data_ptr(), int(data.kscene.numel()),
        data.n_spheres, data.n_planes, data.n_tris, data.n_volumes, int(data.mat_type.shape[0]),
        len(data.dense_mesh_ids), data.kmesh_tri.data_ptr(), data.kmesh_nrm.data_ptr(),
        data.ksl_bounds.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"the flat-scan K1 failed to launch with CUDA error {rc}")
    return rad


def _launch_pre_sphere_tree(lib: ctypes.CDLL, data, o, d, uids, depth: int, max_dist: float):
    """bounce.path_trace_cuda for a K1 from before the sphere tree, whose
    rt_bounce_launch ends (..., tree, tree_len, stream). Returns the
    radiance."""
    lib.rt_bounce_launch.argtypes = _TO_SPH_LEAVES[:-2] + [ctypes.c_void_p]
    lib.rt_bounce_launch.restype = ctypes.c_int
    n = o.shape[0]
    k0, k1 = threefry.key_pair(0)
    rad = torch.empty((n, 3), dtype=torch.float32, device=o.device)
    segs = torch.empty((n,), dtype=torch.int32, device=o.device)
    rc = lib.rt_bounce_launch(
        o.data_ptr(), d.data_ptr(), uids.data_ptr(), n, rad.data_ptr(), segs.data_ptr(), k0, k1,
        depth, integrator.PATH_T_MIN, max_dist, data.kscene.data_ptr(), int(data.kscene.numel()),
        data.n_spheres, data.n_planes, data.n_tris, data.n_volumes, int(data.mat_type.shape[0]),
        len(data.dense_mesh_ids), data.kmesh_tri4.data_ptr(), data.kmesh_nrm.data_ptr(),
        data.ksl_tree.data_ptr(), int(data.ksl_tree.numel()),
        torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"the K1 without the sphere tree failed to launch with CUDA error {rc}")
    return rad


def _launch_counted(lib: ctypes.CDLL, data, o, d, uids, depth: int, max_dist: float):
    """bounce.path_trace_cuda for a K1 that counts its sphere-tree node
    tests, whose rt_bounce_launch ends (..., sph_table, sph_leaves,
    sph_tests, stream). Returns the radiance."""
    lib.rt_bounce_launch.argtypes = _TO_SPH_LEAVES + [ctypes.c_void_p] * 2
    lib.rt_bounce_launch.restype = ctypes.c_int
    n = o.shape[0]
    k0, k1 = threefry.key_pair(0)
    rad = torch.empty((n, 3), dtype=torch.float32, device=o.device)
    segs = torch.empty((n,), dtype=torch.int32, device=o.device)
    tests = torch.zeros((1,), dtype=torch.int64, device=o.device)
    rc = lib.rt_bounce_launch(
        o.data_ptr(), d.data_ptr(), uids.data_ptr(), n, rad.data_ptr(), segs.data_ptr(), k0, k1,
        depth, integrator.PATH_T_MIN, max_dist, data.kscene.data_ptr(), int(data.kscene.numel()),
        data.n_spheres, data.n_planes, data.n_tris, data.n_volumes, int(data.mat_type.shape[0]),
        len(data.dense_mesh_ids), data.kmesh_tri4.data_ptr(), data.kmesh_nrm.data_ptr(),
        data.ksl_tree.data_ptr(), int(data.ksl_tree.numel()), data.ksph_tree.data_ptr(),
        data.sph_tree_leaves, tests.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"the counting K1 failed to launch with CUDA error {rc}")
    return rad


def _launch_pre_big(lib: ctypes.CDLL, data, o, d, uids, depth: int, max_dist: float):
    """bounce.path_trace_cuda for a K1 from before the big-mesh walk, whose
    rt_bounce_launch ends (..., sph_table, sph_leaves, stream). Returns the
    radiance."""
    lib.rt_bounce_launch.argtypes = _TO_SPH_LEAVES + [ctypes.c_void_p]
    lib.rt_bounce_launch.restype = ctypes.c_int
    n = o.shape[0]
    k0, k1 = threefry.key_pair(0)
    rad = torch.empty((n, 3), dtype=torch.float32, device=o.device)
    segs = torch.empty((n,), dtype=torch.int32, device=o.device)
    rc = lib.rt_bounce_launch(
        o.data_ptr(), d.data_ptr(), uids.data_ptr(), n, rad.data_ptr(), segs.data_ptr(), k0, k1,
        depth, integrator.PATH_T_MIN, max_dist, data.kscene.data_ptr(), int(data.kscene.numel()),
        data.n_spheres, data.n_planes, data.n_tris, data.n_volumes, int(data.mat_type.shape[0]),
        len(data.dense_mesh_ids), data.kmesh_tri4.data_ptr(), data.kmesh_nrm.data_ptr(),
        data.ksl_tree.data_ptr(), int(data.ksl_tree.numel()), data.ksph_tree.data_ptr(),
        data.sph_tree_leaves, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"the K1 without the big-mesh walk failed to launch with CUDA error {rc}")
    return rad


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other_csrc", nargs="+", help="csrc/ directories to build K1 from")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("compare_k1: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(f"device: {smi}")
    out_dir = os.path.join(_build.BUILD_DIR, "compare_k1")
    os.makedirs(out_dir, exist_ok=True)
    jobs = []
    for i, csrc in enumerate(args.other_csrc):
        path = os.path.join(out_dir, f"libbounce-{i}.so")
        src = os.path.join(os.path.abspath(csrc), "bounce.cu")
        jobs.append((csrc, path, subprocess.Popen(
            [_build.nvcc_path(), *_build._flags("bounce"), "-o", path, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = {"this checkout": bounce.library()}
    logs = {"this checkout": _build.BUILD_INFO["bounce"]["log"]}
    flat = {"this checkout": False}
    pre_tree = {"this checkout": False}
    counted = {"this checkout": False}
    pre_big = {"this checkout": False}
    for csrc, path, proc in jobs:
        with open(os.path.join(csrc, "bounce.cu")) as f:
            src = f.read()
        flat[csrc] = "tree_len" not in src
        pre_tree[csrc] = not flat[csrc] and "sph_leaves" not in src
        counted[csrc] = "sph_tests" in src
        pre_big[csrc] = not (flat[csrc] or pre_tree[csrc] or counted[csrc]) and "big_nodes" not in src
        logs[csrc] = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed to build {csrc}/bounce.cu:\n{logs[csrc]}")
        libs[csrc] = ctypes.CDLL(path)
    for name, log in logs.items():
        ptxas = [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
        print(f"{name}: {' | '.join(ptxas) or 'built earlier, no ptxas output'}")

    dev = torch.device("cuda")
    scene = bench_scene.build(512, 512, spp=64, path_depth=8)
    data = scene.compile(device=dev)
    ids = torch.arange(512 * 512, dtype=torch.int32, device=dev)
    o, d, uids = driver._gen_chunk_rays(scene.camera, ids, 0, 0, 64, 1)

    def frame(name):
        if flat[name]:
            return _launch_flat(libs[name], data, o, d, uids, 8, 100.0)
        if pre_tree[name]:
            return _launch_pre_sphere_tree(libs[name], data, o, d, uids, 8, 100.0)
        if counted[name]:
            return _launch_counted(libs[name], data, o, d, uids, 8, 100.0)
        if pre_big[name]:
            return _launch_pre_big(libs[name], data, o, d, uids, 8, 100.0)
        with _using(libs[name]):
            return bounce.path_trace_cuda(data, o, d, uids, 0, 8, 100.0)[0]

    rad = {name: frame(name) for name in libs}
    ref = rad["this checkout"]
    for name in args.other_csrc:
        diff = (rad[name] != ref).any(dim=1)
        rows = diff.nonzero()[:8, 0].tolist()
        print(f"{name}{' (flat superleaf scan)' if flat[name] else ''}: {int(diff.sum())} of "
              f"{ref.shape[0]} rows differ from this checkout's, max |diff| "
              f"{float((rad[name] - ref).abs().max()):.3g}; first rows {rows}")
    names = list(libs)
    order = names + names[::-1] + names + names[::-1]
    ms = {name: [] for name in names}
    for name in order:
        frame(name)
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(3):
            frame(name)
        end.record()
        torch.cuda.synchronize()
        ms[name].append(start.elapsed_time(end) / 3)
    for name, t in ms.items():
        print(f"{name}: {', '.join(f'{x:.3f}' for x in t)} ms a frame, median "
              f"{statistics.median(t):.3f} ms")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
