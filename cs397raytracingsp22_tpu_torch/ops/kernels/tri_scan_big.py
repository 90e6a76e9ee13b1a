"""K3, the big-mesh kernel: each ray's nearest hit in one mesh beyond the
dense budget, by a walk of the mesh's threaded BVH.

`tri_scan_big_cuda` launches csrc/bvh_traverse.cu (hand-written CUDA C++
for sm_90a, built by _build.py) for CUDA tensors; for CPU tensors it runs
the plain version, ops/bvh.py::traverse, which is also what the kernel is
held against on the card. It replaces the JAX package's
ops/pallas/tri_scan_big.py::tri_scan_big_pallas (a culled piece scan on
the TPU; the result, the nearest hit, is the same).

`LAUNCHES` counts the kernel's launches (and nothing else).
"""

from __future__ import annotations

import ctypes

import torch

from cs397raytracingsp22_tpu_torch.models.scene import MeshBlock
from cs397raytracingsp22_tpu_torch.ops import bvh as bvhlib
from cs397raytracingsp22_tpu_torch.ops.kernels import _build
from cs397raytracingsp22_tpu_torch.ops.kernels.bounce import check_tensor

LAUNCHES = 0

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [
    _P, _P, _P, _P, _I,  # o, d, t_min, t_max, n
    _P, _P, _P, _P, _P, _I,  # bmin, bmax, skip, leaf_start, leaf_count, nn
    _P,  # tri_verts
    _P, _P, _P, _P, _P,  # hit, t, tri, u, v
    _P,  # stream
]


def library() -> ctypes.CDLL:
    """The built kernel library (builds it on first use)."""
    lib = _build.load_library("bvh_traverse")
    lib.rt_bvh_traverse_launch.argtypes = _ARGTYPES
    lib.rt_bvh_traverse_launch.restype = _I
    lib.rt_bvh_traverse_attrs.argtypes = [ctypes.POINTER(_I), ctypes.POINTER(_I)]
    lib.rt_bvh_traverse_attrs.restype = _I
    return lib


def kernel_attrs() -> tuple[int, int]:
    """(registers per thread, local spill bytes) of the compiled kernel."""
    regs, local = _I(), _I()
    rc = library().rt_bvh_traverse_attrs(ctypes.byref(regs), ctypes.byref(local))
    if rc != 0:
        raise RuntimeError(f"cudaFuncGetAttributes failed with CUDA error {rc}")
    return regs.value, local.value


def tri_scan_big_plain(mesh: MeshBlock, o, d, t_min, t_max, stats: dict | None = None):
    """The plain version: ops/bvh.py::traverse over the mesh's BVH."""
    return bvhlib.traverse(
        o, d, t_min, t_max, mesh.bounds_min, mesh.bounds_max, mesh.skip, mesh.leaf_start,
        mesh.leaf_count, mesh.tri_verts, mesh.leaf_size, stats=stats,
    )


def tri_scan_big_cuda(mesh: MeshBlock, o, d, t_min, t_max):
    """Nearest hit of each ray in `mesh` with K3.

    o, d: (N, 3) float32 object-space rays; t_min, t_max: (N,) float32.
    Returns (hit bool, t, tri int32 — a row of mesh.tri_verts, u, v); a
    ray without a hit has t = t_max and tri = -1.
    CPU tensors run the plain version. CUDA tensors launch the kernel on
    the current stream; anything the kernel does not take, a failed build
    or a failed launch raises.
    """
    global LAUNCHES
    if o.device.type == "cpu":
        return tri_scan_big_plain(mesh, o, d, t_min, t_max)
    if o.device.type != "cuda":
        raise ValueError(f"tri_scan_big_cuda takes CPU or CUDA tensors, got {o.device}")
    dev = o.device
    n = o.shape[0]
    nn = mesh.bounds_min.shape[0]
    nt = mesh.tri_verts.shape[0]
    check_tensor("o", o, torch.float32, (n, 3), dev)
    check_tensor("d", d, torch.float32, (n, 3), dev)
    check_tensor("t_min", t_min, torch.float32, (n,), dev)
    check_tensor("t_max", t_max, torch.float32, (n,), dev)
    check_tensor("mesh.bounds_min", mesh.bounds_min, torch.float32, (nn, 3), dev)
    check_tensor("mesh.bounds_max", mesh.bounds_max, torch.float32, (nn, 3), dev)
    for key in ("skip", "leaf_start", "leaf_count"):
        check_tensor(f"mesh.{key}", getattr(mesh, key), torch.int32, (nn,), dev)
    check_tensor("mesh.tri_verts", mesh.tri_verts, torch.float32, (nt, 3, 3), dev)
    if n >= 2**31 // 3 or nt >= 2**31 // 9:
        raise ValueError(f"{n} rays or {nt} triangles exceed the kernel's int32 indexing")
    hit = torch.empty((n,), dtype=torch.bool, device=dev)
    t = torch.empty((n,), dtype=torch.float32, device=dev)
    tri = torch.empty((n,), dtype=torch.int32, device=dev)
    u = torch.empty((n,), dtype=torch.float32, device=dev)
    v = torch.empty((n,), dtype=torch.float32, device=dev)
    lib = library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = lib.rt_bvh_traverse_launch(
            o.data_ptr(), d.data_ptr(), t_min.data_ptr(), t_max.data_ptr(), n,
            mesh.bounds_min.data_ptr(), mesh.bounds_max.data_ptr(), mesh.skip.data_ptr(),
            mesh.leaf_start.data_ptr(), mesh.leaf_count.data_ptr(), nn,
            mesh.tri_verts.data_ptr(), hit.data_ptr(), t.data_ptr(), tri.data_ptr(),
            u.data_ptr(), v.data_ptr(), stream,
        )
    if rc != 0:
        raise RuntimeError(f"big-mesh traversal kernel launch failed with CUDA error {rc}")
    LAUNCHES += 1
    return hit, t, tri, u, v
