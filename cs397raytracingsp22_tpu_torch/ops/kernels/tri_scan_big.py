"""K3, the big-mesh kernel: each ray's nearest hit in one mesh beyond the
dense budget, by a walk of the mesh's BVH.

`tri_scan_big_cuda` launches csrc/bvh_traverse.cu (hand-written CUDA C++
for sm_90a, built by _build.py) for CUDA tensors; for CPU tensors it runs
the plain version, ops/bvh.py::traverse, which is also what the kernel is
held against on the card. The kernel screens the rays by the root box
and walks each ray inside down the mesh's child-pair rows (mesh.bvh_nodes,
mesh.bvh_tri4) with a stack: in the screen where a warp's rays form a
packet (camera rays), else in persistent blocks of a second kernel that
runs beside the screen's walks. Its step-for-step plain version is
`tri_scan_big_packed` (ops/bvh.py::traverse_packed), which gives
traverse's rows but where the MT and slab tests round apart
(csrc/bvh_traverse.cu). It replaces the JAX package's
ops/pallas/tri_scan_big.py::tri_scan_big_pallas (a culled piece scan on
the TPU; the result, the nearest hit, is the same).

`LAUNCHES` counts the kernels' launches, two a call (the screen and the
persistent walk), and nothing else.
"""

from __future__ import annotations

import ctypes

import torch

from cs397raytracingsp22_tpu_torch.models.scene import MeshBlock
from cs397raytracingsp22_tpu_torch.ops import bvh as bvhlib
from cs397raytracingsp22_tpu_torch.ops.kernels import _build
from cs397raytracingsp22_tpu_torch.ops.kernels._build import check_tensor

LAUNCHES = 0

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [
    _P, _P, _P, _P, _I,  # o, d, t_min, t_max, n
    _P, _I,  # bvh_nodes, bvh_depth
    _P, _P,  # bvh_tri4, scratch
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
    lib.rt_bvh_traverse_config.argtypes = [_I] + [ctypes.POINTER(_I)] * 3
    lib.rt_bvh_traverse_config.restype = _I
    return lib


def kernel_attrs() -> tuple[int, int]:
    """(registers per thread, local spill bytes) of the compiled kernels:
    the larger of the screen's and the walk's."""
    regs, local = _I(), _I()
    rc = library().rt_bvh_traverse_attrs(ctypes.byref(regs), ctypes.byref(local))
    if rc != 0:
        raise RuntimeError(f"cudaFuncGetAttributes failed with CUDA error {rc}")
    return regs.value, local.value


def launch_config(mesh: MeshBlock) -> dict:
    """The walk's launch for `mesh` on the current card: shared bytes a
    block (bvh_depth stack entries of 8 B a thread), resident blocks an SM
    and threads a block."""
    out = [_I() for _ in range(3)]
    rc = library().rt_bvh_traverse_config(mesh.bvh_depth, *(ctypes.byref(x) for x in out))
    if rc != 0:
        raise RuntimeError(f"K3 fits no block on an SM (CUDA error {rc})")
    return dict(zip(("smem_bytes", "blocks_per_sm", "threads"), (x.value for x in out)))


def tri_scan_big_plain(mesh: MeshBlock, o, d, t_min, t_max, stats: dict | None = None):
    """The plain version: ops/bvh.py::traverse over the mesh's BVH."""
    return bvhlib.traverse(
        o, d, t_min, t_max, mesh.bounds_min, mesh.bounds_max, mesh.skip, mesh.leaf_start,
        mesh.leaf_count, mesh.tri_verts, mesh.leaf_size, stats=stats,
    )


def tri_scan_big_packed(mesh: MeshBlock, o, d, t_min, t_max, stats: dict | None = None):
    """The kernel's walk, step for step: ops/bvh.py::traverse_packed over
    the mesh's child-pair rows (the same rows as traverse)."""
    return bvhlib.traverse_packed(o, d, t_min, t_max, mesh.bvh_nodes, mesh.bvh_tri4,
                                  mesh.bvh_depth, stats=stats)


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
    rows = mesh.bvh_nodes.shape[0]
    nt = mesh.bvh_tri4.shape[0]
    check_tensor("o", o, torch.float32, (n, 3), dev)
    check_tensor("d", d, torch.float32, (n, 3), dev)
    check_tensor("t_min", t_min, torch.float32, (n,), dev)
    check_tensor("t_max", t_max, torch.float32, (n,), dev)
    check_tensor("mesh.bvh_nodes", mesh.bvh_nodes, torch.float32, (rows, bvhlib.NODE_ROW), dev)
    check_tensor("mesh.bvh_tri4", mesh.bvh_tri4, torch.float32, (nt, 12), dev)
    if n >= 2**31 // 3 or rows >= 2**31 // 16:
        raise ValueError(f"{n} rays or {rows} node rows exceed the kernel's int32 indexing")
    scratch = torch.empty((n + 3,), dtype=torch.int32, device=dev)  # three counts, the rays inside
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
            mesh.bvh_nodes.data_ptr(), mesh.bvh_depth, mesh.bvh_tri4.data_ptr(),
            scratch.data_ptr(), hit.data_ptr(), t.data_ptr(), tri.data_ptr(), u.data_ptr(),
            v.data_ptr(), stream,
        )
    if rc != 0:
        raise RuntimeError(f"big-mesh traversal kernel launch failed with CUDA error {rc}")
    LAUNCHES += 2  # the screen and the walk
    return hit, t, tri, u, v
