"""K5, the dense single-mesh scan: each ray's nearest hit over every
triangle of one mesh.

`tri_scan_cuda` launches csrc/tri_scan.cu (hand-written CUDA C++ for
sm_90a, built by _build.py) for CUDA tensors; for CPU tensors it runs the
plain version, `tri_scan_plain`, which is also what the kernel is held
against on the card. It replaces the JAX package's
ops/pallas/tri_scan.py::tri_scan_pallas, which intersect_mesh reaches for
meshes of at most DENSE_MESH_MAX_TRIS triangles (JAX intersect.py:290-296,
here ops/intersect.py::intersect_mesh).

Both read the mesh's tri_table rows [a, e1, e2], whose edges the scene
compile forms before the cast to float32 (models/scene.py::_compile_mesh),
so they may differ in the last bit from edges taken from tri_verts; the
kernel reads them padded to 48 bytes (mesh.tri_table4).

`LAUNCHES` counts the kernel's launches (and nothing else).
"""

from __future__ import annotations

import ctypes

import torch

from cs397raytracingsp22_tpu_torch.models.scene import MeshBlock
from cs397raytracingsp22_tpu_torch.ops import bvh as bvhlib
from cs397raytracingsp22_tpu_torch.ops.kernels import _build
from cs397raytracingsp22_tpu_torch.ops.kernels._build import check_tensor
from cs397raytracingsp22_tpu_torch.utils import vecmath as vm

LAUNCHES = 0

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [
    _P, _P, _P, _P, _I,  # o, d, t_min, t_max, n
    _P, _I,  # tri_table4, nt
    _P, _P, _P, _P, _P,  # hit, t, tri, u, v
    _P,  # stream
]


def library() -> ctypes.CDLL:
    """The built kernel library (builds it on first use)."""
    lib = _build.load_library("tri_scan")
    lib.rt_tri_scan_launch.argtypes = _ARGTYPES
    lib.rt_tri_scan_launch.restype = _I
    lib.rt_tri_scan_attrs.argtypes = [ctypes.POINTER(_I), ctypes.POINTER(_I)]
    lib.rt_tri_scan_attrs.restype = _I
    return lib


def kernel_attrs() -> tuple[int, int]:
    """(registers per thread, local spill bytes) of the compiled kernel."""
    regs, local = _I(), _I()
    rc = library().rt_tri_scan_attrs(ctypes.byref(regs), ctypes.byref(local))
    if rc != 0:
        raise RuntimeError(f"cudaFuncGetAttributes failed with CUDA error {rc}")
    return regs.value, local.value


def tri_scan_plain(tri_table: torch.Tensor, o, d, t_min, t_max, chunk: int = 256):
    """Nearest Möller–Trumbore hit of each ray over every row of tri_table
    (T, 9) [a, e1, e2], in the kernel's operation order: a running best
    with strict `<` from t_max, the earliest row winning ties (per chunk of
    `chunk` rows the earliest least t, then strictly nearer than the best
    so far).

    o, d: (N, 3); t_min, t_max: scalars or (N,). Returns (hit bool, t —
    inf on a miss, tri int32 — -1 on a miss, u, v)."""
    n = o.shape[0]
    nt = tri_table.shape[0]
    dev = o.device
    t_min = vm.as_f32(t_min, o)
    t_min = t_min[:, None] if t_min.ndim == 1 else t_min
    best_t = torch.broadcast_to(vm.as_f32(t_max, o), (n,)).clone()
    best_tri = torch.full((n,), -1, dtype=torch.int32, device=dev)
    best_u = torch.zeros((n,), dtype=torch.float32, device=dev)
    best_v = torch.zeros((n,), dtype=torch.float32, device=dev)
    rows = torch.arange(n, device=dev)
    ox, oy, oz = (o[:, k:k + 1] for k in range(3))
    dx, dy, dz = (d[:, k:k + 1] for k in range(3))
    for c0 in range(0, nt, chunk):
        ax, ay, az, e1x, e1y, e1z, e2x, e2y, e2z = tri_table[c0:c0 + chunk].T
        qx = dy * e2z - dz * e2y
        qy = dz * e2x - dx * e2z
        qz = dx * e2y - dy * e2x
        det = e1x * qx + e1y * qy + e1z * qz
        det_ok = torch.abs(det) >= bvhlib.MT_EPSILON
        f = 1.0 / torch.where(det_ok, det, torch.ones_like(det))
        sx, sy, sz = ox - ax, oy - ay, oz - az
        u = f * (sx * qx + sy * qy + sz * qz)
        rx = sy * e1z - sz * e1y
        ry = sz * e1x - sx * e1z
        rz = sx * e1y - sy * e1x
        v = f * (dx * rx + dy * ry + dz * rz)
        t = f * (e2x * rx + e2y * ry + e2z * rz)
        ok = (det_ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t >= t_min)
              & (t < best_t[:, None]))
        k = torch.argmin(torch.where(ok, t, torch.full_like(t, float("inf"))), dim=1)
        better = ok[rows, k]
        best_tri = torch.where(better, c0 + k.to(torch.int32), best_tri)
        best_u = torch.where(better, u[rows, k], best_u)
        best_v = torch.where(better, v[rows, k], best_v)
        best_t = torch.where(better, t[rows, k], best_t)
    hit = best_tri >= 0
    return hit, torch.where(hit, best_t, torch.full_like(best_t, float("inf"))), best_tri, \
        best_u, best_v


def _per_ray(name: str, x, o: torch.Tensor) -> torch.Tensor:
    """A scalar or a (N,) float32 tensor on o's device as a contiguous (N,)
    tensor."""
    n = o.shape[0]
    if not isinstance(x, torch.Tensor):
        return torch.full((n,), float(x), dtype=torch.float32, device=o.device)
    if x.ndim == 0:
        x = torch.broadcast_to(x, (n,)).contiguous()
    check_tensor(name, x, torch.float32, (n,), o.device)
    return x


def tri_scan_cuda(mesh: MeshBlock, o, d, t_min, t_max):
    """Nearest hit of each ray over every triangle of `mesh` with K5.

    o, d: (N, 3) float32 object-space rays; t_min, t_max: scalars or (N,)
    float32. Returns (hit bool, t — inf on a miss, tri int32 — a row of
    mesh.tri_table, -1 on a miss, u, v).
    CPU tensors run the plain version. CUDA tensors launch the kernel on
    the current stream; anything the kernel does not take, a failed build
    or a failed launch raises.
    """
    global LAUNCHES
    if o.device.type == "cpu":
        return tri_scan_plain(mesh.tri_table, o, d, t_min, t_max)
    if o.device.type != "cuda":
        raise ValueError(f"tri_scan_cuda takes CPU or CUDA tensors, got {o.device}")
    dev = o.device
    n = o.shape[0]
    nt = mesh.tri_table4.shape[0]
    check_tensor("o", o, torch.float32, (n, 3), dev)
    check_tensor("d", d, torch.float32, (n, 3), dev)
    check_tensor("mesh.tri_table4", mesh.tri_table4, torch.float32, (nt, 12), dev)
    t_min, t_max = _per_ray("t_min", t_min, o), _per_ray("t_max", t_max, o)
    if n >= 2**31 // 3 or nt >= 2**31 // 12:
        raise ValueError(f"{n} rays or {nt} triangles exceed the kernel's int32 indexing")
    hit = torch.empty((n,), dtype=torch.bool, device=dev)
    t = torch.empty((n,), dtype=torch.float32, device=dev)
    tri = torch.empty((n,), dtype=torch.int32, device=dev)
    u = torch.empty((n,), dtype=torch.float32, device=dev)
    v = torch.empty((n,), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = library().rt_tri_scan_launch(
            o.data_ptr(), d.data_ptr(), t_min.data_ptr(), t_max.data_ptr(), n,
            mesh.tri_table4.data_ptr(), nt, hit.data_ptr(), t.data_ptr(), tri.data_ptr(),
            u.data_ptr(), v.data_ptr(), stream,
        )
    if rc != 0:
        raise RuntimeError(f"dense triangle scan kernel launch failed with CUDA error {rc}")
    LAUNCHES += 1
    return hit, t, tri, u, v
