"""P5, the Baldwin–Weber scan probe: each ray's nearest hit over G
triangles' Baldwin–Weber rows as a packed int32 min-key, on the SIMT cores
and on the tensor cores.

`bw_scan_cuda` (the scalar scan) and `bw_mma_cuda` (the same scan with its
dot products as mma.sync TF32 tiles) launch csrc/bw_scan.cu (hand-written
CUDA C++ for sm_90a, built by _build.py) for CUDA tensors; for CPU tensors
they run the plain versions `bw_scan_plain` and `bw_mma_plain`, which the
kernels are also held against on the card. They replace the JAX package's
tools/bench_mxu_scan.py::scalar_kernel and ::mxu_kernel; the port's
tools/bench_mxu_scan.py times them.

Keys: the scalar scan's is the bits of the nearest t; the matrix scan's
is (bits(t) & -4096) | triangle index, so t keeps 11 mantissa bits. A ray
without a hit keeps the bits of 1e9 (`hit_t` decodes both). The kernels
use MUFU's approximate reciprocal and fuse multiply-adds; the plain
versions divide exactly and round every operation, so the card holds
them by tolerance: the scalar keys agree once their low 12 bits are
dropped, the matrix scan's winners against `bw_mma_plain(..., tf32=True)`,
whose inputs are rounded to TF32 as the tensor cores round them.

`LAUNCHES` counts the scalar kernel's launches, `MMA_LAUNCHES` the matrix
kernel's (and nothing else).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from cs397raytracingsp22_tpu_torch.ops.kernels import _build
from cs397raytracingsp22_tpu_torch.ops.kernels.bounce import check_tensor
from cs397raytracingsp22_tpu_torch.ops.kernels.vpu_peak import fma_f32

LAUNCHES = 0
MMA_LAUNCHES = 0

GROUP = 64  # triangles a group in the matrix operands' layout (the JAX tool's GSTEP)
T_MIN = 1e-3
INT_MAX = 2147483647
EPS_BITS = int(np.float32(1e-4).view(np.int32))
FAR_BITS = int(np.float32(1e9).view(np.int32))
# FP32 operations a ray-triangle test: the scalar scan's 34 (dot products,
# the reciprocal, the hit point, u, v and the reject's subtractions); the
# matrix scan's epilogue after the products (the reciprocal, t, u, v and
# the reject's subtractions) and its products (6 dot products of 4 terms)
SCALAR_OPS, MMA_EPILOGUE_OPS, MMA_PRODUCT_OPS = 34, 9, 48

_P = ctypes.c_void_p
_I = ctypes.c_int


def library() -> ctypes.CDLL:
    """The built kernel library (builds it on first use)."""
    lib = _build.load_library("bw_scan")
    lib.rt_bw_scalar_launch.argtypes = [_P, _I, _P, _P, _I, _P, _P]
    lib.rt_bw_scalar_launch.restype = _I
    lib.rt_bw_mma_launch.argtypes = [_P, _P, _I, _P, _P, _I, _P, _P]
    lib.rt_bw_mma_launch.restype = _I
    lib.rt_bw_attrs.argtypes = [_I, ctypes.POINTER(_I), ctypes.POINTER(_I)]
    lib.rt_bw_attrs.restype = _I
    return lib


def kernel_attrs(mma: bool = False) -> tuple[int, int]:
    """(registers per thread, local spill bytes) of the scalar or mma kernel."""
    regs, local = _I(), _I()
    rc = library().rt_bw_attrs(int(mma), ctypes.byref(regs), ctypes.byref(local))
    if rc != 0:
        raise RuntimeError(f"cudaFuncGetAttributes failed with CUDA error {rc}")
    return regs.value, local.value


def mma_operands(bw: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The matrix scan's coefficient rows (3G, 4) from BW rows (G, 12), in
    the JAX tool's layout: per group of 64 triangles, 64 rows of
    [-n, n·a] (num), 64 of [ū, -ū·a] (u0), 64 of [v̄, -v̄·a] (v0) for
    lhs_o; [n, 0], [ū, 0], [v̄, 0] (den, ud, vd) for lhs_d."""
    g = bw.shape[0]
    if g % GROUP:
        raise ValueError(f"{g} triangles: the matrix scan takes a multiple of {GROUP}")
    z = torch.zeros_like(bw[:, 0])

    def lay(*cols):
        return torch.stack(cols, 1).reshape(g // GROUP, GROUP, 4)

    lhs_o = torch.cat([lay(-bw[:, 0], -bw[:, 1], -bw[:, 2], bw[:, 3]),
                       lay(*bw[:, 4:8].T), lay(*bw[:, 8:12].T)], dim=1)
    lhs_d = torch.cat([lay(*bw[:, 0:3].T, z), lay(*bw[:, 4:7].T, z),
                       lay(*bw[:, 8:11].T, z)], dim=1)
    return lhs_o.reshape(3 * g, 4).contiguous(), lhs_d.reshape(3 * g, 4).contiguous()


def ray_planes(o: torch.Tensor, d: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(4, N) planes [o; 1] and [d; 0] from (N, 3) origins and directions;
    the scalar scan reads their first three rows."""
    n = o.shape[0]
    o4 = torch.cat([o.T, torch.ones((1, n), dtype=o.dtype, device=o.device)])
    d4 = torch.cat([d.T, torch.zeros((1, n), dtype=d.dtype, device=d.device)])
    return o4.contiguous(), d4.contiguous()


def hit_t(key: torch.Tensor, mma: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """(hit, t) from a key: t's bits (the matrix key's low 12 bits dropped),
    a hit where t < 1e8 (the JAX tool's decode)."""
    t = (key & -4096 if mma else key).view(torch.float32)
    return t < 1e8, t


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10 mantissa bits, to nearest with ties away
    from zero, as cvt.rna.tf32.f32 rounds (finite inputs)."""
    return ((x.view(torch.int32) + 0x1000) & -8192).view(torch.float32)


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int32)


def _reject(t, u, v, den) -> torch.Tensor:
    rej = (_bits(u) | _bits(v)) | (_bits((1.0 - u) - v) | _bits(t - T_MIN))
    return rej | ((_bits(den) & 0x7FFFFFFF) - EPS_BITS)


def bw_scan_plain(bw: torch.Tensor, o: torch.Tensor, d: torch.Tensor,
                  chunk: int = 8192) -> torch.Tensor:
    """The scalar scan in torch (tools/bench_mxu_scan.py::scalar_kernel in
    its operation order, with an exact reciprocal): bw (G, 12), o and d
    (3, N) planes (or the (4, N) planes of ray_planes). Returns the (N,)
    int32 keys, min(bits(1e9), bits(t) of each unrejected triangle).

    Its multiply-adds are fused (fma_f32) where XLA's CPU backend fuses the
    JAX kernel's: a0*x + a1*y + a2*z as fma(a2, z, fma(a0, x, a1*y)) and
    o + t*d as fma(t, d, o); with an exact reciprocal the two then give the
    same keys. num's cancellation (n·a - n·o) makes t sensitive to that
    choice: unfused, 3% of 8,192 rays' keys differ in the last bits."""
    n = o.shape[1]
    b = [bw[:, k] for k in range(12)]
    out = torch.empty((n,), dtype=torch.int32, device=o.device)

    def dot3(a0, x, a1, y, a2, z):  # a0*x + a1*y + a2*z, contracted as XLA does
        return fma_f32(a2, z, fma_f32(a0, x, a1 * y))

    for c0 in range(0, n, chunk):
        ox, oy, oz = (o[k, c0:c0 + chunk, None] for k in range(3))
        dx, dy, dz = (d[k, c0:c0 + chunk, None] for k in range(3))
        den = dot3(b[0], dx, b[1], dy, b[2], dz)
        num = b[3] - dot3(b[0], ox, b[1], oy, b[2], oz)
        t = num * (1.0 / den)
        px, py, pz = fma_f32(t, dx, ox), fma_f32(t, dy, oy), fma_f32(t, dz, oz)
        u = dot3(b[4], px, b[5], py, b[6], pz) + b[7]
        v = dot3(b[8], px, b[9], py, b[10], pz) + b[11]
        cand = torch.where(_reject(t, u, v, den) < 0, INT_MAX, _bits(t))
        out[c0:c0 + chunk] = torch.clamp(cand.amin(dim=1), max=FAR_BITS)
    return out


def bw_mma_plain(lhs_o: torch.Tensor, lhs_d: torch.Tensor, o4: torch.Tensor,
                 d4: torch.Tensor, tf32: bool = False, chunk: int = 8192) -> torch.Tensor:
    """The matrix scan in torch (tools/bench_mxu_scan.py::mxu_kernel, with
    an exact reciprocal and its products as float32 sums of 4 terms in
    order): lhs_o, lhs_d (3G, 4) from mma_operands, o4, d4 (4, N) from
    ray_planes. tf32=True rounds the operands to TF32 first, as the
    kernel's tensor cores see them. Returns the (N,) int32 keys,
    min(bits(1e9), (bits(t) & -4096) | triangle of each unrejected one)."""
    g = lhs_o.shape[0] // 3
    if tf32:
        lhs_o, lhs_d, o4, d4 = (round_tf32(x) for x in (lhs_o, lhs_d, o4, d4))
    # (kind, G, 4): kind 0, 1, 2 = num, u0, v0 (lhs_o) or den, ud, vd (lhs_d)
    ao, ad = (x.reshape(g // GROUP, 3, GROUP, 4).transpose(0, 1).reshape(3, g, 4)
              for x in (lhs_o, lhs_d))
    tri = torch.arange(g, dtype=torch.int32, device=o4.device)
    n = o4.shape[1]
    out = torch.empty((n,), dtype=torch.int32, device=o4.device)

    def dot(a, r):  # (chunk, G): a (G, 4) against r (4, chunk)
        acc = a[:, 0] * r[0, :, None]
        for c in range(1, 4):
            acc = acc + a[:, c] * r[c, :, None]
        return acc

    for c0 in range(0, n, chunk):
        ro, rd = o4[:, c0:c0 + chunk], d4[:, c0:c0 + chunk]
        num, u0, v0 = (dot(ao[k], ro) for k in range(3))
        den, ud, vd = (dot(ad[k], rd) for k in range(3))
        t = num * (1.0 / den)
        u = u0 + t * ud
        v = v0 + t * vd
        cand = torch.where(_reject(t, u, v, den) < 0, INT_MAX, (_bits(t) & -4096) | tri)
        out[c0:c0 + chunk] = torch.clamp(cand.amin(dim=1), max=FAR_BITS)
    return out


def bw_scan_cuda(bw: torch.Tensor, o: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """The scalar scan: bw (G, 12) with G a multiple of 16 up to 4,096, o and
    d (3, N) float32 planes (or ray_planes' (4, N), of which it reads three
    rows). CPU tensors run bw_scan_plain; CUDA tensors
    launch the kernel on the current stream, and anything it does not take
    raises."""
    global LAUNCHES
    if o.device.type == "cpu":
        return bw_scan_plain(bw, o, d)
    if o.device.type != "cuda":
        raise ValueError(f"bw_scan_cuda takes CPU or CUDA tensors, got {o.device}")
    g, n = bw.shape[0], o.shape[1]
    if g % 16 or not 0 < g <= 4096 or n >= 2**31 // 3:
        raise ValueError(f"the scalar scan takes 16..4096 triangles in steps of 16 and fewer "
                         f"than 2**31 / 3 rays; got {g} and {n}")
    check_tensor("bw", bw, torch.float32, (g, 12), o.device)
    if o.shape[0] not in (3, 4):
        raise ValueError(f"o has shape {tuple(o.shape)}, expected (3, N) or (4, N) planes")
    check_tensor("o", o, torch.float32, (o.shape[0], n), o.device)
    check_tensor("d", d, torch.float32, (o.shape[0], n), o.device)
    key = torch.empty((n,), dtype=torch.int32, device=o.device)
    stream = torch.cuda.current_stream(o.device).cuda_stream
    with torch.cuda.device(o.device):
        rc = library().rt_bw_scalar_launch(bw.data_ptr(), g, o.data_ptr(), d.data_ptr(), n,
                                           key.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"scalar BW scan launch failed with CUDA error {rc}")
    LAUNCHES += 1
    return key


def bw_mma_cuda(lhs_o: torch.Tensor, lhs_d: torch.Tensor, o4: torch.Tensor,
                d4: torch.Tensor) -> torch.Tensor:
    """The matrix scan: lhs_o, lhs_d (3G, 4) from mma_operands with G a
    multiple of 64 up to 2,048, o4 and d4 (4, N) float32 from ray_planes.
    CPU tensors run bw_mma_plain; CUDA tensors launch the kernel on the
    current stream, and anything it does not take raises."""
    global MMA_LAUNCHES
    if o4.device.type == "cpu":
        return bw_mma_plain(lhs_o, lhs_d, o4, d4)
    if o4.device.type != "cuda":
        raise ValueError(f"bw_mma_cuda takes CPU or CUDA tensors, got {o4.device}")
    g, n = lhs_o.shape[0] // 3, o4.shape[1]
    if g % GROUP or not 0 < g <= 2048 or n >= 2**31 // 4:
        raise ValueError(f"the matrix scan takes 64..2048 triangles in steps of 64 and fewer "
                         f"than 2**31 / 4 rays; got {g} and {n}")
    for name, x in (("lhs_o", lhs_o), ("lhs_d", lhs_d)):
        check_tensor(name, x, torch.float32, (3 * g, 4), o4.device)
    check_tensor("o4", o4, torch.float32, (4, n), o4.device)
    check_tensor("d4", d4, torch.float32, (4, n), o4.device)
    key = torch.empty((n,), dtype=torch.int32, device=o4.device)
    stream = torch.cuda.current_stream(o4.device).cuda_stream
    with torch.cuda.device(o4.device):
        rc = library().rt_bw_mma_launch(lhs_o.data_ptr(), lhs_d.data_ptr(), g, o4.data_ptr(),
                                        d4.data_ptr(), n, key.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"mma BW scan launch failed with CUDA error {rc}")
    MMA_LAUNCHES += 1
    return key
