"""P4, the element-wise rate probe: `iters` rounds of y = y*y + 1;
y = y - y*x in float32 or bfloat16.

`dtype_rate_cuda` launches csrc/dtype_rate.cu (hand-written CUDA C++ for
sm_90a, built by _build.py) for CUDA tensors: f32 one thread an element,
bf16 one thread a pair (packed __nv_bfloat162). For CPU tensors it runs the
plain version, `dtype_rate_plain`, which the kernel is also held against on
the card. It replaces the JAX package's tools/profile_split.py::main.make_k;
the port's tools/profile_split.py times it.

The kernel fuses each round's two multiply-adds (one rounding each). The
plain version does too in float32, where it is bit-identical to the JAX
kernel run by XLA on the CPU; in bfloat16 it rounds after every operation
as XLA does, so there the kernel agrees with it within 2 units in the last
place (bf16 keeps 8 significant bits).

`LAUNCHES` counts the kernel's launches (and nothing else).
"""

from __future__ import annotations

import ctypes

import torch

from cs397raytracingsp22_tpu_torch.ops.kernels import _build
from cs397raytracingsp22_tpu_torch.ops.kernels.bounce import check_tensor
from cs397raytracingsp22_tpu_torch.ops.kernels.vpu_peak import fma_f32

LAUNCHES = 0
DTYPES = (torch.float32, torch.bfloat16)
OPS_PER_ROUND = 4  # multiply, add, multiply, subtract: the JAX tool's count

_P = ctypes.c_void_p
_I = ctypes.c_int


def library() -> ctypes.CDLL:
    """The built kernel library (builds it on first use)."""
    lib = _build.load_library("dtype_rate")
    lib.rt_dtype_rate_launch.argtypes = [_P, _P, _I, _I, _I, _P]
    lib.rt_dtype_rate_launch.restype = _I
    lib.rt_dtype_rate_attrs.argtypes = [_I, ctypes.POINTER(_I), ctypes.POINTER(_I)]
    lib.rt_dtype_rate_attrs.restype = _I
    return lib


def kernel_attrs(dtype=torch.float32) -> tuple[int, int]:
    """(registers per thread, local spill bytes) of the f32 or bf16 kernel."""
    regs, local = _I(), _I()
    rc = library().rt_dtype_rate_attrs(int(dtype == torch.bfloat16), ctypes.byref(regs),
                                       ctypes.byref(local))
    if rc != 0:
        raise RuntimeError(f"cudaFuncGetAttributes failed with CUDA error {rc}")
    return regs.value, local.value


def dtype_rate_plain(x: torch.Tensor, iters: int) -> torch.Tensor:
    """`iters` rounds of y = y*y + 1; y = y - y*x from y = x, in x's dtype
    (tools/profile_split.py::main.make_k). In float32 each line is one
    fused multiply-add (vpu_peak.fma_f32), as in the kernel and in XLA's
    CPU backend; in bfloat16 every operation rounds, as XLA's CPU backend
    rounds it, where the kernel's HFMA2 rounds once a line."""
    y = x
    for _ in range(iters):
        if x.dtype == torch.float32:
            y = fma_f32(y, y, 1.0)
            y = fma_f32(y, -x, y)
        else:
            y = y * y + 1.0
            y = y - y * x
    return y


def threads(x: torch.Tensor) -> int:
    """Threads the kernel launches for x: one an element in f32, one a pair
    in bf16."""
    return x.numel() // (2 if x.dtype == torch.bfloat16 else 1)


def dtype_rate_cuda(x: torch.Tensor, iters: int) -> torch.Tensor:
    """P4 on x (float32, or bfloat16 with an even number of elements).
    CPU tensors run the plain version; CUDA tensors launch the kernel on the
    current stream, and anything it does not take raises."""
    global LAUNCHES
    if x.device.type == "cpu":
        return dtype_rate_plain(x, iters)
    if x.device.type != "cuda":
        raise ValueError(f"dtype_rate_cuda takes CPU or CUDA tensors, got {x.device}")
    if x.dtype not in DTYPES:
        raise ValueError(f"x has dtype {x.dtype}, expected one of {DTYPES}")
    check_tensor("x", x, x.dtype, x.shape, x.device)
    n = x.numel()
    if n >= 2**31 or iters < 0 or (x.dtype == torch.bfloat16 and (n % 2 or x.data_ptr() % 4)):
        raise ValueError(f"P4 takes fewer than 2**31 elements, in bf16 an even count from a "
                         f"4-byte aligned address, and iters >= 0; got {n} elements, iters {iters}")
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        rc = library().rt_dtype_rate_launch(x.data_ptr(), out.data_ptr(), n, iters,
                                            int(x.dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError(f"dtype-rate kernel launch failed with CUDA error {rc}")
    LAUNCHES += 1
    return out
