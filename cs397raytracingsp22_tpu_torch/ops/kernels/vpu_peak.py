"""P1-P3, the issue-rate probes: independent chains of `v*v + 0.4` (and
integer chains) per element, straight-line (P1), in a loop of a given body
size (P2), or with a fresh table coefficient a step (P3).

`chain_cuda`, `looped_cuda` and `table_cuda` launch csrc/vpu_peak.cu
(hand-written CUDA C++ for sm_90a, one template chain<Mix, U, Coef>, built
by _build.py) for CUDA tensors; for CPU tensors they run the plain
versions `chain_plain`, `looped_plain` and `table_plain`, which the kernel
is also held against on the card. They replace the JAX package's
tools/vpu_peak.py::make_kernel, tools/vpu_peak_shape.py::make_kernel and
tools/vpu_peak_smem.py::make_kernel; the port's tools of the same names
(cs397raytracingsp22_tpu_torch/tools/) time them.

The kernel fuses each `v*v + c` into one FMA (built with -fmad=true), and
so do the plain versions (fma_f32) and XLA's CPU backend, which contracts
the JAX kernels' multiply and add when it runs them in interpret mode. The
chains double their relative error each step, so the card holds the
kernel to the plain version within rtol 1e-3 up to 12 steps; beyond ~13
steps the f32 chains from 0.3 overflow to inf (fma) or underflow to 0
(mul), and only that pattern and the integer bits can be compared.

`LAUNCHES` counts the kernel's launches (and nothing else).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from cs397raytracingsp22_tpu_torch.ops.kernels import _build
from cs397raytracingsp22_tpu_torch.ops.kernels.bounce import check_tensor

LAUNCHES = 0

CHAINS = 8
TABLE = 4096  # P3's coefficient table: 512 steps × 8 chains
MIXES = ("fma", "mul", "i32", "both")
# where P3's addend lives: the constant 0.4, or the table in shared memory,
# __constant__ memory or read through the read-only cache
MEMORIES = ("const", "shared", "constant", "ldg")
P1_UNROLLS = (4, 12, 256, 1024)
P2_BODIES = (1, 2, 8, 48, 176, 512)
ADD_04 = float(np.float32(0.4))  # the chains' addend, the float32 nearest 0.4
# (mix, u, memory) of every instantiation in csrc/vpu_peak.cu
VARIANTS = frozenset(
    [(m, u, "const") for m in MIXES for u in P1_UNROLLS]
    + [("fma", u, "const") for u in P2_BODIES]
    + [("fma", 1, mem) for mem in MEMORIES[1:]]
)

_P = ctypes.c_void_p
_I = ctypes.c_int


def library() -> ctypes.CDLL:
    """The built kernel library (builds it on first use)."""
    lib = _build.load_library("vpu_peak")
    lib.rt_vpu_chain_launch.argtypes = [_P, _P, _P, _I, _I, _I, _I, _I, _P]
    lib.rt_vpu_chain_launch.restype = _I
    lib.rt_vpu_chain_attrs.argtypes = [_I, _I, _I, ctypes.POINTER(_I), ctypes.POINTER(_I)]
    lib.rt_vpu_chain_attrs.restype = _I
    return lib


def kernel_attrs(mix: str = "fma", u: int = 1024, memory: str = "const") -> tuple[int, int]:
    """(registers per thread, local spill bytes) of chain<mix, u, memory>."""
    regs, local = _I(), _I()
    rc = library().rt_vpu_chain_attrs(MIXES.index(mix), u, MEMORIES.index(memory),
                                      ctypes.byref(regs), ctypes.byref(local))
    if rc != 0:
        raise RuntimeError(f"cudaFuncGetAttributes failed with CUDA error {rc}")
    return regs.value, local.value


def fma_f32(a: torch.Tensor, b: torch.Tensor, c) -> torch.Tensor:
    """a*b + c for float32 a, b, c, rounded once to float32 as a fused
    multiply-add rounds: the product of two float32 is exact in float64, so
    only the sum's rounding remains (a double rounding can differ from a
    true FMA's in the last bit, about once in 2**29 operations)."""
    a64 = a.double()
    return (a64 * (a64 if b is a else b.double()) + c).float()


def _f32_chains(x: torch.Tensor, n: int) -> torch.Tensor:
    """(n, *x.shape): chain k starts at x * (1 + 0.001 k)."""
    return torch.stack([x * (1.0 + 0.001 * k) for k in range(n)])


def _sum(v: torch.Tensor) -> torch.Tensor:
    acc = v[0]
    for vk in v[1:]:
        acc = acc + vk
    return acc


def _xor(v: torch.Tensor) -> torch.Tensor:
    acc = v[0]
    for vk in v[1:]:
        acc = acc ^ vk
    return acc


def chain_plain(x: torch.Tensor, mix: str, unroll: int, steps: int = 1) -> torch.Tensor:
    """P1's function in torch: 8 chains over `unroll * steps` steps of the
    mix's expression, summed in order (XORed for i32) into a float32 tensor
    of x's shape (tools/vpu_peak.py::make_kernel). Each `v*v + 0.4` is one
    fused multiply-add (fma_f32), as the kernel (built with -fmad=true) and
    XLA's CPU backend, which runs the JAX kernel in interpret mode, both
    compute it."""
    n = unroll * steps
    if mix in ("fma", "mul"):
        v = _f32_chains(x, CHAINS)
        for _ in range(n):
            v = fma_f32(v, v, ADD_04) if mix == "fma" else v * v
        return _sum(v)
    xi = x.to(torch.int32)
    if mix == "i32":
        w = torch.stack([xi + k for k in range(CHAINS)])
        for _ in range(n):
            w = (w & 0x7FFFFFF1) + 12345
        return _xor(w).to(torch.float32)
    if mix != "both":
        raise ValueError(f"mix must be one of {MIXES}, got {mix!r}")
    v = _f32_chains(x, CHAINS // 2)
    w = torch.stack([xi + k for k in range(CHAINS // 2)])
    for _ in range(n):
        v = fma_f32(v, v, ADD_04)
        w = (w ^ 0x5A5A5A5) + 12345
    return _sum(v) + _xor(w).to(torch.float32)


def looped_plain(x: torch.Tensor, u: int, steps: int) -> torch.Tensor:
    """P2's function in torch: `steps` iterations of u rounds of the 8
    fma chains (tools/vpu_peak_shape.py::make_kernel)."""
    return chain_plain(x, "fma", u, steps)


def table_plain(x: torch.Tensor, coefs: torch.Tensor | None, steps: int) -> torch.Tensor:
    """P3's function in torch: `steps` steps of v_k = v_k*v_k + c, one fused
    multiply-add, with c = coefs[step * 8 + k], or 0.4 where coefs is None
    (tools/vpu_peak_smem.py::make_kernel)."""
    v = _f32_chains(x, CHAINS)
    for s in range(steps):
        c = ADD_04 if coefs is None else \
            coefs[s * CHAINS:(s + 1) * CHAINS].double().reshape((CHAINS,) + (1,) * x.ndim)
        v = fma_f32(v, v, c)
    return _sum(v)


def _launch(x: torch.Tensor, mix: str, u: int, memory: str, steps: int,
            coefs: torch.Tensor | None) -> torch.Tensor:
    global LAUNCHES
    if x.device.type != "cuda":
        raise ValueError(f"the chain kernel takes CPU or CUDA tensors, got {x.device}")
    if (mix, u, memory) not in VARIANTS:
        raise ValueError(f"csrc/vpu_peak.cu has no chain<{mix}, {u}, {memory}>; built: "
                         f"{sorted(VARIANTS)}")
    if steps < 0:
        raise ValueError(f"steps must be >= 0, got {steps}")
    n = x.numel()
    check_tensor("x", x, torch.float32, x.shape, x.device)
    if n >= 2**31:
        raise ValueError(f"{n} elements exceed the kernel's int32 indexing")
    if memory != "const":
        if coefs is None:
            raise ValueError(f"a {memory} table needs coefs")
        check_tensor("coefs", coefs, torch.float32, (TABLE,), x.device)
        if steps * u * CHAINS > TABLE:
            raise ValueError(f"{steps} steps × {u} rounds × 8 chains exceed the {TABLE}-entry table")
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        rc = library().rt_vpu_chain_launch(
            x.data_ptr(), coefs.data_ptr() if coefs is not None else None, out.data_ptr(), n,
            MIXES.index(mix), u, MEMORIES.index(memory), steps, stream)
    if rc != 0:
        raise RuntimeError(f"chain kernel launch failed with CUDA error {rc}")
    LAUNCHES += 1
    return out


def chain_cuda(x: torch.Tensor, mix: str, unroll: int) -> torch.Tensor:
    """P1: one straight-line body of `unroll` rounds (unroll in P1_UNROLLS).
    CPU tensors run chain_plain; CUDA tensors launch the kernel on the
    current stream, and anything it does not take raises."""
    if x.device.type == "cpu":
        return chain_plain(x, mix, unroll)
    if unroll not in P1_UNROLLS:
        raise ValueError(f"P1 is built for unroll {P1_UNROLLS}, got {unroll}")
    return _launch(x, mix, unroll, "const", 1, None)


def looped_cuda(x: torch.Tensor, u: int, steps: int) -> torch.Tensor:
    """P2: a loop of `steps` iterations of a u-round body (u in P2_BODIES)."""
    if x.device.type == "cpu":
        return looped_plain(x, u, steps)
    return _launch(x, "fma", u, "const", steps, None)


def table_cuda(x: torch.Tensor, coefs: torch.Tensor | None, steps: int,
               memory: str) -> torch.Tensor:
    """P3: `steps` single-round steps whose addend comes from `memory`
    (MEMORIES; "const" is the control with 0.4 and no table)."""
    if x.device.type == "cpu":
        return table_plain(x, None if memory == "const" else coefs, steps)
    return _launch(x, "fma", 1, memory, steps, None if memory == "const" else coefs)
