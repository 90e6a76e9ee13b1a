"""S1, the per-bounce shading: the miss and emission terms, the five-way
BSDF, the dot term, NEE's term and the path's update in one launch a
bounce.

`shade_update` launches csrc/shade.cu (hand-written CUDA C++ for sm_90a,
built by _build.py) for CUDA tensors. For CPU tensors it runs the plain
version, ops/bsdf.py::shade_plain, which the kernel is held to on the card
bit for bit. It replaces no Pallas kernel: the JAX package's bounce body is
jnp code that XLA fuses, while the plain version launches one torch kernel
per operation (~170 a bounce).

Two instantiations, chosen by what the call passes: the path's, and NEE's
where the bounce took a NEE sample (`nee` given), which adds its term and
writes the flags that suppress the next vertex's emission. `prev_nee`, the
flags of the previous vertex, may come with either (NEE's last bounce takes
no sample) or with neither (a path's bounce; NEE's first).

`LAUNCHES` counts the kernel's launches (and nothing else).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from cs397raytracingsp22_tpu_torch.models import materials as mat
from cs397raytracingsp22_tpu_torch.ops import bsdf
from cs397raytracingsp22_tpu_torch.ops.intersect import HitRecord
from cs397raytracingsp22_tpu_torch.ops.kernels import _build
from cs397raytracingsp22_tpu_torch.ops.kernels._build import check_tensor

LAUNCHES = {"shade": 0}

# the launch's pointers, in csrc/shade.cu's struct order
POINTERS = ("alive", "valid", "point", "normal", "frontface", "mtype", "albedo", "emission",
            "roughness", "metallic", "ior", "o", "d", "thr", "rad", "ball", "u_choice",
            "prev_nee", "contrib", "did", "o_out", "d_out", "thr_out", "rad_out", "live_hit",
            "prev_out")
# the inputs a launch reads: (dtype, columns or None) over N rays
HIT_FIELDS = {"valid": (torch.bool, None), "point": (torch.float32, 3),
              "normal": (torch.float32, 3), "frontface": (torch.bool, None),
              "mtype": (torch.int32, None), "albedo": (torch.float32, 3),
              "emission": (torch.float32, 3), "roughness": (torch.float32, None),
              "metallic": (torch.float32, None), "ior": (torch.float32, None)}
STATE = {"o": (torch.float32, 3), "d": (torch.float32, 3), "thr": (torch.float32, 3),
         "rad": (torch.float32, 3), "alive": (torch.bool, None), "ball": (torch.float32, 3),
         "u_choice": (torch.float32, None)}
NEE_INPUTS = {"prev_nee": (torch.bool, None), "contrib": (torch.float32, 3),
              "did": (torch.bool, None)}

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.cache
def library() -> ctypes.CDLL:
    """The built kernel library (builds it on first use), its entry points
    typed once and its layout checked against the wrapper's."""
    lib = _build.load_library("shade")
    lib.rt_shade_launch.argtypes = [_P, _I, _I, _P]
    lib.rt_shade_attrs.argtypes = [_I, ctypes.POINTER(_I), ctypes.POINTER(_I)]
    lib.rt_shade_constants.argtypes = [ctypes.POINTER(_I)] * 6
    for fn in (lib.rt_shade_launch, lib.rt_shade_attrs, lib.rt_shade_constants):
        fn.restype = _I
    got = [_I() for _ in range(6)]
    lib.rt_shade_constants(*(ctypes.byref(x) for x in got))
    want = [len(POINTERS), mat.LAMBERTIAN, mat.METAL, mat.DIELECTRIC, mat.PARAMETERIZED,
            mat.ISOTROPIC]
    if [x.value for x in got] != want:
        raise RuntimeError(f"csrc/shade.cu takes (pointers, material types) "
                           f"{[x.value for x in got]}, the wrapper {want}")
    return lib


def kernel_attrs(nee: bool = False) -> tuple[int, int]:
    """(registers per thread, local spill bytes) of the path's instantiation,
    or NEE's."""
    regs, local = _I(), _I()
    rc = library().rt_shade_attrs(int(nee), ctypes.byref(regs), ctypes.byref(local))
    if rc != 0:
        raise RuntimeError(f"cudaFuncGetAttributes failed with CUDA error {rc}")
    return regs.value, local.value


def check_inputs(hit: HitRecord, state: dict, nee_inputs: dict, device) -> int:
    """Raise unless every input of a launch over N rays lies on `device` with
    the dtype, shape and contiguous layout the kernel reads (HIT_FIELDS of
    the hit record, STATE, and those of NEE_INPUTS given, None for the
    others); returns N."""
    alive = state["alive"]
    n = alive.shape[0] if alive.ndim == 1 else -1
    specs = [(f"hit.{k}", getattr(hit, k), *HIT_FIELDS[k]) for k in HIT_FIELDS]
    specs += [(k, x, *(STATE | NEE_INPUTS)[k]) for k, x in (state | nee_inputs).items()
              if x is not None]
    for name, x, dtype, cols in specs:
        check_tensor(name, x, dtype, (n, cols) if cols else (n,), device)
    if 3 * n >= 2**31:
        raise ValueError(f"{n} rays exceed the kernel's int32 indexing")
    return n


def shade_update(hit: HitRecord, o, d, thr, rad, alive, ball, u_choice, prev_nee=None,
                 nee=None):
    """One bounce's shading after the intersection (shade_plain's semantics
    and outputs): hit the bounce's hit record; o, d, thr, rad the (N, 3)
    path state; alive (N,) bool; ball, u_choice the bounce's draws;
    prev_nee None or the previous vertex's (N,) NEE flags; nee None or
    (contrib (N, 3), did (N,) bool), the bounce's NEE sample.

    Returns (o, d, thr, rad, live_hit, prev_nee): prev_nee the flags for the
    next vertex where nee is given, else None. CPU tensors run shade_plain;
    CUDA tensors launch S1 on the current stream (outputs from torch.empty),
    and anything it does not take, a failed build or a failed launch
    raises."""
    if o.device.type == "cpu":
        return bsdf.shade_plain(hit, o, d, thr, rad, alive, ball, u_choice, prev_nee, nee)
    if o.device.type != "cuda":
        raise ValueError(f"shade_update takes CPU or CUDA tensors, got {o.device}")
    dev = o.device
    state = dict(o=o, d=d, thr=thr, rad=rad, alive=alive, ball=ball, u_choice=u_choice)
    contrib, did = nee if nee is not None else (None, None)
    nee_inputs = dict(prev_nee=prev_nee, contrib=contrib, did=did)
    n = check_inputs(hit, state, nee_inputs, dev)
    out = {k: torch.empty((n, 3), dtype=torch.float32, device=dev)
           for k in ("o_out", "d_out", "thr_out", "rad_out")}
    out["live_hit"] = torch.empty((n,), dtype=torch.bool, device=dev)
    out["prev_out"] = torch.empty((n,), dtype=torch.bool, device=dev) if nee is not None else None
    if n > 0:
        launch(hit, state, nee_inputs, out)
        LAUNCHES["shade"] += 1
    return (out["o_out"], out["d_out"], out["thr_out"], out["rad_out"], out["live_hit"],
            out["prev_out"])


def launch(hit: HitRecord, state: dict, nee_inputs: dict, out: dict) -> None:
    """One launch of the kernel on the current stream of the inputs' device
    over n > 0 rays, as shade_update checks and allocates them: NEE's
    instantiation where out holds "prev_out". Counts nothing: the wrapper
    counts its launches, and a timing that leaves the checks and
    allocations out of its bracket calls this (chip_smoke.py)."""
    dev = state["o"].device
    tensors = {k: getattr(hit, k) for k in HIT_FIELDS} | state | nee_inputs | out
    ptrs = (_P * len(POINTERS))(*(0 if tensors[k] is None else tensors[k].data_ptr()
                                  for k in POINTERS))
    nee = out["prev_out"] is not None
    with torch.cuda.device(dev):
        rc = library().rt_shade_launch(ptrs, state["o"].shape[0], int(nee),
                                       torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"shade kernel launch failed with CUDA error {rc}")
