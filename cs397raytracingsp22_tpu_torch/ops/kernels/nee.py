"""N1, NEE's light sample: the light pick, the diffuse mask, the geometry
term and the shadow ray's set-up in one launch before the shadow ray, and
the contribution in one launch after it.

`nee_sample` (N1a) and `nee_contrib` (N1b) launch csrc/nee.cu (hand-written
CUDA C++ for sm_90a, built by _build.py) for CUDA tensors. For CPU tensors
they run the plain versions, render/nee.py::nee_sample_plain and
nee_contrib_plain, which the kernel is held to on the card bit for bit. It
replaces no Pallas kernel: the JAX package's NEE sample is jnp code that
XLA fuses, while the plain versions launch one torch kernel per operation
(~134 a NEE bounce).

N1a adapts to what its inputs show: the scene's counts of triangle and
sphere lights, and each ray's material type and normal.

`LAUNCHES` counts the kernel's launches by entry point (and nothing else).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from cs397raytracingsp22_tpu_torch.models import materials as mat
from cs397raytracingsp22_tpu_torch.models.scene import SceneData
from cs397raytracingsp22_tpu_torch.ops.intersect import HitRecord
from cs397raytracingsp22_tpu_torch.ops.kernels import _build
from cs397raytracingsp22_tpu_torch.ops.kernels._build import check_tensor

LAUNCHES = {"nee_sample": 0, "nee_contrib": 0}

# the sample launch's pointers, in csrc/nee.cu's struct order
POINTERS = ("live", "valid", "point", "normal", "mtype", "albedo", "roughness", "metallic",
            "d_in", "u_choice", "u", "lt_tri", "lt_sph", "did", "shoot", "sh_o", "sh_dir", "t_max",
            "pending")
# the hit record's fields the sample reads: (dtype, columns or None) over N rays
HIT_FIELDS = {"valid": (torch.bool, None), "point": (torch.float32, 3),
              "normal": (torch.float32, 3), "mtype": (torch.int32, None),
              "albedo": (torch.float32, 3), "roughness": (torch.float32, None),
              "metallic": (torch.float32, None)}
RAY_INPUTS = {"d_in": (torch.float32, 3), "u_choice": (torch.float32, None),
              "live": (torch.bool, None)}
# the light tables' row widths (models/scene.py)
TRI_ROW, SPH_ROW = 13, 7

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.cache
def library() -> ctypes.CDLL:
    """The built kernel library (builds it on first use), its entry points
    typed once and its layout checked against the wrapper's."""
    lib = _build.load_library("nee")
    lib.rt_nee_sample_launch.argtypes = [_P, _I, _I, _I, _I, ctypes.c_float, _P]
    lib.rt_nee_contrib_launch.argtypes = [_P, _P, _P, _I, _P]
    lib.rt_nee_attrs.argtypes = [_I, ctypes.POINTER(_I), ctypes.POINTER(_I)]
    lib.rt_nee_constants.argtypes = [ctypes.POINTER(_I)] * 6
    for fn in (lib.rt_nee_sample_launch, lib.rt_nee_contrib_launch, lib.rt_nee_attrs,
               lib.rt_nee_constants):
        fn.restype = _I
    got = [_I() for _ in range(6)]
    lib.rt_nee_constants(*(ctypes.byref(x) for x in got))
    want = [len(POINTERS), mat.LAMBERTIAN, mat.PARAMETERIZED, mat.ISOTROPIC, TRI_ROW, SPH_ROW]
    if [x.value for x in got] != want:
        raise RuntimeError(f"csrc/nee.cu takes (pointers, material types, row widths) "
                           f"{[x.value for x in got]}, the wrapper {want}")
    return lib


def kernel_attrs(entry: str) -> tuple[int, int]:
    """(registers per thread, local spill bytes) of an entry point:
    "nee_sample" (N1a) or "nee_contrib" (N1b)."""
    regs, local = _I(), _I()
    rc = library().rt_nee_attrs(tuple(LAUNCHES).index(entry), ctypes.byref(regs),
                                ctypes.byref(local))
    if rc != 0:
        raise RuntimeError(f"cudaFuncGetAttributes failed with CUDA error {rc}")
    return regs.value, local.value


def check_sample_inputs(scene: SceneData, hit: HitRecord, rays: dict, u, device) -> int:
    """Raise unless every input of a sample launch over N rays lies on
    `device` with the dtype, shape and contiguous layout the kernel reads
    (HIT_FIELDS of the hit record, RAY_INPUTS, the (N, M) draws with M >= 4,
    the light tables of the scene's counts) and the scene has a light;
    returns N."""
    live = rays["live"]
    n = live.shape[0] if live.ndim == 1 else -1
    specs = [(f"hit.{k}", getattr(hit, k), *HIT_FIELDS[k]) for k in HIT_FIELDS]
    specs += [(k, x, *RAY_INPUTS[k]) for k, x in rays.items()]
    for name, x, dtype, cols in specs:
        check_tensor(name, x, dtype, (n, cols) if cols else (n,), device)
    m = u.shape[1] if u.ndim == 2 else 0
    if m < 4:
        raise ValueError(f"u has shape {tuple(u.shape)}, expected (N, M) with M >= 4")
    check_tensor("u", u, torch.float32, (n, m), device)
    n_t, n_s = scene.n_lt_tri, scene.n_lt_sph
    if n_t + n_s == 0:
        raise ValueError("nee_sample on a scene with no NEE lights")
    # the compile pads each table to one row at least
    check_tensor("scene.lt_tri", scene.lt_tri, torch.float32, (max(n_t, 1), TRI_ROW), device)
    check_tensor("scene.lt_sph", scene.lt_sph, torch.float32, (max(n_s, 1), SPH_ROW), device)
    if m * n >= 2**31:
        raise ValueError(f"{n} rays of {m} draws exceed the kernel's int32 indexing")
    return n


def nee_sample(scene: SceneData, hit: HitRecord, d_in, u_choice, live, u, max_trace_dist: float):
    """NEE's sample and the shadow ray's set-up (nee_sample_plain's
    semantics and outputs): hit the bounce's hit record; d_in (N, 3) the
    incoming directions; u_choice (N,) the branch uniforms; live (N,) bool,
    the rays that may sample where they hit; u (N, 4 + V + G) NEE's draws.

    Returns (did, shoot, sh_o, sh_dir, t_max, pending). CPU tensors run
    nee_sample_plain; CUDA tensors launch N1a on the current stream (outputs
    from torch.empty), and anything it does not take, a failed build or a
    failed launch raises."""
    if d_in.device.type == "cpu":
        from cs397raytracingsp22_tpu_torch.render import nee as plain

        return plain.nee_sample_plain(scene, hit, d_in, u_choice, live, u, max_trace_dist)
    if d_in.device.type != "cuda":
        raise ValueError(f"nee_sample takes CPU or CUDA tensors, got {d_in.device}")
    dev = d_in.device
    rays = dict(d_in=d_in, u_choice=u_choice, live=live)
    n = check_sample_inputs(scene, hit, rays, u, dev)
    out = {k: torch.empty((n,), dtype=torch.bool, device=dev) for k in ("did", "shoot")}
    out |= {k: torch.empty((n, 3), dtype=torch.float32, device=dev)
            for k in ("sh_o", "sh_dir", "pending")}
    out["t_max"] = torch.empty((n,), dtype=torch.float32, device=dev)
    if n > 0:
        launch_sample(scene, hit, rays, u, max_trace_dist, out)
        LAUNCHES["nee_sample"] += 1
    return out["did"], out["shoot"], out["sh_o"], out["sh_dir"], out["t_max"], out["pending"]


def launch_sample(scene: SceneData, hit: HitRecord, rays: dict, u, max_trace_dist: float,
                  out: dict) -> None:
    """One launch of N1a on the current stream of the inputs' device over
    n > 0 rays, as nee_sample checks and allocates them. Counts nothing: the
    wrapper counts its launches, and a timing that leaves the checks and
    allocations out of its bracket calls this (chip_smoke.py)."""
    dev = rays["d_in"].device
    tensors = ({k: getattr(hit, k) for k in HIT_FIELDS} | rays | out
               | dict(u=u, lt_tri=scene.lt_tri, lt_sph=scene.lt_sph))
    ptrs = (_P * len(POINTERS))(*(tensors[k].data_ptr() for k in POINTERS))
    with torch.cuda.device(dev):
        rc = library().rt_nee_sample_launch(
            ptrs, u.shape[0], u.shape[1], scene.n_lt_tri, scene.n_lt_sph, max_trace_dist,
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"NEE sample kernel launch failed with CUDA error {rc}")


def nee_contrib(sh_valid, pending):
    """NEE's contribution after the shadow ray (nee_contrib_plain's
    semantics): 0 where the shadow ray hit something, else pending (which
    nee_sample leaves 0 where the ray did not shoot), (N, 3). CPU tensors
    run nee_contrib_plain; CUDA tensors launch N1b on the current stream,
    and anything it does not take raises."""
    if pending.device.type == "cpu":
        from cs397raytracingsp22_tpu_torch.render import nee as plain

        return plain.nee_contrib_plain(sh_valid, pending)
    if pending.device.type != "cuda":
        raise ValueError(f"nee_contrib takes CPU or CUDA tensors, got {pending.device}")
    dev = pending.device
    n = pending.shape[0] if pending.ndim == 2 else -1
    check_tensor("sh_valid", sh_valid, torch.bool, (n,), dev)
    check_tensor("pending", pending, torch.float32, (n, 3), dev)
    if 3 * n >= 2**31:
        raise ValueError(f"{n} rays exceed the kernel's int32 indexing")
    contrib = torch.empty((n, 3), dtype=torch.float32, device=dev)
    if n > 0:
        launch_contrib(sh_valid, pending, contrib)
        LAUNCHES["nee_contrib"] += 1
    return contrib


def launch_contrib(sh_valid, pending, contrib) -> None:
    """One launch of N1b over n > 0 rays, as nee_contrib checks and
    allocates them. Counts nothing."""
    dev = pending.device
    with torch.cuda.device(dev):
        rc = library().rt_nee_contrib_launch(
            sh_valid.data_ptr(), pending.data_ptr(), contrib.data_ptr(), pending.shape[0],
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"NEE contribution kernel launch failed with CUDA error {rc}")
