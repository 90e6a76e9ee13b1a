"""D1, the draws layer: camera rays, a bounce's draws and NEE's draws, one
launch each.

`camera_rays`, `bounce_draws` and `counter_uniforms` launch
csrc/draws.cu (hand-written CUDA C++ for sm_90a, built by _build.py) for
CUDA tensors. The plain versions, which the kernels are held against on the
card bit for bit, run for CPU tensors: `bounce_draws` and
`counter_uniforms` call them, and `Camera.generate_rays` calls
`camera_rays` only for CUDA pixel ids, `Camera.generate_rays_plain`
otherwise. The others are `bounce_draws_plain` and
`utils/threefry.py::counter_uniforms`. It replaces no Pallas kernel: the
JAX package leaves utils/threefry.py's jnp ops to XLA, which fuses them,
while the plain versions here launch one torch kernel per masked int64
operation (~350 for four uniforms).

`camera_args` folds the camera's scalars on the host as the plain version
rounds them on the card: a Python double becomes float32 where it meets a
float32 tensor, and a division by a Python scalar is a multiply by the
float32 reciprocal (torch's CUDA division by a CPU scalar).

`LAUNCHES` counts each entry point's launches (and nothing else).
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from cs397raytracingsp22_tpu_torch.ops.kernels import _build
from cs397raytracingsp22_tpu_torch.ops.kernels._build import check_tensor
from cs397raytracingsp22_tpu_torch.utils import sampling
from cs397raytracingsp22_tpu_torch.utils import threefry
from cs397raytracingsp22_tpu_torch.utils import vecmath as vm

LAUNCHES = {"camera_rays": 0, "bounce_draws": 0, "counter_uniforms": 0}

# the camera launch's parameter blocks, in csrc/draws.cu's struct order
CAMERA_INTS = ("width", "aa", "rootn_i", "sample_offset", "ortho")
CAMERA_FLOATS = ("n", "half_rootn", "pixel_size", "inv_rootn", "half_n", "inv_n", "half_w",
                 "half_h_plus", "neg_focal", "two_pi", "lens_radius", "focus_dist",
                 "eye0", "eye1", "eye2", "rot00", "rot01", "rot02", "rot10", "rot11", "rot12",
                 "rot20", "rot21", "rot22", "ortho_dir0", "ortho_dir1", "ortho_dir2")

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint


@functools.cache
def library() -> ctypes.CDLL:
    """The built kernel library (builds it on first use), its entry points
    typed once: the draws launch ~300 times an image."""
    lib = _build.load_library("draws")
    lib.rt_camera_rays_launch.argtypes = [_P, _I, _I, _U, _U, _P, _P, _P, _P, _P]
    lib.rt_bounce_draws_launch.argtypes = [_P, _I, _U, _U, _U, _I, _P, _P, _P, _P]
    lib.rt_counter_uniforms_launch.argtypes = [_P, _I, _U, _U, _U, _I, _P, _P]
    lib.rt_camera_param_counts.argtypes = [ctypes.POINTER(_I), ctypes.POINTER(_I)]
    lib.rt_draws_attrs.argtypes = [_I, ctypes.POINTER(_I), ctypes.POINTER(_I)]
    for fn in (lib.rt_camera_rays_launch, lib.rt_bounce_draws_launch,
               lib.rt_counter_uniforms_launch, lib.rt_camera_param_counts, lib.rt_draws_attrs):
        fn.restype = _I
    n_i, n_f = _I(), _I()
    lib.rt_camera_param_counts(ctypes.byref(n_i), ctypes.byref(n_f))
    if (n_i.value, n_f.value) != (len(CAMERA_INTS), len(CAMERA_FLOATS)):
        raise RuntimeError(f"csrc/draws.cu takes {n_i.value} ints and {n_f.value} floats for a "
                           f"camera, the wrapper builds {len(CAMERA_INTS)} and "
                           f"{len(CAMERA_FLOATS)}")
    return lib


def kernel_attrs(entry: str) -> tuple[int, int]:
    """(registers per thread, local spill bytes) of one entry point."""
    regs, local = _I(), _I()
    rc = library().rt_draws_attrs(list(LAUNCHES).index(entry), ctypes.byref(regs),
                                  ctypes.byref(local))
    if rc != 0:
        raise RuntimeError(f"cudaFuncGetAttributes failed with CUDA error {rc}")
    return regs.value, local.value


def _f32(x) -> float:
    return float(np.float32(x))


def camera_args(camera, sample_offset: int) -> tuple[dict, dict]:
    """The camera launch's (ints, floats), keyed by CAMERA_INTS and
    CAMERA_FLOATS: each scalar of Camera.generate_rays_plain as that
    version's torch ops on the card round it."""
    n = float(camera.aa_sample_count)
    rootn = math.sqrt(n)
    pixel_size = 1.0 / float(camera.screen_height)
    ints = dict(width=camera.screen_width, aa=camera.aa_sample_count, rootn_i=int(rootn),
                sample_offset=int(sample_offset), ortho=int(camera.projection_mode.value
                                                            == "orthographic"))
    rot = camera.rotation(torch.device("cpu"))
    view = torch.tensor(camera.view_dir, dtype=torch.float32)
    ortho_dir = vm.apply_mat3(rot, view)
    floats = dict(
        n=_f32(n), half_rootn=_f32(0.5 * rootn), pixel_size=_f32(pixel_size),
        inv_rootn=_f32(np.float32(1.0) / np.float32(rootn)), half_n=_f32(0.5 * n),
        inv_n=_f32(np.float32(1.0) / np.float32(n)), half_w=_f32(0.5 * camera.screen_width),
        half_h_plus=_f32(0.5 + 0.5 * camera.screen_height), neg_focal=_f32(-camera.focal_length),
        two_pi=_f32(sampling.TWO_PI), lens_radius=_f32(camera.lens_radius),
        focus_dist=_f32(camera.focus_dist),
    )
    floats.update({f"eye{j}": _f32(camera.eyepoint[j]) for j in range(3)})
    floats.update({f"rot{j}{k}": float(rot[j, k]) for j in range(3) for k in range(3)})
    floats.update({f"ortho_dir{j}": float(ortho_dir[j]) for j in range(3)})
    return ints, floats


@functools.lru_cache(maxsize=64)
def _camera_arrays(camera, sample_offset: int):
    """camera_args as the launch's ctypes arrays, kept per (camera, offset):
    a render asks for the same ones every chunk, and camera_args' small CPU
    torch ops take ~0.4 ms of host time a call (an H100 machine's host),
    which showed as 0-1.4 ms more a bench-scene image of 16 chunks when the
    arrays were built every call."""
    ints, floats = camera_args(camera, sample_offset)
    return ((_I * len(CAMERA_INTS))(*(ints[k] for k in CAMERA_INTS)),
            (ctypes.c_float * len(CAMERA_FLOATS))(*(floats[k] for k in CAMERA_FLOATS)))


def check_uids(name: str, uids: torch.Tensor, device) -> int:
    """Raise unless `uids` (or pixel ids) is a contiguous (N,) int32 tensor
    on `device`; returns N."""
    n = uids.shape[0] if uids.ndim == 1 else -1
    check_tensor(name, uids, torch.int32, (n,), device)
    return n


def _site_base(site: int) -> int:
    """The counter word of a draw site's block 0 (threefry._site_base)."""
    return ((site & threefry.MASK) << 16) & threefry.MASK


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed with CUDA error {rc}")


def camera_rays(camera, rng_key, pixel_ids: torch.Tensor, spp: int, sample_offset: int = 0):
    """Camera.generate_rays for CUDA tensors: (N, spp, 3) origins and
    directions for (N,) int32 pixel_ids, one launch of the kernel, which
    raises on what it does not take."""
    if not pixel_ids.is_cuda:
        raise ValueError(f"camera_rays launches on CUDA tensors, got {pixel_ids.device}")
    dev = pixel_ids.device
    n_px = check_uids("pixel_ids", pixel_ids, dev)
    if spp < 1 or sample_offset < 0:
        raise ValueError(f"spp must be >= 1 and sample_offset >= 0, got {spp}, {sample_offset}")
    if n_px * spp >= 2**31:
        raise ValueError(f"{n_px * spp} rays exceed the kernel's int32 indexing")
    iarr, farr = _camera_arrays(camera, sample_offset)
    k0, k1 = threefry.key_pair(rng_key)
    o = torch.empty((n_px, spp, 3), dtype=torch.float32, device=dev)
    d = torch.empty((n_px, spp, 3), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = library().rt_camera_rays_launch(pixel_ids.data_ptr(), n_px, spp, k0, k1, iarr, farr,
                                             o.data_ptr(), d.data_ptr(), _stream(dev))
    _raise_on(rc, "camera-ray")
    LAUNCHES["camera_rays"] += 1
    return o, d


def bounce_draws_plain(rng_key, uids: torch.Tensor, site, n_vol: int):
    """The plain version of one bounce's draws on any device: ball vector
    (N, 3), branch uniform (N,) and the n_vol free-flight uniforms (N,
    n_vol), as views of threefry.bounce_uniforms' (N, 4 + n_vol)."""
    u = threefry.bounce_uniforms(rng_key, uids, site, 4 + n_vol)
    return sampling.ball_vec_from_uniform(u[:, 0:3]), u[:, 3], u[:, 4:]


def bounce_draws(rng_key, uids: torch.Tensor, site, n_vol: int):
    """One bounce's draws at `site` for (N,) int32 uids: ball vector (N, 3),
    branch uniform (N,), free-flight uniforms (N, n_vol). CPU tensors run
    bounce_draws_plain; CUDA tensors launch the kernel (contiguous
    outputs), which raises on what it does not take."""
    if uids.device.type == "cpu":
        return bounce_draws_plain(rng_key, uids, site, n_vol)
    if uids.device.type != "cuda":
        raise ValueError(f"bounce_draws takes CPU or CUDA tensors, got {uids.device}")
    dev = uids.device
    n = check_uids("uids", uids, dev)
    if n_vol < 0:
        raise ValueError(f"n_vol must be >= 0, got {n_vol}")
    k0, k1 = threefry.key_pair(rng_key)
    ball = torch.empty((n, 3), dtype=torch.float32, device=dev)
    u_choice = torch.empty((n,), dtype=torch.float32, device=dev)
    u_vol = torch.empty((n, n_vol), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = library().rt_bounce_draws_launch(
            uids.data_ptr(), n, k0, k1, _site_base(site), n_vol,
            ball.data_ptr(), u_choice.data_ptr(), u_vol.data_ptr(), _stream(dev))
    _raise_on(rc, "bounce-draw")
    LAUNCHES["bounce_draws"] += 1
    return ball, u_choice, u_vol


def counter_uniforms(rng_key, uids: torch.Tensor, site, m: int) -> torch.Tensor:
    """threefry.counter_uniforms, (N, m) float32, for (N,) int32 uids. CPU
    tensors run the plain version; CUDA tensors launch the kernel, which
    raises on what it does not take."""
    if uids.device.type == "cpu":
        return threefry.counter_uniforms(rng_key, uids, site, m)
    if uids.device.type != "cuda":
        raise ValueError(f"counter_uniforms takes CPU or CUDA tensors, got {uids.device}")
    dev = uids.device
    n = check_uids("uids", uids, dev)
    if m < 1:
        raise ValueError(f"m must be >= 1, got {m}")
    k0, k1 = threefry.key_pair(rng_key)
    out = torch.empty((n, m), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = library().rt_counter_uniforms_launch(
            uids.data_ptr(), n, k0, k1, _site_base(site), m,
            out.data_ptr(), _stream(dev))
    _raise_on(rc, "counter-uniform")
    LAUNCHES["counter_uniforms"] += 1
    return out
