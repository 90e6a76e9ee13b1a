"""Build the package's CUDA kernels with nvcc and load them with ctypes.

Each source under csrc/ is compiled on first use into a shared library
with a plain C interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v -o build/torch_kernels/lib<name>-<hash>.so csrc/<name>.cu

Kernels held bit for bit to their plain versions add `-fmad=false`
(EXTRA_FLAGS): without contraction every multiply and add rounds on its
own, as in the plain version's separate torch kernels. The FMA-rate probe
(vpu_peak) states `-fmad=true`, nvcc's default, because the fused
multiply-add is what it measures. The library name
carries a hash of the source, of every header under csrc/ (the kernels
share csrc/intersect.cuh; K1 and K4 csrc/bounce.cuh) and of the flags,
so an edited kernel or header is rebuilt. `build_all` starts one nvcc per
source at once. A failed build raises with the compiler's output;
nothing falls back to the plain version.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "torch_kernels")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# per kernel: flags after NVCC_FLAGS
EXTRA_FLAGS = {"scene_intersect": ("-fmad=false",), "bvh_traverse": ("-fmad=false",),
               "tri_scan": ("-fmad=false",), "draws": ("-fmad=false",),
               "resolve": ("-fmad=false",), "shade": ("-fmad=false",),
               "nee": ("-fmad=false",), "vpu_peak": ("-fmad=true",)}
# every kernel of the package, for build_all: the render kernels K1-K5, the
# draws D1, the merged resolve R1, the shading S1, NEE's sample N1 and the
# roofline probes P1-P3 (vpu_peak), P4 (dtype_rate) and P5 (bw_scan)
KERNELS = ("bounce", "wavefront", "scene_intersect", "bvh_traverse", "tri_scan", "draws",
           "resolve", "shade", "nee", "vpu_peak", "dtype_rate", "bw_scan")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# per kernel: {"seconds": build time (0 when the library was already on
# disk), "log": nvcc's output including ptxas register counts, "path": ...}
BUILD_INFO: dict[str, dict] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def library_path(name: str) -> str:
    """build/torch_kernels/lib<name>-<hash>.so, the hash over csrc/<name>.cu,
    every csrc/*.cuh and the flags."""
    h = hashlib.sha256()
    for path in [os.path.join(CSRC_DIR, f"{name}.cu")] + sorted(
        glob.glob(os.path.join(CSRC_DIR, "*.cuh"))
    ):
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + b"\0" + f.read())
    h.update(" ".join(_flags(name)).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:12]}.so")


def _flags(name: str) -> tuple:
    return NVCC_FLAGS + EXTRA_FLAGS.get(name, ())


def _start(name: str, path: str):
    tmp = f"{path}.{os.getpid()}.tmp"
    src = os.path.join(CSRC_DIR, f"{name}.cu")
    proc = subprocess.Popen(
        [nvcc_path(), *_flags(name), "-o", tmp, src],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    return proc, tmp, src


def build_all(names) -> None:
    """Build the named kernels that are not on disk yet, one nvcc each,
    all started together, and load them."""
    with _lock:
        os.makedirs(BUILD_DIR, exist_ok=True)
        t0 = time.perf_counter()
        jobs = {}
        for name in names:
            if name in _libs:
                continue
            path = library_path(name)
            jobs[name] = (path, _start(name, path) if not os.path.exists(path) else None)
        errors = []
        for name, (path, job) in jobs.items():
            seconds, log = 0.0, ""
            if job is not None:
                proc, tmp, src = job
                log = proc.communicate()[0]
                seconds = time.perf_counter() - t0
                if proc.returncode != 0:
                    errors.append(f"nvcc failed to build {src}:\n{log}")
                    continue
                os.replace(tmp, path)
            _libs[name] = ctypes.CDLL(path)
            BUILD_INFO[name] = {"seconds": seconds, "log": log, "path": path}
        if errors:
            raise RuntimeError("\n".join(errors))


def check_tensor(name: str, x, dtype, shape, device) -> None:
    """Raise unless tensor x is on `device` with `dtype`, `shape` and a
    contiguous layout: what a kernel's wrapper checks before a launch."""
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise ValueError(f"{name} has dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def load_library(name: str) -> ctypes.CDLL:
    """Build csrc/<name>.cu if needed and load it (cached per process)."""
    if name not in _libs:
        build_all([name])
    return _libs[name]
