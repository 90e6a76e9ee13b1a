"""Build the package's CUDA kernels with nvcc and load them with ctypes.

Each source under csrc/ is compiled on first use into a shared library
with a plain C interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v -o build/torch_kernels/lib<name>-<hash>.so csrc/<name>.cu

The library name carries a hash of the source and the flags, so an edited
kernel is rebuilt. A failed build raises with the compiler's output;
nothing falls back to the plain version.
"""

from __future__ import annotations

import ctypes
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


def load_library(name: str) -> ctypes.CDLL:
    """Build csrc/<name>.cu if needed and load it (cached per process)."""
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        src = os.path.join(CSRC_DIR, f"{name}.cu")
        with open(src, "rb") as f:
            digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
        os.makedirs(BUILD_DIR, exist_ok=True)
        path = os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")
        seconds, log = 0.0, ""
        if not os.path.exists(path):
            tmp = f"{path}.{os.getpid()}.tmp"
            t0 = time.perf_counter()
            proc = subprocess.run(
                [nvcc_path(), *NVCC_FLAGS, "-o", tmp, src],
                capture_output=True, text=True,
            )
            seconds = time.perf_counter() - t0
            log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed to build {src}:\n{log}")
            os.replace(tmp, path)
        lib = ctypes.CDLL(path)
        BUILD_INFO[name] = {"seconds": seconds, "log": log, "path": path}
        _libs[name] = lib
        return lib
