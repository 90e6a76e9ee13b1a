"""ctypes bindings to the native host runtime (native/rt_native.cpp).

The same C++ source the JAX package uses: OBJ parsing (tobj semantics,
geometry.rs:140-148) and BVH construction (geometry.rs:175-217), built on
first use with the flags of native/Makefile into build/torch_native/
(the same flags keep the BVH triangle order identical to the JAX
package's). Every entry point has a pure-Python fallback; `available()`
gates use.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_NATIVE_DIR = os.path.join(_ROOT, "native")
_BUILD_DIR = os.path.join(_ROOT, "build", "torch_native")
_SO_PATH = os.path.join(_BUILD_DIR, "librt_native.so")
_CXXFLAGS = ["-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


class _RtObjMesh(ctypes.Structure):
    _fields_ = [
        ("positions", ctypes.POINTER(ctypes.c_float)),
        ("normals", ctypes.POINTER(ctypes.c_float)),
        ("texcoords", ctypes.POINTER(ctypes.c_float)),
        ("indices", ctypes.POINTER(ctypes.c_int32)),
        ("n_vertices", ctypes.c_int64),
        ("n_triangles", ctypes.c_int64),
        ("has_normals", ctypes.c_int32),
        ("has_texcoords", ctypes.c_int32),
    ]


def _build() -> bool:
    """Compile the library once; the write goes through a private
    temporary file and an atomic rename, so concurrent test workers never
    load a half-written library."""
    if os.path.exists(_SO_PATH):
        return True
    try:
        os.makedirs(_BUILD_DIR, exist_ok=True)
        tmp = f"{_SO_PATH}.{os.getpid()}.tmp"
        subprocess.run(
            ["g++", *_CXXFLAGS, "-shared", "-o", tmp,
             os.path.join(_NATIVE_DIR, "rt_native.cpp")],
            check=True,
            capture_output=True,
            timeout=120,
        )
        os.replace(tmp, _SO_PATH)
        return True
    except Exception:
        return False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not _build():
            return None
        lib = ctypes.CDLL(_SO_PATH)
        lib.rt_obj_load.argtypes = [ctypes.c_char_p, ctypes.POINTER(_RtObjMesh)]
        lib.rt_obj_load.restype = ctypes.c_int
        lib.rt_obj_free.argtypes = [ctypes.POINTER(_RtObjMesh)]
        lib.rt_bvh_build.argtypes = [
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_int64,
            ctypes.c_int32,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
            ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
            ctypes.POINTER(ctypes.POINTER(ctypes.c_int32)),
            ctypes.POINTER(ctypes.POINTER(ctypes.c_int32)),
            ctypes.POINTER(ctypes.POINTER(ctypes.c_int32)),
            ctypes.POINTER(ctypes.POINTER(ctypes.c_int32)),
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.rt_bvh_build.restype = ctypes.c_int
        lib.rt_free.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def obj_load(path: str):
    """Native OBJ parse → dict of numpy arrays, or None on failure."""
    lib = _load()
    if lib is None:
        return None
    mesh = _RtObjMesh()
    if lib.rt_obj_load(path.encode(), ctypes.byref(mesh)) != 0:
        return None
    try:
        nv, nt = mesh.n_vertices, mesh.n_triangles
        out = dict(
            positions=np.ctypeslib.as_array(mesh.positions, (nv, 3)).copy(),
            normals=np.ctypeslib.as_array(mesh.normals, (nv, 3)).copy(),
            texcoords=np.ctypeslib.as_array(mesh.texcoords, (nv, 2)).copy(),
            indices=np.ctypeslib.as_array(mesh.indices, (nt, 3)).copy(),
            has_normals=bool(mesh.has_normals),
            has_texcoords=bool(mesh.has_texcoords),
        )
        return out
    finally:
        lib.rt_obj_free(ctypes.byref(mesh))


def bvh_build(tri_verts: np.ndarray, leaf_size: int = 4):
    """Native skip-link-threaded BVH build (tree threading, not
    multithreading — single-threaded C++) → dict of numpy arrays, or
    None."""
    lib = _load()
    if lib is None:
        return None
    tv = np.ascontiguousarray(tri_verts.reshape(-1, 9), np.float32)
    nt = tv.shape[0]
    p_f = ctypes.POINTER(ctypes.c_float)
    p_i = ctypes.POINTER(ctypes.c_int32)
    bmin, bmax = p_f(), p_f()
    skip, ls, lc, order = p_i(), p_i(), p_i(), p_i()
    nn = ctypes.c_int64()
    rc = lib.rt_bvh_build(
        tv.ctypes.data_as(p_f),
        nt,
        leaf_size,
        ctypes.byref(bmin),
        ctypes.byref(bmax),
        ctypes.byref(skip),
        ctypes.byref(ls),
        ctypes.byref(lc),
        ctypes.byref(order),
        ctypes.byref(nn),
    )
    if rc != 0:
        return None
    try:
        n = nn.value
        return dict(
            bounds_min=np.ctypeslib.as_array(bmin, (n, 3)).copy(),
            bounds_max=np.ctypeslib.as_array(bmax, (n, 3)).copy(),
            skip=np.ctypeslib.as_array(skip, (n,)).copy(),
            leaf_start=np.ctypeslib.as_array(ls, (n,)).copy(),
            leaf_count=np.ctypeslib.as_array(lc, (n,)).copy(),
            tri_order=np.ctypeslib.as_array(order, (nt,)).copy(),
        )
    finally:
        for p in (bmin, bmax, skip, ls, lc, order):
            lib.rt_free(ctypes.cast(p, ctypes.c_void_p))
