"""R1, the merged resolve: the mesh winners' world point, shading normal,
front face, texels and material in one launch a call.

`resolve_winners` launches csrc/resolve.cu (hand-written CUDA C++ for
sm_90a, built by _build.py) for CUDA tensors. For CPU tensors it runs the
plain version, ops/intersect.py::resolve_mesh_winners, which the kernel is
held to on the card bit for bit. It replaces no Pallas kernel: the JAX
package's merged resolve is jnp code that XLA fuses, while the plain
version launches one torch kernel per operation (~200 a call on a scene
with three meshes, textures and normal maps) and needs every mesh's
object-space rays; the kernel forms them itself from the inverse
transforms in the scene's kmesh_xfm.

Two instantiations (`variant`): the full one where some mesh binds a
texture slot or has its material synthesized from its textures, which
decides per winner from its mesh's row what to sample, and a bare one
that reads normals and material rows alone. The mesh count and the
material count are the launch's.

`LAUNCHES` counts the kernel's launches (and nothing else).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from cs397raytracingsp22_tpu_torch.models import materials as mat
from cs397raytracingsp22_tpu_torch.models.scene import SceneData, resolve_order
from cs397raytracingsp22_tpu_torch.ops import intersect as isect
from cs397raytracingsp22_tpu_torch.ops.kernels import _build
from cs397raytracingsp22_tpu_torch.ops.kernels._build import check_tensor

LAUNCHES = {"resolve": 0}

# the launch's pointer and int blocks, in csrc/resolve.cu's struct order
POINTERS = ("o", "d", "code", "t", "idx", "u", "v", "point_in", "normal_in", "ff_in", "mat_in",
            "kmesh_res", "kmesh_xfm", "kmesh_tex", "kscene", "tex_pixels", "point", "normal", "frontface", "mtype", "albedo", "emission",
            "roughness", "metallic", "ior")
INTS = ("n", "n_mesh", "n_spheres", "n_planes", "n_tris", "n_volumes", "n_mat")
# the outputs: resolve_mesh_winners' fields, (dtype, columns or None)
OUTPUTS = {"point": (torch.float32, 3), "normal": (torch.float32, 3),
           "frontface": (torch.bool, None), "mtype": (torch.int32, None),
           "albedo": (torch.float32, 3), "emission": (torch.float32, 3),
           "roughness": (torch.float32, None), "metallic": (torch.float32, None),
           "ior": (torch.float32, None)}
_OCCUPANCY: dict = {}  # (device, variant, meshes, materials) -> (blocks an SM, threads)
_SMS: dict = {}  # device -> SMs

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.cache
def library() -> ctypes.CDLL:
    """The built kernel library (builds it on first use), its entry points
    typed once and its layout checked against the wrapper's."""
    lib = _build.load_library("resolve")
    lib.rt_resolve_launch.argtypes = [_P, _P, _I, _I, _P]
    lib.rt_resolve_occupancy.argtypes = [_I, _I, _I, ctypes.POINTER(_I), ctypes.POINTER(_I)]
    lib.rt_resolve_attrs.argtypes = [_I, ctypes.POINTER(_I), ctypes.POINTER(_I)]
    lib.rt_resolve_constants.argtypes = [ctypes.POINTER(_I)] * 4
    lib.rt_resolve_smem_bytes.argtypes = [_I, _I]
    for fn in (lib.rt_resolve_launch, lib.rt_resolve_occupancy, lib.rt_resolve_attrs,
               lib.rt_resolve_constants, lib.rt_resolve_smem_bytes):
        fn.restype = _I
    got = [_I() for _ in range(4)]
    lib.rt_resolve_constants(*(ctypes.byref(x) for x in got))
    want = [len(POINTERS), len(INTS), isect.CODE_MESH0, mat.PARAMETERIZED]
    if [x.value for x in got] != want:
        raise RuntimeError(f"csrc/resolve.cu takes (pointers, ints, first mesh code, synthesized "
                           f"type) {[x.value for x in got]}, the wrapper {want}")
    return lib


def variant(scene: SceneData) -> int:
    """The instantiation a scene launches: 1, the full one, where some mesh
    binds a texture slot or has its material synthesized from its textures
    (resolve_mesh_winners' own tests of the tables), else 0."""
    return int(any(t >= 0 or m.mat_id < 0 for m in scene.meshes for t in m.tex_ids))


def kernel_attrs(which: int = 1) -> tuple[int, int]:
    """(registers per thread, local spill bytes) of instantiation `which`
    (a `variant`; the full one by default)."""
    regs, local = _I(), _I()
    rc = library().rt_resolve_attrs(which, ctypes.byref(regs), ctypes.byref(local))
    if rc != 0:
        raise RuntimeError(f"cudaFuncGetAttributes failed with CUDA error {rc}")
    return regs.value, local.value


def launch_config(scene: SceneData, n: int) -> dict:
    """The launch's shape over n rays of `scene` on the current device: a
    persistent grid of the blocks that stay resident (no more than the rays
    fill), each staging the mesh and material tables once."""
    lib = library()
    dev = torch.cuda.current_device()
    key = (dev, variant(scene), len(scene.meshes), int(scene.mat_type.shape[0]))
    if key not in _OCCUPANCY:
        blocks, threads = _I(), _I()
        rc = lib.rt_resolve_occupancy(*key[1:], ctypes.byref(blocks), ctypes.byref(threads))
        if rc != 0 or blocks.value < 1:
            raise RuntimeError(f"no block of R1 fits on an SM (CUDA error {rc}, "
                               f"{blocks.value} blocks)")
        _OCCUPANCY[key] = (blocks.value, threads.value)
    if dev not in _SMS:
        _SMS[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
    per_sm, threads = _OCCUPANCY[key]
    grid = max(1, min(per_sm * _SMS[dev], -(-n // threads)))
    return dict(variant=key[1], threads=threads, blocks_per_sm=per_sm, sms=_SMS[dev], grid=grid,
                smem_bytes=lib.rt_resolve_smem_bytes(key[2], key[3]))


def check_inputs(scene: SceneData, o, d, code, t, idx, u, v, fields: dict, device) -> int:
    """Raise unless every input of a launch over N rays lies on `device`
    with the dtype, shape and contiguous layout the kernel reads (o, d,
    fields' point and normal (N, 3) float32; code, idx and fields' mat (N,)
    int32; t, u, v (N,) float32; fields' frontface (N,) bool), and the
    scene's tables with theirs; returns N."""
    n = code.shape[0] if code.ndim == 1 else -1
    for name, x, dtype, shape in (
            ("o", o, torch.float32, (n, 3)), ("d", d, torch.float32, (n, 3)),
            ("code", code, torch.int32, (n,)), ("t", t, torch.float32, (n,)),
            ("idx", idx, torch.int32, (n,)), ("u", u, torch.float32, (n,)),
            ("v", v, torch.float32, (n,)), ("point", fields["point"], torch.float32, (n, 3)),
            ("normal", fields["normal"], torch.float32, (n, 3)),
            ("frontface", fields["frontface"], torch.bool, (n,)),
            ("mat", fields["mat"], torch.int32, (n,))):
        check_tensor(name, x, dtype, shape, device)
    m = len(scene.meshes)
    for name, dtype, cols in (("kmesh_res", torch.float32, 18), ("kmesh_xfm", torch.float32, 36),
                              ("kmesh_tex", torch.int32, 15), ("kscene", torch.float32, None),
                              ("tex_pixels", torch.uint8, 3)):
        x = getattr(scene, name)
        shape = (x.shape[0], cols) if cols else (x.shape[0],)
        check_tensor(f"scene.{name}", x, dtype, shape, device)
        if name in ("kmesh_xfm", "kmesh_tex") and x.shape[0] < m:
            raise ValueError(f"scene.{name} has {x.shape[0]} rows for {m} meshes")
    if scene.kmesh_res.data_ptr() % 8:
        raise ValueError("scene.kmesh_res must start on an 8-byte boundary (8-byte loads)")
    if scene.kmesh_res.shape[0] > 2**24:
        raise ValueError(f"{scene.kmesh_res.shape[0]} kmesh_res rows: kmesh_xfm's first rows "
                         "are exact in float32 up to 2**24")
    if 3 * n >= 2**31:
        raise ValueError(f"{n} rays exceed the kernel's int32 indexing")
    return n


def resolve_winners(scene: SceneData, o, d, code, t, idx, u, v, fields: dict) -> dict:
    """The merged resolve of every mesh winner (resolve_mesh_winners'
    semantics and outputs): o, d the (N, 3) world rays; code, t, idx, u, v
    the winners as the scene-intersection kernels leave them; fields the
    point, normal, frontface and mat (material id) of every ray. CPU tensors
    run resolve_mesh_winners on every mesh's object rays; CUDA tensors
    launch R1 on the current stream (outputs from torch.empty), and
    anything it does not take, a failed build or a failed launch raises."""
    if o.device.type == "cpu":
        obj_rays = {mi: isect.object_rays(scene.meshes[mi], o, d)
                    for mi in resolve_order(scene.dense_mesh_ids, len(scene.meshes))}
        return isect.resolve_mesh_winners(scene, obj_rays, code, t, idx, u, v, fields)
    if o.device.type != "cuda":
        raise ValueError(f"resolve_winners takes CPU or CUDA tensors, got {o.device}")
    dev = o.device
    n = check_inputs(scene, o, d, code, t, idx, u, v, fields, dev)
    out = {k: torch.empty((n, c) if c else (n,), dtype=dt, device=dev)
           for k, (dt, c) in OUTPUTS.items()}
    if n == 0:  # nothing to launch
        return out
    launch(scene, (o, d, code, t, idx, u, v, fields), out)
    LAUNCHES["resolve"] += 1
    return out


def launch(scene: SceneData, ins: tuple, out: dict) -> None:
    """One launch of the kernel on the current stream of the inputs' device:
    ins = (o, d, code, t, idx, u, v, fields) over n > 0 rays, as
    resolve_winners checks them; out as it allocates them. Counts nothing:
    the wrapper counts its launches, and a timing that leaves the checks and
    allocations out of its bracket calls this (chip_smoke.py)."""
    o, d, code, t, idx, u, v, fields = ins
    dev = o.device
    lib = library()
    tensors = dict(o=o, d=d, code=code, t=t, idx=idx, u=u, v=v, point_in=fields["point"],
                   normal_in=fields["normal"], ff_in=fields["frontface"], mat_in=fields["mat"],
                   **{k: getattr(scene, k) for k in ("kmesh_res", "kmesh_xfm", "kmesh_tex",
                                                     "kscene", "tex_pixels")}, **out)
    ptrs = (_P * len(POINTERS))(*(tensors[k].data_ptr() for k in POINTERS))
    counts = dict(n=o.shape[0], n_mesh=len(scene.meshes), n_mat=int(scene.mat_type.shape[0]),
                  **{k: getattr(scene, k) for k in INTS[2:6]})
    ints = (_I * len(INTS))(*(counts[k] for k in INTS))
    with torch.cuda.device(dev):
        cfg = launch_config(scene, o.shape[0])
        rc = lib.rt_resolve_launch(ptrs, ints, cfg["variant"], cfg["grid"],
                                   torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"resolve kernel launch failed with CUDA error {rc}")
