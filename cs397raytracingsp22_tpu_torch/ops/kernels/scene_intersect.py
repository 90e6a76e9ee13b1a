"""K2, the scene-intersection kernel: one bounce's nearest hit over every
analytic class and the dense meshes.

`scene_intersect_cuda` launches csrc/scene_intersect.cu (hand-written
CUDA C++ for sm_90a, built by _build.py) for CUDA tensors; for CPU
tensors it runs the plain version `scene_intersect_plain`, which is also
what the kernel is held against on the card. It replaces the JAX
package's ops/pallas/scene_intersect.py::scene_intersect_pallas.

Output, per ray: t (float32; t_max on a miss; object-space t for a mesh
winner), code (int32: -1 miss, 0 sphere, 1 plane, 2 triangle, 3 volume,
4 + k dense mesh k in dense_mesh_ids order), idx (int32: index in its
class; the mesh's own row, in BVH order, for a mesh winner), mat (int32
material id; a dense mesh's own, -1 where its material is synthesized
from its textures: the caller resolves mesh winners), u, v (barycentrics of a mesh winner, else 0), normal
((N, 3) front-facing shading normal of an analytic winner; zero for
volumes and meshes, whose winners the caller resolves) and frontface
(bool; false for volumes and meshes).

`LAUNCHES` counts the kernel's launches (and nothing else).
"""

from __future__ import annotations

import ctypes

import torch

from cs397raytracingsp22_tpu_torch.models.scene import SceneData
from cs397raytracingsp22_tpu_torch.ops import bvh as bvhlib
from cs397raytracingsp22_tpu_torch.ops import intersect as isect
from cs397raytracingsp22_tpu_torch.ops.kernels import _build
from cs397raytracingsp22_tpu_torch.ops.kernels.bounce import check_tensor, staged_bytes
from cs397raytracingsp22_tpu_torch.utils import vecmath as vm

LAUNCHES = 0
SMEM_LIMIT = 227 * 1024  # shared memory a block can use on the H100

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [
    _P, _P, _P, _P, _P, _I, _I,  # o, d, t_min, t_max, u_vol, u_ld, n
    _P, _I, _I, _I, _I, _I, _I, _I,  # scene, len, n_sph n_pln n_tri n_vol n_mat n_mesh
    _P, _P, _I,  # mesh_tri (kmesh_tri4), tree, tree_len
    _P, _P, _P, _P, _P, _P, _P, _P,  # t, code, idx, mat, u, v, normal, ff
    _P,  # stream
]


def library() -> ctypes.CDLL:
    """The built kernel library (builds it on first use)."""
    lib = _build.load_library("scene_intersect")
    lib.rt_scene_intersect_launch.argtypes = _ARGTYPES
    lib.rt_scene_intersect_launch.restype = _I
    lib.rt_scene_intersect_attrs.argtypes = [ctypes.POINTER(_I), ctypes.POINTER(_I)]
    lib.rt_scene_intersect_attrs.restype = _I
    return lib


def kernel_attrs() -> tuple[int, int]:
    """(registers per thread, local spill bytes) of the compiled kernel."""
    regs, local = _I(), _I()
    rc = library().rt_scene_intersect_attrs(ctypes.byref(regs), ctypes.byref(local))
    if rc != 0:
        raise RuntimeError(f"cudaFuncGetAttributes failed with CUDA error {rc}")
    return regs.value, local.value


def scene_intersect_plain(scene: SceneData, o, d, t_min, t_max, u_vol,
                          stats: dict | None = None):
    """The plain version: intersect_scene_plain's per-class tests and each
    dense mesh's object-space scan, reduced to K2's outputs. stats: when a
    dict, receives the dense meshes' per-ray test counts
    (ops/intersect.py::dense_scan_counts)."""
    n = o.shape[0]
    t_max = torch.broadcast_to(vm.as_f32(t_max, o), (n,))
    cands = isect.analytic_candidates(scene, o, d, t_min, t_max, u_vol)
    zero = torch.zeros((n,), dtype=torch.float32, device=o.device)
    for c in cands:
        c["u"] = c["v"] = zero
    for mi in scene.dense_mesh_ids:
        mesh = scene.meshes[mi]
        o_obj, d_obj = isect.object_rays(mesh, o, d)
        hit, t, tri, u, v = bvhlib.intersect_tris_scan(o_obj, d_obj, mesh.tri_verts, t_min, t_max)
        cands.append(dict(
            valid=hit, t=torch.where(hit, t, torch.full_like(t, float("inf"))), idx=tri,
            u=u, v=v, mat=torch.full_like(tri, mesh.mat_id),
            normal=torch.zeros_like(o), frontface=torch.zeros_like(hit),
        ))
    winner, sel = isect.select_winner(
        cands, ("t", "idx", "mat", "u", "v", "normal", "frontface", "valid"))
    if stats is not None:
        isect.dense_scan_counts(scene, o, d, t_min, t_max, sel["t"], stats)
    valid = sel["valid"]

    def on_hit(x):  # the winner's value, zero on a miss
        return torch.where(valid.reshape(-1, *[1] * (x.ndim - 1)), x, torch.zeros_like(x))

    return (torch.where(valid, sel["t"], t_max), torch.where(valid, winner.to(torch.int32), -1),
            on_hit(sel["idx"].to(torch.int32)), on_hit(sel["mat"].to(torch.int32)),
            on_hit(sel["u"]), on_hit(sel["v"]), on_hit(sel["normal"]), on_hit(sel["frontface"]))


def scene_intersect_cuda(scene: SceneData, o, d, t_min, t_max, u_vol):
    """One bounce's nearest hit with K2 (module docstring for the outputs).

    o, d: (N, 3) float32; t_min, t_max: (N,) float32; u_vol: (N, V)
    float32 free-flight uniforms, V >= n_volumes (column q for volume q).
    CPU tensors run the plain version. CUDA tensors launch the kernel on
    the current stream; anything the kernel does not take, a failed build
    or a failed launch raises.
    """
    global LAUNCHES
    if o.device.type == "cpu":
        return scene_intersect_plain(scene, o, d, t_min, t_max, u_vol)
    if o.device.type != "cuda":
        raise ValueError(f"scene_intersect_cuda takes CPU or CUDA tensors, got {o.device}")
    dev = o.device
    n = o.shape[0]
    check_tensor("o", o, torch.float32, (n, 3), dev)
    check_tensor("d", d, torch.float32, (n, 3), dev)
    check_tensor("t_min", t_min, torch.float32, (n,), dev)
    check_tensor("t_max", t_max, torch.float32, (n,), dev)
    if u_vol.ndim != 2 or u_vol.shape[1] < scene.n_volumes:
        raise ValueError(f"u_vol needs shape (N, >= {scene.n_volumes}), got {tuple(u_vol.shape)}")
    check_tensor("u_vol", u_vol, torch.float32, (n, u_vol.shape[1]), dev)
    for key in ("kscene", "kmesh_tri4", "ksl_tree"):
        t = getattr(scene, key)
        check_tensor(f"scene.{key}", t, torch.float32, tuple(t.shape), dev)
    staged = staged_bytes(scene)
    if staged > SMEM_LIMIT:
        raise ValueError(f"the scene table and superleaf trees ({staged} B) exceed shared memory")
    if n * max(3, u_vol.shape[1]) >= 2**31:
        raise ValueError(f"{n} rays exceed the kernel's int32 indexing")
    t = torch.empty((n,), dtype=torch.float32, device=dev)
    code = torch.empty((n,), dtype=torch.int32, device=dev)
    idx = torch.empty((n,), dtype=torch.int32, device=dev)
    mat = torch.empty((n,), dtype=torch.int32, device=dev)
    u = torch.empty((n,), dtype=torch.float32, device=dev)
    v = torch.empty((n,), dtype=torch.float32, device=dev)
    normal = torch.empty((n, 3), dtype=torch.float32, device=dev)
    ff = torch.empty((n,), dtype=torch.bool, device=dev)
    lib = library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = lib.rt_scene_intersect_launch(
            o.data_ptr(), d.data_ptr(), t_min.data_ptr(), t_max.data_ptr(), u_vol.data_ptr(),
            int(u_vol.shape[1]), n,
            scene.kscene.data_ptr(), int(scene.kscene.numel()),
            scene.n_spheres, scene.n_planes, scene.n_tris, scene.n_volumes,
            int(scene.mat_type.shape[0]), len(scene.dense_mesh_ids),
            scene.kmesh_tri4.data_ptr(), scene.ksl_tree.data_ptr(), int(scene.ksl_tree.numel()),
            t.data_ptr(), code.data_ptr(), idx.data_ptr(), mat.data_ptr(), u.data_ptr(),
            v.data_ptr(), normal.data_ptr(), ff.data_ptr(), stream,
        )
    if rc != 0:
        raise RuntimeError(f"scene-intersection kernel launch failed with CUDA error {rc}")
    LAUNCHES += 1
    return t, code, idx, mat, u, v, normal, ff
