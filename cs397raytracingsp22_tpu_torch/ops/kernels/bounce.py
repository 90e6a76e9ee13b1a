"""K1, the mega-bounce kernel: the whole depth-N path trace in one launch.

`path_trace_cuda` launches csrc/bounce.cu (hand-written CUDA C++ for
sm_90a, built by _build.py) for CUDA tensors; for CPU tensors it runs the
plain version, render/integrator.py::path_trace, which is also what the
kernel is held against on the card. It replaces the JAX package's
ops/pallas/bounce.py::path_trace_pallas.

`LAUNCHES` counts the kernel's launches (and nothing else), so a run can
show that its main path went through the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from cs397raytracingsp22_tpu_torch.models.scene import SceneData
from cs397raytracingsp22_tpu_torch.ops.kernels import _build
from cs397raytracingsp22_tpu_torch.ops.kernels._build import check_tensor
from cs397raytracingsp22_tpu_torch.render import integrator
from cs397raytracingsp22_tpu_torch.utils import threefry

LANES = 128  # the kernel's gates: materials, and planes, triangles and volumes
# shared memory a block may stage on the H100 (227 KiB)
MAX_STAGED_BYTES = 232448
LAUNCHES = 0

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [
    _P, _P, _P, _I, _P, _P,  # o, d, uid, n, rad, segs
    ctypes.c_uint, ctypes.c_uint, _I, ctypes.c_float, ctypes.c_float,  # k0 k1 depth t_min t_max
    _P, _I, _I, _I, _I, _I, _I, _I,  # scene, len, n_sph n_pln n_tri n_vol n_mat n_mesh
    _P, _P, _P, _I,  # mesh_tri (kmesh_tri4), mesh_nrm, tree, tree_len
    _P, _I,  # sph_table (ksph_tree), sph_leaves
    _P, _P, _P, _P,  # big_xfm (kmesh_xfm), big_res (kmesh_res), big_nodes, big_tris
    _I, _P,  # big_depth (0: no big mesh), stream
]
TABLES = ("kscene", "kmesh_tri4", "kmesh_nrm", "ksl_tree")  # the scene tables K1 and K4 read


def library() -> ctypes.CDLL:
    """The built kernel library (builds it on first use)."""
    lib = _build.load_library("bounce")
    lib.rt_bounce_launch.argtypes = _ARGTYPES
    lib.rt_bounce_launch.restype = _I
    lib.rt_bounce_attrs.argtypes = [_I, _I, _I, ctypes.POINTER(_I), ctypes.POINTER(_I)]
    lib.rt_bounce_attrs.restype = _I
    lib.rt_bounce_occupancy.argtypes = [_I] * 6 + [ctypes.POINTER(_I)]
    lib.rt_bounce_occupancy.restype = _I
    return lib


def kernel_attrs(dense: bool = True, sph_tree: bool = False, big: bool = False) -> tuple[int, int]:
    """(registers per thread, local spill bytes) of the compiled kernel:
    the instantiation for scenes with a dense mesh, or without (dense
    False), which leaves the superleaf walk out, with a sphere tree
    (sph_tree True) or the sphere scan, or with a big mesh (big True:
    bounce_kernel_big, whose scenes have neither a dense mesh nor a sphere
    tree)."""
    regs, local = _I(), _I()
    rc = library().rt_bounce_attrs(int(dense), int(sph_tree), int(big), ctypes.byref(regs),
                                   ctypes.byref(local))
    if rc != 0:
        raise RuntimeError(f"cudaFuncGetAttributes failed with CUDA error {rc}")
    return regs.value, local.value


def staged_bytes(scene: SceneData) -> int:
    """Shared memory a block of K1 or K2 (each without a sphere tree) or
    K4 stages for `scene`: the scene table, padded to 16 bytes, then the
    superleaf trees (csrc/intersect.cuh::staged_bytes)."""
    return 4 * ((scene.kscene.numel() + 3) // 4 * 4 + scene.ksl_tree.numel())


def big_meshes(scene: SceneData) -> list:
    """The scene's big meshes (beyond the dense budget), in kmesh_xfm's
    order: after the dense meshes, by scene index (models/scene.py::
    resolve_order)."""
    return [m for i, m in enumerate(scene.meshes) if i not in scene.dense_mesh_ids]


def big_depth(scene: SceneData) -> int:
    """Stack entries a thread of K1 needs for its big-mesh walk: the
    deepest of the big meshes' BVHs (MeshBlock.bvh_depth), 0 without a
    big mesh."""
    return max((m.bvh_depth for m in big_meshes(scene)), default=0)


def k1_staged_bytes(scene: SceneData) -> int:
    """Shared memory a block of K1 stages for `scene`: staged_bytes, or,
    with a sphere tree, the scene table less its sphere rows, the
    superleaf trees, and the sphere tree's header and nodes after them,
    or, with a big mesh, staged_bytes, its kmesh_xfm row and a stack of
    big_depth entries of 8 bytes for each of the block's 128 threads
    (csrc/bounce.cu::k1_staged_bytes)."""
    depth = big_depth(scene)
    if depth:
        return staged_bytes(scene) + 144 + 8 * 128 * depth
    if not scene.sph_tree_leaves:
        return staged_bytes(scene)
    return sph_tree_staged_bytes(scene, 5 * scene.n_spheres)


def sph_tree_staged_bytes(scene: SceneData, skip: int) -> int:
    """Shared memory a block stages for `scene` on a sphere-tree route (K1,
    and K2's tree route): the scene table from float `skip` on (past the
    sphere rows: K1 skips them exactly, K2 from its last 16-byte word
    before their end), padded to 16 bytes, the superleaf trees, and the
    sphere tree's header and nodes, 64 B a leaf
    (csrc/intersect.cuh::sph_tree_staged_bytes)."""
    table = int(scene.kscene.numel()) - skip
    return 4 * ((table + 3) // 4 * 4 + int(scene.ksl_tree.numel())) + 64 * scene.sph_tree_leaves


def resident_blocks(scene: SceneData) -> int:
    """Blocks of K1 resident on one SM when each stages `scene`'s tables
    (k1_staged_bytes), for the instantiation `scene` launches
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor)."""
    blocks = _I()
    rc = library().rt_bounce_occupancy(int(scene.kscene.numel()), int(scene.ksl_tree.numel()),
                                       len(scene.dense_mesh_ids), scene.n_spheres,
                                       scene.sph_tree_leaves, big_depth(scene),
                                       ctypes.byref(blocks))
    if rc != 0:
        raise RuntimeError(f"cudaOccupancyMaxActiveBlocksPerMultiprocessor failed with CUDA error {rc}")
    return blocks.value


def scene_is_simple(scene: SceneData) -> bool:
    """True when K1 can run the scene (bounce.py:285 in the JAX package):
    every mesh with an explicit material and no normal map, no
    general-boundary volume, at most 128 materials, at most 128 planes,
    triangles and volumes together, the spheres among them unless the
    scene has a sphere tree (models/scene.py::sphere_tree), and tables
    that fit a block's shared memory (k1_staged_bytes, 227 KiB). A mesh
    beyond the dense budget (a big mesh) is walked through its BVH when it
    is the scene's only mesh and the scene has no sphere tree. K1 reads
    neither textures nor general volumes: the staged path renders those
    scenes, and scenes with more meshes beside a big one."""
    big = big_meshes(scene)
    if big and (len(big) > 1 or scene.dense_mesh_ids or scene.sph_tree_leaves):
        return False
    if scene.n_gvols:
        return False
    if int(scene.mat_type.shape[0]) > LANES:
        return False
    counted = 0 if scene.sph_tree_leaves else scene.n_spheres
    if counted + scene.n_planes + scene.n_tris + scene.n_volumes > LANES:
        return False
    if k1_staged_bytes(scene) > MAX_STAGED_BYTES:
        return False
    return all(m.mat_id >= 0 and m.tex_ids[4] < 0 for m in scene.meshes)


def path_trace_cuda(
    scene: SceneData,
    o: torch.Tensor,
    d: torch.Tensor,
    uids: torch.Tensor,
    rng_key,
    path_depth: int,
    max_trace_dist: float,
    t_min: float = integrator.PATH_T_MIN,
    stats: dict | None = None,
):
    """Trace N ray chains with K1.

    o, d: (N, 3) float32; uids: (N,) int32; rng_key: int seed or (2,) key
    words. The kernel reads the scene's packed tables (TABLES and
    ksph_tree: models/scene.py::pack_kernel_tables); on a scene with a
    sphere tree it walks the tree in place of its sphere scan; on a scene
    with a big mesh it walks the mesh's BVH (MeshBlock.bvh_nodes,
    bvh_tri4), with its kmesh_xfm row and the corner normals of kmesh_res
    (bounce_kernel_big).
    Returns (radiance (N, 3) float32, segments int64 scalar tensor).
    stats: when a dict, receives "segs", the (N,) int64 segments of each
    chain (and on the CPU the plain version's other counts).

    CPU tensors run the plain version (integrator.path_trace). CUDA
    tensors launch the kernel on the current stream; anything the kernel
    does not take, a failed build or a failed launch raises.
    """
    global LAUNCHES
    if o.device.type == "cpu":
        return integrator.path_trace(scene, o, d, uids, rng_key, path_depth, max_trace_dist,
                                     stats=stats)
    if o.device.type != "cuda":
        raise ValueError(f"path_trace_cuda takes CPU or CUDA tensors, got {o.device}")
    if not scene_is_simple(scene):
        raise ValueError("scene exceeds the mega-bounce kernel's gates (scene_is_simple)")
    dev = o.device
    n = o.shape[0]
    check_tensor("o", o, torch.float32, (n, 3), dev)
    check_tensor("d", d, torch.float32, (n, 3), dev)
    check_tensor("uids", uids, torch.int32, (n,), dev)
    for key in TABLES + ("ksph_tree", "kmesh_xfm", "kmesh_res"):
        t = getattr(scene, key)
        check_tensor(f"scene.{key}", t, torch.float32, tuple(t.shape), dev)
    big = big_meshes(scene)  # the gate lets through one, the scene's only mesh
    for m in big:
        for key in ("bvh_nodes", "bvh_tri4"):
            t = getattr(m, key)
            check_tensor(f"the big mesh's {key}", t, torch.float32, tuple(t.shape), dev)
    if n >= 2**31 // 3:
        raise ValueError(f"{n} rays exceed the kernel's int32 indexing")
    if path_depth < 0:
        raise ValueError("path_depth must be >= 0")
    k0, k1 = threefry.key_pair(rng_key)
    big_nodes, big_tris = (big[0].bvh_nodes.data_ptr(), big[0].bvh_tri4.data_ptr()) if big else (
        None, None)
    lib = library()
    rad = torch.empty((n, 3), dtype=torch.float32, device=dev)
    segs = torch.empty((n,), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = lib.rt_bounce_launch(
            o.data_ptr(), d.data_ptr(), uids.data_ptr(), n, rad.data_ptr(), segs.data_ptr(),
            k0, k1, int(path_depth), float(t_min), float(max_trace_dist),
            scene.kscene.data_ptr(), int(scene.kscene.numel()),
            scene.n_spheres, scene.n_planes, scene.n_tris, scene.n_volumes,
            int(scene.mat_type.shape[0]), len(scene.dense_mesh_ids),
            scene.kmesh_tri4.data_ptr(), scene.kmesh_nrm.data_ptr(),
            scene.ksl_tree.data_ptr(), int(scene.ksl_tree.numel()),
            scene.ksph_tree.data_ptr(), scene.sph_tree_leaves, scene.kmesh_xfm.data_ptr(),
            scene.kmesh_res.data_ptr(), big_nodes, big_tris, big_depth(scene), stream,
        )
    if rc != 0:
        raise RuntimeError(f"mega-bounce kernel launch failed with CUDA error {rc}")
    LAUNCHES += 1
    if stats is not None:
        stats["segs"] = segs.to(torch.int64)
    return rad, segs.sum(dtype=torch.int64)
