"""K2, the scene-intersection kernel: one bounce's nearest hit over every
analytic class and the dense meshes.

`scene_intersect_cuda` launches csrc/scene_intersect.cu (hand-written
CUDA C++ for sm_90a, built by _build.py) for CUDA tensors; for CPU
tensors it runs the plain version `scene_intersect_plain`, which is also
what the kernel is held against on the card. It replaces the JAX
package's ops/pallas/scene_intersect.py::scene_intersect_pallas.

The launch is a persistent grid (`launch_config`: the blocks that stay
resident on the card, no more than the rays' 32-ray tiles give each warp
one) whose blocks stage the scene tables once. Its W warps take 32-ray
tiles: warp w takes w, w + W, ... below `static_tiles` (every tile without
a dense mesh or a sphere tree, up to half with one), and the rest come
from a ticket: two int32 on the device a stream (`ticket`), zero before a
launch and put back to zero by its last warp.

A scene with a sphere tree (models/scene.py::sphere_tree: 64 spheres or
more) takes the tree route (`route`): a second kernel whose blocks
stage the tree's nodes where the scan's stage the sphere rows, and whose
rays walk it with K1's walk (csrc/intersect.cuh::walk_spheres), giving
the scan's rows bit for bit; past 8,192 spheres, whose nodes do not fit a
block, the scan. The plain version walks the tree (ops/intersect.py::
walk_spheres).

Output, per ray: t (float32; t_max on a miss; object-space t for a mesh
winner), code (int32: -1 miss, 0 sphere, 1 plane, 2 triangle, 3 volume,
4 + k dense mesh k in dense_mesh_ids order), idx (int32: index in its
class; the mesh's own row, in BVH order, for a mesh winner), mat (int32
material id; a dense mesh's own, -1 where its material is synthesized
from its textures: the caller resolves mesh winners), u, v (barycentrics of a mesh winner, else 0), normal
((N, 3) front-facing shading normal of an analytic winner; zero for
volumes and meshes, whose winners the caller resolves) and frontface
(bool; false for volumes and meshes).

`LAUNCHES` counts the kernel's launches (and nothing else), on both routes;
`TREE_LAUNCHES` those on the tree route alone.
"""

from __future__ import annotations

import ctypes

import torch

from cs397raytracingsp22_tpu_torch.models.scene import SceneData
from cs397raytracingsp22_tpu_torch.ops import bvh as bvhlib
from cs397raytracingsp22_tpu_torch.ops import intersect as isect
from cs397raytracingsp22_tpu_torch.ops.kernels import _build
from cs397raytracingsp22_tpu_torch.ops.kernels._build import check_tensor
from cs397raytracingsp22_tpu_torch.ops.kernels.bounce import sph_tree_staged_bytes
from cs397raytracingsp22_tpu_torch.ops.kernels.bounce import staged_bytes as bounce_staged_bytes
from cs397raytracingsp22_tpu_torch.utils import vecmath as vm

LAUNCHES = 0
TREE_LAUNCHES = 0
SMEM_LIMIT = 227 * 1024  # shared memory a block can use on the H100
TILE = 32  # rays a warp takes at a time
_OCCUPANCY: dict = {}  # (library, device, table sizes, dense meshes) -> (blocks an SM, threads)
_ROUTES: dict = {}  # (table sizes, spheres, tree leaves) -> route
_SMS: dict = {}  # device -> SMs
_TICKETS: dict = {}  # (device, stream) -> the tile ticket
_TYPED: set = set()  # libraries whose functions carry their C types

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [
    _P, _P, _P, _P, _P, _I, _I,  # o, d, t_min, t_max, u_vol, u_ld, n
    _I, _I, _P,  # grid, n_static, ticket
    _P, _I, _I, _I, _I, _I, _I, _I,  # scene, len, n_sph n_pln n_tri n_vol n_mat n_mesh
    _P, _P, _I,  # mesh_tri (kmesh_tri4), tree, tree_len
    _P, _I,  # sph_table (ksph_tree), sph_leaves (0: the sphere scan)
    _P, _P, _P, _P, _P, _P, _P, _P,  # t, code, idx, mat, u, v, normal, ff
    _P,  # stream
]


def library() -> ctypes.CDLL:
    """The built kernel library (builds it on first use), its functions
    typed once."""
    lib = _build.load_library("scene_intersect")
    if id(lib) in _TYPED:
        return lib
    _TYPED.add(id(lib))
    lib.rt_scene_intersect_launch.argtypes = _ARGTYPES
    lib.rt_scene_intersect_launch.restype = _I
    lib.rt_scene_intersect_attrs.argtypes = [_I, _I, ctypes.POINTER(_I), ctypes.POINTER(_I)]
    lib.rt_scene_intersect_attrs.restype = _I
    lib.rt_scene_intersect_occupancy.argtypes = [_I, _I, _I, _I, _I, ctypes.POINTER(_I),
                                                 ctypes.POINTER(_I)]
    lib.rt_scene_intersect_occupancy.restype = _I
    return lib


def kernel_attrs(dense: bool = True, sph_tree: bool = False) -> tuple[int, int]:
    """(registers per thread, local spill bytes) of the compiled kernel: the
    instantiation with the dense-mesh walk and the ticket, or (dense False)
    the one for scenes without a dense mesh; with the sphere scan, or
    (sph_tree True) the tree route's."""
    regs, local = _I(), _I()
    rc = library().rt_scene_intersect_attrs(int(dense), int(sph_tree), ctypes.byref(regs),
                                            ctypes.byref(local))
    if rc != 0:
        raise RuntimeError(f"cudaFuncGetAttributes failed with CUDA error {rc}")
    return regs.value, local.value


def grid_blocks(n: int, per_sm: int, sms: int, threads: int) -> int:
    """Blocks of a launch over n > 0 rays: as many as stay resident on the
    card (per_sm on each of sms SMs), but no more than give each warp of
    `threads`-thread blocks one 32-ray tile."""
    if per_sm < 1 or sms < 1:
        raise ValueError(f"no block of K2 fits on an SM ({per_sm} an SM, {sms} SMs)")
    warps_a_block = threads // TILE
    tiles = -(-n // TILE)
    return max(1, min(per_sm * sms, -(-tiles // warps_a_block)))


def static_tiles(n_tiles: int, n_warps: int, dense: bool) -> int:
    """The tiles of a launch that its warps take by the fixed rule (warp w
    of n_warps takes w, w + n_warps, ...): all of them without a walk
    (rays of about the same cost, where one atomic a tile would cost more
    than it balances); with one (dense: a dense mesh or a sphere tree),
    whole rounds of the warps up to half the tiles (at least one round),
    the rest drawn from the ticket (PERF.md)."""
    if not dense:
        return n_tiles
    return max(1, n_tiles // 2 // n_warps) * n_warps


def route(scene: SceneData) -> tuple[int, int]:
    """(leaves, staged bytes) of K2's launches on `scene`, decided once per
    table sizes. leaves: those of the sphere tree K2 walks, 0 for the
    sphere scan; the scene's tree (64 spheres or more) while its nodes fit
    a block's shared memory with the rest of the table (up to 8,192
    spheres), past that the scan, whose rows take 20 B a sphere. staged
    bytes: what a block stages, on the tree route the table from its first
    16-byte word past the sphere rows, the superleaf trees and the tree's
    nodes (bounce.sph_tree_staged_bytes), else the scene table and the
    superleaf trees (bounce.staged_bytes)."""
    g = scene.sph_tree_leaves
    key = (int(scene.kscene.numel()), int(scene.ksl_tree.numel()), scene.n_spheres, g)
    if key not in _ROUTES:
        tree = sph_tree_staged_bytes(scene, 5 * scene.n_spheres // 4 * 4) if g else 0
        _ROUTES[key] = ((g, tree) if g and tree <= SMEM_LIMIT
                        else (0, bounce_staged_bytes(scene)))
    return _ROUTES[key]


def staged_bytes(scene: SceneData) -> int:
    """Shared memory a block of K2 stages for `scene` (route)."""
    return route(scene)[1]


def occupancy(scene: SceneData, lib: ctypes.CDLL | None = None,
              rt: tuple[int, int] | None = None) -> tuple[int, int]:
    """(blocks resident on one SM, threads a block) of the instantiation that
    `scene` launches when each block stages its tables (rt: its route, as
    route gives it; cudaOccupancyMaxActiveBlocksPerMultiprocessor; cached
    per library, device, table sizes and instantiation)."""
    lib = lib or library()
    leaves = (rt or route(scene))[0]
    key = (id(lib), torch.cuda.current_device(), int(scene.kscene.numel()),
           int(scene.ksl_tree.numel()), len(scene.dense_mesh_ids), scene.n_spheres, leaves)
    if key not in _OCCUPANCY:
        blocks, threads = _I(), _I()
        rc = lib.rt_scene_intersect_occupancy(*key[2:], ctypes.byref(blocks),
                                              ctypes.byref(threads))
        if rc != 0:
            raise RuntimeError(
                f"cudaOccupancyMaxActiveBlocksPerMultiprocessor failed with CUDA error {rc}")
        _OCCUPANCY[key] = (blocks.value, threads.value)
    return _OCCUPANCY[key]


def launch_config(scene: SceneData, n: int, lib: ctypes.CDLL | None = None,
                  rt: tuple[int, int] | None = None) -> dict:
    """The launch's shape over n rays of `scene` on the current device:
    threads a block, rays a tile, resident blocks an SM, SMs, the grid,
    the tiles and those taken by the fixed rule (the rest come from the
    ticket), the shared memory a block stages, and the sphere tree's
    leaves (0: the scan). rt: the scene's route, as route gives it."""
    leaves, smem = rt = rt or route(scene)
    per_sm, threads = occupancy(scene, lib, rt)
    dev = torch.cuda.current_device()
    if dev not in _SMS:
        _SMS[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
    sms = _SMS[dev]
    grid = grid_blocks(max(n, 1), per_sm, sms, threads)
    tiles = -(-n // TILE)
    return dict(threads=threads, tile=TILE, blocks_per_sm=per_sm, sms=sms, grid=grid,
                tiles=tiles, static_tiles=static_tiles(
                    tiles, grid * threads // TILE, bool(scene.dense_mesh_ids) or bool(leaves)),
                smem_bytes=smem, leaves=leaves)


def ticket(dev: torch.device, stream: int) -> torch.Tensor:
    """The tile ticket of launches on `stream` of device `dev`: two int32,
    zeroed once; each launch leaves them zero."""
    key = (dev.index, stream)
    if key not in _TICKETS:
        _TICKETS[key] = torch.zeros((2,), dtype=torch.int32, device=dev)
    return _TICKETS[key]


def scene_intersect_plain(scene: SceneData, o, d, t_min, t_max, u_vol,
                          stats: dict | None = None):
    """The plain version: intersect_scene_plain's per-class tests (the
    sphere tree's walk on a scene with one) and each dense mesh's
    object-space scan, reduced to K2's outputs. stats: when a dict,
    receives the per-ray test counts of the sphere tree's walk
    (analytic_candidates: "sph_nodes", "sph_spheres") and of the dense
    meshes' (ops/intersect.py::dense_scan_counts)."""
    n = o.shape[0]
    t_max = torch.broadcast_to(vm.as_f32(t_max, o), (n,))
    cands = isect.analytic_candidates(scene, o, d, t_min, t_max, u_vol, stats=stats)
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
    global LAUNCHES, TREE_LAUNCHES
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
    for key in ("kscene", "kmesh_tri4", "ksl_tree", "ksph_tree"):
        t = getattr(scene, key)
        check_tensor(f"scene.{key}", t, torch.float32, tuple(t.shape), dev)
        if t.data_ptr() % 16:
            raise ValueError(f"scene.{key} must start on a 16-byte boundary (bulk copy)")
    rt = route(scene)
    if rt[1] > SMEM_LIMIT:
        what = "and sphere tree" if rt[0] else "and superleaf trees"
        raise ValueError(f"the scene table {what} ({rt[1]} B) exceed shared memory")
    if n * max(3, u_vol.shape[1]) >= 2**31:
        raise ValueError(f"{n} rays exceed the kernel's int32 indexing")
    out = empty_outputs(n, dev)
    if n == 0:  # nothing to launch
        return out
    launch(scene, (o, d, t_min, t_max, u_vol), out, rt)
    LAUNCHES += 1
    TREE_LAUNCHES += bool(rt[0])
    return out


def empty_outputs(n: int, dev) -> tuple:
    """The kernel's outputs for n rays on `dev`, unset: t, code, idx, mat,
    u, v, normal, ff."""
    f32, i32 = dict(dtype=torch.float32, device=dev), dict(dtype=torch.int32, device=dev)
    return (torch.empty((n,), **f32), torch.empty((n,), **i32), torch.empty((n,), **i32),
            torch.empty((n,), **i32), torch.empty((n,), **f32), torch.empty((n,), **f32),
            torch.empty((n, 3), **f32), torch.empty((n,), dtype=torch.bool, device=dev))


def launch(scene: SceneData, ins: tuple, out: tuple, rt: tuple[int, int] | None = None) -> None:
    """One launch of the kernel on the current stream of the inputs' device:
    ins = (o, d, t_min, t_max, u_vol), n > 0 rays, as scene_intersect_cuda
    checks them; out from empty_outputs; rt the scene's route, as route
    gives it. Counts nothing: the wrapper counts
    its launches, and a timing that leaves the wrapper's checks and
    allocations out of its bracket calls this (chip_smoke.py)."""
    o, d, t_min, t_max, u_vol = ins
    dev = o.device
    lib = library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        cfg = launch_config(scene, o.shape[0], lib, rt)
        rc = lib.rt_scene_intersect_launch(
            o.data_ptr(), d.data_ptr(), t_min.data_ptr(), t_max.data_ptr(), u_vol.data_ptr(),
            int(u_vol.shape[1]), o.shape[0], cfg["grid"], cfg["static_tiles"],
            ticket(dev, stream).data_ptr(),
            scene.kscene.data_ptr(), int(scene.kscene.numel()),
            scene.n_spheres, scene.n_planes, scene.n_tris, scene.n_volumes,
            int(scene.mat_type.shape[0]), len(scene.dense_mesh_ids),
            scene.kmesh_tri4.data_ptr(), scene.ksl_tree.data_ptr(), int(scene.ksl_tree.numel()),
            scene.ksph_tree.data_ptr(), cfg["leaves"],
            *(x.data_ptr() for x in out), stream,
        )
    if rc != 0:
        raise RuntimeError(f"scene-intersection kernel launch failed with CUDA error {rc}")
