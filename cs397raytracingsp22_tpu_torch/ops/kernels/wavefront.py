"""K4, the wavefront kernel: the path trace one bounce per launch, with the
live rays compacted to the front between bounces.

The JAX package's ops/pallas/bounce.py::path_trace_wavefront runs a host
loop: per bounce one step over the whole width, then a stable dead-last
partition of the ray state (bounce.py:1658 `_stable_partition`), and at
the end the radiance put back in the caller's order. Its plain version
here, `path_trace_wavefront_plain`, is that loop with
render/integrator.py::bounce_update as the step and `stable_partition`.
CPU tensors run it.

For CUDA tensors `path_trace_wavefront` launches csrc/wavefront.cu
(hand-written CUDA C++ for sm_90a, built by _build.py) once a bounce. It
replaces the TPU step kernel bounce.py::_make_step_kernel and the
partition together: a launch steps the live rows of one buffer with K1's
body (csrc/bounce.cuh) and writes the rays that stay alive into the other,
compacted in one pass (a ray's rank in its tile, plus the tile's offset,
reserved by one atomic add once the tile is stepped: tiles keep their
rays' order, and take their places in the order they finish); a ray
that dies writes its radiance straight to its caller index. The live
count of each bounce stays on the device (`Workspace.live`): no step reads
it on the host, and a launch walks only the tiles that hold live rays.
`step_model` is one launch step for step in plain torch (`compact_plain`,
`reservation_order`), and `path_trace_wavefront_model` runs the kernel's
host loop with it.

The state of a ray is one row of ROW float32 (STATE_* columns), the ints
stored as int32 bits.

`LAUNCHES` counts K4's launches (and nothing else).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from cs397raytracingsp22_tpu_torch.models.scene import SceneData
from cs397raytracingsp22_tpu_torch.ops.intersect import intersect_scene_plain
from cs397raytracingsp22_tpu_torch.ops.kernels import _build
from cs397raytracingsp22_tpu_torch.ops.kernels._build import check_tensor
from cs397raytracingsp22_tpu_torch.ops.kernels.bounce import TABLES, big_meshes, scene_is_simple
from cs397raytracingsp22_tpu_torch.render import integrator
from cs397raytracingsp22_tpu_torch.utils import profiling
from cs397raytracingsp22_tpu_torch.utils import threefry

LAUNCHES = 0

# the columns of a state row (csrc/wavefront.cu reads them as four float4)
ROW = 16
STATE_O, STATE_D, STATE_THR, STATE_RAD = slice(0, 3), slice(3, 6), slice(6, 9), slice(9, 12)
# int32 bits: the ray's uid, its index in the caller's order, and (K4's rows)
# 1 while it lives
STATE_UID, STATE_IDX, STATE_ALIVE = 12, 13, 14

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [
    _P, _P, _P, _P, _P, _P,  # o, d, uid, src, dst, rad
    _P, _P, _P,  # live, ticket, tiles
    _I, _I, _I, _I, _I,  # n, first, compact, depth, last
    ctypes.c_uint, ctypes.c_uint, ctypes.c_float, ctypes.c_float,  # k0 k1 t_min t_max
    _P, _I, _I, _I, _I, _I, _I, _I,  # scene, len, n_sph n_pln n_tri n_vol n_mat n_mesh
    _P, _P, _P, _I, _P,  # mesh_tri (kmesh_tri4), mesh_nrm, tree, tree_len, stream
]


def library() -> ctypes.CDLL:
    """The built kernel library (builds it on first use)."""
    lib = _build.load_library("wavefront")
    lib.rt_wavefront_launch.argtypes = _ARGTYPES
    lib.rt_wavefront_launch.restype = _I
    lib.rt_wavefront_attrs.argtypes = [_I, _I, ctypes.POINTER(_I), ctypes.POINTER(_I)]
    lib.rt_wavefront_attrs.restype = _I
    lib.rt_wavefront_occupancy.argtypes = [_I, _I, _I, _I, ctypes.POINTER(_I)]
    lib.rt_wavefront_occupancy.restype = _I
    return lib


def kernel_attrs(dense: bool = True, last: bool = False) -> tuple[int, int]:
    """(registers per thread, local spill bytes) of one of the four
    instantiations: with the dense-mesh walk or without (dense False), the
    emission-only last bounce when `last`."""
    regs, local = _I(), _I()
    rc = library().rt_wavefront_attrs(int(dense), int(last), ctypes.byref(regs),
                                      ctypes.byref(local))
    if rc != 0:
        raise RuntimeError(f"cudaFuncGetAttributes failed with CUDA error {rc}")
    return regs.value, local.value


def resident_blocks(scene: SceneData, last: bool = False) -> int:
    """Blocks of K4 resident on one SM, each staging `scene`'s tables, for
    the instantiation `scene` launches: the persistent grid's blocks an SM."""
    blocks = _I()
    rc = library().rt_wavefront_occupancy(
        int(len(scene.dense_mesh_ids) > 0), int(last), int(scene.kscene.numel()),
        int(scene.ksl_tree.numel()), ctypes.byref(blocks))
    if rc != 0:
        raise RuntimeError(f"cudaOccupancyMaxActiveBlocksPerMultiprocessor failed with CUDA error {rc}")
    return blocks.value


def tile_rays(scene: SceneData) -> int:
    """Rays in one of K4's tiles for `scene`: a warp's 32 with a dense mesh
    (csrc/wavefront.cu: a bounce with the walk is long, so warps take tiles
    on their own), a block's 128 without."""
    return 32 if scene.dense_mesh_ids else 128


def pack_state(o: torch.Tensor, d: torch.Tensor, uids: torch.Tensor):
    """(rows (N, ROW) float32, alive (N,) int32) of N camera rays: origin,
    direction, throughput 1, radiance 0, uid, caller index; all alive."""
    n = o.shape[0]
    rows = torch.zeros((n, ROW), dtype=torch.float32, device=o.device)
    rows[:, STATE_O] = o
    rows[:, STATE_D] = d
    rows[:, STATE_THR] = 1.0
    ints = rows.view(torch.int32)
    ints[:, STATE_UID] = uids
    ints[:, STATE_IDX] = torch.arange(n, dtype=torch.int32, device=o.device)
    return rows, torch.ones((n,), dtype=torch.int32, device=o.device)


def stable_partition(alive: torch.Tensor, rows: torch.Tensor):
    """Stable partition of the rows of `rows` by `alive` (N,): live rows
    first, dead rows after, each in its order (bounce.py::_stable_partition:
    cumsum positions, one scatter). Returns (rows, alive) permuted; the new
    alive is 1 on the first (live count) rows. All on the device, no host
    read. Profiler traces show it as the span "wavefront_partition"."""
    with profiling.span("wavefront_partition"):
        n = alive.shape[0]
        live = alive != 0
        n_live = torch.cumsum(live, 0, dtype=torch.int64)  # live rows up to and including i
        rank = torch.arange(1, n + 1, dtype=torch.int64, device=alive.device)
        total = n_live[-1:]
        pos = torch.where(live, n_live, total + rank - n_live) - 1
        out = torch.empty_like(rows).index_copy_(0, pos, rows)
        return out, (rank <= total).to(torch.int32)


def radiance_in_caller_order(rows: torch.Tensor) -> torch.Tensor:
    """The (N, 3) radiance of the state rows, un-permuted by their caller
    index."""
    idx = rows.view(torch.int32)[:, STATE_IDX].long()
    return torch.empty((rows.shape[0], 3), dtype=torch.float32, device=rows.device).index_copy_(
        0, idx, rows[:, STATE_RAD])


def step_plain(scene: SceneData, rows, alive, rng_key, depth: int, max_trace_dist: float):
    """One bounce of every row by the plain version
    (integrator.bounce_update on intersect_scene_plain; the state's columns
    packed, as the shading kernel S1 takes them on the card). Returns new
    (rows, alive)."""
    o, d, thr, rad = (rows[:, cols].contiguous()
                      for cols in (STATE_O, STATE_D, STATE_THR, STATE_RAD))
    o, d, thr, rad, live, _, _ = integrator.bounce_update(
        scene, o, d, thr, rad, alive != 0, rows.view(torch.int32)[:, STATE_UID].contiguous(),
        rng_key, depth, max_trace_dist, intersect=intersect_scene_plain,
    )
    out = rows.clone()
    out[:, STATE_O], out[:, STATE_D], out[:, STATE_THR], out[:, STATE_RAD] = o, d, thr, rad
    return out, live.to(torch.int32)


class Workspace:
    """The device words of one render through K4, in one zeroed int32
    buffer: `live` (depth + 1,), the rays entering each bounce (live[0] = n,
    the rest added up by the launches); `tiles` (depth,), the tiles each
    launch processed; and `tickets` (depth,), each launch's tile ticket."""

    def __init__(self, n: int, path_depth: int, device):
        buf = torch.zeros((3 * path_depth + 1,), dtype=torch.int32, device=device)
        self.live = buf[:path_depth + 1]
        self.tiles = buf[path_depth + 1:2 * path_depth + 1]
        self.tickets = buf[2 * path_depth + 1:]
        self.live[0] = n


def reservation_order(n_tiles: int, resident: int | None = None, seed: int | None = None) -> list:
    """The order in which K4's tiles reserve their places: `resident` warps
    or blocks (one a tile when None) take tiles from a ticket in order, and
    each reserves its tile's place when the tile's bounce ends and then
    takes the next ticket. Which running one ends next is drawn from `seed`;
    with seed None the tiles reserve in ticket order."""
    if seed is None:
        return list(range(n_tiles))
    pick = np.random.default_rng(seed)
    running = list(range(min(n_tiles, n_tiles if resident is None else resident)))
    ticket, order = len(running), []
    while running:
        order.append(running.pop(int(pick.integers(len(running)))))
        if ticket < n_tiles:
            running.append(ticket)
            ticket += 1
    return order


def compact_plain(rows, on, rad, tile: int, order: list | None = None):
    """K4's compaction of the rows one launch stepped, in plain torch:
    `rows` (n, ROW) in the order the launch read them, `on` (n,) bool the
    rays that live on, in tiles of `tile` rays. A ray's position is its
    rank inside its tile (the kernel's warp ballots and warp offsets) plus
    its tile's offset: the live rays of the tiles that reserved before it,
    in `order` (reservation_order; ticket order when None, which gives
    stable_partition's live rows). The dead rays' radiance goes to rad
    (N, 3) at their caller index. Returns (the live rows compacted
    (m, ROW), m)."""
    n = rows.shape[0]
    n_tiles = -(-n // tile)
    flags = torch.zeros((n_tiles * tile,), dtype=torch.int64, device=rows.device)
    flags[:n] = on
    flags = flags.view(n_tiles, tile)
    rank = torch.cumsum(flags, 1) - flags  # live rays before each in its tile
    counts = flags.sum(1)
    order = torch.tensor(list(range(n_tiles)) if order is None else order, dtype=torch.int64,
                         device=rows.device)
    base = torch.empty_like(counts)
    base[order] = torch.cumsum(counts[order], 0) - counts[order]
    pos = (base[:, None] + rank).reshape(-1)[:n]
    m = int(counts.sum())
    out = torch.empty((m, ROW), dtype=rows.dtype, device=rows.device)
    out[pos[on]] = rows[on]
    _radiance_to_caller(rows[~on], rad)
    return out, m


def _radiance_to_caller(rows, rad) -> None:
    rad[rows.view(torch.int32)[:, STATE_IDX].long()] = rows[:, STATE_RAD]


def step_model(scene: SceneData, src, dst, rad, ws: Workspace, rng_key, depth: int, last: bool,
               max_trace_dist: float, compact: bool = True, camera=None,
               resident: int | None = None, seed: int | None = None) -> None:
    """One K4 launch step for step in plain torch (step_cuda's arguments;
    the step is step_plain, which traces from integrator.PATH_T_MIN): read
    live[depth] rows of src (the camera rays (o, d, uids) when `camera` is
    given; every row, skipping those with alive 0, when not `compact`), step
    them, write the dead rays' radiance to rad by caller index, and unless
    `last` write the rays that live on to dst (compact_plain, the tiles
    reserving in reservation_order(resident, seed); in place when not
    `compact`) and their count to live[depth + 1]; tiles[depth] gets the
    tiles walked."""
    if camera is not None:
        rows, alive = pack_state(*camera)
    else:
        n_in = int(ws.live[depth]) if compact else src.shape[0]
        rows = src[:n_in]
        alive = (torch.ones((n_in,), dtype=torch.int32, device=rows.device) if compact
                 else rows.view(torch.int32)[:, STATE_ALIVE])
    tile = tile_rays(scene)
    ws.tiles[depth] = -(-rows.shape[0] // tile)
    new, on = step_plain(scene, rows, alive, rng_key, depth, max_trace_dist)
    on = (on != 0) & (not last)
    new.view(torch.int32)[:, STATE_ALIVE] = on.to(torch.int32)
    if last or not compact:
        valid = alive != 0
        _radiance_to_caller(new[valid & ~on], rad)
        if not last:
            dst[valid] = new[valid]
            ws.live[depth + 1] = int(on.sum())
        return
    order = reservation_order(-(-new.shape[0] // tile), resident, seed)
    out, m = compact_plain(new, on, rad, tile, order)
    dst[:m] = out
    ws.live[depth + 1] = m


def step_cuda(scene: SceneData, src, dst, rad, ws: Workspace, key_pair, depth: int, last: bool,
              t_min: float, max_trace_dist: float, compact: bool = True, camera=None) -> None:
    """Bounce `depth` by one K4 launch on the current stream. src, dst:
    (N, ROW) float32 row buffers (src ignored when `camera` = (o, d, uids)
    gives the first launch's rays; dst None on the `last` launch, which
    writes only radiance; with compact False, dst is src after the first
    launch); rad: (N, 3) radiance out by caller index; ws: the render's
    Workspace. No host read: the launch reads live[depth] on the device.
    A failed build or launch raises."""
    global LAUNCHES
    n = rad.shape[0]
    dev = rad.device
    if not compact and camera is None and dst is not None and dst.data_ptr() != src.data_ptr():
        raise ValueError("compact=False updates the rows in place: dst must be src")
    for name, t in (("src", src), ("dst", dst)):
        if t is not None:
            check_tensor(name, t, torch.float32, (n, ROW), dev)
    if (dst is None) != bool(last):
        raise ValueError("every launch but the last writes rows to dst")
    o, d, uids = camera if camera is not None else (None, None, None)
    k0, k1 = key_pair

    def ptr(t):
        return None if t is None else t.data_ptr()

    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = library().rt_wavefront_launch(
            ptr(o), ptr(d), ptr(uids), ptr(src), ptr(dst), rad.data_ptr(),
            ws.live.data_ptr(), ws.tickets.data_ptr(), ws.tiles.data_ptr(), n,
            int(camera is not None), int(compact), int(depth), int(last), k0, k1, float(t_min),
            float(max_trace_dist), scene.kscene.data_ptr(), int(scene.kscene.numel()), scene.n_spheres, scene.n_planes, scene.n_tris,
            scene.n_volumes, int(scene.mat_type.shape[0]), len(scene.dense_mesh_ids),
            scene.kmesh_tri4.data_ptr(), scene.kmesh_nrm.data_ptr(),
            scene.ksl_tree.data_ptr(), int(scene.ksl_tree.numel()), stream,
        )
    if rc != 0:
        raise RuntimeError(f"wavefront kernel launch failed with CUDA error {rc}")
    LAUNCHES += 1


def _wavefront(step, o, d, uids, path_depth: int, compact: bool, stats: dict | None):
    """The host loop: per bounce count the live rays, step, and, except
    after the last bounce, partition. Returns (radiance in the caller's order,
    segments int64)."""
    rows, alive = pack_state(o, d, uids)
    live = []
    for depth in range(path_depth):
        live.append(alive.sum(dtype=torch.int64))  # the segments of this bounce
        rows, alive = step(rows, alive, depth, depth == path_depth - 1)
        if compact and depth < path_depth - 1:
            rows, alive = stable_partition(alive, rows)
    live = torch.stack(live) if live else torch.zeros((0,), dtype=torch.int64, device=o.device)
    if stats is not None:
        stats["live"] = live
    return radiance_in_caller_order(rows), live.sum()


def _kernel_loop(launch, o, d, uids, path_depth: int, compact: bool, stats: dict | None):
    """K4's host loop: the render's Workspace and row buffers, then one
    launch a bounce (the first reads the camera rays; with `compact`, rows
    go back and forth between two buffers). Returns (radiance in the
    caller's order, segments int64: the live counts summed on the device).
    stats: when a dict, receives "live" (path_depth,) int64 and "tiles"
    (path_depth,) int32, the tiles each launch walked."""
    n, dev = o.shape[0], o.device
    rad = torch.empty((n, 3), dtype=torch.float32, device=dev)
    if path_depth == 0:
        rad.zero_()
    ws = Workspace(n, path_depth, dev)
    n_bufs = 0 if path_depth < 2 else 2 if compact and path_depth > 2 else 1
    bufs = [torch.empty((n, ROW), dtype=torch.float32, device=dev) for _ in range(n_bufs)]
    for depth in range(path_depth):
        last = depth == path_depth - 1
        launch(bufs[(depth - 1) % n_bufs] if depth else None,
               None if last else bufs[depth % n_bufs], rad, ws, depth, last,
               None if depth else (o, d, uids))
    live = ws.live[:path_depth].to(torch.int64)
    if stats is not None:
        stats["live"], stats["tiles"] = live, ws.tiles
    return rad, live.sum()


def path_trace_wavefront_plain(
    scene: SceneData,
    o: torch.Tensor,
    d: torch.Tensor,
    uids: torch.Tensor,
    rng_key,
    path_depth: int,
    max_trace_dist: float,
    compact: bool = True,
    stats: dict | None = None,
):
    """path_trace_wavefront with the plain step, on the tensors' device
    (the step traces from integrator.PATH_T_MIN)."""
    def step(rows, alive, depth, last):
        return step_plain(scene, rows, alive, rng_key, depth, max_trace_dist)

    return _wavefront(step, o, d, uids, path_depth, compact, stats)


def path_trace_wavefront_model(
    scene: SceneData,
    o: torch.Tensor,
    d: torch.Tensor,
    uids: torch.Tensor,
    rng_key,
    path_depth: int,
    max_trace_dist: float,
    compact: bool = True,
    stats: dict | None = None,
    resident: int | None = None,
    seed: int | None = None,
):
    """K4's host loop with step_model for the launch, on the tensors'
    device: what the kernel computes, in plain torch (`resident` and `seed`:
    the order in which tiles reserve their places, reservation_order; with
    seed None, ticket order, which gives path_trace_wavefront_plain's rows
    order)."""
    def launch(src, dst, rad, ws, depth, last, camera):
        step_model(scene, src, dst, rad, ws, rng_key, depth, last, max_trace_dist, compact,
                   camera, resident, None if seed is None else seed + depth)

    return _kernel_loop(launch, o, d, uids, path_depth, compact, stats)


def path_trace_wavefront(
    scene: SceneData,
    o: torch.Tensor,
    d: torch.Tensor,
    uids: torch.Tensor,
    rng_key,
    path_depth: int,
    max_trace_dist: float,
    t_min: float = integrator.PATH_T_MIN,
    compact: bool = True,
    stats: dict | None = None,
):
    """Trace N ray chains one bounce per step, compacting the live rays to
    the front between bounces (compact=False keeps every ray in place; the
    result is the same, since each ray's draws follow its uid).

    o, d: (N, 3) float32; uids: (N,) int32; rng_key: int seed or (2,) key
    words. Returns (radiance (N, 3) float32 in the caller's order, segments
    int64 scalar tensor: the live rays entering each bounce, summed on the
    device). stats: when a dict, receives "live", the (path_depth,) int64
    live counts entering each bounce (and on the card "tiles", the tiles
    each launch walked).

    CPU tensors run the plain version (path_trace_wavefront_plain, which
    traces from integrator.PATH_T_MIN). CUDA tensors launch K4 once per
    bounce, compacting inside the launch; a scene beyond K1's gates,
    anything the kernel does not take (a scene with a sphere tree or a big
    mesh among them), a failed build or a failed launch raises.
    """
    if o.device.type == "cpu":
        return path_trace_wavefront_plain(scene, o, d, uids, rng_key, path_depth,
                                          max_trace_dist, compact, stats)
    if o.device.type != "cuda":
        raise ValueError(f"path_trace_wavefront takes CPU or CUDA tensors, got {o.device}")
    if not scene_is_simple(scene):
        raise ValueError("scene exceeds the wavefront kernel's gates (scene_is_simple)")
    if scene.sph_tree_leaves:
        raise ValueError("the wavefront kernel scans spheres; a scene with a sphere tree "
                         "(models/scene.py::sphere_tree) takes K1")
    if big_meshes(scene):
        raise ValueError("the wavefront kernel walks dense meshes alone; a scene with a mesh "
                         "past the dense budget takes K1")
    dev = o.device
    n = o.shape[0]
    check_tensor("o", o, torch.float32, (n, 3), dev)
    check_tensor("d", d, torch.float32, (n, 3), dev)
    check_tensor("uids", uids, torch.int32, (n,), dev)
    for key in TABLES:
        t = getattr(scene, key)
        check_tensor(f"scene.{key}", t, torch.float32, tuple(t.shape), dev)
    if n >= 2**31:
        raise ValueError(f"{n} rays exceed the kernel's int32 ray count")
    if path_depth < 0:
        raise ValueError("path_depth must be >= 0")
    key_pair = threefry.key_pair(rng_key)

    def launch(src, dst, rad, ws, depth, last, camera):
        step_cuda(scene, src, dst, rad, ws, key_pair, depth, last, t_min, max_trace_dist,
                  compact, camera)

    return _kernel_loop(launch, o, d, uids, path_depth, compact, stats)
