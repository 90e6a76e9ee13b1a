"""K4, the wavefront kernel: the path trace one bounce per launch, with the
live rays compacted to the front between bounces.

`path_trace_wavefront` runs the host loop of the JAX package's
ops/pallas/bounce.py::path_trace_wavefront: per bounce one step over the
whole width, then a stable dead-last partition of the ray state
(`stable_partition`, bounce.py:1658), and at the end the radiance put
back in the caller's order. For CUDA tensors the step is one launch of
csrc/wavefront.cu (hand-written CUDA C++ for sm_90a, built by _build.py),
which replaces the TPU step kernel bounce.py::_make_step_kernel and runs
the same body as K1 (csrc/bounce.cuh). For CPU tensors the step is the
plain version, render/integrator.py::_bounce_update on
intersect_scene_plain, through the same loop and partition
(`path_trace_wavefront_plain` runs that on any device).

No step reads the live count on the host: K4 launches over the full width
and a dead ray's thread returns at once; the live rays sit at the front
after each partition, so whole blocks of dead rays return together.

The state of a ray is one row of ROW float32 (STATE_* columns), the ints
stored as int32 bits; `alive` is a separate (N,) int32.

`LAUNCHES` counts K4's launches (and nothing else).
"""

from __future__ import annotations

import ctypes

import torch
from torch.profiler import record_function

from cs397raytracingsp22_tpu_torch.models.scene import SceneData
from cs397raytracingsp22_tpu_torch.ops.kernels import _build
from cs397raytracingsp22_tpu_torch.ops.kernels.bounce import TABLES, check_tensor, scene_is_simple
from cs397raytracingsp22_tpu_torch.render import integrator
from cs397raytracingsp22_tpu_torch.utils import rng as rnglib
from cs397raytracingsp22_tpu_torch.utils import threefry

LAUNCHES = 0

# the columns of a state row (csrc/wavefront.cu reads them as four float4)
ROW = 16
STATE_O, STATE_D, STATE_THR, STATE_RAD = slice(0, 3), slice(3, 6), slice(6, 9), slice(9, 12)
STATE_UID, STATE_IDX = 12, 13  # int32 bits: the ray's uid, its index in the caller's order

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [
    _P, _P, _I, _I, _I,  # rows, alive, n, depth, last
    ctypes.c_uint, ctypes.c_uint, ctypes.c_float, ctypes.c_float,  # k0 k1 t_min t_max
    _P, _I, _I, _I, _I, _I, _I, _I,  # scene, len, n_sph n_pln n_tri n_vol n_mat n_mesh
    _P, _P, _P, _I, _P,  # mesh_tri (kmesh_tri4), mesh_nrm, tree, tree_len, stream
]


def library() -> ctypes.CDLL:
    """The built kernel library (builds it on first use)."""
    lib = _build.load_library("wavefront")
    lib.rt_wavefront_launch.argtypes = _ARGTYPES
    lib.rt_wavefront_launch.restype = _I
    lib.rt_wavefront_attrs.argtypes = [_I, ctypes.POINTER(_I), ctypes.POINTER(_I)]
    lib.rt_wavefront_attrs.restype = _I
    return lib


def kernel_attrs(last: bool = False) -> tuple[int, int]:
    """(registers per thread, local spill bytes) of the compiled kernel, the
    emission-only variant when `last`."""
    regs, local = _I(), _I()
    rc = library().rt_wavefront_attrs(int(last), ctypes.byref(regs), ctypes.byref(local))
    if rc != 0:
        raise RuntimeError(f"cudaFuncGetAttributes failed with CUDA error {rc}")
    return regs.value, local.value


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
    with record_function("wavefront_partition"):
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
    (integrator._bounce_update on intersect_scene_plain). Returns new
    (rows, alive)."""
    o, d, thr, rad, live, _ = integrator._bounce_update(
        scene, rows[:, STATE_O], rows[:, STATE_D], rows[:, STATE_THR], rows[:, STATE_RAD],
        alive != 0, rows.view(torch.int32)[:, STATE_UID], rng_key,
        rnglib.SITE_BOUNCE0 + depth, max_trace_dist,
    )
    out = rows.clone()
    out[:, STATE_O], out[:, STATE_D], out[:, STATE_THR], out[:, STATE_RAD] = o, d, thr, rad
    return out, live.to(torch.int32)


def step_cuda(scene: SceneData, rows, alive, key_pair, depth: int, last: bool, t_min: float,
              max_trace_dist: float):
    """One bounce of every live row by one K4 launch on the current stream
    (rows and alive updated in place; `last`: the emission-only variant).
    A failed build or launch raises."""
    global LAUNCHES
    n = rows.shape[0]
    k0, k1 = key_pair
    stream = torch.cuda.current_stream(rows.device).cuda_stream
    with torch.cuda.device(rows.device):
        rc = library().rt_wavefront_launch(
            rows.data_ptr(), alive.data_ptr(), n, int(depth), int(last), k0, k1, float(t_min),
            float(max_trace_dist), scene.kscene.data_ptr(), int(scene.kscene.numel()),
            scene.n_spheres, scene.n_planes, scene.n_tris, scene.n_volumes,
            int(scene.mat_type.shape[0]), len(scene.dense_mesh_ids),
            scene.kmesh_tri4.data_ptr(), scene.kmesh_nrm.data_ptr(),
            scene.ksl_tree.data_ptr(), int(scene.ksl_tree.numel()), stream,
        )
    if rc != 0:
        raise RuntimeError(f"wavefront kernel launch failed with CUDA error {rc}")
    LAUNCHES += 1
    return rows, alive


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
    live counts entering each bounce.

    CPU tensors run the plain step (path_trace_wavefront_plain, which
    traces from integrator.PATH_T_MIN). CUDA tensors launch K4 once per
    bounce; a scene beyond K1's gates, anything the kernel does not take, a
    failed build or a failed launch raises.
    """
    if o.device.type == "cpu":
        return path_trace_wavefront_plain(scene, o, d, uids, rng_key, path_depth,
                                          max_trace_dist, compact, stats)
    if o.device.type != "cuda":
        raise ValueError(f"path_trace_wavefront takes CPU or CUDA tensors, got {o.device}")
    if not scene_is_simple(scene):
        raise ValueError("scene exceeds the wavefront kernel's gates (scene_is_simple)")
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

    def step(rows, alive, depth, last):
        return step_cuda(scene, rows, alive, key_pair, depth, last, t_min, max_trace_dist)

    return _wavefront(step, o, d, uids, path_depth, compact, stats)
