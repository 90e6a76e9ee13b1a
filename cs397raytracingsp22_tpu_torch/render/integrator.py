"""The path-trace estimator over ray batches, in plain torch.

Mirrors `cs397raytracingsp22_tpu/render/integrator.py::path_trace`: the
reference's recursive `shade_ray` (tracing.rs:300-324) as a loop over
bounce depth carrying (origin, direction, throughput, radiance, alive)
for the whole batch,

    radiance = Σ_k  (Π_{j<k} dot_j·brdf_j/pdf_j) · emission_k,

with misses adding the (black) background and rays still alive after
`path_depth` bounces contributing nothing more. `path_trace` is the plain
version of the mega-bounce kernel: `ops/kernels/bounce.py::path_trace_cuda`
runs it for CPU tensors, and the kernel is held against it on the card.

`path_trace_shrink` is the staged executor (scenes beyond the mega-bounce
kernel's gates): the same estimator one bounce at a time through
`intersect_scene` (the scene-intersection and big-mesh kernels for CUDA
tensors), compacting the wavefront to its live rays after every bounce.
"""

from __future__ import annotations

import functools

import torch
from torch.profiler import record_function

from cs397raytracingsp22_tpu_torch.models.scene import SceneData
from cs397raytracingsp22_tpu_torch.ops import bsdf
from cs397raytracingsp22_tpu_torch.ops.intersect import intersect_scene, intersect_scene_plain
from cs397raytracingsp22_tpu_torch.utils import rng as rnglib
from cs397raytracingsp22_tpu_torch.utils import sampling
from cs397raytracingsp22_tpu_torch.utils import threefry
from cs397raytracingsp22_tpu_torch.utils import vecmath as vm

# path-trace ray epsilon (tracing.rs:305)
PATH_T_MIN = 0.001


def background_color(d: torch.Tensor) -> torch.Tensor:
    """Black void (tracing.rs:266-274)."""
    return torch.zeros(d.shape[:-1] + (3,), dtype=torch.float32, device=d.device)


def _bounce_draws(scene: SceneData, rng_key, uids: torch.Tensor, site):
    """One bounce's draws from the counter RNG: ball vector, branch
    uniform and one free-flight uniform per volume-table row (draw slots
    4..4+V). Profiler traces show them as the span "bounce_rng"."""
    with record_function("bounce_rng"):
        n_vol = scene.vol_center.shape[0]
        u = threefry.bounce_uniforms(rng_key, uids, site, 4 + n_vol)
        ball = sampling.ball_vec_from_uniform(u[:, 0:3])
        return ball, u[:, 3], u[:, 4:]


def _bounce_update(scene, o, d, thr, rad, alive, uids, rng_key, site, max_trace_dist,
                   intersect=intersect_scene_plain):
    """The estimator body for ONE bounce (tracing.rs:300-324), shared by
    path_trace (plain intersection) and path_trace_shrink (intersect_scene).
    Returns (o, d, thr, rad, live_hit, segments this bounce)."""
    ball, u_choice, u_vol = _bounce_draws(scene, rng_key, uids, site)
    # dead rays get an empty [t_min, 0] window: every test rejects
    t_max = torch.where(
        alive,
        torch.full_like(alive, max_trace_dist, dtype=torch.float32),
        torch.zeros_like(alive, dtype=torch.float32),
    )
    hit = intersect(scene, o, d, PATH_T_MIN, t_max, u_vol)

    live_hit = alive & hit.valid
    live_miss = alive & ~hit.valid

    # miss: background·throughput, then die (tracing.rs:306)
    rad = rad + torch.where(live_miss[:, None], thr * background_color(d), 0.0)

    # hit: emission + scatter (tracing.rs:307-322)
    new_dir, att, inv_pdf = bsdf.scatter(hit, d, ball, u_choice)
    # dot term |new_dir·n| clamped to [0, 1]; 1 for zero-normal volume
    # hits (tracing.rs:313)
    has_normal = vm.magnitude2(hit.normal) > 0.0
    dot_term = torch.where(
        has_normal,
        torch.clamp(torch.abs(vm.dot(new_dir, hit.normal)), 0.0, 1.0),
        torch.ones_like(inv_pdf),
    )
    factor = (dot_term * inv_pdf)[:, None] * att

    rad = rad + torch.where(live_hit[:, None], thr * hit.emission, 0.0)
    thr = torch.where(live_hit[:, None], thr * factor, thr)
    o = torch.where(live_hit[:, None], hit.point, o)
    d = torch.where(live_hit[:, None], new_dir, d)
    segs = alive.sum()
    return o, d, thr, rad, live_hit, segs


def path_trace(
    scene: SceneData,
    o: torch.Tensor,
    d: torch.Tensor,
    uids: torch.Tensor,
    rng_key,
    path_depth: int,
    max_trace_dist: float,
    stats: dict | None = None,
):
    """Trace N ray chains to completion.

    o, d: (N, 3) primary rays; uids (N,) int32 chain ids (the RNG
    counters); rng_key an int seed or (2,) key words.

    Returns (radiance (N, 3) float32, segments): segments is the exact
    count of path segments traced, an int64 scalar tensor (a float32 sum
    loses count past 2^24 segments).

    stats: when a dict, receives per-chain int64 counts of the dense-mesh
    tests summed over the bounces (intersect_scene_plain's stats) and
    "segs", the per-chain segment counts.
    """
    n = o.shape[0]
    dev = o.device
    thr = torch.ones((n, 3), dtype=torch.float32, device=dev)
    rad = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    alive = torch.ones((n,), dtype=torch.bool, device=dev)
    segments = torch.zeros((), dtype=torch.int64, device=dev)
    intersect = functools.partial(intersect_scene_plain, stats=stats)
    for depth in range(path_depth):
        if stats is not None:
            stats["segs"] = stats.get("segs", 0) + alive.to(torch.int64)
        o, d, thr, rad, alive, segs = _bounce_update(
            scene, o, d, thr, rad, alive, uids, rng_key,
            rnglib.SITE_BOUNCE0 + depth, max_trace_dist, intersect=intersect,
        )
        segments = segments + segs
    return rad, segments


def has_big_mesh(scene: SceneData) -> bool:
    return len(scene.dense_mesh_ids) < len(scene.meshes)


def path_trace_shrink(
    scene: SceneData,
    o: torch.Tensor,
    d: torch.Tensor,
    uids: torch.Tensor,
    rng_key,
    path_depth: int,
    max_trace_dist: float,
):
    """path_trace one bounce at a time through intersect_scene, the
    wavefront compacted to its live rays after every bounce.

    After a bounce a stable partition puts the dead rays last, the live
    count is read on the host (one sync per bounce), the dead rows retire
    their radiance into the output at their caller position, and the next
    bounce runs on exactly the live rows. The RNG follows each ray's uid,
    so the radiance is the same, bit for bit, as path_trace's with the same
    intersection, in whatever order the rays come.

    Returns (radiance (N, 3) float32 in the caller's order, segments int64
    scalar tensor).
    """
    n = o.shape[0]
    dev = o.device
    thr = torch.ones((n, 3), dtype=torch.float32, device=dev)
    rad = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    alive = torch.ones((n,), dtype=torch.bool, device=dev)
    pos = torch.arange(n, device=dev)
    out = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    segments = torch.zeros((), dtype=torch.int64, device=dev)
    for depth in range(path_depth):
        o, d, thr, rad, alive, segs = _bounce_update(
            scene, o, d, thr, rad, alive, uids, rng_key, rnglib.SITE_BOUNCE0 + depth,
            max_trace_dist, intersect=intersect_scene,
        )
        segments = segments + segs
        if depth == path_depth - 1:
            break
        perm = torch.argsort((~alive).to(torch.int32), stable=True)
        n_alive = int(alive.sum())  # the one host sync of the bounce
        gone = perm[n_alive:]
        out[pos[gone]] = rad[gone]
        keep = perm[:n_alive]
        o, d, thr, rad, uids, pos = o[keep], d[keep], thr[keep], rad[keep], uids[keep], pos[keep]
        alive = alive[keep]
        if n_alive == 0:
            break
    out[pos] = rad
    return out, segments
