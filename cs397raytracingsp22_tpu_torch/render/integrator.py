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
kernel's gates, and next-event estimation with `nee=True`): the same
estimator one bounce at a time, compacting the wavefront to its live rays
after every bounce. `bounce_update` is the one bounce body all of them
share, with or without NEE (render/nee.py): the draws, the intersection,
and the shading after it, one launch of the shading kernel S1
(ops/kernels/shade.py) for CUDA tensors and its plain version
ops/bsdf.py::shade_plain for CPU tensors; NEE's sample around its shadow
rays is two launches of N1 (ops/kernels/nee.py) for CUDA tensors.
`phong_trace` is the reference's Phong shading with hard shadows. The
executors take `intersect=`: `intersect_scene` (K2, and K3 per big mesh,
for CUDA tensors; the plain version for CPU tensors) by default,
`intersect_scene_plain` for their plain versions on the card.
"""

from __future__ import annotations

import functools

import torch

from cs397raytracingsp22_tpu_torch.models.scene import SceneData
from cs397raytracingsp22_tpu_torch.ops import bsdf
from cs397raytracingsp22_tpu_torch.ops.intersect import intersect_scene, intersect_scene_plain
from cs397raytracingsp22_tpu_torch.ops.kernels import draws, shade
from cs397raytracingsp22_tpu_torch.render import nee
from cs397raytracingsp22_tpu_torch.utils import profiling
from cs397raytracingsp22_tpu_torch.utils import rng as rnglib
from cs397raytracingsp22_tpu_torch.utils import vecmath as vm

# path-trace ray epsilon (tracing.rs:305) and Phong's shadow-ray offset
# (tracing.rs:289)
PATH_T_MIN = 0.001
PHONG_SHADOW_OFFSET = 0.01


def _bounce_draws(scene: SceneData, rng_key, uids: torch.Tensor, site):
    """One bounce's draws from the counter RNG: ball vector, branch
    uniform, one free-flight uniform per volume-table row (draw slots
    4..4+V) and one per general volume (the G slots after them; each slot
    is independent, so they move no sphere-volume draw): one launch of the
    draws kernel for CUDA tensors, the plain version for CPU tensors
    (ops/kernels/draws.py::bounce_draws). Profiler traces show them as the
    span "bounce_rng"."""
    with profiling.span("bounce_rng"):
        return draws.bounce_draws(rng_key, uids, site, scene.vol_center.shape[0] + scene.n_gvols)


def bounce_update(scene, o, d, thr, rad, alive, uids, rng_key, depth, max_trace_dist, *,
                  intersect, prev_nee=None, do_nee=False):
    """The estimator body for ONE bounce (tracing.rs:300-324; with NEE,
    integrator.py:420 in the JAX package), shared by path_trace,
    path_trace_shrink and K4's plain step.

    intersect: intersect_scene_plain (the plain version on any device) or
    intersect_scene (K2, and K3 per big mesh, for CUDA tensors).
    prev_nee: None, or (N,) flags of the rays whose previous vertex took a
    NEE sample: the emission they find here is what that sample covered,
    and is suppressed. do_nee: add the direct-light term (render/nee.py);
    False with NEE off and on NEE's last bounce, which keeps the
    expectation of the depth-limited plain estimator. NEE draws at the
    sites of the plain estimator, so it changes the estimator, not the
    sampled paths.

    Launches on CUDA tensors: the bounce's draws (D1), the intersection,
    with do_nee NEE's draws (D1), its sample and shadow-ray set-up (N1a),
    the shadow rays' intersection and its contribution (N1b), then the
    shading (S1). On CPU tensors the same calls run the plain versions
    (render/nee.py::nee_sample_plain and nee_contrib_plain for N1,
    ops/bsdf.py::shade_plain for S1).

    Returns (o, d, thr, rad, live_hit, prev_nee, segments this bounce: the
    live rays, and the shadow rays shot); prev_nee is None unless do_nee."""
    ball, u_choice, u_vol = _bounce_draws(scene, rng_key, uids, rnglib.SITE_BOUNCE0 + depth)
    # dead rays get an empty [t_min, 0] window: every test rejects
    t_max = torch.where(
        alive,
        torch.full_like(alive, max_trace_dist, dtype=torch.float32),
        torch.zeros_like(alive, dtype=torch.float32),
    )
    hit = intersect(scene, o, d, PATH_T_MIN, t_max, u_vol)
    segs = alive.sum()

    # miss, emission and scatter, then the path's update (tracing.rs:306-322):
    # NEE's sample first (its inputs come from no scatter), then one launch of
    # the shading kernel S1 for CUDA tensors, the plain version for CPU tensors
    with profiling.span("render.shade"):
        sample = None
        if do_nee:
            contrib, did, shadow = nee.direct_light(
                scene, hit, d, u_choice, alive, uids, rng_key, depth, PATH_T_MIN,
                max_trace_dist, intersect=intersect,
            )
            sample = (contrib, did)
            segs = segs + shadow
        o, d, thr, rad, live_hit, prev_nee = shade.shade_update(
            hit, o, d, thr, rad, alive, ball, u_choice, prev_nee=prev_nee, nee=sample)
    return o, d, thr, rad, live_hit, prev_nee, segs


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

    stats: when a dict, receives per-chain int64 counts of the dense- and
    big-mesh walks' tests summed over the bounces (intersect_scene_plain's
    stats) and "segs", the per-chain segment counts.
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
        o, d, thr, rad, alive, _, segs = bounce_update(
            scene, o, d, thr, rad, alive, uids, rng_key, depth, max_trace_dist,
            intersect=intersect,
        )
        segments = segments + segs
    return rad, segments


def _compact(alive: torch.Tensor, pos: torch.Tensor, rad: torch.Tensor, out: torch.Tensor):
    """Retire the dead rows: a stable partition puts them last, their
    radiance goes to `out` at their caller positions, and the live rows'
    indices come back (with the live count, the one host read)."""
    perm = torch.argsort((~alive).to(torch.int32), stable=True)
    with profiling.span("render.live_count"):
        n_alive = int(alive.sum())  # the one host sync of the bounce
    gone = perm[n_alive:]
    out[pos[gone]] = rad[gone]
    return perm[:n_alive], n_alive


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
    *,
    nee: bool = False,
    intersect=intersect_scene,
):
    """path_trace one bounce at a time, the wavefront compacted to its live
    rays after every bounce; with nee, the next-event estimator
    (render/nee.py) under the same compaction, one executor for what the
    JAX package splits in two (path_trace_nee and path_trace_nee_shrink).

    After a bounce a stable partition puts the dead rays last, the live
    count is read on the host (one sync per bounce), the dead rows retire
    their radiance into the output at their caller position, and the next
    bounce, its shadow rays included, runs on exactly the live rows; NEE's
    suppression flags ride the compaction with the rest of the state. The
    RNG follows each ray's uid, so the radiance is the same, bit for bit,
    in whatever order the rays come (without NEE, path_trace's with the
    same intersection).

    intersect: intersect_scene (K2 and K3 for CUDA tensors, the plain
    version for CPU tensors) or intersect_scene_plain (the plain version
    on any device).

    Returns (radiance (N, 3) float32 in the caller's order, segments: an
    int64 scalar tensor counting the path segments and the shadow rays
    shot).
    """
    if nee and not scene.nee_ok:
        raise ValueError("NEE needs every emissive object to be a standalone Triangle or "
                         "Sphere, and at least one (the scene compiled with nee_ok False)")
    n = o.shape[0]
    dev = o.device
    thr = torch.ones((n, 3), dtype=torch.float32, device=dev)
    rad = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    alive = torch.ones((n,), dtype=torch.bool, device=dev)
    prev_nee = None
    pos = torch.arange(n, device=dev)
    out = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    segments = torch.zeros((), dtype=torch.int64, device=dev)
    for depth in range(path_depth):
        with profiling.span("render.bounce"):
            o, d, thr, rad, alive, prev_nee, segs = bounce_update(
                scene, o, d, thr, rad, alive, uids, rng_key, depth, max_trace_dist,
                intersect=intersect, prev_nee=prev_nee, do_nee=nee and depth < path_depth - 1,
            )
            segments = segments + segs
            if depth == path_depth - 1:
                break
            keep, n_alive = _compact(alive, pos, rad, out)
            o, d, thr, rad, uids = o[keep], d[keep], thr[keep], rad[keep], uids[keep]
            pos, alive = pos[keep], alive[keep]
            if prev_nee is not None:
                prev_nee = prev_nee[keep]
            if n_alive == 0:
                break
    out[pos] = rad
    return out, segments


def phong_trace(
    scene: SceneData,
    o: torch.Tensor,
    d: torch.Tensor,
    uids: torch.Tensor,
    rng_key,
    eyepoint,
    max_trace_dist: float,
    intersect=intersect_scene,
):
    """Phong shading with hard shadows (tracing.rs:277-297; integrator.py:894
    in the JAX package): ambient + diffuse·albedo + 0.4·(r·v)^40 under one
    point light, the shadow ray offset 0.01·n along the normal, 0.3 where
    it is occluded. The "albedo" is the attenuation the material's scatter
    returns, stochastic for a parameterized material, as the reference's
    call (tracing.rs:294). Both rays start at t_min 0; the shadow ray's
    volume draws come from site SITE_BOUNCE0 + 1.

    The occlusion test keeps the reference's rebinding (it shadows `hit` in
    the inner match): the shadow hit counts as far enough when its t² is
    beyond |light − shadow hit point|², the light's distance from the
    shadow hit, not from the shaded point. Camera rays that miss get an
    empty shadow window; their colour is the background either way.

    Returns (N, 3) float32 colours."""
    ball, u_choice, u_vol = _bounce_draws(scene, rng_key, uids, rnglib.SITE_BOUNCE0)
    hit = intersect(scene, o, d, 0.0, max_trace_dist, u_vol)

    light = scene.point_light_pos
    to_light = vm.normalize(light - hit.point, eps=1e-30)
    to_camera = vm.normalize(vm.as_f32(eyepoint, o) - hit.point, eps=1e-30)
    n = hit.normal
    reflected = -to_light + 2.0 * vm.vdot(to_light, n) * n
    diffuse_w = torch.clamp(vm.dot(n, to_light), 0.0, 1.0)
    specular_w = torch.clamp(vm.dot(to_camera, reflected), 0.0, 1.0) ** 40.0

    valid = hit.valid
    shadow_o = torch.where(valid[:, None], hit.point + PHONG_SHADOW_OFFSET * n, 0.0)
    shadow_d = torch.where(valid[:, None], to_light, 1.0)
    light_dist = torch.where(valid, vm.magnitude(light - hit.point), 0.0)
    _, _, u_vol2 = _bounce_draws(scene, rng_key, uids, rnglib.SITE_BOUNCE0 + 1)
    sh = intersect(scene, shadow_o, shadow_d, 0.0, light_dist, u_vol2.contiguous())
    far_enough = sh.t * sh.t > vm.magnitude2(light - sh.point)
    shadow_w = torch.where(~sh.valid | far_enough, 1.0, 0.3)

    _, att, _ = bsdf.scatter(hit, d, ball, u_choice)
    color = shadow_w[:, None] * (
        scene.ambient + diffuse_w[:, None] * att + specular_w[:, None] * 0.4
    )
    return torch.where(valid[:, None], color, bsdf.background_color(d))
