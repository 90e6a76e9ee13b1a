"""Next-event estimation (NEE): explicit direct-light sampling, in torch.

Mirrors `cs397raytracingsp22_tpu/render/nee.py`. An opt-in estimator
beyond the reference's (whose path tracer finds lights only by chance):
with `Camera(nee=True)` or `--nee`, each diffuse-like path vertex also
samples one point on one light (uniform over the scene's emissive
Triangles and Spheres, uniform over the chosen light's area) and adds

    thr · f · cosθ_x · V(x,y) · E · cosθ_y / (|x−y|² · p_area / n_lights)

with f the BRDF the reference's estimator converges to (Lambertian and
the diffuse lobe of a parameterized material: albedo/π with cosθ_x;
Isotropic: albedo/4π with cosθ_x = 1, the zero-normal volume convention),
V a shadow ray through the full scene intersection (a volume hit inside
its window is occlusion, so V is a stochastic transmittance), and
two-sided lights (the reference adds emission on any face, so cosθ_y =
|n_y·ω|).

A vertex that did NEE suppresses the emission its scatter ray finds next:
whatever that ray hits first is straight-line visible, so NEE's
expectation covers it. That is right only when the sampled lights are
every emitter, so the compile sets `nee_ok` False otherwise and the driver
refuses NEE there.

A parameterized material keeps the reference's branch bias (no division by
the pick probability): NEE fires exactly when the shared branch uniform
picked the diffuse lobe.

The integrator applies NEE at every vertex but the last bounce's: a
depth-k path's NEE term equals emission at a (k+1)-th vertex, so skipping
the last keeps the expectation of the depth-limited plain path trace.

On CUDA tensors `direct_light` is three launches and the shadow rays:
NEE's draws (D1, `nee_draws`), the sample and the shadow ray's set-up
(N1a, ops/kernels/nee.py::nee_sample), and after the shadow rays the
contribution (N1b, `nee_contrib`). On CPU tensors the same calls run the
plain versions, threefry.counter_uniforms, `nee_sample_plain` and
`nee_contrib_plain`, which N1 is held to on the card bit for bit.

The shadow rays go through the `intersect` the caller passes: the
scene-intersection kernel K2 (and K3 per big mesh) for CUDA tensors
through ops/intersect.py::intersect_scene, the plain version otherwise.
"""

from __future__ import annotations

import torch

from cs397raytracingsp22_tpu_torch.models import materials as mat
from cs397raytracingsp22_tpu_torch.models.scene import SceneData
from cs397raytracingsp22_tpu_torch.ops.intersect import HitRecord, intersect_scene
from cs397raytracingsp22_tpu_torch.ops.kernels import draws
from cs397raytracingsp22_tpu_torch.ops.kernels import nee as n1
from cs397raytracingsp22_tpu_torch.utils import profiling
from cs397raytracingsp22_tpu_torch.utils import vecmath as vm
from cs397raytracingsp22_tpu_torch.utils.rng import SITE_NEE0

PI = 3.14159265358979
FOUR_PI = 4.0 * PI
# the shadow window ends at this fraction of the light's own ray parameter
# t_light, so the sampled light never occludes its own sample; the 1e-3 gap
# mirrors the reference's 0.001 acne epsilon on the near side
SHADOW_T_MAX = 1.0 - 1e-3


def _diffuse_mask(hit: HitRecord, d_in: torch.Tensor, u_choice: torch.Tensor,
                  has_normal: torch.Tensor):
    """Where NEE applies, and the BRDF value there.

    - Lambertian at a surface vertex (nonzero normal): f = albedo/π, times
      the shadow ray's ball length by the caller. The reference's scatter
      direction is an unnormalized uniform-ball vector whose length feeds
      the dot term (tracing.rs:72, :313), and E|v| over the unit ball is
      3/4, so its converged diffuse transport is (3/4)·albedo/π·cosθ; NEE
      weights each sample by its own sampled length r (mean 3/4), which
      keeps the correlation of r with the t-unit transmittance and reach.
    - Isotropic at a zero-normal vertex (a volume): f = albedo/4π, no
      ball length (the plain estimator forces the dot term to 1).
    - Parameterized at a surface vertex, exactly when the shared branch
      uniform picked the diffuse lobe (as ops/bsdf.py decides it:
      u_choice < k_d, k_s = fresnel(d_in, n, 1.5)·(1 − roughness), k_d =
      (1 − k_s)·(1 − metallic)): f = albedo/π with the ball length.
    - Metal and Dielectric: never (delta lobes keep emission on hit).
    - Isotropic on a surface, and Lambertian or Parameterized at a
      zero-normal vertex: never; their plain transport matches neither
      convention, so they keep by-chance transport.

    Returns (applies, f, ball_weighted)."""
    mtype = hit.mtype
    lam = (mtype == mat.LAMBERTIAN) & has_normal
    iso = (mtype == mat.ISOTROPIC) & ~has_normal
    par = (mtype == mat.PARAMETERIZED) & has_normal
    k_s = vm.fresnel(d_in, hit.normal, 1.5) * (1.0 - hit.roughness)
    k_d = (1.0 - k_s) * (1.0 - hit.metallic)
    applies = lam | iso | (par & (u_choice < k_d))
    f = torch.where(iso[:, None], hit.albedo / FOUR_PI, hit.albedo / PI)
    return applies, f, ~iso


def sample_light_point(scene: SceneData, u_pick, u1, u2):
    """One uniformly chosen light and a uniform point on its area.

    Returns (x, n_l, emission, inv_pdf), inv_pdf = n_lights · area for a
    triangle, n_lights · 4πr² for a sphere: the reciprocal of the joint
    pick and area density."""
    n_t, n_s = scene.n_lt_tri, scene.n_lt_sph
    n_l = n_t + n_s
    if n_l == 0:
        raise ValueError("sample_light_point on a scene with no NEE lights")
    pick = torch.clamp((u_pick * n_l).to(torch.int32), max=n_l - 1)
    x = torch.zeros(u1.shape + (3,), dtype=torch.float32, device=u1.device)
    nrm = torch.zeros_like(x)
    emi = torch.zeros_like(x)
    inv_pdf = torch.zeros_like(u1)

    if n_t:
        row = scene.lt_tri[torch.clamp(pick, 0, n_t - 1).long()]  # (N, 13)
        a, e1, e2 = row[:, 0:3], row[:, 3:6], row[:, 6:9]
        # uniform over the triangle: a + su(1 − u2)·e1 + su·u2·e2
        su = torch.sqrt(torch.clamp(u1, min=0.0))
        xt = a + (su * (1.0 - u2))[:, None] * e1 + (su * u2)[:, None] * e2
        is_t = pick < n_t
        x = torch.where(is_t[:, None], xt, x)
        nrm = torch.where(is_t[:, None], vm.normalize(vm.cross(e1, e2), eps=1e-30), nrm)
        emi = torch.where(is_t[:, None], row[:, 9:12], emi)
        inv_pdf = torch.where(is_t, n_l * row[:, 12], inv_pdf)

    if n_s:
        row = scene.lt_sph[torch.clamp(pick - n_t, 0, n_s - 1).long()]  # (N, 7)
        c, r = row[:, 0:3], row[:, 3]
        z = 1.0 - 2.0 * u1
        rr = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
        phi = 2.0 * PI * u2
        w = torch.stack([rr * torch.cos(phi), rr * torch.sin(phi), z], dim=-1)
        is_s = pick >= n_t
        x = torch.where(is_s[:, None], c + r[:, None] * w, x)
        nrm = torch.where(is_s[:, None], w, nrm)
        emi = torch.where(is_s[:, None], row[:, 4:7], emi)
        inv_pdf = torch.where(is_s, n_l * FOUR_PI * r * r, inv_pdf)

    return x, nrm, emi, inv_pdf


def nee_draws(scene: SceneData, rng_key, uids: torch.Tensor, depth: int) -> torch.Tensor:
    """One bounce's NEE draws, (N, 4 + V + G) at site SITE_NEE0 + depth:
    light pick, two area uniforms, the shadow ray's ball length, and one
    free-flight uniform per volume-table row and per general volume: one
    launch of the draws kernel for CUDA tensors, threefry.counter_uniforms
    for CPU tensors (ops/kernels/draws.py::counter_uniforms). Profiler
    traces show them as the span "nee_rng"."""
    with profiling.span("nee_rng"):
        return draws.counter_uniforms(rng_key, uids, SITE_NEE0 + depth,
                                      4 + scene.vol_center.shape[0] + scene.n_gvols)


def direct_light(scene: SceneData, hit: HitRecord, d_in: torch.Tensor, u_choice: torch.Tensor,
                 live: torch.Tensor, uids: torch.Tensor, rng_key, depth: int, t_min: float,
                 max_trace_dist: float, intersect=intersect_scene):
    """One NEE sample at each live diffuse-like vertex: live (N,) bool, the
    rays that may sample (alive; a vertex samples only where hit.valid too).

    Returns (contribution (N, 3), not yet times the throughput; did (N,)
    bool, the NEE attempt, for the caller's suppression of the next
    vertex's emission; the int64 count of shadow rays shot).

    The shadow ray matches the plain estimator's ray lengths: its
    direction is the unit direction times a sampled ball length r =
    u^(1/3), the length distribution of the diffuse scatter directions.
    So what the reference measures in ray-parameter units agrees with the
    plain estimator's scatter ray toward the light: the volume free-flight
    (transmittance exp(−ρ·span/|v|)) and the max_trace_dist reach (a light
    at distance L is reachable iff L ≤ max_trace_dist·|v|). Its window is
    [t_min, SHADOW_T_MAX·t_light) per ray; rays that do not shoot get an
    empty window, so every test rejects them.

    `did` stays True when the sample is occluded or out of reach: both are
    part of the estimator whose expectation covers the emission, and
    suppressing only on success would count the plain emission again on
    every failed sample.

    For CUDA tensors the sample and the shadow ray's set-up are one launch
    of N1a and the contribution one launch of N1b (ops/kernels/nee.py,
    csrc/nee.cu), around the shadow rays' `intersect`; for CPU tensors
    nee_sample_plain and nee_contrib_plain run. Profiler traces show the
    call as the span "render.nee"."""
    with profiling.span("render.nee"):
        u = nee_draws(scene, rng_key, uids, depth)
        did, shoot, sh_o, sh_dir, t_max, pending = n1.nee_sample(
            scene, hit, d_in, u_choice, live, u, max_trace_dist)
        # the volume draws are a strided view; the kernels take them packed
        sh = intersect(scene, sh_o, sh_dir, t_min, t_max, u[:, 4:].contiguous())
        return n1.nee_contrib(sh.valid, pending), did, shoot.sum()


def nee_sample_plain(scene: SceneData, hit: HitRecord, d_in, u_choice, live, u,
                     max_trace_dist: float):
    """NEE's sample before the shadow ray, the plain version of N1a: the
    light point (sample_light_point on the draws u[:, 0:3]), the diffuse
    mask, the shadow ray and the geometry term (direct_light's docstring).

    Returns (did, shoot, sh_o, sh_dir, t_max, pending): did (N,) the NEE
    attempt (live, a hit, and diffuse-like); shoot (N,) did and the light
    within reach; the shadow ray's origin, direction and window end, the
    empty ray (0, 1, 0) where it does not shoot; pending (N, 3) the
    contribution before the visibility test, f · E · geo where it shoots,
    0 elsewhere."""
    x, n_l, emission, inv_pdf = sample_light_point(scene, u[:, 0], u[:, 1], u[:, 2])

    has_normal = vm.magnitude2(hit.normal) > 0.0
    applies, f, ball_weighted = _diffuse_mask(hit, d_in, u_choice, has_normal)
    did = live & hit.valid & applies

    to_l = x - hit.point
    dist2 = vm.dot(to_l, to_l)
    inv_dist = torch.rsqrt(torch.clamp(dist2, min=1e-12))
    dist = dist2 * inv_dist
    wl = to_l * inv_dist[:, None]

    # cosθ at the vertex, clipped to [0, 1] like the estimator's dot term
    # (tracing.rs:313), 1 at a zero-normal volume vertex; two-sided lights
    cos_x = torch.where(has_normal, torch.clamp(vm.dot(wl, hit.normal), 0.0, 1.0),
                        torch.ones_like(dist))
    cos_y = torch.abs(vm.dot(wl, n_l))

    r_len = torch.clamp(u[:, 3] ** (1.0 / 3.0), min=1e-6)
    t_light = dist / r_len
    shoot = did & (t_light <= max_trace_dist)
    shoot3 = shoot[:, None]
    sh_o = torch.where(shoot3, hit.point, 0.0)
    sh_dir = torch.where(shoot3, wl * r_len[:, None], 1.0)
    t_max = torch.where(shoot, SHADOW_T_MAX * t_light, 0.0)

    geo = cos_x * cos_y / torch.clamp(dist2, min=1e-12) * inv_pdf
    geo = torch.where(ball_weighted, geo * r_len, geo)
    pending = torch.where(shoot3, f * emission * geo[:, None], 0.0)
    return did, shoot, sh_o, sh_dir, t_max, pending


def nee_contrib_plain(sh_valid, pending):
    """NEE's contribution after the shadow ray, the plain version of N1b:
    pending where the shadow ray hit nothing, else 0. pending is 0 where
    the ray did not shoot (nee_sample_plain), so the contribution is
    pending where the ray shot and the light is visible."""
    return torch.where(sh_valid[:, None], 0.0, pending)
