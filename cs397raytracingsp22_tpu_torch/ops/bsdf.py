"""Branchless masked BSDF switch — the wavefront scatter stage.

Mirrors `cs397raytracingsp22_tpu/ops/bsdf.py` in plain torch; the CUDA
mega-bounce kernel (csrc/bounce.cu) evaluates the same five branches
per ray. `shade_plain` is the whole of a bounce's shading around the
scatter (the miss and emission terms, the dot term, NEE's term, the path's
update): the plain version of the shading kernel S1 (csrc/shade.cu), which
evaluates each ray's own branch alone, bit for bit.

The reference dispatches `hit.material.scatter(&hit, &ray)` through an
`Arc<dyn Material>` vtable per ray (materials.rs:12-15). Here all five
material models are evaluated on the whole batch and blended by the
material-type mask.

Faithfully replicated estimator conventions (SURVEY.md §3.3/§3.5):
- Lambertian: UNNORMALIZED uniform half-ball scatter direction (its length
  feeds the integrator's dot_term), brdf = albedo/π, pdf = 1/(2π)
  (materials.rs:33-48).
- Metal: reflect + roughness·ball perturbation, attenuation = albedo,
  pdf = 1, no cosine compensation (materials.rs:56-71).
- Dielectric: Schlick fresnel of the FULL ior (materials.rs:82), critical
  angle check on eta·sin, stochastic reflect/refract, attenuation = 1
  (materials.rs:77-104).
- ParameterizedMaterial: k_s = fresnel(1.5)·(1−roughness), k_d =
  (1−k_s)·(1−metallic); stochastic branch WITHOUT dividing by the branch
  probability — the reference's biased estimator, replicated exactly
  because it changes image brightness (materials.rs:113-149).
- Isotropic: uniform ball direction, attenuation = albedo, pdf = 1
  (materials.rs:158-166).

One ball-vector draw and one branch-choice uniform per ray serve every
material path: each ray evaluates exactly one material, so sharing draws
across the masked branches leaves all per-material distributions intact.
"""

from __future__ import annotations

import torch

from cs397raytracingsp22_tpu_torch.models import materials as mat
from cs397raytracingsp22_tpu_torch.ops.intersect import HitRecord
from cs397raytracingsp22_tpu_torch.utils import sampling
from cs397raytracingsp22_tpu_torch.utils import vecmath as vm

PI = 3.14159265358979


def scatter(
    hit: HitRecord,
    d_in: torch.Tensor,
    ball: torch.Tensor,
    u_choice: torch.Tensor,
):
    """Sample the scattered ray for a batch of hits.

    Args:
      hit: resolved HitRecord (N rays).
      d_in: (N, 3) incoming ray directions (unnormalized allowed).
      ball: (N, 3) uniform unit-ball vectors (the bounce's shared draw).
      u_choice: (N,) uniforms for the stochastic branch choices.

    Returns:
      (new_dir, attenuation, inv_pdf): (N,3), (N,3), (N,).
      inv_pdf is the RECIPROCAL pdf (2π for half-ball lobes, 1 for
      deterministic lobes) so the integrator applies it as a multiply —
      see sampling.hemisphere_inv_pdf. New-ray origins are always
      hit.point (materials.rs:37,61,93 etc.).
    """
    n = hit.normal
    albedo = hit.albedo

    # --- Lambertian (materials.rs:33-48) ---
    hemi = sampling.hemisphere_vec(ball, n)
    lam_dir = hemi
    lam_att = albedo / PI
    lam_ipdf = torch.full_like(u_choice, sampling.hemisphere_inv_pdf())

    # --- Metal (materials.rs:56-71) ---
    refl = vm.reflect(d_in, n)
    met_dir = refl + hit.roughness[:, None] * ball
    met_att = albedo
    met_ipdf = torch.ones_like(lam_ipdf)

    # --- Dielectric (materials.rs:77-104) ---
    ior = hit.ior
    eta = torch.where(hit.frontface, 1.0 / ior, ior)
    cos_in = torch.clamp(vm.dot(-d_in, n), max=1.0)
    critical = eta * torch.sqrt(torch.clamp(1.0 - cos_in * cos_in, min=0.0)) > 1.0
    fres = vm.fresnel(d_in, n, ior)  # full-ior quirk (materials.rs:82)
    will_refract = (~critical) & (u_choice >= fres)
    refr = vm.refract(d_in, n, eta)
    die_dir = torch.where(will_refract[:, None], refr, refl)
    die_att = torch.ones_like(albedo)
    die_ipdf = torch.ones_like(lam_ipdf)

    # --- ParameterizedMaterial (materials.rs:113-149) ---
    fres15 = vm.fresnel(d_in, n, 1.5)
    k_s = fres15 * (1.0 - hit.roughness)
    k_d = (1.0 - k_s) * (1.0 - hit.metallic)
    diffuse = u_choice < k_d
    par_dir = torch.where(diffuse[:, None], hemi, met_dir)
    par_att = torch.where(
        diffuse[:, None],
        albedo / PI,
        vm.lerpvec(torch.ones_like(albedo), albedo, hit.metallic[:, None]),
    )
    par_ipdf = torch.where(diffuse, lam_ipdf, met_ipdf)

    # --- Isotropic (materials.rs:158-166) ---
    iso_dir = ball
    iso_att = albedo
    iso_ipdf = torch.ones_like(lam_ipdf)

    mtype = hit.mtype

    def pick(lam, met, die, par, iso):
        expand = lam.ndim == 2
        def m(code):
            return (mtype == code)[:, None] if expand else (mtype == code)
        out = torch.where(m(mat.METAL), met, lam)
        out = torch.where(m(mat.DIELECTRIC), die, out)
        out = torch.where(m(mat.PARAMETERIZED), par, out)
        out = torch.where(m(mat.ISOTROPIC), iso, out)
        return out

    new_dir = pick(lam_dir, met_dir, die_dir, par_dir, iso_dir)
    att = pick(lam_att, met_att, die_att, par_att, iso_att)
    inv_pdf = pick(lam_ipdf, met_ipdf, die_ipdf, par_ipdf, iso_ipdf)
    return new_dir, att, inv_pdf


def background_color(d: torch.Tensor) -> torch.Tensor:
    """Black void (tracing.rs:266-274)."""
    return torch.zeros(d.shape[:-1] + (3,), dtype=torch.float32, device=d.device)


def shade_plain(hit: HitRecord, o, d, thr, rad, alive, ball, u_choice, prev_nee=None, nee=None):
    """One bounce's shading after the intersection (tracing.rs:306-322), in
    plain torch: the plain version of the shading kernel S1
    (ops/kernels/shade.py::shade_update, which runs it for CPU tensors).

    Misses add background·throughput, then die; live hits add their
    emission (not where prev_nee flags a previous NEE sample that covered
    it), scatter, and carry throughput·dot·brdf/pdf on from the hit point.
    nee: None, or (contrib (N, 3), did (N,) bool), the bounce's NEE sample
    (render/nee.py::direct_light): its term is added with the throughput
    from before the update, and the flags live_hit & did come back for the
    next vertex. The adds to the radiance come in this order: miss,
    emission, NEE.

    Returns (o, d, thr, rad, live_hit, prev_nee): prev_nee None unless nee
    is given."""
    live_hit = alive & hit.valid
    live_miss = alive ^ live_hit  # alive & ~valid
    rad = rad + torch.where(live_miss[:, None], thr * background_color(d), 0.0)
    emit = live_hit if prev_nee is None else live_hit & ~prev_nee
    rad = rad + torch.where(emit[:, None], thr * hit.emission, 0.0)
    new_dir, att, inv_pdf = scatter(hit, d, ball, u_choice)
    # dot term |new_dir·n| clamped to [0, 1]; 1 for zero-normal volume
    # hits (tracing.rs:313)
    has_normal = vm.magnitude2(hit.normal) > 0.0
    dot_term = torch.where(
        has_normal,
        torch.clamp(torch.abs(vm.dot(new_dir, hit.normal)), 0.0, 1.0),
        torch.ones_like(inv_pdf),
    )
    factor = (dot_term * inv_pdf)[:, None] * att

    prev_out = None
    if nee is not None:
        contrib, did = nee
        rad = rad + torch.where(live_hit[:, None], thr * contrib, 0.0)
        prev_out = live_hit & did

    thr = torch.where(live_hit[:, None], thr * factor, thr)
    o = torch.where(live_hit[:, None], hit.point, o)
    d = torch.where(live_hit[:, None], new_dir, d)
    return o, d, thr, rad, live_hit, prev_out
