"""Branchless masked BSDF switch — the wavefront scatter stage.

Mirrors `cs397raytracingsp22_tpu/ops/bsdf.py` in plain torch; the CUDA
mega-bounce kernel (csrc/bounce.cu) evaluates the same five branches
per ray.

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
