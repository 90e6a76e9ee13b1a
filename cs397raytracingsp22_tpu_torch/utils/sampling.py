"""Samplers that map counter-RNG uniforms to directions.

Mirrors `cs397raytracingsp22_tpu/utils/sampling.py`. The reference's
rejection samplers (tracing.rs:70-89) become exact analytic maps with the
same distributions; `sincos_2pi` and `cbrt_fast` are the same polynomials
and Newton steps the CUDA kernel evaluates, so the plain version and the
kernel agree to float rounding.
"""

from __future__ import annotations

import torch

from cs397raytracingsp22_tpu_torch.utils import vecmath as vm

TWO_PI = 6.283185307179586


def sincos_2pi(u: torch.Tensor):
    """(cos 2πu, sin 2πu) for u in [0, 1): quadrant reduction plus the
    Cephes f32 minimax polynomials."""
    y = u * 4.0
    k = torch.round(y)  # half to even, as jnp.round and rintf
    theta = (y - k) * 1.5707963267948966
    z = theta * theta
    s = theta * (
        1.0 + z * (-1.6666654611e-1 + z * (8.3321608736e-3 + z * -1.9515295891e-4))
    )
    c = (
        1.0
        - 0.5 * z
        + (z * z)
        * (
            4.166664568298827e-2
            + z * (-1.388731625493765e-3 + z * 2.443315711809948e-5)
        )
    )
    ki = k.to(torch.int32)
    swap = (ki & 1) == 1
    neg = (ki & 2) == 2
    cos_out = torch.where(swap, -s, c)
    sin_out = torch.where(swap, c, s)
    cos_out = torch.where(neg, -cos_out, cos_out)
    sin_out = torch.where(neg, -sin_out, sin_out)
    return cos_out, sin_out


def cbrt_fast(u: torch.Tensor) -> torch.Tensor:
    """x^(1/3) for x in (0, 1]: bit-hack inverse-cbrt seed and three
    division-free Newton steps z ← z·(4 − x·z³)/3, then r = x·z². Inputs
    are clamped to FLT_MIN (the seed's arithmetic needs normal floats)."""
    x = torch.clamp(u, min=1.1754944e-38)
    i = x.view(torch.int32)
    z = (0x54A21D2A - torch.div(i, 3, rounding_mode="floor")).to(torch.int32)
    z = z.view(torch.float32)
    third = 1.0 / 3.0
    for _ in range(3):
        z = z * (4.0 - x * z * z * z) * third
    return x * z * z


def ball_vec_from_uniform(u: torch.Tensor) -> torch.Tensor:
    """(..., 3) uniforms → uniform unit-ball vectors (unnormalized)."""
    z = 2.0 * u[..., 0] - 1.0
    cphi, sphi = sincos_2pi(u[..., 1])
    r = cbrt_fast(u[..., 2])
    s = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    return r[..., None] * torch.stack([s * cphi, s * sphi, z], dim=-1)


def disk_vec_from_uniform(u: torch.Tensor) -> torch.Tensor:
    """(..., 2) uniforms → uniform unit-disk vectors in the xy plane."""
    theta = TWO_PI * u[..., 0]
    r = torch.sqrt(u[..., 1])
    return torch.stack(
        [r * torch.cos(theta), r * torch.sin(theta), torch.zeros_like(r)], dim=-1
    )


def hemisphere_vec(ball: torch.Tensor, normal: torch.Tensor) -> torch.Tensor:
    """Fold a ball vector into the half-ball about `normal`
    (materials.rs:171-178 distribution); unnormalized, pdf 1/(2π)."""
    d = vm.vdot(ball, normal)
    return torch.where(d < 0.0, ball - 2.0 * d * normal, ball)


def hemisphere_pdf() -> float:
    return 1.0 / TWO_PI


def hemisphere_inv_pdf() -> float:
    """2π: the integrator multiplies by the reciprocal pdf."""
    return TWO_PI


def alpha_sample(u: torch.Tensor, normal: torch.Tensor, alpha: float = 1.0):
    """Cosine-power-lobe sample about `normal` (materials.rs:181-193; the
    reference defines but never uses it). Returns (direction, pdf)."""
    cos_theta = u[..., 0] ** (1.0 / (alpha + 1.0))
    sin_theta = torch.sqrt(torch.clamp(1.0 - cos_theta * cos_theta, min=0.0))
    phi = TWO_PI * u[..., 1]
    local = torch.stack(
        [torch.cos(phi) * sin_theta, torch.sin(phi) * sin_theta, cos_theta], dim=-1
    )
    z = torch.zeros_like(normal)
    z[..., 2] = 1.0
    k = torch.linalg.cross(z, normal, dim=-1)
    s = torch.sqrt(torch.sum(k * k, dim=-1, keepdim=True))
    c = torch.sum(z * normal, dim=-1, keepdim=True)
    k_unit = k / torch.clamp(s, min=1e-20)
    kv = torch.linalg.cross(k_unit, local, dim=-1)
    kdv = torch.sum(k_unit * local, dim=-1, keepdim=True)
    rotated = local * c + kv * s + k_unit * kdv * (1.0 - c)
    direction = torch.where(s > 1e-12, rotated, torch.where(c >= 0, local, -local))
    pdf = (alpha + 1.0) * cos_theta**alpha / TWO_PI
    return direction, pdf


def rtow_sample(ball: torch.Tensor, hitpoint: torch.Tensor, normal: torch.Tensor):
    """Ray Tracing in One Weekend-style sample (materials.rs:196-199; unused
    by the reference): returns (hitpoint + normal + ball, 1/(2π))."""
    return hitpoint + normal + ball, 1.0 / TWO_PI
