"""Vector math on batched (..., 3) float32 tensors.

Mirrors `cs397raytracingsp22_tpu/utils/vecmath.py` (the reference's
tracing.rs:54-97 helpers). Three-term sums are written out component by
component so their float order is fixed and matches the CUDA kernel.
"""

from __future__ import annotations

import torch


def as_f32(x, like: torch.Tensor) -> torch.Tensor:
    """x (a scalar or tensor) as float32 on like's device."""
    return torch.as_tensor(x, dtype=torch.float32, device=like.device)


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Dot product over the trailing axis, (...)."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def vdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Dot product keeping the trailing axis, (..., 1)."""
    return dot(a, b)[..., None]


def magnitude2(v: torch.Tensor) -> torch.Tensor:
    return dot(v, v)


def magnitude(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(magnitude2(v))


def normalize(v: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    """v / sqrt(|v|² + eps); eps=0 matches cgmath's normalize (inf/NaN on
    zero vectors)."""
    return v / torch.sqrt(magnitude2(v) + eps)[..., None]


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack(
        [a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], dim=-1
    )


def reflect(v: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Reflect v about n (tracing.rs:54-56); preserves |v|."""
    return v - 2.0 * vdot(v, n) * n


def pow5(x: torch.Tensor) -> torch.Tensor:
    """x⁵ as x·((x·x)·(x·x)), the multiply order of jax's integer_pow."""
    x2 = x * x
    return x * (x2 * x2)


def fresnel(v: torch.Tensor, n: torch.Tensor, ir) -> torch.Tensor:
    """Schlick fresnel (tracing.rs:58-62) of the FULL index of
    refraction, the reference's quirk (materials.rs:82)."""
    ir = as_f32(ir, v)
    r0 = (ir - 1.0) / (ir + 1.0)
    r0 = r0 * r0
    return r0 + (1.0 - r0) * pow5(1.0 - torch.abs(dot(v, n)))


def refract(v: torch.Tensor, n: torch.Tensor, eta) -> torch.Tensor:
    """Refraction per Ray Tracing in One Weekend (tracing.rs:64-69); the
    abs() under the sqrt matches the reference, total internal reflection
    is the caller's job."""
    eta = as_f32(eta, v)
    if eta.ndim == v.ndim - 1:
        eta = eta[..., None]
    cos_theta = torch.clamp(dot(-v, n), max=1.0)[..., None]
    r_out_perp = eta * (v + cos_theta * n)
    r_out_parallel = -torch.sqrt(torch.abs(1.0 - magnitude2(r_out_perp)))[..., None] * n
    return r_out_perp + r_out_parallel


def clampvec(v: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    return torch.clamp(v, lo, hi)


def lerpvec(a: torch.Tensor, b: torch.Tensor, k) -> torch.Tensor:
    """(1-k)·a + k·b (tracing.rs:95-97); k broadcasts."""
    k = as_f32(k, a)
    if k.ndim == a.ndim - 1:
        k = k[..., None]
    return (1.0 - k) * a + k * b


def apply_mat3(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(3,3) matrix times (..., 3) vectors, m @ v, as explicit multiply-adds."""
    return m[:, 0] * v[..., 0:1] + m[:, 1] * v[..., 1:2] + m[:, 2] * v[..., 2:3]


def apply_mat4_point(m: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """(4,4) homogeneous transform of (..., 3) points (w=1)."""
    return (
        m[:3, 0] * p[..., 0:1]
        + m[:3, 1] * p[..., 1:2]
        + m[:3, 2] * p[..., 2:3]
        + m[:3, 3]
    )


def apply_mat4_vector(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(4,4) (or (3,3)) transform of (..., 3) direction vectors (w=0)."""
    return m[:3, 0] * v[..., 0:1] + m[:3, 1] * v[..., 1:2] + m[:3, 2] * v[..., 2:3]


def signum(x: torch.Tensor) -> torch.Tensor:
    """Rust f32::signum: +1 for x >= +0.0, -1 for x < 0 (torch.sign would
    give 0 at 0 and break the plane flip of geometry.rs:478)."""
    one = torch.ones((), dtype=x.dtype, device=x.device)
    return torch.where(x >= 0.0, one, -one)
