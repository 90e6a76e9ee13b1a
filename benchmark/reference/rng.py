"""The renderer's counter RNG and its samplers, in plain torch.

A frozen copy of the path tracer's published draw scheme: Threefry-2x32-20
keyed by the image seed, counters (ray uid, site << 16 + block), the
camera at site 0, bounce k at site 1 + k, next-event estimation at site
4096 + k. Every 32-bit word is held in int64 and masked after each add and
shift. The samplers turn uniforms into directions with the same
polynomials as the renderer, so the two agree to float rounding; `dtype`
is the float type the uniforms and directions are computed in (float32,
or a lower type for the control).
"""

from __future__ import annotations

import torch

MASK = 0xFFFFFFFF
_ROTATIONS = (13, 15, 26, 6, 17, 29, 16, 24)
_PARITY = 0x1BD11BDA
SITE_CAMERA = 0
SITE_BOUNCE0 = 1
SITE_NEE0 = 1 << 12
TWO_PI = 6.283185307179586


def key_pair(seed: int) -> tuple[int, int]:
    return seed & MASK, (seed >> 32) & MASK


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry2x32(k0: int, k1: int, c0: torch.Tensor, c1: torch.Tensor):
    """Threefry-2x32-20 of counters (c0, c1) (int64 tensors holding uint32
    words) under the key (k0, k1): two int64 tensors of uint32 words."""
    ks2 = k0 ^ k1 ^ _PARITY
    x0 = (c0 + k0) & MASK
    x1 = (c1 + k1) & MASK
    ks = (k1, ks2, k0)
    for group in range(5):
        for i in range(4):
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, _ROTATIONS[(group % 2) * 4 + i])
            x1 = x1 ^ x0
        x0 = (x0 + ks[group % 3]) & MASK
        x1 = (x1 + ks[(group + 1) % 3] + (group + 1)) & MASK
    return x0, x1


def _u24(bits, dtype):
    return ((bits >> 8).to(torch.float32) * (2.0 ** -24)).to(dtype)


def counter_uniforms(seed: int, uids: torch.Tensor, site: int, m: int, dtype=torch.float32):
    """(N, m) uniforms of a draw site: draw j from block j // 2."""
    k0, k1 = key_pair(seed)
    u = uids.to(torch.int64) & MASK
    s = (site << 16) & MASK
    cols = []
    for blk in range((m + 1) // 2):
        x0, x1 = threefry2x32(k0, k1, u, torch.full_like(u, (s + blk) & MASK))
        cols += [_u24(x0, dtype), _u24(x1, dtype)]
    return torch.stack(cols[:m], dim=-1)


def bounce_uniforms(seed: int, uids: torch.Tensor, site: int, m: int, dtype=torch.float32):
    """(N, m) bounce draws: 0-3 the 16-bit halves of block 0, draw j >= 4
    the 24-bit words of block 1 + (j - 4) // 2."""
    k0, k1 = key_pair(seed)
    u = uids.to(torch.int64) & MASK
    s = (site << 16) & MASK
    x0, x1 = threefry2x32(k0, k1, u, torch.full_like(u, s))
    cols = []
    for w in (x0, x1):
        cols.append(((w >> 16).to(torch.float32) * (2.0 ** -16)).to(dtype))
        cols.append(((w & 0xFFFF).to(torch.float32) * (2.0 ** -16)).to(dtype))
    for blk in range(1, 1 + (max(m - 4, 0) + 1) // 2):
        x0, x1 = threefry2x32(k0, k1, u, torch.full_like(u, (s + blk) & MASK))
        cols += [_u24(x0, dtype), _u24(x1, dtype)]
    return torch.stack(cols[:m], dim=-1)


def sincos_2pi(u: torch.Tensor):
    """(cos 2πu, sin 2πu): quadrant reduction and the Cephes polynomials."""
    y = u * 4.0
    k = torch.round(y)
    theta = (y - k) * 1.5707963267948966
    z = theta * theta
    s = theta * (1.0 + z * (-1.6666654611e-1 + z * (8.3321608736e-3 + z * -1.9515295891e-4)))
    c = (1.0 - 0.5 * z + (z * z) * (4.166664568298827e-2
                                     + z * (-1.388731625493765e-3 + z * 2.443315711809948e-5)))
    ki = k.to(torch.int32)
    swap = (ki & 1) == 1
    neg = (ki & 2) == 2
    cos_out = torch.where(swap, -s, c)
    sin_out = torch.where(swap, c, s)
    return torch.where(neg, -cos_out, cos_out), torch.where(neg, -sin_out, sin_out)


def cbrt(u: torch.Tensor) -> torch.Tensor:
    """u^(1/3) on (0, 1]: in float32 the renderer's bit-trick seed and
    three Newton steps; in another type the power in that type."""
    if u.dtype != torch.float32:
        return torch.pow(u, 1.0 / 3.0)
    x = torch.clamp(u, min=1.1754944e-38)
    z = (0x54A21D2A - torch.div(x.view(torch.int32), 3, rounding_mode="floor")).to(torch.int32)
    z = z.view(torch.float32)
    for _ in range(3):
        z = z * (4.0 - x * z * z * z) * (1.0 / 3.0)
    return x * z * z


def ball(u: torch.Tensor) -> torch.Tensor:
    """(N, 3) uniforms -> uniform unit-ball vectors."""
    z = 2.0 * u[:, 0] - 1.0
    cphi, sphi = sincos_2pi(u[:, 1])
    r = cbrt(u[:, 2])
    s = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    return r[:, None] * torch.stack([s * cphi, s * sphi, z], dim=-1)


def disk(u: torch.Tensor) -> torch.Tensor:
    """(N, 2) uniforms -> uniform unit-disk vectors in the xy plane."""
    theta = TWO_PI * u[:, 0]
    r = torch.sqrt(u[:, 1])
    return torch.stack([r * torch.cos(theta), r * torch.sin(theta), torch.zeros_like(r)], dim=-1)
