"""Counter-based Threefry-2x32-20 on torch tensors.

The same generator as `cs397raytracingsp22_tpu/utils/threefry.py`, bit
for bit: renders are a pure function of (seed, ray uid, draw site), so an
image does not depend on the chunking, the device or the backend. The
CUDA mega-bounce kernel (csrc/bounce.cu) and the draws kernels
(csrc/draws.cu, which the render paths launch for CUDA tensors) evaluate
the same function in native uint32; the functions here are their plain
versions.

torch has no uint32 add or shifts on the CPU, so every 32-bit word is
held in an int64 tensor and masked with 0xFFFFFFFF after each add and
shift. The largest intermediate is a word shifted left by 29 bits, which
stays below 2^63.
"""

from __future__ import annotations

import torch

MASK = 0xFFFFFFFF
_ROTATIONS = (13, 15, 26, 6, 17, 29, 16, 24)
_PARITY = 0x1BD11BDA


def _words(x, like=None):
    """An int, or an integer tensor read as uint32 words, as int64."""
    if isinstance(x, int):
        return x & MASK
    x = torch.as_tensor(x)
    if like is not None:
        x = x.to(like.device)
    return x.to(torch.int64) & MASK


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry2x32(k0, k1, c0, c1):
    """Threefry-2x32-20 block: key (k0, k1), counter (c0, c1) → 2 words.

    Arguments are ints or integer tensors (broadcastable) read as uint32;
    returns (x0, x1) as int64 tensors holding uint32 values.
    """
    c0 = _words(c0)
    c1 = _words(c1, like=c0 if torch.is_tensor(c0) else None)
    k0 = _words(k0)
    k1 = _words(k1)
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


def uniform_from_bits(bits):
    """uint32 words → float32 uniforms in [0, 1): top 24 bits · 2^-24."""
    return (bits >> 8).to(torch.float32) * (2.0**-24)


def key_words(seed: int) -> torch.Tensor:
    """Split an int seed into the (2,) key words [lo, hi] (int64, CPU)."""
    return torch.tensor(
        [seed & MASK, (seed >> 32) & MASK], dtype=torch.int64
    )


def key_pair(key) -> tuple[int, int]:
    """(k0, k1) as ints from an int seed or (2,) key words."""
    if isinstance(key, int):
        key = key_words(key)
    return int(key[0]) & MASK, int(key[1]) & MASK


def _site_base(site, like):
    s = _words(site, like=like)
    return (s << 16) & MASK


def bounce_uniforms(key, uids, site, m: int):
    """Bounce-site draws, (N, m) float32: draws 0-3 (ball xyz + branch
    choice) are the 16-bit halves [x0>>16, x0&0xFFFF, x1>>16, x1&0xFFFF]
    · 2^-16 of counter block 0; draws j ≥ 4 (volume free flight) are
    24-bit, two per block, from block 1 + (j-4)//2."""
    k0, k1 = key_pair(key)
    u = _words(uids)
    s = _site_base(site, u)
    x0, x1 = threefry2x32(k0, k1, u, s)
    cols = []
    for w in (x0, x1):
        cols.append((w >> 16).to(torch.float32) * (2.0**-16))
        cols.append((w & 0xFFFF).to(torch.float32) * (2.0**-16))
    for blk in range(1, 1 + (max(m - 4, 0) + 1) // 2):
        x0, x1 = threefry2x32(k0, k1, u, (s + blk) & MASK)
        cols.append(uniform_from_bits(x0))
        cols.append(uniform_from_bits(x1))
    return torch.stack(cols[:m], dim=-1)


def counter_uniforms(key, uids, site, m: int):
    """m uniforms per uid for a draw site, (N, m) float32 in [0, 1).
    Draw j comes from block j // 2 at counter (uid, site·2^16 + block)."""
    k0, k1 = key_pair(key)
    u = _words(uids)
    s = _site_base(site, u)
    cols = []
    for blk in range((m + 1) // 2):
        x0, x1 = threefry2x32(k0, k1, u, (s + blk) & MASK)
        cols.append(uniform_from_bits(x0))
        cols.append(uniform_from_bits(x1))
    return torch.stack(cols[:m], dim=-1)
