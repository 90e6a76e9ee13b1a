"""Post-processing: overbright channel bleed, gamma, quantize.

Mirrors `cs397raytracingsp22_tpu/ops/tonemap.py`, the reference's
per-pixel epilogue (tracing.rs:241-256):
1. "channel bleed": any channel's excess over 1.0 is added to the OTHER
   two channels, read from the pre-bleed color;
2. clamp to [0, 1], gamma-correct with pow(c, 1/gamma), scale by
   255.9999 and truncate to u8.
"""

from __future__ import annotations

import torch


def channel_bleed(color: torch.Tensor) -> torch.Tensor:
    """final[i] = color[i] + sum_{j != i} max(color[j] - 1, 0)."""
    excess = torch.clamp(color - 1.0, min=0.0)
    total = (excess[..., 0] + excess[..., 1] + excess[..., 2])[..., None]
    return color + (total - excess)


def tonemap(color: torch.Tensor, gamma: float) -> torch.Tensor:
    """(..., 3) linear radiance (already averaged) → (..., 3) uint8."""
    c = torch.clamp(channel_bleed(color), 0.0, 1.0)
    c = torch.pow(c, 1.0 / gamma) * 255.9999
    return c.to(torch.uint8)
