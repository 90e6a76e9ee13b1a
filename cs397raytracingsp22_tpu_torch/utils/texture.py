"""Texture loading and the packed texture atlas.

Mirrors `cs397raytracingsp22_tpu/utils/texture.py`: every texture of a
scene is packed into one flat (total_pixels, 3) uint8 buffer with
per-texture (offset, width, height) tables, so a batch of hits samples
any binding with one gather (ops/intersect.py::sample_texture). Sampling
replicates texture.rs:26-32:

    x = min(u32(clamp(u, 0, 0.999) * w), w - 1)
    y = min(u32((1 - clamp(v, 0, 0.999)) * h), h - 1)
    rgb = pixel / 255
"""

from __future__ import annotations

import dataclasses
import hashlib

import numpy as np


def load_image(path: str) -> np.ndarray | None:
    """Load an image file to (H, W, 3) uint8, or None on failure — the
    reference's graceful None on unreadable files (texture.rs:16-25)."""
    try:
        from PIL import Image

        with Image.open(path) as im:
            return np.asarray(im.convert("RGB"), dtype=np.uint8)
    except Exception:
        return None


@dataclasses.dataclass
class TextureAtlas:
    """Packed scene textures: row-major pixels concatenated per texture."""

    pixels: np.ndarray  # (P, 3) uint8
    offset: np.ndarray  # (T,) int32 first index into pixels
    width: np.ndarray  # (T,) int32
    height: np.ndarray  # (T,) int32


class TextureAtlasBuilder:
    """Collects a scene's images; the same content (hashed with its height)
    packs once, whichever array holds it."""

    def __init__(self):
        self._images: list[np.ndarray] = []
        self._index: dict[bytes, int] = {}  # content hash → texture id
        self._id_cache: dict[int, int] = {}  # id(array) → texture id

    def add(self, img: np.ndarray) -> int:
        """Register an (H, W, 3) uint8 image, returning its texture id."""
        fast = id(img)
        if fast in self._id_cache:
            return self._id_cache[fast]
        key = hashlib.sha1(
            img.shape[0].to_bytes(4, "little") + np.ascontiguousarray(img).tobytes()
        ).digest()
        tid = self._index.get(key)
        if tid is None:
            tid = len(self._images)
            self._images.append(img)
            self._index[key] = tid
        self._id_cache[fast] = tid
        return tid

    def build(self) -> TextureAtlas:
        if not self._images:
            # a 1-pixel placeholder: the compiled tables are never empty
            self._images.append(np.zeros((1, 1, 3), np.uint8))
        offsets, ws, hs, flats = [], [], [], []
        cursor = 0
        for img in self._images:
            h, w, _ = img.shape
            offsets.append(cursor)
            ws.append(w)
            hs.append(h)
            flats.append(img.reshape(-1, 3))
            cursor += h * w
        return TextureAtlas(
            pixels=np.concatenate(flats, axis=0),
            offset=np.asarray(offsets, np.int32),
            width=np.asarray(ws, np.int32),
            height=np.asarray(hs, np.int32),
        )
