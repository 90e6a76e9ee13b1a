"""Texture image loading for StaticMesh texture slots.

Meshes accept the five texture slots of the reference (texture.rs:12-33),
but this slice of the port renders no textured scene: `Scene.compile`
refuses a mesh with any texture bound (the staged path comes later).
"""

from __future__ import annotations

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
