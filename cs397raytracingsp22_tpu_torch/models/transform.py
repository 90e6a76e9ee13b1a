"""4x4 homogeneous transform helpers (cgmath Matrix4 equivalents).

The reference composes `Matrix4::from_translation * from_angle_y *
from_scale` etc. (tracing.rs:383,393,403). These helpers return numpy
(4,4) float32 matrices in standard row-major math convention (M @ v),
which matches cgmath's column-major storage semantics for composition
order: `translate(t) @ rotate_y(a) @ scale(s)` ≡ the reference's
`from_translation(t)*from_angle_y(a)*from_scale(s)`.
"""

from __future__ import annotations

import math

import numpy as np


def identity() -> np.ndarray:
    return np.eye(4, dtype=np.float32)


def translate(x: float, y: float, z: float) -> np.ndarray:
    m = np.eye(4, dtype=np.float32)
    m[:3, 3] = (x, y, z)
    return m


def scale(s: float) -> np.ndarray:
    m = np.eye(4, dtype=np.float32)
    m[0, 0] = m[1, 1] = m[2, 2] = s
    return m


def scale_xyz(x: float, y: float, z: float) -> np.ndarray:
    m = np.eye(4, dtype=np.float32)
    m[0, 0], m[1, 1], m[2, 2] = x, y, z
    return m


def rotate_x(degrees: float) -> np.ndarray:
    a = math.radians(degrees)
    c, s = math.cos(a), math.sin(a)
    m = np.eye(4, dtype=np.float32)
    m[1, 1], m[1, 2] = c, -s
    m[2, 1], m[2, 2] = s, c
    return m


def rotate_y(degrees: float) -> np.ndarray:
    a = math.radians(degrees)
    c, s = math.cos(a), math.sin(a)
    m = np.eye(4, dtype=np.float32)
    m[0, 0], m[0, 2] = c, s
    m[2, 0], m[2, 2] = -s, c
    return m


def rotate_z(degrees: float) -> np.ndarray:
    a = math.radians(degrees)
    c, s = math.cos(a), math.sin(a)
    m = np.eye(4, dtype=np.float32)
    m[0, 0], m[0, 1] = c, -s
    m[1, 0], m[1, 1] = s, c
    return m
