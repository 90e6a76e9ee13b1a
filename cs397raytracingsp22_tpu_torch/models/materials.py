"""Material descriptions and the compiled material parameter table.

The reference dispatches `Arc<dyn Material>` per hit (materials.rs:12-15).
TPU-native design: materials are rows in a flat parameter table
(type enum + albedo/emission/roughness/metallic/ior); the BSDF stage is a
branchless masked switch over the type column (ops/bsdf.py). Texture-driven
mesh materials (geometry.rs:253-271) resolve their parameters per hit from
the texture atlas and share the same parameter layout.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

Vec3 = Tuple[float, float, float]

# Material type enum — the lax-select switch key.
LAMBERTIAN = 0
METAL = 1
DIELECTRIC = 2
PARAMETERIZED = 3
ISOTROPIC = 4


@dataclasses.dataclass(frozen=True)
class Material:
    """Base class for material descriptions (compile-time only)."""


@dataclasses.dataclass(frozen=True)
class Lambertian(Material):
    """Uniform-hemisphere diffuse; may also emit (area lights).

    Reference: materials.rs:19-48. brdf = albedo/π, pdf = 1/(2π).
    """

    albedo: Vec3 = (1.0, 1.0, 1.0)
    emission: Vec3 = (0.0, 0.0, 0.0)


@dataclasses.dataclass(frozen=True)
class Metal(Material):
    """Mirror reflection + roughness-scaled ball perturbation.

    Reference: materials.rs:51-71. attenuation = albedo, pdf = 1.
    """

    albedo: Vec3 = (1.0, 1.0, 1.0)
    emission: Vec3 = (0.0, 0.0, 0.0)
    roughness: float = 0.0


@dataclasses.dataclass(frozen=True)
class Dielectric(Material):
    """Glass: stochastic Schlick-fresnel reflect/refract.

    Reference: materials.rs:74-104 (incl. the quirk that fresnel is fed the
    full IOR rather than the direction-dependent eta, materials.rs:82).
    """

    idx_of_refraction: float = 1.5


@dataclasses.dataclass(frozen=True)
class ParameterizedMaterial(Material):
    """PBR-ish stochastic diffuse/specular mix.

    Reference: materials.rs:107-149 — k_s = fresnel(1.5)·(1−roughness),
    k_d = (1−k_s)·(1−metallic); branch picked stochastically WITHOUT
    dividing by the branch probability (a biased estimator the rebuild
    replicates exactly, SURVEY.md §3.5).
    """

    albedo: Vec3 = (1.0, 1.0, 1.0)
    emission: Vec3 = (0.0, 0.0, 0.0)
    roughness: float = 0.0
    metallic: float = 0.0


@dataclasses.dataclass(frozen=True)
class Isotropic(Material):
    """Uniform-ball phase function for participating media.

    Reference: materials.rs:152-166. attenuation = albedo, pdf = 1.
    """

    albedo: Vec3 = (1.0, 1.0, 1.0)
    emission: Vec3 = (0.0, 0.0, 0.0)


_TYPE_CODE = {
    Lambertian: LAMBERTIAN,
    Metal: METAL,
    Dielectric: DIELECTRIC,
    ParameterizedMaterial: PARAMETERIZED,
    Isotropic: ISOTROPIC,
}


def material_row(m: Material) -> tuple[int, np.ndarray, np.ndarray, float, float, float]:
    """Lower one material description to its table row:
    (type, albedo[3], emission[3], roughness, metallic, ior)."""
    code = _TYPE_CODE[type(m)]
    albedo = np.asarray(getattr(m, "albedo", (0.0, 0.0, 0.0)), np.float32)
    emission = np.asarray(getattr(m, "emission", (0.0, 0.0, 0.0)), np.float32)
    roughness = float(getattr(m, "roughness", 0.0))
    metallic = float(getattr(m, "metallic", 0.0))
    ior = float(getattr(m, "idx_of_refraction", 1.5))
    return code, albedo, emission, roughness, metallic, ior


class MaterialTableBuilder:
    """Deduplicating builder for the compiled material table."""

    def __init__(self):
        self._rows: list[tuple] = []
        self._index: dict[Material, int] = {}

    def add(self, m: Material) -> int:
        if m in self._index:
            return self._index[m]
        idx = len(self._rows)
        self._rows.append(material_row(m))
        self._index[m] = idx
        return idx

    def build(self) -> dict[str, np.ndarray]:
        if not self._rows:
            # Inert padding row so compiled scenes are never zero-size.
            self._rows.append(material_row(Lambertian(albedo=(0, 0, 0))))
        types, albedos, emissions, rough, metal, ior = zip(*self._rows)
        return dict(
            mat_type=np.asarray(types, np.int32),
            mat_albedo=np.stack(albedos).astype(np.float32),
            mat_emission=np.stack(emissions).astype(np.float32),
            mat_roughness=np.asarray(rough, np.float32),
            mat_metallic=np.asarray(metal, np.float32),
            mat_ior=np.asarray(ior, np.float32),
        )
