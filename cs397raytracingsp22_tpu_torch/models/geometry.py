"""Primitive and mesh descriptions (compile-time scene-graph level).

These mirror the reference's `Intersectable` implementors
(geometry.rs:389-530, 126-321) as plain Python descriptions; they carry no
device arrays. `Scene.compile()` lowers them into the flat SoA tables the
device ops consume.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from cs397raytracingsp22_tpu_torch.models.materials import Material
from cs397raytracingsp22_tpu_torch.utils import obj_loader
from cs397raytracingsp22_tpu_torch.utils.texture import load_image

Vec3 = Tuple[float, float, float]


@dataclasses.dataclass(frozen=True)
class Sphere:
    """Analytic sphere (geometry.rs:389-420)."""

    center: Vec3
    radius: float
    material: Material


@dataclasses.dataclass(frozen=True)
class Triangle:
    """Standalone triangle with flat geometric normal, no UVs
    (geometry.rs:423-465)."""

    a: Vec3
    b: Vec3
    c: Vec3
    material: Material


@dataclasses.dataclass(frozen=True)
class Plane:
    """Infinite plane; normal sign-flips toward the ray origin
    (geometry.rs:468-493)."""

    point: Vec3
    normal: Vec3
    material: Material


@dataclasses.dataclass(frozen=True)
class ConvexVolume:
    """Homogeneous participating medium inside a convex boundary
    (geometry.rs:495-530).

    The boundary may be any convex `Intersectable`-equivalent, matching
    the reference's `Arc<dyn Intersectable>` field: Sphere (the demo
    scene's only kind — fast analytic entry/exit in every kernel tier),
    Triangle, or a convex StaticMesh (entry/exit found by scanning the
    boundary triangles, like the reference's two nearest-hit boundary
    queries at geometry.rs:505-510). The boundary's own material is
    ignored, exactly like the reference (only entry/exit distances are
    used). Scatter distance is sampled as -ln(U)/density per ray per
    bounce; hits carry a zero normal which the integrator special-cases
    (tracing.rs:313). Non-convex boundaries are accepted silently but
    give the same nearest-entry/next-exit behavior as the reference
    (which also never checks convexity).
    """

    boundary: object  # Sphere | Triangle | StaticMesh
    phase_function: Material
    density: float


class StaticMesh:
    """OBJ mesh with transform, optional uniform material, and up to five
    texture maps [albedo, emission, metallic, roughness, normal]
    (geometry.rs:126-321).

    Loading replicates tobj's triangulate+single_index semantics
    (geometry.rs:140-148) and degrades gracefully to absent textures
    (texture.rs:16-25). The reference panics when a mesh has neither an
    explicit material nor texcoords (geometry.rs:253-257 unwrap); here
    that is a load-time ValueError (SURVEY.md §3.5.5).
    """

    def __init__(
        self,
        mesh: obj_loader.ObjMesh,
        textures: list[Optional[np.ndarray]],
        material: Optional[Material],
        transform: np.ndarray,
    ):
        if material is None and not mesh.has_texcoords:
            raise ValueError(
                "StaticMesh needs an explicit material or texcoords to "
                "synthesize one from textures (reference geometry.rs:253-257 "
                "would panic here)"
            )
        if mesh.num_triangles == 0:
            raise ValueError("StaticMesh requires a non-empty mesh")
        self.mesh = mesh
        self.textures = textures  # 5 entries of (H,W,3) u8 or None
        self.material = material
        self.transform = np.asarray(transform, np.float32)
        self.inv_transform = np.linalg.inv(self.transform).astype(np.float32)

    @classmethod
    def load_from_file(
        cls,
        file_name: str,
        albedo_path: Optional[str] = None,
        emission_path: Optional[str] = None,
        metallic_path: Optional[str] = None,
        roughness_path: Optional[str] = None,
        normal_path: Optional[str] = None,
        material: Optional[Material] = None,
        transform: Optional[np.ndarray] = None,
    ) -> "StaticMesh":
        """Signature mirrors geometry.rs:138 (5 texture slots in the same
        order)."""
        mesh = obj_loader.load_obj(file_name)
        tex_paths = [albedo_path, emission_path, metallic_path, roughness_path, normal_path]
        textures = [load_image(p) if p else None for p in tex_paths]
        if transform is None:
            transform = np.eye(4, dtype=np.float32)
        return cls(mesh, textures, material, transform)
