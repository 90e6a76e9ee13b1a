"""cs397raytracingsp22_tpu_torch — the path tracer ported to PyTorch + CUDA.

The second package beside `cs397raytracingsp22_tpu` (JAX on a TPU), which
stays the reference this port is tested against. Its first slice renders
the main path end to end: scene compile, camera rays, the mega-bounce
path-trace kernel written by hand in CUDA C++ for Hopper
(csrc/bounce.cu, plain torch version in render/integrator.py), the
per-pixel sum and the tonemap. Importing it needs neither JAX nor CUDA;
the kernel builds with nvcc on first use.

Public API mirrors the reference's scene-description surface: `Camera`,
`Scene`, `Sphere`, `Triangle`, `Plane`, `ConvexVolume`, `StaticMesh`, and
the material types `Lambertian`, `Metal`, `Dielectric`,
`ParameterizedMaterial`, `Isotropic`.
"""

from cs397raytracingsp22_tpu_torch.models.camera import (
    Camera,
    CameraProjectionMode,
    ShadingMode,
)
from cs397raytracingsp22_tpu_torch.models.geometry import (
    ConvexVolume,
    Plane,
    Sphere,
    StaticMesh,
    Triangle,
)
from cs397raytracingsp22_tpu_torch.models.materials import (
    Dielectric,
    Isotropic,
    Lambertian,
    Metal,
    ParameterizedMaterial,
)
from cs397raytracingsp22_tpu_torch.models.scene import Scene

__version__ = "0.1.0"

__all__ = [
    "Camera",
    "CameraProjectionMode",
    "ShadingMode",
    "Scene",
    "Sphere",
    "Triangle",
    "Plane",
    "ConvexVolume",
    "StaticMesh",
    "Lambertian",
    "Metal",
    "Dielectric",
    "ParameterizedMaterial",
    "Isotropic",
]
