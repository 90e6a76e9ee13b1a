"""cs397raytracingsp22_tpu_torch — the path tracer ported to PyTorch + CUDA.

The second package beside `cs397raytracingsp22_tpu` (JAX on a TPU), which
stays the reference this port is tested against. It holds every render
path of the JAX package: scene compile (textures, normal maps, general
volumes), camera rays, the mega-bounce path-trace kernel K1 for scenes it
can run and the staged executor around the scene-intersection kernel K2
and the big-mesh BVH kernel K3 for the others, next-event estimation,
Phong shading, the chunked driver with checkpoints and multi-device
rendering over torch.distributed (parallel/), the CLI, the scenes of
BASELINE configs 1-5 (scenes/), and its tools (tools/: artifacts,
checkpoint previews, the demo scene's region check, benchmarks, the
kernels' comparisons and roofline probes). Each kernel is written by hand
in CUDA C++ for Hopper (csrc/) beside a plain torch version that CPU
tensors take. Importing it needs neither JAX nor CUDA; the kernels build
with nvcc on first use.

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
