"""The benchmark scene: Cornell walls, a dense teapot mesh, metal and
glass spheres and an emissive triangle light (mirrors
bench.py::build_bench_scene).

The mesh is pinned to the in-repo assets/teapot_6k.obj (6,144 triangles,
inside the dense budget, so the scene takes the mega-bounce kernel), or to
a subdivision of it made by `teapot_obj` (scenes/bench_teapot_32k.py: the
same scene with a 32,832-triangle teapot, a big mesh, whose BVH the
mega-bounce kernel walks). A missing mesh raises instead of rendering a
scene without it.
"""

from __future__ import annotations

import os

from cs397raytracingsp22_tpu_torch.utils import subdivide
from cs397raytracingsp22_tpu_torch import (
    Camera, Dielectric, Lambertian, Metal, Plane, Scene, Sphere, StaticMesh, Triangle,
)
from cs397raytracingsp22_tpu_torch.models import transform as tf

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
TEAPOT_6K = os.path.join(_ROOT, "assets", "teapot_6k.obj")


def teapot_obj(target: int) -> str:
    """build/assets/teapot_<target>.obj: teapot_6k midpoint-subdivided to
    about `target` triangles (utils/subdivide.py), written at first use.
    Target 32768 gives 32,832 triangles; 9000 gives 9,000, just beyond the
    dense budget."""
    path = os.path.join(_ROOT, "build", "assets", f"teapot_{target}.obj")
    if not os.path.exists(path):
        subdivide.write_obj(path, TEAPOT_6K, *subdivide.subdivide_to(TEAPOT_6K, target))
    return path


def build(width: int = 512, height: int = 512, spp: int = 64, path_depth: int = 8,
          obj_path: str = TEAPOT_6K) -> Scene:
    if not os.path.exists(obj_path):
        raise FileNotFoundError(f"bench scene mesh {obj_path} is missing")
    white = Lambertian(albedo=(0.73, 0.73, 0.73))
    red = Lambertian(albedo=(0.65, 0.05, 0.05))
    green = Lambertian(albedo=(0.12, 0.45, 0.15))
    light = Lambertian(albedo=(0.0, 0.0, 0.0), emission=(15.0, 15.0, 15.0))
    objects = [
        Plane(point=(0, 0, 0), normal=(0, 1, 0), material=white),
        Plane(point=(0, 5, 0), normal=(0, -1, 0), material=white),
        Plane(point=(0, 0, -2.5), normal=(0, 0, 1), material=white),
        Plane(point=(-2.5, 0, 0), normal=(1, 0, 0), material=red),
        Plane(point=(2.5, 0, 0), normal=(-1, 0, 0), material=green),
        Sphere(center=(1.4, 0.7, 0.6), radius=0.7, material=Metal(albedo=(0.8, 0.8, 0.9), roughness=0.05)),
        Sphere(center=(-1.6, 0.6, 1.2), radius=0.6, material=Dielectric(idx_of_refraction=1.5)),
        Triangle(a=(-1.2, 4.99, -1.5), b=(1.2, 4.99, -1.5), c=(1.2, 4.99, 0.5), material=light),
        Triangle(a=(-1.2, 4.99, -1.5), b=(-1.2, 4.99, 0.5), c=(1.2, 4.99, 0.5), material=light),
        StaticMesh.load_from_file(
            obj_path,
            material=Lambertian(albedo=(0.7, 0.45, 0.2)),
            transform=tf.translate(0.0, 0.75, -0.6) @ tf.rotate_x(-90.0) @ tf.scale(1.5),
        ),
    ]
    camera = Camera(
        eyepoint=(0.0, 2.5, 7.5),
        view_dir=(0.0, 0.0, -1.0),
        up=(0.0, 1.0, 0.0),
        focal_length=0.8,
        focus_dist=5.0,
        screen_width=width,
        screen_height=height,
        aa_sample_count=spp,
        path_depth=path_depth,
        max_trace_dist=100.0,
        gamma=2.0,
    )
    return Scene(camera=camera, objects=objects)
