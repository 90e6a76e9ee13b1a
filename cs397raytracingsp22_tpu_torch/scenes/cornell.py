"""Cornell box scenes for the port (mirrors scenes/cornell.py).

BASELINE config 1: Cornell box — lambertian walls, emissive area
light, two spheres. 256², 16 spp.

Also used (with overrides) as config 3: metal/glass/emissive spheres at
depth-8, 512², 64 spp — `build_config3()`.
"""

from __future__ import annotations

from cs397raytracingsp22_tpu_torch import (
    Camera,
    Dielectric,
    Lambertian,
    Metal,
    Plane,
    Scene,
    Sphere,
    Triangle,
)


def build(
    width: int = 256,
    height: int = 256,
    spp: int = 16,
    path_depth: int = 10,
    **camera_overrides,
) -> Scene:
    white = Lambertian(albedo=(0.73, 0.73, 0.73))
    red = Lambertian(albedo=(0.65, 0.05, 0.05))
    green = Lambertian(albedo=(0.12, 0.45, 0.15))
    light = Lambertian(albedo=(0.0, 0.0, 0.0), emission=(15.0, 15.0, 15.0))

    objects = [
        Plane(point=(0.0, 0.0, 0.0), normal=(0.0, 1.0, 0.0), material=white),  # floor
        Plane(point=(0.0, 5.0, 0.0), normal=(0.0, -1.0, 0.0), material=white),  # ceiling
        Plane(point=(0.0, 0.0, -2.5), normal=(0.0, 0.0, 1.0), material=white),  # back
        Plane(point=(-2.5, 0.0, 0.0), normal=(1.0, 0.0, 0.0), material=red),  # left
        Plane(point=(2.5, 0.0, 0.0), normal=(-1.0, 0.0, 0.0), material=green),  # right
        Sphere(center=(-1.1, 1.0, -0.8), radius=1.0, material=white),
        Sphere(center=(1.2, 0.7, 0.6), radius=0.7, material=white),
        # area light: two ceiling triangles
        Triangle(a=(-1.2, 4.99, -1.5), b=(1.2, 4.99, -1.5), c=(1.2, 4.99, 0.5), material=light),
        Triangle(a=(-1.2, 4.99, -1.5), b=(-1.2, 4.99, 0.5), c=(1.2, 4.99, 0.5), material=light),
    ]

    camera = Camera(
        eyepoint=(0.0, 2.5, 7.5),
        view_dir=(0.0, 0.0, -1.0),
        up=(0.0, 1.0, 0.0),
        focal_length=0.8,
        focus_dist=5.0,
        lens_radius=0.0,
        screen_width=width,
        screen_height=height,
        aa_sample_count=spp,
        path_depth=path_depth,
        max_trace_dist=100.0,
        gamma=2.0,
        **camera_overrides,
    )
    return Scene(camera=camera, objects=objects)


def build_config3(
    width: int = 512, height: int = 512, spp: int = 64, path_depth: int = 8
) -> Scene:
    """Config 3: Cornell box with metal/glass/emissive spheres."""
    scene = build(width, height, spp, path_depth)
    extra = [
        Sphere(center=(-1.1, 1.0, 1.2), radius=0.5, material=Metal(albedo=(0.9, 0.8, 0.6), roughness=0.1)),
        Sphere(center=(0.2, 0.5, 1.6), radius=0.5, material=Dielectric(idx_of_refraction=1.5)),
        Sphere(
            center=(0.0, 3.2, -1.2),
            radius=0.4,
            material=Lambertian(albedo=(0.2, 0.2, 0.2), emission=(0.0, 2.0, 2.0)),
        ),
    ]
    return Scene(camera=scene.camera, objects=list(scene.objects) + extra)
