"""The teapot scene (mirrors scenes/teapot.py, BASELINE config 2): the Utah
teapot with smooth vertex normals on one floor plane under a black sky,
depth 6.

The mesh is pinned to the in-repo assets/teapot_6k.obj (6,144 triangles, a
dense mesh) unless obj_path names another; a missing mesh raises. It
shades by Phong with hard shadows (the default: integrator.phong_trace,
two scene intersections a camera ray). The scene's only light is Phong's
point light, so under the path tracer (shading=ShadingMode.PATH_TRACE)
its image is black, and NEE is refused (no emitter: nee_ok is False). It
is an open scene: camera rays above the floor escape at bounce 0 and most
floor bounces at bounce 1, so the path tracer's live rays fall fast, which
is what the wavefront kernel's compaction is for.
"""

from __future__ import annotations

import os

from cs397raytracingsp22_tpu_torch import Camera, Lambertian, Plane, Scene, ShadingMode, StaticMesh
from cs397raytracingsp22_tpu_torch.models import transform as tf
from cs397raytracingsp22_tpu_torch.scenes.bench_scene import TEAPOT_6K


def build(width: int = 256, height: int = 256, spp: int = 16,
          shading: ShadingMode = ShadingMode.PHONG, obj_path: str = TEAPOT_6K) -> Scene:
    if not os.path.exists(obj_path):
        raise FileNotFoundError(f"teapot scene mesh {obj_path} is missing")
    teapot = StaticMesh.load_from_file(
        obj_path,
        material=Lambertian(albedo=(0.7, 0.45, 0.2)),
        transform=tf.translate(0.0, 0.8, 0.0) @ tf.rotate_x(-90.0) @ tf.scale(1.2),
    )
    floor = Plane(point=(0.0, 0.0, 0.0), normal=(0.0, 1.0, 0.0),
                  material=Lambertian(albedo=(0.5, 0.5, 0.5)))
    camera = Camera(
        eyepoint=(0.0, 1.8, 4.0),
        view_dir=(0.0, -0.25, -1.0),
        up=(0.0, 1.0, 0.0),
        focal_length=0.7,
        focus_dist=4.0,
        lens_radius=0.0,
        screen_width=width,
        screen_height=height,
        aa_sample_count=spp,
        shading_mode=shading,
        path_depth=6,
        max_trace_dist=100.0,
        gamma=2.0,
    )
    return Scene(
        camera=camera,
        objects=[teapot, floor],
        point_light_pos=(3.0, 6.0, 4.0),
        ambient=(0.1, 0.1, 0.1),
    )
