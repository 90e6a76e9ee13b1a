"""The kitchen-sink scene: every feature class of the staged path at once.

Mirrors the JAX package's tests/test_kitchen_sink.py::kitchen_sink_scene,
built in code with no external file:
- a big textured, normal-mapped grid mesh (8,450 triangles, beyond the
  dense budget: the big-mesh kernel K3) whose material is synthesized
  from its albedo and roughness textures;
- a dense texture-synthesized grid mesh (288 triangles: K2's walk);
- a sphere-boundary volume and a triangle-boundary (general) volume;
- a dielectric sphere, a plane and an emissive sphere.

    python -m cs397raytracingsp22_tpu_torch.cli cs397raytracingsp22_tpu_torch/scenes/kitchen_sink.py
"""

from __future__ import annotations

import numpy as np

from cs397raytracingsp22_tpu_torch import (
    Camera, ConvexVolume, Dielectric, Isotropic, Lambertian, Plane, Scene, Sphere, StaticMesh,
    Triangle,
)
from cs397raytracingsp22_tpu_torch.models import transform as tf
from cs397raytracingsp22_tpu_torch.ops.bvh import DENSE_MESH_MAX_TRIS
from cs397raytracingsp22_tpu_torch.utils.obj_loader import ObjMesh

BIG_GRID = 65  # 2 · 65² = 8,450 triangles, beyond the dense budget
DENSE_GRID = 12  # 288 triangles


def mesh_from_arrays(positions, indices, texcoords, textures, material=None,
                     transform=None) -> StaticMesh:
    """A StaticMesh from vertex arrays, every corner normal +z (the JAX
    package's tests/test_mesh.py::make_mesh)."""
    positions = np.asarray(positions, np.float32)
    normals = np.zeros_like(positions)
    normals[:, 2] = 1.0
    mesh = ObjMesh(positions=positions, normals=normals,
                   texcoords=np.asarray(texcoords, np.float32),
                   indices=np.asarray(indices, np.int32), has_normals=True, has_texcoords=True)
    return StaticMesh(mesh, list(textures), material,
                      np.eye(4, dtype=np.float32) if transform is None else transform)


def grid_mesh_arrays(g: int, bump: float = 0.0):
    """(positions, uv, faces) of a g × g grid over [-1, 1]² in x-z, bumped
    in y by bump·sin(2.5x)·cos(2.5z), two triangles a cell."""
    xs = np.linspace(-1.0, 1.0, g + 1, dtype=np.float32)
    px, pz = np.meshgrid(xs, xs, indexing="ij")
    py = bump * np.sin(2.5 * px) * np.cos(2.5 * pz)
    positions = np.stack([px, py, pz], axis=-1).reshape(-1, 3)
    uv = np.stack([(px + 1.0) / 2.0, (pz + 1.0) / 2.0], axis=-1).reshape(-1, 2)
    vid = np.arange((g + 1) * (g + 1), dtype=np.int32).reshape(g + 1, g + 1)
    a, b = vid[:-1, :-1].ravel(), vid[1:, :-1].ravel()
    c, d4 = vid[1:, 1:].ravel(), vid[:-1, 1:].ravel()
    faces = np.concatenate([np.stack([a, b, c], axis=-1), np.stack([a, c, d4], axis=-1)])
    return positions, uv, faces


def build(width: int = 12, height: int = 12, spp: int = 2, path_depth: int = 5) -> Scene:
    pos, uv, faces = grid_mesh_arrays(BIG_GRID, bump=0.3)
    assert len(faces) > DENSE_MESH_MAX_TRIS
    tex = np.zeros((8, 8, 3), np.uint8)
    tex[::2] = (200, 120, 60)
    tex[1::2] = (60, 120, 200)
    nrm_map = np.full((4, 4, 3), 128, np.uint8)
    nrm_map[:2, :2] = (160, 140, 235)
    big = mesh_from_arrays(pos, faces, uv, (tex, None, None, tex, nrm_map),
                           transform=tf.translate(0.0, 0.0, -2.0) @ tf.scale(2.0))
    pos2, uv2, faces2 = grid_mesh_arrays(DENSE_GRID, bump=0.15)
    dense = mesh_from_arrays(pos2, faces2, uv2, (tex, None, None, None, None),
                             transform=tf.translate(-1.2, 1.2, -1.0) @ tf.rotate_x(80.0))
    sphere_vol = ConvexVolume(
        boundary=Sphere(center=(1.3, 0.8, -1.2), radius=0.7, material=Lambertian()),
        phase_function=Isotropic(albedo=(0.9, 0.7, 0.7)), density=0.8,
    )
    triangle_vol = ConvexVolume(
        boundary=Triangle(a=(-2.2, 0.2, -1.0), b=(-1.4, 0.2, -1.0), c=(-1.8, 1.0, -1.0),
                          material=Lambertian()),
        phase_function=Isotropic(albedo=(0.6, 0.9, 0.6)), density=1.5,
    )
    return Scene(
        camera=Camera(eyepoint=(0.0, 1.2, 2.6), view_dir=(0.0, -0.25, -1.0), up=(0, 1, 0),
                      screen_width=width, screen_height=height, aa_sample_count=spp,
                      path_depth=path_depth),
        objects=[
            big, dense, sphere_vol, triangle_vol,
            Sphere(center=(0.0, 0.55, -0.6), radius=0.35,
                   material=Dielectric(idx_of_refraction=1.5)),
            Plane(point=(0, -0.8, 0), normal=(0, 1, 0),
                  material=Lambertian(albedo=(0.6, 0.6, 0.6))),
            Sphere(center=(0, 5.5, 0), radius=2.0,
                   material=Lambertian(albedo=(0, 0, 0), emission=(8.0, 8.0, 8.0))),
        ],
    )
