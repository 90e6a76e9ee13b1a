"""BASELINE config 4: earth-textured and normal-mapped spheres with a
defocus-blur camera, 512² × 32 spp, depth 8 (mirrors the JAX package's
scenes/textured_spheres.py).

The textured spheres are a sphere OBJ mesh with texcoords carrying an
albedo map and a normal map, as the reference builds them
(tracing.rs:395-404); their materials are synthesized from the textures.
Both meshes are dense, so the scene intersects through K2's walk on the
staged path, and its two emissive triangles make it NEE-able.

`asset_dir` holds `obj/sphere.obj` and `texture/{earthmap.jpg,
magenta.jpg, normal_test.png, normal_test.jpg}`. Without one, the scene
uses stand-ins that `write_stand_in_assets` writes into
build/assets/config4/ at first use: a UV sphere of 64 longitude × 32
latitude segments with triangle-fan poles (3,968 triangles; u = lon/2π,
v = lat/π with lat measured from the south pole) and maps generated from
seeded numpy patterns.

    python -m cs397raytracingsp22_tpu_torch.cli cs397raytracingsp22_tpu_torch/scenes/textured_spheres.py
"""

from __future__ import annotations

import os

import numpy as np

from cs397raytracingsp22_tpu_torch import (
    Camera, Lambertian, ParameterizedMaterial, Plane, Scene, Sphere, StaticMesh, Triangle,
)
from cs397raytracingsp22_tpu_torch.models import transform as tf

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
STAND_IN_DIR = os.path.join(_ROOT, "build", "assets", "config4")
MAPS = ("earthmap.jpg", "magenta.jpg", "normal_test.png", "normal_test.jpg")
LON, LAT = 64, 32  # the stand-in sphere's segments
SEED = 4  # the stand-in maps' patterns


def uv_sphere(lon: int = LON, lat: int = LAT):
    """A unit UV sphere: (positions, normals, uvs, faces). Rings of lon + 1
    vertices (the seam duplicated at u = 1) at polar angles π·j/lat from
    the south pole, j = 1 .. lat - 1; each pole a fan of lon triangles
    around lon pole vertices at u = (i + 0.5)/lon. (lat - 2)·lon·2 + 2·lon
    triangles."""
    i = np.arange(lon + 1)
    j = np.arange(1, lat)
    theta = np.pi * j / lat
    phi = 2.0 * np.pi * i / lon
    ring = np.stack([np.sin(theta)[:, None] * np.cos(phi)[None, :],
                     -np.cos(theta)[:, None] * np.ones_like(phi)[None, :],
                     np.sin(theta)[:, None] * np.sin(phi)[None, :]], axis=-1).reshape(-1, 3)
    ring_uv = np.stack(np.broadcast_arrays(i[None, :] / lon, j[:, None] / lat), -1).reshape(-1, 2)
    pole_u = (np.arange(lon) + 0.5) / lon
    south = np.tile([[0.0, -1.0, 0.0]], (lon, 1))
    north = np.tile([[0.0, 1.0, 0.0]], (lon, 1))
    positions = np.concatenate([ring, south, north])
    uvs = np.concatenate([ring_uv, np.stack([pole_u, np.zeros(lon)], 1),
                          np.stack([pole_u, np.ones(lon)], 1)])
    vid = np.arange(ring.shape[0]).reshape(lat - 1, lon + 1)
    s0, n0 = ring.shape[0], ring.shape[0] + lon
    k = np.arange(lon)
    a, b = vid[:-1, :-1].ravel(), vid[:-1, 1:].ravel()
    c, d = vid[1:, 1:].ravel(), vid[1:, :-1].ravel()
    faces = np.concatenate([
        np.stack([s0 + k, vid[0, k + 1], vid[0, k]], 1),
        np.stack([a, b, c], 1), np.stack([a, c, d], 1),
        np.stack([vid[-1, k], vid[-1, k + 1], n0 + k], 1),
    ])
    return positions, positions.copy(), uvs, faces


def _noise(rng, h: int, w: int, waves: int, freq: float) -> np.ndarray:
    """A smooth periodic pattern: a sum of random sinusoids over [0, 1)²."""
    y, x = np.mgrid[0:h, 0:w] / np.array([h, w])[:, None, None]
    out = np.zeros((h, w))
    for _ in range(waves):
        fx, fy = rng.integers(1, int(freq) + 1, 2)
        out += np.sin(2.0 * np.pi * (fx * x + fy * y) + rng.uniform(0, 2.0 * np.pi)) / (fx + fy)
    return out / np.abs(out).max()


def _stand_in_maps() -> dict:
    """The four maps as (H, W, 3) uint8 arrays, from seeded patterns."""
    rng = np.random.default_rng(SEED)
    h = _noise(rng, 512, 1024, 24, 8.0)
    lat = np.abs(np.linspace(-1.0, 1.0, 512))[:, None]
    land = np.clip(h, 0.0, 1.0)[..., None]
    sea = np.clip(-h, 0.0, 1.0)[..., None]
    earth = np.where(h[..., None] > 0.0, np.array([60.0, 140.0, 50.0]) + land * [120.0, 60.0, 10.0],
                     np.array([20.0, 60.0, 170.0]) - sea * [10.0, 30.0, 80.0])
    earth = np.where((lat > 0.85)[..., None], 235.0, earth)
    magenta = np.array([210.0, 40.0, 200.0]) + 30.0 * _noise(rng, 256, 256, 12, 6.0)[..., None]
    bump = _noise(rng, 256, 256, 16, 10.0)
    gy, gx = np.gradient(bump)
    n = np.stack([-40.0 * gx, -40.0 * gy, np.ones_like(bump)], -1)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    normal = (n * 0.5 + 0.5) * 255.0
    maps = dict(earth=earth, magenta=magenta, normal=normal)
    return {k: np.clip(np.round(v), 0, 255).astype(np.uint8) for k, v in maps.items()}


def _replace(path: str, write) -> None:
    """write(tmp) then move it to path, so a reader never sees half a file."""
    tmp = f"{path}.{os.getpid()}.tmp{os.path.splitext(path)[1]}"
    write(tmp)
    os.replace(tmp, path)


def write_stand_in_assets(asset_dir: str) -> str:
    """Write the stand-in obj/sphere.obj and texture/ maps into asset_dir
    (the recipe in the module docstring); returns asset_dir."""
    from PIL import Image

    os.makedirs(os.path.join(asset_dir, "obj"), exist_ok=True)
    os.makedirs(os.path.join(asset_dir, "texture"), exist_ok=True)
    pos, nrm, uvs, faces = uv_sphere()

    def write_obj(path):
        with open(path, "w") as f:
            f.write("# stand-in UV sphere, 64 x 32 segments, triangle-fan poles\n")
            f.writelines(f"v {x:.9g} {y:.9g} {z:.9g}\n" for x, y, z in pos)
            f.writelines(f"vt {u:.9g} {v:.9g}\n" for u, v in uvs)
            f.writelines(f"vn {x:.9g} {y:.9g} {z:.9g}\n" for x, y, z in nrm)
            f.writelines(f"f {a}/{a}/{a} {b}/{b}/{b} {c}/{c}/{c}\n" for a, b, c in faces + 1)

    _replace(os.path.join(asset_dir, "obj", "sphere.obj"), write_obj)
    maps = _stand_in_maps()
    for name, img in (("earthmap.jpg", maps["earth"]), ("magenta.jpg", maps["magenta"]),
                      ("normal_test.png", maps["normal"]), ("normal_test.jpg", maps["normal"])):
        _replace(os.path.join(asset_dir, "texture", name),
                 lambda p, img=img: Image.fromarray(img, mode="RGB").save(p, quality=90))
    return asset_dir


def stand_in_dir() -> str:
    """build/assets/config4/, the stand-in assets written there at first use."""
    files = [os.path.join(STAND_IN_DIR, "obj", "sphere.obj")]
    files += [os.path.join(STAND_IN_DIR, "texture", m) for m in MAPS]
    if not all(os.path.exists(f) for f in files):
        write_stand_in_assets(STAND_IN_DIR)
    return STAND_IN_DIR


def build(width: int = 512, height: int = 512, spp: int = 32, lens_radius: float = 0.08,
          asset_dir: str | None = None) -> Scene:
    asset_dir = stand_in_dir() if asset_dir is None else asset_dir
    mesh_obj = os.path.join(asset_dir, "obj", "sphere.obj")
    tex = lambda name: os.path.join(asset_dir, "texture", name)  # noqa: E731

    earth = StaticMesh.load_from_file(
        mesh_obj, albedo_path=tex("earthmap.jpg"), normal_path=tex("normal_test.png"),
        transform=tf.translate(-1.1, 1.0, 0.0) @ tf.rotate_y(90.0) @ tf.scale(1.0),
    )
    magenta = StaticMesh.load_from_file(
        mesh_obj, albedo_path=tex("magenta.jpg"), normal_path=tex("normal_test.jpg"),
        transform=tf.translate(1.4, 0.8, 0.8) @ tf.rotate_y(45.0) @ tf.scale(0.8),
    )
    floor = Plane(point=(0.0, 0.0, 0.0), normal=(0.0, 1.0, 0.0),
                  material=ParameterizedMaterial(albedo=(0.33, 0.33, 0.33), metallic=0.3,
                                                 roughness=0.7))
    light = Lambertian(albedo=(0.0, 0.6, 0.0), emission=(7.0, 7.0, 7.0))
    objects = [
        earth,
        magenta,
        floor,
        Sphere(center=(0.2, 0.5, 2.2), radius=0.5,
               material=ParameterizedMaterial(albedo=(0.01, 0.02, 0.5), roughness=0.2,
                                              metallic=0.8)),
        Triangle(a=(-2.5, 7.5, -0.5), b=(2.5, 7.5, -0.5), c=(2.5, 7.5, 3.5), material=light),
        Triangle(a=(-2.5, 7.5, -0.5), b=(-2.5, 7.5, 3.5), c=(2.5, 7.5, 3.5), material=light),
    ]
    camera = Camera(
        eyepoint=(0.0, 1.6, 5.0), view_dir=(0.0, 0.0, -1.0), up=(0.0, 1.0, 0.0),
        focal_length=0.6, focus_dist=5.0, lens_radius=lens_radius, screen_width=width,
        screen_height=height, aa_sample_count=spp, path_depth=8, max_trace_dist=100.0,
        gamma=2.0,
    )
    return Scene(camera=camera, objects=objects)
