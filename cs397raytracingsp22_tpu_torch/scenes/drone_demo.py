"""BASELINE config 5, the reference's demo scene (tracing.rs:354-548;
mirrors the JAX package's scenes/drone_demo.py): the drone, cube and
sphere meshes with texture sets, the 15-sphere metallic × roughness
ParameterizedMaterial grid, a dielectric and an emissive sphere, two
subsurface ConvexVolumes, a parameterized floor and the two-triangle area
light. Its spec is 1024² × 1000 spp, depth 10.

`asset_dir` holds `obj/{drone,cube,sphere}.obj` and `texture/{green.png,
normal_test.jpg, magenta.jpg, normal_test.png}`; the drone's five
`Drone_*.tga` maps are optional. A missing map falls back as the
reference's does (texture.rs:16-25): the slot stays empty, and the drone
with all five empty renders with the reference's default parameters
(albedo and emission 0, metallic 0, roughness 1; geometry.rs:260-263). A
missing OBJ raises. `include_meshes=False` builds the analytic part
alone (22 primitives, which the mega-bounce kernel K1 runs).

Without an asset_dir the scene uses stand-ins that
`write_stand_in_assets` writes into build/assets/config5/ at first use,
with the counts of the reference's files (SURVEY.md §2.4):
- `sphere.obj`: the UV sphere of `textured_spheres.uv_sphere(128, 128)`
  with its positions written once (127 rings × 128 + 2 poles = 16,258
  `v`), its texcoords as uv_sphere repeats them at the seam and the poles
  (16,639 `vt`), normals equal to the positions, and 16,384 faces indexed
  `f v/vt/vn`: 16,128 quads (fan-triangulated by the loader) and 256
  pole triangles, so 32,512 triangles: a big mesh (the BVH kernel K3);
- `cube.obj`: 8 positions, 4 texcoords (the unit square), 6 face normals,
  12 triangles;
- `drone.obj`: a quadcopter of 794 positions and 896 faces, quads and
  triangles mixed (1,536 triangles, a dense mesh): an ellipsoid body (a
  32 × 16 UV sphere), four square-tube arms, four rotor discs of 24
  segments with triangle-fan caps, four box legs; texcoords a planar map
  of x and z. Built upside down, as the scene's rotate_x(180) turns it;
- `green.png`: a green map from seeded numpy patterns (seed 5); the other
  three maps are config 4's stand-ins (scenes/textured_spheres.py);
- no `Drone_*.tga`: those maps are absent from the reference checkout too.

    python -m cs397raytracingsp22_tpu_torch.cli cs397raytracingsp22_tpu_torch/scenes/drone_demo.py --width 1024 --height 1024 --spp 64
"""

from __future__ import annotations

import os

import numpy as np

from cs397raytracingsp22_tpu_torch import (
    Camera, ConvexVolume, Dielectric, Isotropic, Lambertian, ParameterizedMaterial, Plane,
    Scene, Sphere, StaticMesh, Triangle,
)
from cs397raytracingsp22_tpu_torch.models import transform as tf
from cs397raytracingsp22_tpu_torch.scenes import textured_spheres

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
STAND_IN_DIR = os.path.join(_ROOT, "build", "assets", "config5")
OBJS = ("drone.obj", "cube.obj", "sphere.obj")
MAPS = ("green.png", "normal_test.jpg", "magenta.jpg", "normal_test.png")
LON, LAT = 128, 128  # the stand-in sphere's segments
SEED = 5  # the green map's pattern


def _obj_lines(v, vt, vn, faces) -> list:
    """OBJ text: faces are lists of (v, vt, vn) 0-based index triples."""
    out = [f"v {x:.9g} {y:.9g} {z:.9g}\n" for x, y, z in v]
    out += [f"vt {a:.9g} {b:.9g}\n" for a, b in vt]
    out += [f"vn {x:.9g} {y:.9g} {z:.9g}\n" for x, y, z in vn]
    out += ["f " + " ".join(f"{a + 1}/{b + 1}/{c + 1}" for a, b, c in f) + "\n" for f in faces]
    return out


def sphere_obj(lon: int = LON, lat: int = LAT) -> list:
    """The stand-in sphere.obj's lines (the recipe in the module docstring)."""
    pos, _, uvs, faces = textured_spheres.uv_sphere(lon, lat)
    n_ring = (lat - 1) * (lon + 1)
    ring = np.arange(n_ring)
    # uv_sphere's vertex k → its distinct position: the seam column i = lon
    # is column 0, every pole copy one pole
    vmap = np.concatenate([(ring // (lon + 1)) * lon + (ring % (lon + 1)) % lon,
                           np.full(lon, (lat - 1) * lon), np.full(lon, (lat - 1) * lon + 1)])
    keep = np.concatenate([ring[ring % (lon + 1) < lon], [n_ring, n_ring + lon]])
    v = pos[keep]
    corner = lambda k: (int(vmap[k]), int(k), int(vmap[k]))  # noqa: E731
    quads = (lat - 2) * lon
    fan = [faces[:lon], faces[lon + 2 * quads:]]
    abc, acd = faces[lon:lon + quads], faces[lon + quads:lon + 2 * quads]
    out = [[corner(k) for k in t] for t in fan[0]]
    out += [[corner(a), corner(b), corner(c), corner(d)]
            for (a, b, c), (_, _, d) in zip(abc, acd)]
    out += [[corner(k) for k in t] for t in fan[1]]
    return _obj_lines(v, uvs, v, out)


def cube_obj() -> list:
    """The stand-in cube.obj's lines: the cube [-1, 1]³, two triangles a
    face, counter-clockwise seen from outside."""
    v = [(x, y, z) for x in (-1, 1) for y in (-1, 1) for z in (-1, 1)]
    vt = [(0.0, 0.0), (1.0, 0.0), (1.0, 1.0), (0.0, 1.0)]
    quads = [((0, 1, 3, 2), (-1, 0, 0)), ((4, 6, 7, 5), (1, 0, 0)),
             ((0, 4, 5, 1), (0, -1, 0)), ((2, 3, 7, 6), (0, 1, 0)),
             ((0, 2, 6, 4), (0, 0, -1)), ((1, 5, 7, 3), (0, 0, 1))]
    faces = []
    for n, (q, _) in enumerate(quads):
        faces.append([(q[0], 0, n), (q[1], 1, n), (q[2], 2, n)])
        faces.append([(q[0], 0, n), (q[2], 2, n), (q[3], 3, n)])
    return _obj_lines(v, vt, [nrm for _, nrm in quads], faces)


class _Mesh:
    """Positions, normals and faces of the stand-in drone, built part by
    part; texcoords are a planar map of x and z over the finished mesh."""

    def __init__(self):
        self.v, self.vn, self.faces = [], [], []

    def add_v(self, p) -> int:
        self.v.append(tuple(float(x) for x in p))
        return len(self.v) - 1

    def add_n(self, n) -> int:
        n = np.asarray(n, np.float64)
        self.vn.append(tuple(n / np.linalg.norm(n)))
        return len(self.vn) - 1

    def face(self, vids, nids) -> None:
        self.faces.append(list(zip(vids, nids)))

    def box(self, lo, hi) -> None:
        """An axis-aligned box: 8 positions, 6 quads with face normals."""
        c = [self.add_v((x, y, z)) for x in (lo[0], hi[0]) for y in (lo[1], hi[1])
             for z in (lo[2], hi[2])]
        for q, n in (((0, 1, 3, 2), (-1, 0, 0)), ((4, 6, 7, 5), (1, 0, 0)),
                     ((0, 4, 5, 1), (0, -1, 0)), ((2, 3, 7, 6), (0, 1, 0)),
                     ((0, 2, 6, 4), (0, 0, -1)), ((1, 5, 7, 3), (0, 0, 1))):
            self.face([c[k] for k in q], [self.add_n(n)] * 4)

    def lines(self) -> list:
        v = np.asarray(self.v)
        lo, hi = v[:, [0, 2]].min(0), v[:, [0, 2]].max(0)
        vt = (v[:, [0, 2]] - lo) / (hi - lo)
        faces = [[(p, p, n) for p, n in f] for f in self.faces]
        return _obj_lines(v, vt, self.vn, faces)


def drone_obj() -> list:
    """The stand-in drone.obj's lines (the recipe in the module docstring).
    Units as the reference's drone: the scene scales it by 0.003."""
    m = _Mesh()
    # body: an ellipsoid, lon 32 × lat 16, fan poles, smooth normals
    lon, lat, r = 32, 16, np.array([60.0, 25.0, 40.0])
    rings = []
    for j in range(1, lat):
        th = np.pi * j / lat
        ids = []
        for i in range(lon):
            ph = 2.0 * np.pi * i / lon
            u = np.array([np.sin(th) * np.cos(ph), -np.cos(th), np.sin(th) * np.sin(ph)])
            ids.append((m.add_v(r * u), m.add_n(u / r)))
        rings.append(ids)
    south = (m.add_v((0.0, -r[1], 0.0)), m.add_n((0, -1, 0)))
    north = (m.add_v((0.0, r[1], 0.0)), m.add_n((0, 1, 0)))
    for i in range(lon):
        k = (i + 1) % lon
        m.face(*zip(south, rings[0][k], rings[0][i]))
        for j in range(lat - 2):
            a, b, c, d = rings[j][i], rings[j][k], rings[j + 1][k], rings[j + 1][i]
            m.face(*zip(a, b, c, d))
        m.face(*zip(rings[-1][i], rings[-1][k], north))
    # arms along the diagonals: square tubes of 4 segments; rotors at their
    # ends below the body (above it once the scene turns the drone over)
    for ang in (45.0, 135.0, 225.0, 315.0):
        a = np.radians(ang)
        axis, side = np.array([np.cos(a), 0.0, np.sin(a)]), np.array([-np.sin(a), 0.0, np.cos(a)])
        up = np.array([0.0, 1.0, 0.0])
        w = 6.0
        offs = [(-w, -w), (w, -w), (w, w), (-w, w)]
        st = [[m.add_v(axis * (50.0 + 15.0 * s) + side * p + up * (q - 12.0)) for p, q in offs]
              for s in range(5)]
        norms = [m.add_n(-up), m.add_n(side), m.add_n(up), m.add_n(-side)]
        for s in range(4):
            for e in range(4):
                f = (e + 1) % 4
                m.face([st[s][e], st[s + 1][e], st[s + 1][f], st[s][f]], [norms[e]] * 4)
        m.face(st[0][::-1], [m.add_n(-axis)] * 4)
        m.face(st[4], [m.add_n(axis)] * 4)
        # the rotor: a disc of radius 45, 24 segments, at the arm's end
        c = axis * 110.0 + up * -22.0
        seg, rad, h = 24, 45.0, 4.0
        top = [m.add_v(c + rad * (np.cos(2 * np.pi * i / seg) * axis
                                   + np.sin(2 * np.pi * i / seg) * side) + up * h / 2)
               for i in range(seg)]
        bot = [m.add_v(m.v[t][0:3] - up * h) for t in top]
        ct, cb = m.add_v(c + up * h / 2), m.add_v(c - up * h / 2)
        nt, nb = m.add_n(up), m.add_n(-up)
        for i in range(seg):
            k = (i + 1) % seg
            m.face([ct, top[k], top[i]], [nt] * 3)
            m.face([cb, bot[i], bot[k]], [nb] * 3)
            radial = np.asarray(m.v[top[i]]) + np.asarray(m.v[top[k]]) - 2.0 * (c + up * h / 2)
            m.face([top[i], top[k], bot[k], bot[i]], [m.add_n(radial)] * 4)
    # legs: boxes above the body (below it once turned over)
    for x in (-35.0, 35.0):
        for z in (-20.0, 20.0):
            m.box((x - 3.0, 15.0, z - 3.0), (x + 3.0, 45.0, z + 3.0))
    return m.lines()


def _green_map() -> np.ndarray:
    rng = np.random.default_rng(SEED)
    h = textured_spheres._noise(rng, 256, 256, 12, 6.0)[..., None]
    green = np.array([40.0, 170.0, 60.0]) + h * np.array([20.0, 50.0, 20.0])
    return np.clip(np.round(green), 0, 255).astype(np.uint8)


def write_stand_in_assets(asset_dir: str, lon: int = LON, lat: int = LAT) -> str:
    """Write the stand-in obj/ and texture/ files into asset_dir (the recipe
    in the module docstring; lon × lat the sphere's segments); returns
    asset_dir."""
    from PIL import Image

    os.makedirs(os.path.join(asset_dir, "obj"), exist_ok=True)
    os.makedirs(os.path.join(asset_dir, "texture"), exist_ok=True)
    for name, lines in (("sphere.obj", sphere_obj(lon, lat)), ("cube.obj", cube_obj()),
                        ("drone.obj", drone_obj())):
        def write(path, lines=lines, name=name):
            with open(path, "w") as f:
                f.write(f"# stand-in {name} (cs397raytracingsp22_tpu_torch/scenes/drone_demo.py)\n")
                f.writelines(lines)

        textured_spheres._replace(os.path.join(asset_dir, "obj", name), write)
    maps = textured_spheres._stand_in_maps()
    for name, img in (("green.png", _green_map()), ("magenta.jpg", maps["magenta"]),
                      ("normal_test.png", maps["normal"]), ("normal_test.jpg", maps["normal"])):
        textured_spheres._replace(os.path.join(asset_dir, "texture", name),
                                  lambda p, img=img: Image.fromarray(img, mode="RGB")
                                  .save(p, quality=90))
    return asset_dir


def stand_in_dir() -> str:
    """build/assets/config5/, the stand-in assets written there at first use."""
    files = [os.path.join(STAND_IN_DIR, "obj", o) for o in OBJS]
    files += [os.path.join(STAND_IN_DIR, "texture", m) for m in MAPS]
    if not all(os.path.exists(f) for f in files):
        write_stand_in_assets(STAND_IN_DIR)
    return STAND_IN_DIR


def build(width: int = 100, height: int = 100, spp: int = 100, path_depth: int = 10,
          include_meshes: bool = True, asset_dir: str | None = None) -> Scene:
    objects = []
    if include_meshes:
        asset_dir = stand_in_dir() if asset_dir is None else asset_dir
        tex = lambda name: os.path.join(asset_dir, "texture", name)  # noqa: E731

        def obj(name):
            path = os.path.join(asset_dir, "obj", name)
            if not os.path.exists(path):
                raise FileNotFoundError(f"config 5 mesh {path} is missing (asset_dir "
                                        f"{asset_dir}); build(include_meshes=False) renders "
                                        "the scene without its meshes")
            return path

        objects += [
            StaticMesh.load_from_file(
                obj("drone.obj"),
                albedo_path=tex("Drone_Albedo.tga"),
                emission_path=tex("Drone_Emission.tga"),
                metallic_path=tex("Drone_Metallic.tga"),
                roughness_path=tex("Drone_Roughness.tga"),
                normal_path=tex("Drone_Normal.tga"),
                transform=tf.translate(0.0, 1.3, 1.7) @ tf.rotate_y(-60.0) @ tf.rotate_x(180.0)
                @ tf.scale(0.0030),
            ),
            StaticMesh.load_from_file(
                obj("cube.obj"), albedo_path=tex("green.png"), normal_path=tex("normal_test.jpg"),
                transform=tf.translate(-1.7, 0.5, 2.7) @ tf.rotate_y(45.0) @ tf.scale(0.4),
            ),
            StaticMesh.load_from_file(
                obj("sphere.obj"), albedo_path=tex("magenta.jpg"),
                normal_path=tex("normal_test.png"),
                transform=tf.translate(1.7, 0.5, 2.7) @ tf.rotate_y(45.0) @ tf.scale(0.6),
            ),
        ]

    # the ParameterizedMaterial grid: metallic rows × roughness columns
    blue = (0.01, 0.02, 0.5)
    for row, metallic in ((3.3, 0.0), (4.4, 0.5), (5.5, 1.0)):
        for col, roughness in zip((-2.6, -1.3, 0.0, 1.3, 2.6), (0.0, 0.25, 0.5, 0.75, 1.0)):
            objects.append(Sphere(center=(col, row, 0.0), radius=0.5,
                                  material=ParameterizedMaterial(albedo=blue, roughness=roughness,
                                                                 metallic=metallic)))
    objects += [
        Sphere(center=(-2.3, 2.0, 2.0), radius=0.4, material=Dielectric(idx_of_refraction=2.5)),
        Sphere(center=(2.3, 2.0, 2.0), radius=0.4,
               material=Lambertian(albedo=(0.3, 0.3, 0.3), emission=(0.0, 1.0, 1.0))),
        ConvexVolume(boundary=Sphere(center=(-3.0, 1.0, 1.0), radius=1.0,
                                     material=Dielectric(idx_of_refraction=1.5)),
                     phase_function=Isotropic(albedo=(1.0, 1.0, 1.0)), density=0.6),
        ConvexVolume(boundary=Sphere(center=(3.0, 1.0, 1.0), radius=1.0,
                                     material=Dielectric(idx_of_refraction=1.5)),
                     phase_function=Isotropic(albedo=(0.0, 0.0, 0.0)), density=0.8),
        Plane(point=(0.0, 0.0, 0.0), normal=(0.0, 1.0, 0.0),
              material=ParameterizedMaterial(albedo=(0.33, 0.33, 0.33), metallic=0.3,
                                             roughness=0.7)),
        Triangle(a=(-2.5, 7.5, -0.5), b=(2.5, 7.5, -0.5), c=(2.5, 7.5, 3.5),
                 material=Lambertian(albedo=(0.0, 0.6, 0.0), emission=(7.0, 7.0, 7.0))),
        Triangle(a=(-2.5, 7.5, -0.5), b=(-2.5, 7.5, 3.5), c=(2.5, 7.5, 3.5),
                 material=Lambertian(albedo=(0.0, 0.6, 0.0), emission=(7.0, 7.0, 7.0))),
    ]
    camera = Camera(
        eyepoint=(0.0, 2.0, 5.5), view_dir=(0.0, 0.0, -1.0), up=(0.0, 1.0, 0.0),
        focal_length=0.6, focus_dist=5.0, lens_radius=0.0, screen_width=width,
        screen_height=height, aa_sample_count=spp, path_depth=path_depth, path_samples=1,
        max_trace_dist=100.0, gamma=2.0,
    )
    return Scene(camera=camera, objects=objects, point_light_pos=(0.0, 1.0, 5.0),
                 ambient=(0.1, 0.1, 0.1))
