"""The final scene of *Ray Tracing: The Next Week* (P. Shirley, T. D. Black,
S. Hollasch, v4.0.1, 2024; §10 "A Scene Testing All New Features",
`final_scene(800, 10000, 40)` in the book's main.cc).

A ground of 20 × 20 boxes 100 wide and 1-101 high (one mesh of 4,800
triangles with flat normals), a 300 × 265 quad light at y = 554 (two
triangles, emission 7), a cluster of 1,000 spheres of radius 10 (centres
uniform in [0, 165]³, turned 15° about y and moved by (-100, 270, 395),
written here in world coordinates: a rotation moves a sphere's centre
only), a glass, a fuzzy metal, a moving, an earth and a marble sphere, a
glass shell holding a blue medium, and a white fog of density 0.0001
inside a sphere of radius 5,000 that holds the camera and the whole
scene; 800², depth 40, vfov 40°, a black background. With 1,006 spheres
the compile builds the sphere tree (models/scene.py::sphere_tree) that
the mega-bounce kernel walks.

Departures from the book, which the renderer has no counterpart for:
the moving sphere is static at the middle of its shutter; the earth and
marble textures are constant albedos (`EARTH_ALBEDO`, and the marble's
mean 0.5 grey); the quads are triangle pairs and the boxes one mesh; the
random heights and centres come from numpy's `default_rng(SEED)` with the
book's distributions, not from the book's generator. `max_trace_dist`
covers the fog's diameter from any point inside it.

`description()` is the benchmark's configuration (benchmark/configs/
rtnw_final.json) and `ground_obj_text()` its mesh (benchmark/data/
rtnw_ground_boxes.obj); `write_files(root)` writes both. `build()` is the
scene through the renderer's API, its mesh written into build/assets/ at
first use.
"""

from __future__ import annotations

import json
import math
import os

import numpy as np

from cs397raytracingsp22_tpu_torch import (
    Camera, ConvexVolume, Dielectric, Isotropic, Lambertian, Metal, Scene, Sphere, StaticMesh,
    Triangle,
)

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SEED = 4010  # numpy's default_rng seed of the box heights and the cluster's centres
OBJ_NAME = "rtnw_ground_boxes.obj"
CONFIG_PATH = os.path.join("benchmark", "configs", "rtnw_final.json")
OBJ_PATH = os.path.join("benchmark", "data", OBJ_NAME)
EARTH_ALBEDO = (0.25, 0.3, 0.4)  # earthmap.jpg is absent: a mostly-ocean mean, assumed
SOURCE = ("P. Shirley, T. D. Black, S. Hollasch, Ray Tracing: The Next Week, v4.0.1 (2024), "
          "sec. 10 A Scene Testing All New Features: final_scene(800, 10000, 40)")

MATERIALS = {
    "ground": {"type": "lambertian", "albedo": [0.48, 0.83, 0.53]},
    "light": {"type": "lambertian", "albedo": [0.0, 0.0, 0.0], "emission": [7.0, 7.0, 7.0]},
    "moving": {"type": "lambertian", "albedo": [0.7, 0.3, 0.1]},
    "glass": {"type": "dielectric", "ior": 1.5},
    "metal": {"type": "metal", "albedo": [0.8, 0.8, 0.9], "roughness": 1.0},
    "blue_medium": {"type": "isotropic", "albedo": [0.2, 0.4, 0.9]},
    "fog": {"type": "isotropic", "albedo": [1.0, 1.0, 1.0]},
    "earth": {"type": "lambertian", "albedo": list(EARTH_ALBEDO)},
    "marble": {"type": "lambertian", "albedo": [0.5, 0.5, 0.5]},
    "white": {"type": "lambertian", "albedo": [0.73, 0.73, 0.73]},
}


def _draws() -> tuple[np.ndarray, np.ndarray]:
    """(box heights (20, 20) by (i, j), cluster centres (1000, 3) in world
    coordinates), rounded to 1e-4 as the files hold them."""
    rng = np.random.default_rng(SEED)
    heights = np.round(rng.uniform(1.0, 101.0, (20, 20)), 4)
    local = rng.uniform(0.0, 165.0, (1000, 3))
    c, s = math.cos(math.radians(15.0)), math.sin(math.radians(15.0))
    world = np.stack([c * local[:, 0] + s * local[:, 2], local[:, 1],
                      -s * local[:, 0] + c * local[:, 2]], axis=1) + np.array([-100.0, 270.0, 395.0])
    return heights, np.round(world, 4)


def camera_desc(width: int = 800, height: int = 800, spp: int = 64, path_depth: int = 40) -> dict:
    view = np.array([278.0 - 478.0, 0.0, 600.0])
    return {
        "eyepoint": [478.0, 278.0, -600.0], "view_dir": [float(x) for x in view / np.linalg.norm(view)],
        "up": [0.0, 1.0, 0.0], "focal_length": 0.5 / math.tan(math.radians(20.0)),
        "focus_dist": 10.0, "lens_radius": 0.0, "screen_width": width, "screen_height": height,
        "aa_sample_count": spp, "path_depth": path_depth, "max_trace_dist": 20000.0, "gamma": 2.0,
    }


def objects_desc() -> list:
    """The scene's objects in the book's order, as the configuration lists them."""
    _, centres = _draws()
    light = [[123.0, 554.0, 147.0], [423.0, 554.0, 147.0], [423.0, 554.0, 412.0],
             [123.0, 554.0, 412.0]]

    def sphere(c, r, m):
        return {"type": "sphere", "center": [float(x) for x in c], "radius": float(r), "material": m}

    def volume(c, r, density, phase):
        return {"type": "volume", "boundary": {"type": "sphere", "center": c, "radius": r},
                "density": density, "phase": phase}

    return ([{"type": "mesh", "obj": OBJ_NAME, "material": "ground"},
             {"type": "triangle", "a": light[0], "b": light[1], "c": light[2], "material": "light"},
             {"type": "triangle", "a": light[0], "b": light[2], "c": light[3], "material": "light"},
             sphere((415.0, 400.0, 200.0), 50.0, "moving"),
             sphere((260.0, 150.0, 45.0), 50.0, "glass"),
             sphere((0.0, 150.0, 145.0), 50.0, "metal"),
             sphere((360.0, 150.0, 145.0), 70.0, "glass"),
             volume([360.0, 150.0, 145.0], 70.0, 0.2, "blue_medium"),
             volume([0.0, 0.0, 0.0], 5000.0, 0.0001, "fog"),
             sphere((400.0, 200.0, 400.0), 100.0, "earth"),
             sphere((220.0, 280.0, 300.0), 80.0, "marble")]
            + [sphere(c, 10.0, "white") for c in centres])


def description() -> dict:
    """The benchmark's configuration of this scene (cut to 64 spp)."""
    return {
        "name": "rtnw_final",
        "source": SOURCE,
        "reduced": ["aa_sample_count"],
        "assumed": {
            "aa_sample_count": "10,000 -> 64 samples a pixel: the staged path that a parent "
                               "without the sphere tree takes would need ~10 min an image, and "
                               "800 x 800 x 10,000 passes the int32 uid range",
            "moving_sphere": "static at its shutter's middle, (415, 400, 200): the renderer "
                             "has no shutter time",
            "earth_albedo": f"earthmap.jpg is absent and analytic spheres carry no texture: "
                            f"a constant Lambertian {list(EARTH_ALBEDO)}, a mostly-ocean mean",
            "marble_albedo": "the Perlin texture 0.5 (1 + sin(...)) as its mean, 0.5 grey",
            "rng": f"box heights uniform in [1, 101] and cluster centres uniform in [0, 165]^3 "
                   f"drawn by numpy default_rng({SEED}) (the book's distributions, not its "
                   f"generator), rounded to 1e-4 and written into the files",
            "quads": "the light quad as two triangles; the 400 ground boxes as one mesh of "
                     "4,800 triangles with flat normals (benchmark/data/rtnw_ground_boxes.obj)",
            "cluster": "the 1,000 spheres in world coordinates: rotate_y(15) then translate "
                       "(-100, 270, 395) moves only their centres",
            "metal": "fuzz 1.0 as the renderer's metal roughness",
            "max_trace_dist": "20,000: covers the fog's 10,000 diameter from any point inside it",
            "focal_length": "0.5 / tan(20 deg): the image plane is one unit high, so vfov is 40",
            "precision": "float32, the renderer's and the reference's",
        },
        "precision": "float32",
        "files": {OBJ_NAME: OBJ_PATH},
        "scene": {"camera": camera_desc(), "materials": MATERIALS, "objects": objects_desc()},
    }


def config_text() -> str:
    """description() as the committed JSON: one object a line."""
    desc = description()
    objects = desc["scene"].pop("objects")
    text = json.dumps(desc, indent=2)
    lines = ",\n".join(f"      {json.dumps(o)}" for o in objects)
    return text[:-len("\n  }\n}")] + ',\n    "objects": [\n' + lines + "\n    ]\n  }\n}\n"


def _box_faces():
    """Each face of a unit box as (corner bits (4, 3) counter-clockwise seen
    from outside, outward normal index into NORMALS)."""
    faces = []
    for axis in range(3):
        for side in (0, 1):
            u, v = (axis + 1) % 3, (axis + 2) % 3
            quad = []
            for a, b in ((0, 0), (1, 0), (1, 1), (0, 1)):
                c = [0, 0, 0]
                c[axis], c[u], c[v] = side, a, b
                quad.append(c)
            quad = np.array(quad)
            normal = np.zeros(3)
            normal[axis] = 1.0 if side else -1.0
            if np.dot(np.cross(quad[1] - quad[0], quad[2] - quad[0]), normal) < 0:
                quad = quad[::-1]
            faces.append((quad, 2 * axis + (0 if side else 1)))
    return faces


NORMALS = ((1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0), (0, 0, 1), (0, 0, -1))


def ground_obj_text() -> str:
    """The 400 ground boxes as OBJ text: 8 vertices and 12 triangles a box,
    each face's two triangles carrying its outward normal as `vn`."""
    heights, _ = _draws()
    out = ["# Ray Tracing: The Next Week, final scene: the ground's 20 x 20 boxes, 100 wide,",
           f"# heights uniform in [1, 101] from numpy default_rng({SEED}); "
           "written by cs397raytracingsp22_tpu_torch/scenes/rtnw_final.py"]
    out += [f"vn {x} {y} {z}" for x, y, z in NORMALS]
    faces = _box_faces()
    for i in range(20):
        for j in range(20):
            base = 8 * (20 * i + j)  # vertices written before this box
            lo = (-1000.0 + 100.0 * i, 0.0, -1000.0 + 100.0 * j)
            hi = (lo[0] + 100.0, float(heights[i, j]), lo[2] + 100.0)
            for bits in range(8):
                c = [(hi if (bits >> (2 - k)) & 1 else lo)[k] for k in range(3)]
                out.append("v " + " ".join(repr(x) for x in c))
            for quad, n in faces:
                ids = [base + 1 + 4 * c[0] + 2 * c[1] + c[2] for c in quad]
                for tri in ((0, 1, 2), (0, 2, 3)):
                    out.append("f " + " ".join(f"{ids[t]}//{n + 1}" for t in tri))
    return "\n".join(out) + "\n"


def write_files(root: str = _ROOT) -> None:
    """Write the benchmark's configuration and mesh under `root`."""
    for rel, text in ((CONFIG_PATH, config_text()), (OBJ_PATH, ground_obj_text())):
        path = os.path.join(root, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            f.write(text)


def ground_obj() -> str:
    """build/assets/rtnw_ground_boxes.obj, written at first use."""
    path = os.path.join(_ROOT, "build", "assets", OBJ_NAME)
    if not os.path.exists(path):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            f.write(ground_obj_text())
    return path


def build(width: int = 800, height: int = 800, spp: int = 64, path_depth: int = 40,
          obj_path: str | None = None) -> Scene:
    """The scene through the renderer's API, at the configuration's cut
    (64 spp) unless told otherwise."""
    kinds = {"lambertian": lambda m: Lambertian(albedo=tuple(m["albedo"]),
                                               emission=tuple(m.get("emission", (0, 0, 0)))),
             "metal": lambda m: Metal(albedo=tuple(m["albedo"]), roughness=m["roughness"]),
             "dielectric": lambda m: Dielectric(idx_of_refraction=m["ior"]),
             "isotropic": lambda m: Isotropic(albedo=tuple(m["albedo"]))}
    mats = {name: kinds[m["type"]](m) for name, m in MATERIALS.items()}
    objects = []
    for obj in objects_desc():
        kind = obj["type"]
        if kind == "sphere":
            objects.append(Sphere(center=tuple(obj["center"]), radius=obj["radius"],
                                  material=mats[obj["material"]]))
        elif kind == "triangle":
            objects.append(Triangle(a=tuple(obj["a"]), b=tuple(obj["b"]), c=tuple(obj["c"]),
                                    material=mats[obj["material"]]))
        elif kind == "volume":
            b = obj["boundary"]
            objects.append(ConvexVolume(
                boundary=Sphere(center=tuple(b["center"]), radius=b["radius"],
                                material=Dielectric(idx_of_refraction=1.5)),
                phase_function=mats[obj["phase"]], density=obj["density"]))
        else:
            objects.append(StaticMesh.load_from_file(obj_path or ground_obj(),
                                                     material=mats[obj["material"]]))
    cam = camera_desc(width, height, spp, path_depth)
    camera = Camera(
        eyepoint=tuple(cam["eyepoint"]), view_dir=tuple(cam["view_dir"]), up=tuple(cam["up"]),
        focal_length=cam["focal_length"], focus_dist=cam["focus_dist"],
        lens_radius=cam["lens_radius"], screen_width=width, screen_height=height,
        aa_sample_count=spp, path_depth=path_depth, max_trace_dist=cam["max_trace_dist"],
        gamma=cam["gamma"])
    return Scene(camera=camera, objects=objects)


if __name__ == "__main__":
    write_files()
