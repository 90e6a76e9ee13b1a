"""Stand-in assets, written from their recipe and seed once per checkout.

The reference's demo scene (BASELINE config 5) loads `drone.obj`,
`cube.obj`, `sphere.obj` and four maps that are absent from the
repository. A configuration names a recipe here, and `stand_in_dir`
writes its files into build/benchmark/stand_ins/<recipe>/ inside the
checkout, a fixed directory that a later run finds filled (a file
`complete` is written last). Both sides of a run read the same files.

Recipe "demo_scene", with the reference files' counts:
- `sphere.obj`: a 128 × 128 UV sphere, 16,258 positions, 16,639
  texcoords, normals equal to the positions, 16,384 faces (16,128 quads
  fan-triangulated on load, 256 pole triangles): 32,512 triangles;
- `cube.obj`: the cube [-1, 1]³, 12 triangles, face normals, unit uvs;
- `drone.obj`: a quadcopter of 794 positions and 896 quad and triangle
  faces (1,536 triangles): an ellipsoid body, four square-tube arms,
  four rotor discs, four box legs, texcoords a planar map of x and z;
- `green.png` from seed 5, `magenta.jpg`, `normal_test.png` and
  `normal_test.jpg` from seed 4 (smooth sums of random sinusoids).
"""

from __future__ import annotations

import os

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STAND_IN_ROOT = os.path.join(ROOT, "build", "benchmark", "stand_ins")


def _replace(path: str, write) -> None:
    tmp = f"{path}.{os.getpid()}.tmp{os.path.splitext(path)[1]}"
    write(tmp)
    os.replace(tmp, path)


def _obj_lines(v, vt, vn, faces) -> list:
    out = [f"v {x:.9g} {y:.9g} {z:.9g}\n" for x, y, z in v]
    out += [f"vt {a:.9g} {b:.9g}\n" for a, b in vt]
    out += [f"vn {x:.9g} {y:.9g} {z:.9g}\n" for x, y, z in vn]
    out += ["f " + " ".join(f"{a + 1}/{b + 1}/{c + 1}" for a, b, c in f) + "\n" for f in faces]
    return out


def uv_sphere(lon: int, lat: int):
    """A unit UV sphere: (positions, uvs, faces); rings of lon + 1 vertices
    (the seam repeated) at polar angles π·j/lat from the south pole, each
    pole a fan of lon triangles."""
    i = np.arange(lon + 1)
    j = np.arange(1, lat)
    theta = np.pi * j / lat
    phi = 2.0 * np.pi * i / lon
    ring = np.stack([np.sin(theta)[:, None] * np.cos(phi)[None, :],
                     -np.cos(theta)[:, None] * np.ones_like(phi)[None, :],
                     np.sin(theta)[:, None] * np.sin(phi)[None, :]], axis=-1).reshape(-1, 3)
    ring_uv = np.stack(np.broadcast_arrays(i[None, :] / lon, j[:, None] / lat), -1).reshape(-1, 2)
    pole_u = (np.arange(lon) + 0.5) / lon
    positions = np.concatenate([ring, np.tile([[0.0, -1.0, 0.0]], (lon, 1)),
                                np.tile([[0.0, 1.0, 0.0]], (lon, 1))])
    uvs = np.concatenate([ring_uv, np.stack([pole_u, np.zeros(lon)], 1),
                          np.stack([pole_u, np.ones(lon)], 1)])
    vid = np.arange(ring.shape[0]).reshape(lat - 1, lon + 1)
    s0, n0 = ring.shape[0], ring.shape[0] + lon
    k = np.arange(lon)
    a, b = vid[:-1, :-1].ravel(), vid[:-1, 1:].ravel()
    c, d = vid[1:, 1:].ravel(), vid[1:, :-1].ravel()
    faces = np.concatenate([np.stack([s0 + k, vid[0, k + 1], vid[0, k]], 1),
                            np.stack([a, b, c], 1), np.stack([a, c, d], 1),
                            np.stack([vid[-1, k], vid[-1, k + 1], n0 + k], 1)])
    return positions, uvs, faces


def sphere_obj(lon: int, lat: int) -> list:
    """The sphere with its positions written once and quads between rings."""
    pos, uvs, faces = uv_sphere(lon, lat)
    n_ring = (lat - 1) * (lon + 1)
    ring = np.arange(n_ring)
    vmap = np.concatenate([(ring // (lon + 1)) * lon + (ring % (lon + 1)) % lon,
                           np.full(lon, (lat - 1) * lon), np.full(lon, (lat - 1) * lon + 1)])
    keep = np.concatenate([ring[ring % (lon + 1) < lon], [n_ring, n_ring + lon]])
    v = pos[keep]
    corner = lambda k: (int(vmap[k]), int(k), int(vmap[k]))  # noqa: E731
    quads = (lat - 2) * lon
    abc, acd = faces[lon:lon + quads], faces[lon + quads:lon + 2 * quads]
    out = [[corner(k) for k in t] for t in faces[:lon]]
    out += [[corner(a), corner(b), corner(c), corner(d)] for (a, b, c), (_, _, d) in zip(abc, acd)]
    out += [[corner(k) for k in t] for t in faces[lon + 2 * quads:]]
    return _obj_lines(v, uvs, v, out)


_BOX = (((0, 1, 3, 2), (-1, 0, 0)), ((4, 6, 7, 5), (1, 0, 0)), ((0, 4, 5, 1), (0, -1, 0)),
        ((2, 3, 7, 6), (0, 1, 0)), ((0, 2, 6, 4), (0, 0, -1)), ((1, 5, 7, 3), (0, 0, 1)))


def cube_obj() -> list:
    v = [(x, y, z) for x in (-1, 1) for y in (-1, 1) for z in (-1, 1)]
    vt = [(0.0, 0.0), (1.0, 0.0), (1.0, 1.0), (0.0, 1.0)]
    faces = []
    for n, (q, _) in enumerate(_BOX):
        faces.append([(q[0], 0, n), (q[1], 1, n), (q[2], 2, n)])
        faces.append([(q[0], 0, n), (q[2], 2, n), (q[3], 3, n)])
    return _obj_lines(v, vt, [nrm for _, nrm in _BOX], faces)


class _Mesh:
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
        c = [self.add_v((x, y, z)) for x in (lo[0], hi[0]) for y in (lo[1], hi[1])
             for z in (lo[2], hi[2])]
        for q, n in _BOX:
            self.face([c[k] for k in q], [self.add_n(n)] * 4)

    def lines(self) -> list:
        v = np.asarray(self.v)
        lo, hi = v[:, [0, 2]].min(0), v[:, [0, 2]].max(0)
        vt = (v[:, [0, 2]] - lo) / (hi - lo)
        return _obj_lines(v, vt, self.vn, [[(p, p, n) for p, n in f] for f in self.faces])


def drone_obj() -> list:
    m = _Mesh()
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
            m.face(*zip(rings[j][i], rings[j][k], rings[j + 1][k], rings[j + 1][i]))
        m.face(*zip(rings[-1][i], rings[-1][k], north))
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
    for x in (-35.0, 35.0):
        for z in (-20.0, 20.0):
            m.box((x - 3.0, 15.0, z - 3.0), (x + 3.0, 45.0, z + 3.0))
    return m.lines()


def _noise(rng, h: int, w: int, waves: int, freq: float) -> np.ndarray:
    y, x = np.mgrid[0:h, 0:w] / np.array([h, w])[:, None, None]
    out = np.zeros((h, w))
    for _ in range(waves):
        fx, fy = rng.integers(1, int(freq) + 1, 2)
        out += np.sin(2.0 * np.pi * (fx * x + fy * y) + rng.uniform(0, 2.0 * np.pi)) / (fx + fy)
    return out / np.abs(out).max()


def _maps() -> dict:
    rng = np.random.default_rng(4)
    _noise(rng, 512, 1024, 24, 8.0)  # the earth map's draws, which come first in the stream
    magenta = np.array([210.0, 40.0, 200.0]) + 30.0 * _noise(rng, 256, 256, 12, 6.0)[..., None]
    bump = _noise(rng, 256, 256, 16, 10.0)
    gy, gx = np.gradient(bump)
    n = np.stack([-40.0 * gx, -40.0 * gy, np.ones_like(bump)], -1)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    h = _noise(np.random.default_rng(5), 256, 256, 12, 6.0)[..., None]
    green = np.array([40.0, 170.0, 60.0]) + h * np.array([20.0, 50.0, 20.0])
    maps = dict(magenta=magenta, normal=(n * 0.5 + 0.5) * 255.0, green=green)
    return {k: np.clip(np.round(v), 0, 255).astype(np.uint8) for k, v in maps.items()}


def write_demo_scene(out_dir: str, lon: int = 128, lat: int = 128) -> None:
    from PIL import Image

    os.makedirs(os.path.join(out_dir, "obj"), exist_ok=True)
    os.makedirs(os.path.join(out_dir, "texture"), exist_ok=True)
    for name, lines in (("sphere.obj", sphere_obj(lon, lat)), ("cube.obj", cube_obj()),
                        ("drone.obj", drone_obj())):
        def write(path, lines=lines, name=name):
            with open(path, "w") as f:
                f.write(f"# stand-in {name}\n")
                f.writelines(lines)

        _replace(os.path.join(out_dir, "obj", name), write)
    maps = _maps()
    for name, img in (("green.png", maps["green"]), ("magenta.jpg", maps["magenta"]),
                      ("normal_test.png", maps["normal"]), ("normal_test.jpg", maps["normal"])):
        _replace(os.path.join(out_dir, "texture", name),
                 lambda p, img=img: Image.fromarray(img, mode="RGB").save(p, quality=90))


RECIPES = {"demo_scene": write_demo_scene}


def stand_in_dir(recipe: dict) -> str:
    """The directory of a configuration's stand-ins ({"recipe": name,
    ...keyword arguments}), written there when it is not complete."""
    kwargs = {k: v for k, v in recipe.items() if k != "recipe"}
    tag = "_".join([recipe["recipe"]] + [f"{k}{v}" for k, v in sorted(kwargs.items())])
    out = os.path.join(STAND_IN_ROOT, tag)
    done = os.path.join(out, "complete")
    if not os.path.exists(done):
        RECIPES[recipe["recipe"]](out, **kwargs)
        with open(done, "w") as f:
            f.write("written\n")
    return out
