"""A configuration's scene as the plain reference's tables.

Built from the configuration file's description alone (materials,
objects, camera), with the meshes parsed from their OBJ files and the
maps read from their image files here: nothing of the renderer's compile
is used. Meshes keep their file's triangle order (the reference scans
every triangle, so it needs no tree). Vertex normals go through the
octahedral 16-bit encoding that the renderer's scene format specifies,
and each triangle's tangent is the reference's formula in float32, inf or
NaN where the uv determinant is 0.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

LAMBERTIAN, METAL, DIELECTRIC, PARAMETERIZED, ISOTROPIC = range(5)
_TYPES = {"lambertian": LAMBERTIAN, "metal": METAL, "dielectric": DIELECTRIC,
          "parameterized": PARAMETERIZED, "isotropic": ISOTROPIC}
TEX_SLOTS = ("albedo", "emission", "metallic", "roughness", "normal")


def parse_obj(path: str):
    """tobj's triangulate + single_index reading of an OBJ: fan-triangulated
    faces, one vertex per distinct (v, vt, vn) triple, zeros for a missing
    vt or vn. Returns (positions, normals, texcoords, indices, has_uv)."""
    pos, tex, nrm, faces = [], [], [], []

    def index(s: str, n: int) -> int:
        if not s:
            return -1
        i = int(s)
        return i - 1 if i > 0 else n + i

    with open(path, encoding="utf-8", errors="replace") as f:
        for line in f:
            parts = line.split()
            if not parts or parts[0].startswith("#"):
                continue
            if parts[0] == "v":
                pos.append([float(x) for x in parts[1:4]])
            elif parts[0] == "vt":
                tex.append([float(parts[1]), float(parts[2]) if len(parts) > 2 else 0.0])
            elif parts[0] == "vn":
                nrm.append([float(x) for x in parts[1:4]])
            elif parts[0] == "f":
                corners = []
                for tok in parts[1:]:
                    p = tok.split("/")
                    v = index(p[0], len(pos))
                    vt = index(p[1], len(tex)) if len(p) > 1 else -1
                    vn = index(p[2], len(nrm)) if len(p) > 2 else -1
                    if 0 <= v < len(pos):
                        corners.append((v, vt if 0 <= vt < len(tex) else -1,
                                        vn if 0 <= vn < len(nrm) else -1))
                if len(corners) >= 3:
                    faces.append(corners)
    pos_a = np.asarray(pos, np.float32).reshape(-1, 3)
    tex_a = np.asarray(tex, np.float32).reshape(-1, 2)
    nrm_a = np.asarray(nrm, np.float32).reshape(-1, 3)
    unified: dict = {}
    out_p, out_t, out_n, tris = [], [], [], []

    def unify(c) -> int:
        if c not in unified:
            unified[c] = len(out_p)
            out_p.append(pos_a[c[0]])
            out_t.append(tex_a[c[1]] if c[1] >= 0 else np.zeros(2, np.float32))
            out_n.append(nrm_a[c[2]] if c[2] >= 0 else np.zeros(3, np.float32))
        return unified[c]

    for corners in faces:
        ids = [unify(c) for c in corners]
        tris += [(ids[0], ids[i], ids[i + 1]) for i in range(1, len(ids) - 1)]
    return (np.stack(out_p), np.stack(out_n), np.stack(out_t),
            np.asarray(tris, np.int64).reshape(-1, 3), len(tex) > 0)


def oct_roundtrip(n: np.ndarray) -> np.ndarray:
    """Unit vectors after the octahedral encoding (two 16-bit snorm
    components) and its decoding to float32."""
    v = n.astype(np.float64)
    norm = np.linalg.norm(v, axis=-1, keepdims=True)
    v = v / np.where(norm > 0, norm, 1.0)
    l1 = np.abs(v).sum(axis=-1, keepdims=True)
    p = v[..., :2] / np.where(l1 > 0, l1, 1.0)
    flip = (1.0 - np.abs(p[..., ::-1])) * np.where(p >= 0.0, 1.0, -1.0)
    p = np.where((v[..., 2] < 0.0)[..., None], flip, p)
    q = np.round(np.clip(p, -1.0, 1.0) * 32767.0).astype(np.int64)
    fu = q[..., 0].astype(np.float32) * np.float32(1.0 / 32767.0)
    fv = q[..., 1].astype(np.float32) * np.float32(1.0 / 32767.0)
    z = np.float32(1.0) - np.abs(fu) - np.abs(fv)
    t = np.maximum(-z, np.float32(0.0))
    x = fu + np.where(fu >= 0.0, -t, t)
    y = fv + np.where(fv >= 0.0, -t, t)
    out = np.stack([x, y, z], axis=-1).astype(np.float32)
    length = np.sqrt((out ** 2).sum(axis=-1, keepdims=True))
    return (out / np.maximum(length, np.float32(1e-30))).astype(np.float32)


def load_image(path: str):
    """(H, W, 3) uint8, or None where the file is absent or unreadable (the
    slot then stays empty)."""
    try:
        from PIL import Image

        with Image.open(path) as im:
            return np.asarray(im.convert("RGB"), dtype=np.uint8)
    except (OSError, ValueError):
        return None


@dataclasses.dataclass
class Mesh:
    a: torch.Tensor  # (T, 3) first corner, object space, file order
    e1: torch.Tensor  # (T, 3) b - a
    e2: torch.Tensor  # (T, 3) c - a
    box: torch.Tensor  # (2, 3) the corners' bounds, padded
    normals: torch.Tensor  # (T, 3, 3) per corner, after the octahedral encoding
    uvs: torch.Tensor  # (T, 3, 2)
    tangent: torch.Tensor  # (T, 3)
    transform: torch.Tensor  # (4, 4)
    inv_transform: torch.Tensor  # (4, 4)
    normal_mat: torch.Tensor  # (3, 3)
    mat: int  # material row, -1 for a material made from the textures
    textures: list  # five (H, W, 3) uint8 tensors or None
    bounds: np.ndarray  # (T, 3, 3) float32 vertices (the K1 count's input)


@dataclasses.dataclass
class RefScene:
    camera: dict
    mat_type: torch.Tensor
    mat_albedo: torch.Tensor
    mat_emission: torch.Tensor
    mat_roughness: torch.Tensor
    mat_metallic: torch.Tensor
    mat_ior: torch.Tensor
    spheres: tuple  # (center (S, 3), radius (S,), mat (S,))
    planes: tuple  # (point (P, 3), normal (P, 3), mat (P,))
    triangles: tuple  # (a, b, c (T, 3), mat (T,))
    volumes: tuple  # (center (V, 3), radius (V,), density (V,), mat (V,))
    meshes: list
    lt_tri: torch.Tensor  # (L, 13) a, e1, e2, emission, area
    lt_sph: torch.Tensor  # (L, 7) center, radius, emission
    nee_ok: bool
    dtype: torch.dtype


def build(desc: dict, files: dict, device, dtype=torch.float32) -> RefScene:
    """The tables of the scene `desc` (a configuration's "scene"); files
    maps each file name the description uses to its path."""
    f = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=device).to(dtype)  # noqa: E731
    names = list(desc["materials"])
    rows = [desc["materials"][n] for n in names]
    mid = {n: i for i, n in enumerate(names)}
    mat_type = torch.tensor([_TYPES[r["type"]] for r in rows], device=device)
    mat_albedo = f([r.get("albedo", [0.0, 0.0, 0.0]) for r in rows])
    mat_emission = f([r.get("emission", [0.0, 0.0, 0.0]) for r in rows])
    mat_roughness = f([r.get("roughness", 0.0) for r in rows])
    mat_metallic = f([r.get("metallic", 0.0) for r in rows])
    mat_ior = f([r.get("ior", 1.5) for r in rows])
    emits = {n: max(abs(x) for x in r.get("emission", [0.0])) > 0 for n, r in zip(names, rows)}
    sph, pln, tri, vol, meshes, lt_tri, lt_sph = [], [], [], [], [], [], []
    nee_ok = True
    for obj in desc["objects"]:
        kind = obj["type"]
        if kind == "sphere":
            sph.append((obj["center"], obj["radius"], mid[obj["material"]]))
            if emits[obj["material"]]:
                lt_sph.append(list(obj["center"]) + [obj["radius"]]
                              + list(desc["materials"][obj["material"]]["emission"]))
        elif kind == "plane":
            pln.append((obj["point"], obj["normal"], mid[obj["material"]]))
            nee_ok = nee_ok and not emits[obj["material"]]
        elif kind == "triangle":
            tri.append((obj["a"], obj["b"], obj["c"], mid[obj["material"]]))
            if emits[obj["material"]]:
                a = np.asarray(obj["a"], np.float32)
                e1 = np.asarray(obj["b"], np.float32) - a
                e2 = np.asarray(obj["c"], np.float32) - a
                area = 0.5 * float(np.linalg.norm(np.cross(e1, e2)))
                lt_tri.append(list(a) + list(e1) + list(e2)
                              + list(desc["materials"][obj["material"]]["emission"]) + [area])
        elif kind == "volume":
            b = obj["boundary"]
            if b["type"] != "sphere":
                raise ValueError("the reference takes sphere-bounded volumes only")
            vol.append((b["center"], b["radius"], obj["density"], mid[obj["phase"]]))
            nee_ok = nee_ok and not emits[obj["phase"]]
        elif kind == "mesh":
            meshes.append(_mesh(obj, files, mid, f, device))
            nee_ok = (nee_ok and not (obj.get("material") and emits[obj["material"]])
                      and meshes[-1].textures[1] is None)
        else:
            raise ValueError(f"unknown object type {kind!r}")
    nee_ok = nee_ok and bool(lt_tri or lt_sph)

    def cols(items, k, width=None):
        vals = [it[k] for it in items]
        if not vals:
            return f(np.zeros((0, width) if width else (0,)))
        return f(vals)

    def ids(items, k):
        return torch.tensor([it[k] for it in items], dtype=torch.int64, device=device)

    return RefScene(
        camera=desc["camera"], mat_type=mat_type, mat_albedo=mat_albedo,
        mat_emission=mat_emission, mat_roughness=mat_roughness, mat_metallic=mat_metallic,
        mat_ior=mat_ior,
        spheres=(cols(sph, 0, 3), cols(sph, 1), ids(sph, 2)),
        planes=(cols(pln, 0, 3), cols(pln, 1, 3), ids(pln, 2)),
        triangles=(cols(tri, 0, 3), cols(tri, 1, 3), cols(tri, 2, 3), ids(tri, 3)),
        volumes=(cols(vol, 0, 3), cols(vol, 1), cols(vol, 2), ids(vol, 3)),
        meshes=meshes, lt_tri=f(np.asarray(lt_tri, np.float32).reshape(-1, 13)),
        lt_sph=f(np.asarray(lt_sph, np.float32).reshape(-1, 7)), nee_ok=nee_ok, dtype=dtype)


def transform_matrix(steps) -> np.ndarray:
    """The 4 × 4 float32 product of a list of [op, args...] steps
    (translate x y z, rotate_x/y/z degrees, scale s), leftmost outermost."""
    import math

    m = np.eye(4, dtype=np.float32)
    for op, *args in steps:
        s = np.eye(4, dtype=np.float32)
        if op == "translate":
            s[:3, 3] = args
        elif op == "scale":
            s[0, 0] = s[1, 1] = s[2, 2] = args[0]
        else:
            a = math.radians(args[0])
            c, n = math.cos(a), math.sin(a)
            i, j = {"rotate_x": (1, 2), "rotate_y": (2, 0), "rotate_z": (0, 1)}[op]
            s[i, i], s[i, j], s[j, i], s[j, j] = c, -n, n, c
        m = m @ s
    return m


def _mesh(obj: dict, files: dict, mid: dict, f, device) -> Mesh:
    pos, nrm, tex, idx, has_uv = parse_obj(files[obj["obj"]])
    if obj.get("material") is None and not has_uv:
        raise ValueError("a mesh without a material needs texcoords")
    verts = pos[idx]
    uvs = tex[idx]
    p1, p2, p3 = verts[:, 0], verts[:, 1], verts[:, 2]
    u1, u2, u3 = uvs[:, 0, 0], uvs[:, 1, 0], uvs[:, 2, 0]
    v1, v2, v3 = uvs[:, 0, 1], uvs[:, 1, 1], uvs[:, 2, 1]
    denom = (u2 - u1) * (v3 - v1) - (v2 - v1) * (u3 - u1)
    with np.errstate(divide="ignore", invalid="ignore"):
        tangent = ((v3 - v1)[:, None] * (p2 - p1) - (v2 - v1)[:, None] * (p3 - p1)) / denom[:, None]
    xf = transform_matrix(obj.get("transform", []))
    inv = np.linalg.inv(xf).astype(np.float32)
    textures = []
    for slot in TEX_SLOTS:
        name = obj.get("textures", {}).get(slot)
        img = load_image(files[name]) if name else None
        textures.append(None if img is None else torch.as_tensor(np.array(img), device=device))
    tv = f(verts)
    lo, hi = verts.min(axis=(0, 1)), verts.max(axis=(0, 1))
    pad = 1e-3 + 1e-3 * np.abs(np.stack([lo, hi])).max(axis=0)
    return Mesh(a=tv[:, 0], e1=tv[:, 1] - tv[:, 0], e2=tv[:, 2] - tv[:, 0],
                box=f(np.stack([lo - pad, hi + pad])), normals=f(oct_roundtrip(nrm[idx])), uvs=f(uvs),
                tangent=f(tangent.astype(np.float32)), transform=f(xf), inv_transform=f(inv),
                normal_mat=f(inv[:3, :3].T.copy()),
                mat=mid[obj["material"]] if obj.get("material") else -1, textures=textures,
                bounds=verts.astype(np.float32))
