"""Midpoint subdivision of a triangle mesh up to a target triangle count.

The port's copy of tools/subdivide_teapot.py (`subdivide` and the target
logic of its `main`), writing the same OBJ text: positions, normals and
uvs are interpolated at edge midpoints (normals renormalized), so the
surface is unchanged and only the triangle count grows. It makes the
larger bench meshes, e.g. ~32k triangles from assets/teapot_6k.obj.

    python -m cs397raytracingsp22_tpu_torch.utils.subdivide SRC DST TARGET
"""

from __future__ import annotations

import os
import sys

import numpy as np

from cs397raytracingsp22_tpu_torch.utils import obj_loader


def subdivide(pos, nrm, uv, tris, select=None):
    """One 4:1 midpoint subdivision; `select` masks which triangles split
    (the others are kept). Returns the new (pos, nrm, uv, tris)."""
    pos = list(map(tuple, pos))
    nrm = list(map(tuple, nrm))
    uv = list(map(tuple, uv))
    midpoint_cache = {}

    def midpoint(a, b):
        k = (min(a, b), max(a, b))
        if k in midpoint_cache:
            return midpoint_cache[k]
        p = tuple((np.array(pos[a]) + np.array(pos[b])) / 2.0)
        nv = np.array(nrm[a]) + np.array(nrm[b])
        ln = np.linalg.norm(nv)
        nv = tuple(nv / ln) if ln > 0 else tuple(nv)
        t = tuple((np.array(uv[a]) + np.array(uv[b])) / 2.0)
        pos.append(p)
        nrm.append(nv)
        uv.append(t)
        idx = len(pos) - 1
        midpoint_cache[k] = idx
        return idx

    out = []
    for ti, (a, b, c) in enumerate(tris):
        if select is not None and not select[ti]:
            out.append((a, b, c))
            continue
        ab = midpoint(a, b)
        bc = midpoint(b, c)
        ca = midpoint(c, a)
        out += [(a, ab, ca), (ab, b, bc), (ca, bc, c), (ab, bc, ca)]
    return (
        np.asarray(pos, np.float64),
        np.asarray(nrm, np.float64),
        np.asarray(uv, np.float64),
        np.asarray(out, np.int64),
    )


def subdivide_to(src: str, target: int):
    """Whole 4:1 subdivisions while 4× the count stays within `target`,
    then a split of the largest triangles (+3 each) up to about `target`.
    Returns (pos, nrm, uv, tris)."""
    m = obj_loader.load_obj(src)
    pos, nrm, uv, tris = (
        m.positions.astype(np.float64), m.normals.astype(np.float64),
        m.texcoords.astype(np.float64), m.indices.astype(np.int64),
    )
    while tris.shape[0] * 4 <= target:
        pos, nrm, uv, tris = subdivide(pos, nrm, uv, tris)
    if tris.shape[0] < target:
        need = (target - tris.shape[0]) // 3
        a = pos[tris[:, 0]]
        e1 = pos[tris[:, 1]] - a
        e2 = pos[tris[:, 2]] - a
        area = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=1)
        thresh = np.partition(area, -need)[-need] if need else np.inf
        pos, nrm, uv, tris = subdivide(pos, nrm, uv, tris, area >= thresh)
    return pos, nrm, uv, tris


def write_obj(dst: str, src: str, pos, nrm, uv, tris) -> None:
    """Single-index OBJ (v/vt/vn + f), through a temporary file and an
    atomic rename so a concurrent reader never sees half a file."""
    os.makedirs(os.path.dirname(os.path.abspath(dst)), exist_ok=True)
    tmp = f"{dst}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        f.write(f"# teapot_6k: midpoint-subdivided {src} ({tris.shape[0]} tris)\n")
        for p in pos:
            f.write(f"v {p[0]:.6f} {p[1]:.6f} {p[2]:.6f}\n")
        for t in uv:
            f.write(f"vt {t[0]:.6f} {t[1]:.6f}\n")
        for v in nrm:
            f.write(f"vn {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        for a, b, c in tris + 1:
            f.write(f"f {a}/{a}/{a} {b}/{b}/{b} {c}/{c}/{c}\n")
    os.replace(tmp, dst)


def main(argv=None) -> int:
    src, dst, target = (argv if argv is not None else sys.argv[1:])[:3]
    pos, nrm, uv, tris = subdivide_to(src, int(target))
    write_obj(dst, src, pos, nrm, uv, tris)
    print(f"wrote {dst}: {pos.shape[0]} verts, {tris.shape[0]} tris")
    return 0


if __name__ == "__main__":
    sys.exit(main())
