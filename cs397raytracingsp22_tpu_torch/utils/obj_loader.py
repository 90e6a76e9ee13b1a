"""Wavefront OBJ loader with tobj-equivalent semantics.

The reference loads meshes via the `tobj` crate configured with
`single_index: true, triangulate: true` (geometry.rs:140-148). This loader
reproduces that behavior:

- polygon faces are fan-triangulated: (0, i, i+1) for i in 1..m-1;
- `single_index`: each distinct (position, texcoord, normal) index triple
  becomes one unified vertex, so positions/texcoords/normals are parallel
  arrays indexed by a single index buffer — exactly the layout
  `get_triangle_from_mesh`/`get_texcoords_from_mesh`/`get_normals_from_mesh`
  assume (geometry.rs:223-243);
- negative OBJ indices are relative to the current array end;
- missing texcoord/normal references fill zeros (the reference would panic
  indexing empty arrays; we validate instead — SURVEY.md §3.5.5).

MTL files are ignored (the reference only asserts they parse;
material data is never used — geometry.rs:150-151).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class ObjMesh:
    """Unified-index triangle mesh (tobj `Mesh` equivalent)."""

    positions: np.ndarray  # (V, 3) float32
    normals: np.ndarray  # (V, 3) float32 (zeros if the OBJ has no vn)
    texcoords: np.ndarray  # (V, 2) float32 (zeros if the OBJ has no vt)
    indices: np.ndarray  # (T, 3) int32
    has_normals: bool
    has_texcoords: bool

    @property
    def num_vertices(self) -> int:
        return int(self.positions.shape[0])

    @property
    def num_triangles(self) -> int:
        return int(self.indices.shape[0])


def _parse_index(token: str, n_v: int, n_vt: int, n_vn: int):
    """Parse one face token 'v', 'v/vt', 'v//vn', or 'v/vt/vn' → 0-based
    (v, vt, vn) with -1 for absent. Negative indices are relative."""
    parts = token.split("/")
    def conv(s: str, n: int) -> int:
        if not s:
            return -1
        i = int(s)
        return i - 1 if i > 0 else n + i

    v = conv(parts[0], n_v)
    vt = conv(parts[1], n_vt) if len(parts) > 1 else -1
    vn = conv(parts[2], n_vn) if len(parts) > 2 else -1
    return v, vt, vn


def load_obj(path: str, use_native: bool = True) -> ObjMesh:
    """Load the first model of an OBJ file (the reference assumes a single
    mesh per file, geometry.rs:155-157).

    Uses the C++ parser (utils/native.py) when available — same semantics,
    ~20× faster on the 32k-triangle sphere.obj — with this pure-Python
    implementation as both specification and fallback."""
    if use_native:
        from cs397raytracingsp22_tpu_torch.utils import native

        raw = native.obj_load(path) if native.available() else None
        if raw is not None:
            return ObjMesh(
                positions=raw["positions"],
                normals=raw["normals"],
                texcoords=raw["texcoords"],
                indices=raw["indices"],
                has_normals=raw["has_normals"],
                has_texcoords=raw["has_texcoords"],
            )
    positions: list[tuple] = []
    texcoords: list[tuple] = []
    normals: list[tuple] = []
    faces: list[list[tuple]] = []

    with open(path, "r", encoding="utf-8", errors="replace") as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            tag = parts[0]
            if tag == "v":
                positions.append(tuple(float(x) for x in parts[1:4]))
            elif tag == "vt":
                # OBJ vt may have 1-3 components; keep (u, v).
                u = float(parts[1])
                v = float(parts[2]) if len(parts) > 2 else 0.0
                texcoords.append((u, v))
            elif tag == "vn":
                normals.append(tuple(float(x) for x in parts[1:4]))
            elif tag == "f":
                corners = [
                    _parse_index(t, len(positions), len(texcoords), len(normals))
                    for t in parts[1:]
                ]
                # drop corners with a missing/out-of-range position index
                # instead of letting v = -1 wrap to pos_arr[-1] (a phantom
                # triangle at the file's last vertex); out-of-range vt/vn
                # degrade to absent — same skips the native parser applies
                # (rt_native.cpp parse_corner + bounds checks)
                corners = [
                    (
                        v,
                        vt if 0 <= vt < len(texcoords) else -1,
                        vn if 0 <= vn < len(normals) else -1,
                    )
                    for (v, vt, vn) in corners
                    if 0 <= v < len(positions)
                ]
                if len(corners) >= 3:
                    faces.append(corners)

    has_vt = len(texcoords) > 0
    has_vn = len(normals) > 0
    pos_arr = np.asarray(positions, np.float32).reshape(-1, 3)
    vt_arr = np.asarray(texcoords, np.float32).reshape(-1, 2)
    vn_arr = np.asarray(normals, np.float32).reshape(-1, 3)

    # single_index unification
    triple_to_unified: dict[tuple, int] = {}
    out_pos: list[np.ndarray] = []
    out_vt: list[np.ndarray] = []
    out_vn: list[np.ndarray] = []
    tri_indices: list[tuple] = []

    def unify(triple: tuple) -> int:
        idx = triple_to_unified.get(triple)
        if idx is not None:
            return idx
        v, vt, vn = triple
        idx = len(out_pos)
        triple_to_unified[triple] = idx
        out_pos.append(pos_arr[v])
        out_vt.append(vt_arr[vt] if vt >= 0 else np.zeros(2, np.float32))
        out_vn.append(vn_arr[vn] if vn >= 0 else np.zeros(3, np.float32))
        return idx

    for corners in faces:
        # fan triangulation (tobj `triangulate: true`)
        unified = [unify(c) for c in corners]
        for i in range(1, len(corners) - 1):
            tri_indices.append((unified[0], unified[i], unified[i + 1]))

    return ObjMesh(
        positions=np.stack(out_pos) if out_pos else np.zeros((0, 3), np.float32),
        normals=np.stack(out_vn) if out_vn else np.zeros((0, 3), np.float32),
        texcoords=np.stack(out_vt) if out_vt else np.zeros((0, 2), np.float32),
        indices=np.asarray(tri_indices, np.int32).reshape(-1, 3),
        has_normals=has_vn,
        has_texcoords=has_vt,
    )
