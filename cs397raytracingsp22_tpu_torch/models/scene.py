"""Scene description → flat tables on a torch device.

Mirrors `cs397raytracingsp22_tpu/models/scene.py` for spheres, planes,
standalone triangles, sphere-bounded volumes and meshes with an explicit
material. Meshes within the dense budget feed the dense scans of the
mega-bounce and scene-intersection kernels; every mesh also carries its
threaded BVH (the node arrays of ops/bvh.py::FlatBVH) for the traversal
of meshes beyond that budget. The tables are built with the same numpy
arithmetic, so they equal the JAX package's bit for bit. Textured meshes
and general-boundary volumes raise NotImplementedError: they are a later
slice of the staged path.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple, Union

import numpy as np
import torch

from cs397raytracingsp22_tpu_torch.models.camera import Camera
from cs397raytracingsp22_tpu_torch.models.geometry import (
    ConvexVolume,
    Plane,
    Sphere,
    StaticMesh,
    Triangle,
)
from cs397raytracingsp22_tpu_torch.models.materials import MaterialTableBuilder
from cs397raytracingsp22_tpu_torch.ops import bvh as bvhlib

SceneObject = Union[Sphere, Triangle, Plane, ConvexVolume, StaticMesh]

_STAGED = ("not ported yet (a later slice of the staged path: textures and "
           "general-boundary volumes)")


def _to(x, device):
    return x.to(device) if torch.is_tensor(x) else x


def resolve_device(device) -> torch.device:
    """torch.device(device), refusing a CUDA device on a machine without
    one (nothing falls back to the CPU: pass device="cpu" for that)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card by default; pass device='cpu' "
            "to run its plain torch version on the CPU"
        )
    return device


@dataclasses.dataclass
class MeshBlock:
    """One compiled StaticMesh, triangles in BVH order, with its threaded
    BVH (ops/bvh.py::FlatBVH node arrays; leaves index tri_verts rows)."""

    tri_verts: torch.Tensor  # (NT, 3, 3) object-space corners
    tri_table: torch.Tensor  # (NT, 9) [a, b-a, c-a]
    tri_normals: torch.Tensor  # (NT, 3, 3) corner normals, oct-quantized
    transform: torch.Tensor  # (4, 4)
    inv_transform: torch.Tensor  # (4, 4)
    normal_mat: torch.Tensor  # (3, 3) = inv_transform[:3,:3].T
    bounds_min: torch.Tensor  # (NN, 3) node AABB
    bounds_max: torch.Tensor  # (NN, 3)
    skip: torch.Tensor  # (NN,) int32 next node on an AABB miss (NN = done)
    leaf_start: torch.Tensor  # (NN,) int32 first row of a leaf; -1 interior
    leaf_count: torch.Tensor  # (NN,) int32
    mat_id: int
    leaf_size: int

    def to(self, device) -> "MeshBlock":
        return dataclasses.replace(
            self,
            **{f.name: _to(getattr(self, f.name), device) for f in dataclasses.fields(self)},
        )


@dataclasses.dataclass
class SceneData:
    """Compiled scene: tensors plus static counts. Every table has at
    least one (inert) row; the counts mask the padding."""

    mat_type: torch.Tensor
    mat_albedo: torch.Tensor
    mat_emission: torch.Tensor
    mat_roughness: torch.Tensor
    mat_metallic: torch.Tensor
    mat_ior: torch.Tensor
    sph_center: torch.Tensor
    sph_radius: torch.Tensor
    sph_mat: torch.Tensor
    pln_point: torch.Tensor
    pln_normal: torch.Tensor
    pln_mat: torch.Tensor
    tri_a: torch.Tensor
    tri_b: torch.Tensor
    tri_c: torch.Tensor
    tri_mat: torch.Tensor
    vol_center: torch.Tensor
    vol_radius: torch.Tensor
    vol_density: torch.Tensor
    vol_mat: torch.Tensor
    meshes: Tuple[MeshBlock, ...]
    # kernel tables: spheres (S,4)=[c,r], planes (P,6)=[p,n], standalone
    # tris (T,12)=[a,e1,e2,geo_n], volumes (V,5)=[c,r,-1/rho],
    # concatenated dense triangles (TT,9)=[a,e1,e2], superleaf AABBs
    # (NSL,6) over 16 consecutive rows, epsilon-padded
    ksph_f: torch.Tensor
    ksph_m: torch.Tensor
    kpln_f: torch.Tensor
    kpln_m: torch.Tensor
    ktri_f: torch.Tensor
    ktri_m: torch.Tensor
    kvol_f: torch.Tensor
    kvol_m: torch.Tensor
    kmesh_tri: torch.Tensor
    ksl_bounds: torch.Tensor
    # the mega-bounce kernel's packed tables (pack_kernel_tables)
    kscene: torch.Tensor
    kmesh_nrm: torch.Tensor
    n_spheres: int
    n_planes: int
    n_tris: int
    n_volumes: int
    kmesh_ranges: Tuple[Tuple[int, int], ...]  # per dense mesh: (first row, padded count)
    ksl_ranges: Tuple[Tuple[int, int], ...]  # per dense mesh: (first superleaf, count)
    dense_mesh_ids: Tuple[int, ...]
    mat_types_present: Tuple[int, ...] = (0, 1, 2, 3, 4)

    @property
    def device(self) -> torch.device:
        return self.mat_type.device

    def to(self, device) -> "SceneData":
        out = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if f.name == "meshes":
                v = tuple(m.to(device) for m in v)
            out[f.name] = _to(v, device)
        return SceneData(**out)


@dataclasses.dataclass(frozen=True)
class Scene:
    """User-facing scene (reference tracing.rs:213-218)."""

    camera: Camera
    objects: Sequence[SceneObject]
    point_light_pos: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    ambient: Tuple[float, float, float] = (0.0, 0.0, 0.0)

    def compile(self, leaf_size: int = 4, device="cuda") -> SceneData:
        return compile_scene(self, leaf_size=leaf_size, device=device)


def _pad_rows(arr: np.ndarray, min_rows: int, fill: float) -> np.ndarray:
    if arr.shape[0] >= min_rows:
        return arr
    pad_shape = (min_rows - arr.shape[0],) + arr.shape[1:]
    return np.concatenate([arr, np.full(pad_shape, fill, arr.dtype)], axis=0)


def _oct_encode(n: np.ndarray) -> np.ndarray:
    """Octahedral-encode directions: (N, 3) → (N,) uint32 holding two
    16-bit snorm components (lo = u, hi = v)."""
    v = n.astype(np.float64)
    norm = np.linalg.norm(v, axis=-1, keepdims=True)
    v = v / np.where(norm > 0, norm, 1.0)
    l1 = np.abs(v).sum(axis=-1, keepdims=True)
    p = v[..., :2] / np.where(l1 > 0, l1, 1.0)
    neg = v[..., 2] < 0.0
    flip = (1.0 - np.abs(p[..., ::-1])) * np.where(p >= 0.0, 1.0, -1.0)
    p = np.where(neg[..., None], flip, p)
    q = np.round(np.clip(p, -1.0, 1.0) * 32767.0).astype(np.int64) + 32767
    return (q[..., 0] | (q[..., 1] << 16)).astype(np.uint32)


def _oct_decode(packed: np.ndarray) -> np.ndarray:
    """Decode _oct_encode output to unit float32 vectors; every path
    consumes these decoded values."""
    w = packed.astype(np.int64)
    fu = ((w & 0xFFFF) - 32767).astype(np.float32) * np.float32(1.0 / 32767.0)
    fv = (((w >> 16) & 0xFFFF) - 32767).astype(np.float32) * np.float32(1.0 / 32767.0)
    z = np.float32(1.0) - np.abs(fu) - np.abs(fv)
    t = np.maximum(-z, np.float32(0.0))
    x = fu + np.where(fu >= 0.0, -t, t)
    y = fv + np.where(fv >= 0.0, -t, t)
    v = np.stack([x, y, z], axis=-1).astype(np.float32)
    n = np.sqrt((v.astype(np.float32) ** 2).sum(axis=-1, keepdims=True))
    return (v / np.maximum(n, np.float32(1e-30))).astype(np.float32)


def baldwin_weber_rows(verts: np.ndarray) -> np.ndarray:
    """Per-triangle Baldwin–Weber intersection rows (T, 12) float32 from
    verts (T, 3, 3), built in float64 (the JAX package's
    models/scene.py::_baldwin_weber_rows).

    For triangle (a, b, c) with e1 = b-a, e2 = c-a, n = e1×e2:
      row = [n(3), n·a, ū(3), -ū·a, v̄(3), -v̄·a]
    where ū = (e2×n)/|n|² and v̄ = (n×e1)/|n|², so for a hit point P the
    barycentrics u = ū·P - ū·a and v = v̄·P - v̄·a are Möller–Trumbore's,
    and t = (n·a − n·o)/(n·d) with |n·d| = |MT det|. Degenerate (zero-area)
    triangles get all-zero rows: n·d = 0 is rejected. No render path reads
    these rows yet; the Baldwin–Weber scan probe (csrc/bw_scan.cu) does.
    """
    v = verts.astype(np.float64)
    a, b, c = v[:, 0], v[:, 1], v[:, 2]
    e1 = b - a
    e2 = c - a
    n = np.cross(e1, e2)
    n2 = np.sum(n * n, axis=-1, keepdims=True)
    ok = n2 > 0.0
    inv_n2 = np.where(ok, 1.0 / np.where(ok, n2, 1.0), 0.0)
    u_row = np.cross(e2, n) * inv_n2
    v_row = np.cross(n, e1) * inv_n2
    n = np.where(ok, n, 0.0)
    rows = np.concatenate(
        [
            n,
            np.sum(n * a, axis=-1, keepdims=True),
            u_row,
            -np.sum(u_row * a, axis=-1, keepdims=True),
            v_row,
            -np.sum(v_row * a, axis=-1, keepdims=True),
        ],
        axis=1,
    )
    return rows.astype(np.float32)


def _compile_mesh(sm: StaticMesh, mats: MaterialTableBuilder, leaf_size: int) -> dict:
    if any(t is not None for t in sm.textures) or sm.material is None:
        raise NotImplementedError(f"textured StaticMesh: {_STAGED}")
    mesh = sm.mesh
    idx = mesh.indices
    verts = mesh.positions[idx]
    normals = mesh.normals[idx]
    flat = bvhlib.build_bvh(verts, leaf_size=leaf_size)
    order = flat.tri_order
    rv = verts[order]
    tri_table = np.concatenate(
        [rv[:, 0], rv[:, 1] - rv[:, 0], rv[:, 2] - rv[:, 0]], axis=1
    ).astype(np.float32)
    noct = _oct_encode(normals[order].astype(np.float64))
    return dict(
        tri_verts=rv.astype(np.float32),
        tri_table=tri_table,
        tri_normals=_oct_decode(noct),
        transform=np.asarray(sm.transform, np.float32),
        inv_transform=np.asarray(sm.inv_transform, np.float32),
        normal_mat=np.asarray(sm.inv_transform[:3, :3].T, np.float32).copy(),
        bounds_min=flat.bounds_min,
        bounds_max=flat.bounds_max,
        skip=flat.skip,
        leaf_start=flat.leaf_start,
        leaf_count=flat.leaf_count,
        leaf_size=leaf_size,
        mat_id=mats.add(sm.material),
    )


def compile_scene(scene: Scene, leaf_size: int = 4, device="cuda") -> SceneData:
    """Lower a Scene into tables (numpy on the host), then onto `device`
    (the card by default)."""
    mats = MaterialTableBuilder()
    sph_center, sph_radius, sph_mat = [], [], []
    pln_point, pln_normal, pln_mat = [], [], []
    tri_a, tri_b, tri_c, tri_mat = [], [], [], []
    vol_center, vol_radius, vol_density, vol_mat = [], [], [], []
    mesh_blocks: list[dict] = []

    for obj in scene.objects:
        if isinstance(obj, Sphere):
            sph_center.append(obj.center)
            sph_radius.append(obj.radius)
            sph_mat.append(mats.add(obj.material))
        elif isinstance(obj, Plane):
            pln_point.append(obj.point)
            pln_normal.append(obj.normal)
            pln_mat.append(mats.add(obj.material))
        elif isinstance(obj, Triangle):
            tri_a.append(obj.a)
            tri_b.append(obj.b)
            tri_c.append(obj.c)
            tri_mat.append(mats.add(obj.material))
        elif isinstance(obj, ConvexVolume):
            if not isinstance(obj.boundary, Sphere):
                raise NotImplementedError(
                    f"ConvexVolume with a {type(obj.boundary).__name__} boundary: {_STAGED}"
                )
            vol_center.append(obj.boundary.center)
            vol_radius.append(obj.boundary.radius)
            vol_density.append(obj.density)
            vol_mat.append(mats.add(obj.phase_function))
        elif isinstance(obj, StaticMesh):
            mesh_blocks.append(_compile_mesh(obj, mats, leaf_size))
        else:
            raise TypeError(f"unsupported scene object {type(obj)!r}")

    table = mats.build()

    def f32(rows, width=None, fill=0.0):
        if rows:
            a = np.asarray(rows, np.float32)
        else:
            a = np.zeros((0, width) if width else (0,), np.float32)
        return _pad_rows(a, 1, fill)

    def i32(rows):
        a = np.asarray(rows, np.int32) if rows else np.zeros((0,), np.int32)
        return _pad_rows(a, 1, 0).astype(np.int32)

    def np_pad(rows, width, fill=0.0):
        a = (
            np.asarray(rows, np.float32).reshape(-1, width)
            if rows
            else np.zeros((0, width), np.float32)
        )
        return _pad_rows(a, 1, fill)

    sph_np = np_pad([tuple(c) + (r,) for c, r in zip(sph_center, sph_radius)], 4, 0.0)
    sph_np[len(sph_center):, :3] = 1e30  # inert padding
    pln_np = np_pad([tuple(p) + tuple(n) for p, n in zip(pln_point, pln_normal)], 6, 0.0)
    if tri_a:
        a_np = np.asarray(tri_a, np.float32)
        e1_np = np.asarray(tri_b, np.float32) - a_np
        e2_np = np.asarray(tri_c, np.float32) - a_np
        gn = np.cross(e1_np, e2_np)
        gn = gn / np.maximum(np.linalg.norm(gn, axis=1, keepdims=True), 1e-30)
        tri_np = np.concatenate([a_np, e1_np, e2_np, gn], axis=1).astype(np.float32)
    else:
        tri_np = np.zeros((1, 12), np.float32)
    # col 4 = -1/rho; rho = 0 never scatters (-inf·ln(u<1) = +inf)
    vol_np = np_pad(
        [
            tuple(c) + (r, -1.0 / rho if rho > 0 else float("-inf"))
            for c, r, rho in zip(vol_center, vol_radius, vol_density)
        ],
        5,
        0.0,
    )
    vol_np[len(vol_center):, :3] = 1e30

    # DENSE_MESH_MAX_TRIS bounds each dense mesh and their total; the
    # smallest meshes are admitted first, as in the JAX package, and every
    # mesh left over is a big mesh, traversed through its BVH
    cand = sorted(
        (i for i, m in enumerate(mesh_blocks)
         if m["tri_verts"].shape[0] <= bvhlib.DENSE_MESH_MAX_TRIS),
        key=lambda i: int(mesh_blocks[i]["tri_verts"].shape[0]),
    )
    chosen, total = [], 0
    for i in cand:
        nt_pad = (int(mesh_blocks[i]["tri_verts"].shape[0]) + 15) // 16 * 16
        if total + nt_pad > bvhlib.DENSE_MESH_MAX_TRIS:
            break
        chosen.append(i)
        total += nt_pad
    dense_ids = tuple(sorted(chosen))

    ranges, real_counts, tables = [], [], []
    cursor = 0
    for mi in dense_ids:
        m = mesh_blocks[mi]
        # each mesh padded to a multiple of 16 rows; zero rows are inert
        # (MT det = 0 is rejected by the epsilon test)
        nt = int(m["tri_table"].shape[0])
        nt_pad = (nt + 15) // 16 * 16
        tables.append(_pad_rows(m["tri_table"], nt_pad, 0.0))
        ranges.append((cursor, nt_pad))
        real_counts.append(nt)
        cursor += nt_pad
    kmesh_tri = (
        np.concatenate(tables, axis=0).astype(np.float32) if tables
        else np.zeros((1, 9), np.float32)
    )

    # superleaf AABBs over 16 consecutive rows (sibling BVH leaves), from
    # the real rows only: zero padding rows would pull a box to the origin
    SL = 16
    sl_bounds, sl_ranges = [], []
    for (start, count), real in zip(ranges, real_counts):
        first = len(sl_bounds)
        for s0 in range(0, count, SL):
            rows = kmesh_tri[start + s0 : start + min(s0 + SL, real)]
            sl_bounds.append(bvhlib.tri_rows_aabb(rows))
        sl_ranges.append((first, len(sl_bounds) - first))
    ksl_bounds = (
        np.stack(sl_bounds).astype(np.float32) if sl_bounds
        else np.zeros((1, 6), np.float32)
    )

    arrays = dict(
        mat_type=table["mat_type"],
        mat_albedo=table["mat_albedo"],
        mat_emission=table["mat_emission"],
        mat_roughness=table["mat_roughness"],
        mat_metallic=table["mat_metallic"],
        mat_ior=table["mat_ior"],
        sph_center=f32(sph_center, 3, 1e30),
        sph_radius=f32(sph_radius, None, 0.0),
        sph_mat=i32(sph_mat),
        pln_point=f32(pln_point, 3, 0.0),
        pln_normal=f32(pln_normal, 3, 0.0),
        pln_mat=i32(pln_mat),
        tri_a=f32(tri_a, 3, 0.0),
        tri_b=f32(tri_b, 3, 0.0),
        tri_c=f32(tri_c, 3, 0.0),
        tri_mat=i32(tri_mat),
        vol_center=f32(vol_center, 3, 1e30),
        vol_radius=f32(vol_radius, None, 0.0),
        vol_density=f32(vol_density, None, 1.0),
        vol_mat=i32(vol_mat),
        meshes=mesh_blocks,
        ksph_f=sph_np,
        ksph_m=i32(sph_mat),
        kpln_f=pln_np,
        kpln_m=i32(pln_mat),
        ktri_f=tri_np,
        ktri_m=i32(tri_mat),
        kvol_f=vol_np,
        kvol_m=i32(vol_mat),
        kmesh_tri=kmesh_tri,
        ksl_bounds=ksl_bounds,
    )
    meta = dict(
        n_spheres=len(sph_center),
        n_planes=len(pln_point),
        n_tris=len(tri_a),
        n_volumes=len(vol_center),
        kmesh_ranges=tuple(ranges),
        ksl_ranges=tuple(sl_ranges),
        dense_mesh_ids=dense_ids,
        mat_types_present=tuple(sorted({int(x) for x in table["mat_type"]})),
        mesh_mat_ids=[m["mat_id"] for m in mesh_blocks],
    )
    return scene_data_from_numpy(arrays, meta, device=device)


_MESH_ARRAYS = ("tri_verts", "tri_table", "tri_normals", "transform", "inv_transform",
                "normal_mat", "bounds_min", "bounds_max", "skip", "leaf_start", "leaf_count")
_STATIC = ("n_spheres", "n_planes", "n_tris", "n_volumes", "kmesh_ranges",
           "ksl_ranges", "dense_mesh_ids", "mat_types_present")
PACKED = ("kscene", "kmesh_nrm")  # built by pack_kernel_tables, never passed in


def pack_kernel_tables(arrays: dict, meta: dict) -> tuple[np.ndarray, np.ndarray]:
    """The mega-bounce kernel's tables (csrc/bounce.cu), from host arrays
    laid out as for scene_data_from_numpy.

    kscene: one flat float32 table that the kernel stages into shared
    memory — spheres [c, r, mat], planes [p, n, mat], triangles [a, e1,
    e2, mat], volumes [c, r, density, mat], materials [type, albedo,
    emission, roughness, metallic, ior] and one row per dense mesh
    [inverse R, inverse t, normal matrix, R, t, mat, first row, rows,
    first superleaf, superleaves] (ids and counts are exact in float32).
    kmesh_nrm: (TT, 9) decoded corner normals of the kmesh_tri rows, zero
    on padding rows. The kernel reads kmesh_tri and ksl_bounds as they are.
    """
    ns, npl, nt, nv = (int(meta[k]) for k in ("n_spheres", "n_planes", "n_tris", "n_volumes"))

    def f(x):
        return np.asarray(x, np.float32)

    def col(x):
        return f(x).reshape(-1, 1)

    a = arrays
    rows = [
        np.concatenate([f(a["ksph_f"])[:ns], col(a["ksph_m"])[:ns]], 1),
        np.concatenate([f(a["kpln_f"])[:npl], col(a["kpln_m"])[:npl]], 1),
        np.concatenate([f(a["ktri_f"])[:nt, :9], col(a["ktri_m"])[:nt]], 1),
        np.concatenate([f(a["vol_center"])[:nv], col(a["vol_radius"])[:nv],
                        col(a["vol_density"])[:nv], col(a["vol_mat"])[:nv]], 1),
        np.concatenate([col(a["mat_type"]), f(a["mat_albedo"]), f(a["mat_emission"]),
                        col(a["mat_roughness"]), col(a["mat_metallic"]), col(a["mat_ior"])], 1),
    ]
    kmesh_nrm = np.zeros(np.shape(a["kmesh_tri"]), np.float32)
    for k, mi in enumerate(meta["dense_mesh_ids"]):
        m = a["meshes"][mi]
        start, count = meta["kmesh_ranges"][k]
        sl_first, sl_count = meta["ksl_ranges"][k]
        inv, fwd = f(m["inv_transform"]), f(m["transform"])
        rows.append(np.concatenate([
            inv[:3, :3].reshape(-1), inv[:3, 3], f(m["normal_mat"]).reshape(-1),
            fwd[:3, :3].reshape(-1), fwd[:3, 3],
            f([meta["mesh_mat_ids"][mi], start, count, sl_first, sl_count]),
        ])[None, :])
        tn = f(m["tri_normals"]).reshape(-1, 9)
        kmesh_nrm[start:start + tn.shape[0]] = tn
    kscene = np.concatenate([r.reshape(-1) for r in rows]).astype(np.float32)
    return kscene, kmesh_nrm


def scene_data_from_numpy(arrays: dict, meta: dict, device="cuda") -> SceneData:
    """Build a SceneData from host arrays — `compile_scene`'s own, or the
    leaves of the JAX package's compiled SceneData as numpy, so that both
    packages run the same tables — and move it onto `device`.

    arrays: every tensor field of SceneData except `meshes` and the
      kernel's packed tables (PACKED, built here), plus "meshes": a list of
      dicts holding the MeshBlock array fields and "leaf_size".
    meta: the static counts (n_spheres, n_planes, n_tris, n_volumes,
      kmesh_ranges, ksl_ranges, dense_mesh_ids, mat_types_present) and
      "mesh_mat_ids", one material id per mesh.
    `device` is the card unless the caller asks for the CPU.
    Raises NotImplementedError for what `compile_scene` also refuses.
    """
    mesh_mat_ids = list(meta["mesh_mat_ids"])
    if any(m < 0 for m in mesh_mat_ids):
        raise NotImplementedError(f"texture-synthesized mesh material: {_STAGED}")
    device = resolve_device(device)

    def t(x):
        return torch.from_numpy(np.array(x)).to(device)  # a writable copy

    meshes = tuple(
        MeshBlock(**{k: t(m[k]) for k in _MESH_ARRAYS}, mat_id=int(mid),
                  leaf_size=int(m["leaf_size"]))
        for m, mid in zip(arrays["meshes"], mesh_mat_ids)
    )
    kscene, kmesh_nrm = pack_kernel_tables(arrays, meta)
    fields = {"meshes": meshes, "kscene": t(kscene), "kmesh_nrm": t(kmesh_nrm)}
    for f in dataclasses.fields(SceneData):
        if f.name in fields:
            continue
        if f.name in _STATIC:
            v = meta[f.name]
            fields[f.name] = tuple(tuple(x) for x in v) if f.name.endswith("ranges") else (
                tuple(v) if isinstance(v, (tuple, list)) else int(v)
            )
        else:
            fields[f.name] = t(arrays[f.name])
    return SceneData(**fields)
