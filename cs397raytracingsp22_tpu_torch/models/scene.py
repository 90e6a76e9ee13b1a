"""Scene description → flat tables on a torch device.

Mirrors `cs397raytracingsp22_tpu/models/scene.py`: spheres, planes,
standalone triangles, sphere-bounded volumes, general-boundary volumes
(a Triangle or StaticMesh boundary lowered to world-space triangle rows),
and meshes with an explicit material or one synthesized from their
textures, with texcoords, per-triangle tangents and the scene's packed
texture atlas. Meshes within the dense budget feed the dense scans of the
mega-bounce and scene-intersection kernels; every mesh also carries its
threaded BVH (the node arrays of ops/bvh.py::FlatBVH) for the traversal
of meshes beyond that budget. The tables are built with the same numpy
arithmetic, so they equal the JAX package's bit for bit (a triangle whose
uv determinant is 0 gets the reference's non-finite tangent in both).

The compile also extracts the lights that next-event estimation samples
(render/nee.py): every emissive standalone Triangle and Sphere, with
`nee_ok` False where another object emits (a plane, a mesh, a mesh with
an emission texture, a medium) or nothing does. Phong shading's point
light and ambient term ride along.
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
from cs397raytracingsp22_tpu_torch.utils import profiling
from cs397raytracingsp22_tpu_torch.utils.texture import TextureAtlasBuilder

SceneObject = Union[Sphere, Triangle, Plane, ConvexVolume, StaticMesh]


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
    BVH (ops/bvh.py::FlatBVH node arrays; leaves index tri_verts rows) and
    the kernels' packed copies of both (mesh_kernel_tables)."""

    tri_verts: torch.Tensor  # (NT, 3, 3) object-space corners
    tri_table: torch.Tensor  # (NT, 9) [a, b-a, c-a]
    tri_normals: torch.Tensor  # (NT, 3, 3) corner normals, oct-quantized
    tri_uvs: torch.Tensor  # (NT, 3, 2) corner texcoords
    tri_tangent: torch.Tensor  # (NT, 3) per-triangle tangent (non-finite where the uv det is 0)
    transform: torch.Tensor  # (4, 4)
    inv_transform: torch.Tensor  # (4, 4)
    normal_mat: torch.Tensor  # (3, 3) = inv_transform[:3,:3].T
    bounds_min: torch.Tensor  # (NN, 3) node AABB
    bounds_max: torch.Tensor  # (NN, 3)
    skip: torch.Tensor  # (NN,) int32 next node on an AABB miss (NN = done)
    leaf_start: torch.Tensor  # (NN,) int32 first row of a leaf; -1 interior
    leaf_count: torch.Tensor  # (NN,) int32
    bvh_nodes: torch.Tensor  # (NI + 1, 16) child-pair rows (ops/bvh.py::pack_bvh)
    bvh_tri4: torch.Tensor  # (NT, 12) tri_verts as [a, e1, e2, 0, 0, 0]
    tri_table4: torch.Tensor  # (NT, 12) tri_table rows and three zeros
    mat_id: int  # -1: the material is synthesized from the textures
    # atlas ids of [albedo, emission, metallic, roughness, normal], -1 unbound
    tex_ids: Tuple[int, ...]
    has_uv: bool
    leaf_size: int
    bvh_depth: int  # bvh_nodes' deepest leaf: the ordered walk's stack

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
    # general-boundary volumes: per volume its world-space boundary rows
    # (T, 9) = [a, e1, e2]
    gvol_tri: Tuple[torch.Tensor, ...]
    gvol_density: torch.Tensor
    gvol_mat: torch.Tensor
    meshes: Tuple[MeshBlock, ...]
    # texture atlas (utils/texture.py): (P, 3) uint8 pixels, (T,) int32 each
    tex_pixels: torch.Tensor
    tex_offset: torch.Tensor
    tex_width: torch.Tensor
    tex_height: torch.Tensor
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
    ksl_tree: torch.Tensor
    kmesh_tri4: torch.Tensor
    # the sphere tree that K1 walks in place of its sphere scan, one inert
    # row below SPHERE_TREE_MIN spheres (sphere_tree)
    ksph_tree: torch.Tensor
    # the staged path's merged mesh resolve (pack_kernel_tables): per
    # triangle of every mesh in resolve order [corner normals, corner uvs,
    # tangent] (ΣT, 18), per mesh [normal matrix, R, t, inverse R, inverse
    # t, first kmesh_res row, triangles, material id] (M, 36) and the int32
    # atlas [offset, width, height] of each texture slot (M, 15)
    kmesh_res: torch.Tensor
    kmesh_xfm: torch.Tensor
    kmesh_tex: torch.Tensor
    # Phong's point light and ambient term, (3,) each
    point_light_pos: torch.Tensor
    ambient: torch.Tensor
    # NEE's sampled lights: triangles (L, 13) = [a, e1, e2, emission,
    # area], spheres (L, 7) = [c, r, emission]
    lt_tri: torch.Tensor
    lt_sph: torch.Tensor
    n_spheres: int
    n_planes: int
    n_tris: int
    n_volumes: int
    n_gvols: int
    gvol_eps: Tuple[float, ...]  # per general volume: 1e-4·|det M|, its world-space MT epsilon
    kmesh_ranges: Tuple[Tuple[int, int], ...]  # per dense mesh: (first row, padded count)
    ksl_ranges: Tuple[Tuple[int, int], ...]  # per dense mesh: (first superleaf, count)
    dense_mesh_ids: Tuple[int, ...]
    mat_types_present: Tuple[int, ...] = (0, 1, 2, 3, 4)
    n_lt_tri: int = 0
    n_lt_sph: int = 0
    # every emitter is a sampled light (and there is one): NEE is exact
    nee_ok: bool = False

    @property
    def device(self) -> torch.device:
        return self.mat_type.device

    @property
    def sph_tree_leaves(self) -> int:
        """Leaves of the sphere tree (ksph_tree), 0 when there is none."""
        return sphere_tree_leaves(self.n_spheres)

    def to(self, device) -> "SceneData":
        out = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if f.name == "meshes":
                v = tuple(m.to(device) for m in v)
            elif f.name == "gvol_tri":
                v = tuple(x.to(device) for x in v)
            out[f.name] = _to(v, device)
        return SceneData(**out)


@dataclasses.dataclass(frozen=True)
class Scene:
    """User-facing scene (reference tracing.rs:213-218)."""

    camera: Camera
    objects: Sequence[SceneObject]
    point_light_pos: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    ambient: Tuple[float, float, float] = (0.0, 0.0, 0.0)

    def compile(self, leaf_size: int = 4, device="cuda",
                dense_max_tris: int = bvhlib.DENSE_MESH_MAX_TRIS) -> SceneData:
        return compile_scene(self, leaf_size=leaf_size, device=device,
                             dense_max_tris=dense_max_tris)


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


def _boundary_tri_table(boundary) -> tuple[np.ndarray, float]:
    """A general ConvexVolume boundary (a Triangle or a StaticMesh) as
    world-space rows (T, 9) = [a, e1, e2] for the entry/exit scan, and the
    volume's world-space Möller–Trumbore epsilon (models/scene.py:279 in
    the JAX package).

    A mesh's triangles are transformed to world space: the reference
    intersects the boundary in its object space with |det| >= 1e-4
    (geometry.rs:335), and det scales by det(M) under the linear part M of
    the transform, so 1e-4·|det M| keeps its accept set."""
    if isinstance(boundary, Triangle):
        a = np.asarray(boundary.a, np.float32)
        rows = np.concatenate([a, np.asarray(boundary.b, np.float32) - a,
                               np.asarray(boundary.c, np.float32) - a]).reshape(1, 9)
        return rows, bvhlib.MT_EPSILON
    if isinstance(boundary, StaticMesh):
        m = np.asarray(boundary.transform, np.float64)
        pos_w = boundary.mesh.positions.astype(np.float64) @ m[:3, :3].T + m[:3, 3]
        tri = pos_w[boundary.mesh.indices]  # (T, 3, 3)
        a = tri[:, 0]
        rows = np.concatenate([a, tri[:, 1] - a, tri[:, 2] - a], axis=1).astype(np.float32)
        return rows, bvhlib.MT_EPSILON * float(abs(np.linalg.det(m[:3, :3])))
    raise TypeError(f"unsupported ConvexVolume boundary {type(boundary)!r} "
                    "(Sphere, Triangle and StaticMesh are supported)")


def _compile_mesh(sm: StaticMesh, mats: MaterialTableBuilder, atlas: TextureAtlasBuilder,
                  leaf_size: int) -> dict:
    mesh = sm.mesh
    idx = mesh.indices
    verts = mesh.positions[idx]
    normals = mesh.normals[idx]
    uvs = mesh.texcoords[idx]  # (NT, 3, 2)
    # per-triangle tangent (geometry.rs:245-250):
    # ((v3-v1)(p2-p1) - (v2-v1)(p3-p1)) / ((u2-u1)(v3-v1) - (v2-v1)(u3-u1)),
    # inf or NaN where the uv determinant is 0, as in the reference
    p1, p2, p3 = verts[:, 0], verts[:, 1], verts[:, 2]
    u1, u2, u3 = uvs[:, 0, 0], uvs[:, 1, 0], uvs[:, 2, 0]
    v1, v2, v3 = uvs[:, 0, 1], uvs[:, 1, 1], uvs[:, 2, 1]
    denom = (u2 - u1) * (v3 - v1) - (v2 - v1) * (u3 - u1)
    with np.errstate(divide="ignore", invalid="ignore"):
        tangent = ((v3 - v1)[:, None] * (p2 - p1) - (v2 - v1)[:, None] * (p3 - p1)) / denom[:, None]
    flat = bvhlib.build_bvh(verts, leaf_size=leaf_size)
    order = flat.tri_order
    tex_ids = tuple(atlas.add(img) if img is not None else -1 for img in sm.textures)
    rv = verts[order]
    tri_table = np.concatenate(
        [rv[:, 0], rv[:, 1] - rv[:, 0], rv[:, 2] - rv[:, 0]], axis=1
    ).astype(np.float32)
    noct = _oct_encode(normals[order].astype(np.float64))
    return dict(
        tri_verts=rv.astype(np.float32),
        tri_table=tri_table,
        tri_normals=_oct_decode(noct),
        tri_uvs=uvs[order],
        tri_tangent=tangent[order].astype(np.float32),
        transform=np.asarray(sm.transform, np.float32),
        inv_transform=np.asarray(sm.inv_transform, np.float32),
        normal_mat=np.asarray(sm.inv_transform[:3, :3].T, np.float32).copy(),
        bounds_min=flat.bounds_min,
        bounds_max=flat.bounds_max,
        skip=flat.skip,
        leaf_start=flat.leaf_start,
        leaf_count=flat.leaf_count,
        leaf_size=leaf_size,
        mat_id=mats.add(sm.material) if sm.material is not None else -1,
        tex_ids=tex_ids,
        has_uv=bool(mesh.has_texcoords),
    )


def compile_scene(scene: Scene, leaf_size: int = 4, device="cuda",
                  dense_max_tris: int = bvhlib.DENSE_MESH_MAX_TRIS) -> SceneData:
    """Lower a Scene into tables (numpy on the host), then onto `device`
    (the card by default). dense_max_tris bounds each dense mesh and their
    total (the JAX package reads it from RT_DENSE_MAX_TRIS at import); a
    budget whose dense meshes need more than TREE_MAX_NODES superleaf-tree
    nodes raises ValueError (superleaf_trees)."""
    mats = MaterialTableBuilder()
    atlas = TextureAtlasBuilder()
    sph_center, sph_radius, sph_mat = [], [], []
    pln_point, pln_normal, pln_mat = [], [], []
    tri_a, tri_b, tri_c, tri_mat = [], [], [], []
    vol_center, vol_radius, vol_density, vol_mat = [], [], [], []
    gvol_tris, gvol_density, gvol_mat, gvol_eps = [], [], [], []
    mesh_blocks: list[dict] = []
    # NEE's lights: emissive standalone Triangles and Spheres; any other
    # emitter voids nee_ok, because NEE suppresses the emission a scatter
    # ray finds next, which is right only where the sampled lights are
    # every emitter of the scene
    lt_tri_rows: list = []
    lt_sph_rows: list = []
    nee_ok = True

    def emission_of(m):
        e = np.asarray(getattr(m, "emission", (0.0, 0.0, 0.0)), np.float32)
        return e if float(np.abs(e).max()) > 0.0 else None

    for obj in scene.objects:
        if isinstance(obj, Sphere):
            sph_center.append(obj.center)
            sph_radius.append(obj.radius)
            sph_mat.append(mats.add(obj.material))
            e = emission_of(obj.material)
            if e is not None:
                lt_sph_rows.append(tuple(obj.center) + (obj.radius,) + tuple(e))
        elif isinstance(obj, Plane):
            pln_point.append(obj.point)
            pln_normal.append(obj.normal)
            pln_mat.append(mats.add(obj.material))
            if emission_of(obj.material) is not None:
                nee_ok = False  # an infinite plane has no area to sample
        elif isinstance(obj, Triangle):
            tri_a.append(obj.a)
            tri_b.append(obj.b)
            tri_c.append(obj.c)
            tri_mat.append(mats.add(obj.material))
            e = emission_of(obj.material)
            if e is not None:
                a = np.asarray(obj.a, np.float32)
                e1 = np.asarray(obj.b, np.float32) - a
                e2 = np.asarray(obj.c, np.float32) - a
                area = 0.5 * float(np.linalg.norm(np.cross(e1, e2)))
                lt_tri_rows.append(tuple(a) + tuple(e1) + tuple(e2) + tuple(e) + (area,))
        elif isinstance(obj, ConvexVolume):
            if emission_of(obj.phase_function) is not None:
                nee_ok = False  # an emissive medium is not a sampled light
            if isinstance(obj.boundary, Sphere):  # analytic entry and exit
                vol_center.append(obj.boundary.center)
                vol_radius.append(obj.boundary.radius)
                vol_density.append(obj.density)
                vol_mat.append(mats.add(obj.phase_function))
            else:  # a boundary scanned for entry and exit
                rows, eps = _boundary_tri_table(obj.boundary)
                gvol_tris.append(rows)
                gvol_eps.append(eps)
                gvol_density.append(obj.density)
                gvol_mat.append(mats.add(obj.phase_function))
        elif isinstance(obj, StaticMesh):
            mesh_blocks.append(_compile_mesh(obj, mats, atlas, leaf_size))
            if emission_of(obj.material) is not None or mesh_blocks[-1]["tex_ids"][1] >= 0:
                nee_ok = False  # mesh faces (or an emission texture) are not sampled lights
        else:
            raise TypeError(f"unsupported scene object {type(obj)!r}")
    if not (lt_tri_rows or lt_sph_rows):
        nee_ok = False  # nothing to sample

    table = mats.build()
    packed = atlas.build()

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

    # dense_max_tris bounds each dense mesh and their total; the smallest
    # meshes are admitted first, as in the JAX package, and every mesh left
    # over is a big mesh, traversed through its BVH
    cand = sorted(
        (i for i, m in enumerate(mesh_blocks) if m["tri_verts"].shape[0] <= dense_max_tris),
        key=lambda i: int(mesh_blocks[i]["tri_verts"].shape[0]),
    )
    chosen, total = [], 0
    for i in cand:
        nt_pad = (int(mesh_blocks[i]["tri_verts"].shape[0]) + 15) // 16 * 16
        if total + nt_pad > dense_max_tris:
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
    SL = SUPERLEAF
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
        gvol_tri=gvol_tris,
        gvol_density=f32(gvol_density, None, 1.0),
        gvol_mat=i32(gvol_mat),
        meshes=mesh_blocks,
        tex_pixels=packed.pixels,
        tex_offset=packed.offset,
        tex_width=packed.width,
        tex_height=packed.height,
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
        point_light_pos=np.asarray(scene.point_light_pos, np.float32),
        ambient=np.asarray(scene.ambient, np.float32),
        lt_tri=np_pad(lt_tri_rows, 13, 0.0),
        lt_sph=np_pad(lt_sph_rows, 7, 0.0),
    )
    meta = dict(
        n_spheres=len(sph_center),
        n_planes=len(pln_point),
        n_tris=len(tri_a),
        n_volumes=len(vol_center),
        n_gvols=len(gvol_tris),
        gvol_eps=tuple(gvol_eps),
        kmesh_ranges=tuple(ranges),
        ksl_ranges=tuple(sl_ranges),
        dense_mesh_ids=dense_ids,
        mat_types_present=tuple(sorted({int(x) for x in table["mat_type"]})),
        mesh_mat_ids=[m["mat_id"] for m in mesh_blocks],
        n_lt_tri=len(lt_tri_rows),
        n_lt_sph=len(lt_sph_rows),
        nee_ok=nee_ok,
    )
    return scene_data_from_numpy(arrays, meta, device=device)


_MESH_ARRAYS = ("tri_verts", "tri_table", "tri_normals", "tri_uvs", "tri_tangent", "transform",
                "inv_transform", "normal_mat", "bounds_min", "bounds_max", "skip", "leaf_start",
                "leaf_count")
_STATIC = ("n_spheres", "n_planes", "n_tris", "n_volumes", "n_gvols", "gvol_eps",
           "kmesh_ranges", "ksl_ranges", "dense_mesh_ids", "mat_types_present", "n_lt_tri",
           "n_lt_sph", "nee_ok")
# built by pack_kernel_tables, never passed in
PACKED = ("kscene", "kmesh_nrm", "ksl_tree", "kmesh_tri4", "kmesh_res", "kmesh_xfm", "kmesh_tex",
          "ksph_tree")

SUPERLEAF = 16  # kmesh_tri rows under one superleaf box
# the superleaf trees of all dense meshes: 2S - 1 nodes for S superleaves,
# and DENSE_MESH_MAX_TRIS caps the scene at 512 superleaves
TREE_MAX_NODES = 2 * (bvhlib.DENSE_MESH_MAX_TRIS // SUPERLEAF) - 1
TREE_ROW = 8  # floats a node: lo.xyz, 0, hi.xyz, 0 (two 16-byte loads)
# the sphere tree: built from this many spheres on (below it K1 scans them),
# SPHERE_LEAF sphere slots a leaf
SPHERE_TREE_MIN = 64
SPHERE_LEAF = 4


def superleaf_tree(boxes: np.ndarray) -> np.ndarray:
    """The superleaf tree of one dense mesh: (2S - 1, TREE_ROW) float32
    from its S superleaf boxes (S, 6) [lo, hi] in BVH row order.

    A complete binary tree in heap order: node k (1-based, row k - 1) has
    children 2k and 2k + 1, and k >= S is a leaf. Every inner node has two
    children, so a preorder walk needs no stack: after node k it goes to
    2k (enter) or, skipping k's subtree, strips k's trailing one bits and
    adds 1 (back at the root means done). The deepest level is filled from
    the left, so preorder meets the leaves k = 2^D .. 2S - 1 and then
    S .. 2^D - 1 (2^D the largest power of two <= 2S - 1): the leaf of
    rank g, superleaf g, is k = 2^D + g, less S where that passes 2S - 1.
    Leaves hold the boxes as they are; an inner node holds the exact
    float32 min / max union of its children, which rounds nothing, so a
    parent's box contains each child's."""
    s = boxes.shape[0]
    assert s >= 1 and boxes.shape[1] == 6
    n = 2 * s - 1
    top = 1 << (n.bit_length() - 1)
    k = top + np.arange(s)
    k = np.where(k > n, k - s, k)
    lo = np.zeros((n + 1, 3), np.float32)
    hi = np.zeros((n + 1, 3), np.float32)
    lo[k], hi[k] = boxes[:, :3], boxes[:, 3:]
    for j in range(s - 1, 0, -1):
        lo[j] = np.minimum(lo[2 * j], lo[2 * j + 1])
        hi[j] = np.maximum(hi[2 * j], hi[2 * j + 1])
    zero = np.zeros((n, 1), np.float32)
    return np.concatenate([lo[1:], zero, hi[1:], zero], axis=1)


def superleaf_trees(ksl_bounds: np.ndarray, ksl_ranges) -> np.ndarray:
    """ksl_tree: (nodes, TREE_ROW) the superleaf trees of the dense meshes
    (superleaf_tree over each mesh's ksl_bounds rows), mesh k's 2S - 1
    nodes first at row 2 * first superleaf - k; one inert zero row when
    there is no dense mesh. Raises ValueError on ranges that do not follow
    each other, on a box that is not lo < hi on every axis, and beyond
    TREE_MAX_NODES."""
    trees, rows = [], 0
    for k, (sl_first, sl_count) in enumerate(ksl_ranges):
        boxes = np.asarray(ksl_bounds, np.float32)[sl_first:sl_first + sl_count]
        if rows != 2 * sl_first - k:
            raise ValueError(f"superleaf range {k} starts at {sl_first}, after {rows} tree rows")
        # a leaf with lo >= hi on an axis could be entered where its parent
        # is culled (a NaN slab); the eps pad of tri_rows_aabb rules it out
        if not (boxes[:, :3] < boxes[:, 3:]).all():
            raise ValueError(f"a superleaf box of dense mesh {k} is flat, empty or not finite")
        trees.append(superleaf_tree(boxes))
        rows += len(trees[-1])
    ksl_tree = np.concatenate(trees) if trees else np.zeros((1, TREE_ROW), np.float32)
    if ksl_tree.shape[0] > TREE_MAX_NODES:
        raise ValueError(f"{ksl_tree.shape[0]} superleaf tree nodes, more than {TREE_MAX_NODES}")
    return ksl_tree


def sphere_tree_leaves(n_spheres: int) -> int:
    """Leaves G of the sphere tree of a scene with `n_spheres` spheres: the
    least power of two with G · SPHERE_LEAF >= n_spheres, or 0 (no tree)
    below SPHERE_TREE_MIN spheres."""
    if n_spheres < SPHERE_TREE_MIN:
        return 0
    return 1 << (-(-n_spheres // SPHERE_LEAF) - 1).bit_length()


def sphere_tree(spheres: np.ndarray) -> np.ndarray:
    """ksph_tree: the tree K1 walks over the spheres (S, 4) [c, r] in place
    of its sphere scan, as (rows, 4) float32; one inert zero row below
    SPHERE_TREE_MIN spheres.

    A complete binary tree over G = sphere_tree_leaves(S) leaves in heap
    order (node k has children 2k and 2k + 1, leaves G .. 2G - 1): a median
    split on the widest centroid axis of node k's spheres, ceil and floor
    halves, gives its children theirs, so every leaf holds 2 to SPHERE_LEAF
    spheres, and its box is the union of theirs, [c - r, c + r]; an inner
    node holds the exact float32 union of its children's boxes
    (superleaf_tree). Rows: [reach, G, SPHERE_LEAF, 0] with reach = max
    |c|_inf + r (rounded up), a zero row, node k at rows 2k (lo, 0) and
    2k + 1 (hi, 0); then the leaves' slots, SPHERE_LEAF a leaf, each [c, r]
    as the scene table holds it; then each slot's sphere index (-1 for an
    empty slot), four a row. K1 stages rows 0 .. 4G - 1 and reads the
    slots and indices from device memory."""
    n = spheres.shape[0]
    g = sphere_tree_leaves(n)
    if g == 0:
        return np.zeros((1, 4), np.float32)
    rows = np.asarray(spheres, np.float32)
    cent = rows[:, :3].astype(np.float64)
    ids = np.full(g * SPHERE_LEAF, -1, np.int64)
    leaf_of = np.zeros(n, np.int64)

    def split(sel: np.ndarray, k: int) -> None:
        if k >= g:
            ids[(k - g) * SPHERE_LEAF:(k - g) * SPHERE_LEAF + sel.size] = np.sort(sel)
            leaf_of[sel] = k - g
            return
        c = cent[sel]
        axis = int(np.argmax(c.max(axis=0) - c.min(axis=0)))
        part = sel[np.argsort(c[:, axis], kind="stable")]
        half = (sel.size + 1) // 2
        split(part[:half], 2 * k)
        split(part[half:], 2 * k + 1)

    split(np.arange(n), 1)
    lo_s, hi_s = rows[:, :3] - rows[:, 3:4], rows[:, :3] + rows[:, 3:4]
    boxes = np.zeros((g, 6), np.float32)
    for leaf in range(g):
        mine = leaf_of == leaf
        boxes[leaf] = np.concatenate([lo_s[mine].min(axis=0), hi_s[mine].max(axis=0)])
    reach = np.float32(np.max(np.abs(cent).max(axis=1) + rows[:, 3].astype(np.float64)))
    header = np.array([[np.nextafter(reach, np.float32(np.inf)), g, SPHERE_LEAF, 0.0],
                       [0.0, 0.0, 0.0, 0.0]], np.float32)
    slots = np.where((ids >= 0)[:, None], rows[np.maximum(ids, 0)], np.float32(0.0))
    return np.concatenate([header, superleaf_tree(boxes).reshape(-1, 4), slots,
                           ids.astype(np.float32).reshape(-1, 4)]).astype(np.float32)


def pack_kernel_tables(arrays: dict, meta: dict) -> tuple[np.ndarray, ...]:
    """The mega-bounce kernel's tables (csrc/bounce.cu), from host arrays
    laid out as for scene_data_from_numpy.

    kscene: one flat float32 table that the kernel stages into shared
    memory — spheres [c, r, mat], planes [p, n, mat], triangles [a, e1,
    e2, mat], volumes [c, r, density, mat], materials [type, albedo,
    emission, roughness, metallic, ior] and one row per dense mesh
    [inverse R, inverse t, normal matrix, R, t, mat, first row, rows,
    first superleaf, superleaves] (ids and counts are exact in float32).
    kmesh_nrm: (TT, 9) decoded corner normals of the kmesh_tri rows, zero
    on padding rows. ksl_tree: the superleaf trees (superleaf_trees),
    which the kernels stage into shared memory. kmesh_tri4: (TT, 12) the
    kmesh_tri rows [a, e1, e2] padded with three zeros, so that a kernel
    reads a row as three 16-byte loads. kmesh_res and kmesh_xfm: the
    staged path's merged mesh resolve (ops/intersect.py::resolve_mesh_winners)
    over the meshes in resolve_order: per triangle [corner normals, corner
    uvs, tangent] (ΣT, 18) and per mesh [normal matrix, R, t, inverse R,
    inverse t, first kmesh_res row, triangles, material id (-1: synthesized
    from the textures)] (M, 36), float32 copies of the mesh tables (the
    plain version reads the first 21 columns, the resolve kernel R1 all;
    ids and counts are exact in float32), and kmesh_tex, per mesh the int32
    atlas [offset, width, height] of each of the five texture slots (-1
    where a slot is unbound) (M, 15); one inert row each without a mesh.
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
    kmesh_tri = f(a["kmesh_tri"])
    kmesh_tri4 = np.concatenate([kmesh_tri, np.zeros((kmesh_tri.shape[0], 3), np.float32)], 1)
    res, xfm = [np.zeros((0, 18), np.float32)], [np.zeros((0, 36), np.float32)]
    tex, first = [np.zeros((0, 15), np.int32)], 0
    for mi in resolve_order(meta["dense_mesh_ids"], len(a["meshes"])):
        m = a["meshes"][mi]
        nt = np.shape(m["tri_normals"])[0]
        res.append(np.concatenate([f(m["tri_normals"]).reshape(nt, 9),
                                   f(m["tri_uvs"]).reshape(nt, 6), f(m["tri_tangent"])], 1))
        fwd, bwd = f(m["transform"]), f(m["inv_transform"])
        xfm.append(np.concatenate([f(m["normal_mat"]).reshape(-1), fwd[:3, :3].reshape(-1),
                                   fwd[:3, 3], bwd[:3, :3].reshape(-1), bwd[:3, 3],
                                   f([first, nt, meta["mesh_mat_ids"][mi]])])[None, :])
        first += nt
        slots = [(int(a["tex_offset"][i]), int(a["tex_width"][i]), int(a["tex_height"][i]))
                 if i >= 0 else (-1, -1, -1) for i in m["tex_ids"]]
        tex.append(np.asarray([sum(slots, ())], np.int32))
    kmesh_res = _pad_rows(np.concatenate(res), 1, 0.0)
    kmesh_xfm = _pad_rows(np.concatenate(xfm), 1, 0.0)
    kmesh_tex = _pad_rows(np.concatenate(tex), 1, -1)
    with profiling.span("scene.sphere_tree"):
        ksph_tree = sphere_tree(f(a["ksph_f"])[:ns])
    return (kscene, kmesh_nrm, superleaf_trees(a["ksl_bounds"], meta["ksl_ranges"]), kmesh_tri4,
            kmesh_res, kmesh_xfm, kmesh_tex, ksph_tree)


def resolve_order(dense_mesh_ids, n_meshes: int) -> list[int]:
    """The staged path's mesh order: the dense meshes (K2's codes 4 + k),
    then the big ones (K3, codes after them)."""
    return list(dense_mesh_ids) + [i for i in range(n_meshes) if i not in dense_mesh_ids]


def mesh_kernel_tables(m: dict) -> dict:
    """The per-mesh tables of the big-mesh kernel (csrc/bvh_traverse.cu)
    and the dense-mesh scan (csrc/tri_scan.cu), from the host arrays of one
    mesh (_MESH_ARRAYS): bvh_nodes and bvh_depth (ops/bvh.py::pack_bvh),
    bvh_tri4, tri_verts' rows as [a, e1, e2, 0, 0, 0] with the edges formed
    in float32 as traverse forms them (tri_table's edges were formed before
    the cast and may differ in the last bit), and tri_table4, tri_table's
    rows padded the same way. A 48-byte row is three 16-byte loads."""
    tv = np.asarray(m["tri_verts"], np.float32)
    zero = np.zeros((tv.shape[0], 3), np.float32)
    nodes, depth = bvhlib.pack_bvh(*(np.asarray(m[k]) for k in (
        "bounds_min", "bounds_max", "skip", "leaf_start", "leaf_count")))
    return dict(
        bvh_nodes=nodes,
        bvh_tri4=np.concatenate([tv[:, 0], tv[:, 1] - tv[:, 0], tv[:, 2] - tv[:, 0], zero], 1),
        tri_table4=np.concatenate([np.asarray(m["tri_table"], np.float32), zero], 1),
        bvh_depth=depth,
    )


def scene_data_from_numpy(arrays: dict, meta: dict, device="cuda") -> SceneData:
    """Build a SceneData from host arrays — `compile_scene`'s own, or the
    leaves of the JAX package's compiled SceneData as numpy, so that both
    packages run the same tables — and move it onto `device`.

    arrays: every tensor field of SceneData except `meshes` and the
      kernel's packed tables (PACKED, built here), with "gvol_tri" a list
      of (T, 9) arrays, plus "meshes": a list of dicts holding the
      MeshBlock array fields, "leaf_size", "tex_ids" and "has_uv" (the
      kernels' per-mesh tables are built here, by mesh_kernel_tables).
    meta: the static fields (_STATIC: the counts, ranges and mesh ids,
      mat_types_present, n_gvols and gvol_eps, the light counts n_lt_tri
      and n_lt_sph, nee_ok) and "mesh_mat_ids", one material id per mesh
      (-1 for a material synthesized from the mesh's textures).
    `device` is the card unless the caller asks for the CPU.
    """
    device = resolve_device(device)

    def t(x):
        return torch.from_numpy(np.array(x)).to(device)  # a writable copy

    meshes = []
    for m, mid in zip(arrays["meshes"], meta["mesh_mat_ids"]):
        packed = mesh_kernel_tables(m)
        depth = packed.pop("bvh_depth")
        meshes.append(MeshBlock(**{k: t(m[k]) for k in _MESH_ARRAYS},
                                **{k: t(x) for k, x in packed.items()}, mat_id=int(mid),
                                tex_ids=tuple(int(x) for x in m["tex_ids"]),
                                has_uv=bool(m["has_uv"]), leaf_size=int(m["leaf_size"]),
                                bvh_depth=depth))
    meshes = tuple(meshes)
    fields = {"meshes": meshes, "gvol_tri": tuple(t(x) for x in arrays["gvol_tri"]),
              **{k: t(x) for k, x in zip(PACKED, pack_kernel_tables(arrays, meta))}}
    for f in dataclasses.fields(SceneData):
        if f.name in fields:
            continue
        if f.name in _STATIC:
            v = meta[f.name]
            if f.name == "nee_ok":
                fields[f.name] = bool(v)
            elif f.name == "gvol_eps":
                fields[f.name] = tuple(float(x) for x in v)
            elif f.name.endswith("ranges"):
                fields[f.name] = tuple(tuple(x) for x in v)
            else:
                fields[f.name] = tuple(v) if isinstance(v, (tuple, list)) else int(v)
        else:
            fields[f.name] = t(arrays[f.name])
    return SceneData(**fields)
