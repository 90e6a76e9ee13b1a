"""Scene-level intersection: per-class batched tests and the nearest-hit
resolve.

Mirrors `cs397raytracingsp22_tpu/ops/intersect.py`:
- `intersect_scene_plain` is `intersect_scene_jnp`, in plain torch: the
  spec, the intersection half of the mega-bounce kernel's plain version
  (render/integrator.py::path_trace), and what CPU tensors run;
- `intersect_scene_fused` is the staged path's intersection on the card:
  the scene-intersection kernel K2 (ops/kernels/scene_intersect.py: every
  analytic class and the dense meshes), then the big-mesh traversal
  kernel K3 per mesh beyond the dense budget (ops/kernels/tri_scan_big.py)
  with the running best t as its far bound, the general-boundary volumes,
  and one merged resolve of the mesh winners (the kernel R1,
  ops/kernels/resolve.py, whose plain version is `resolve_mesh_winners`:
  smooth normals, texcoords, texture sampling, normal maps and the
  materials synthesized from textures);
- `intersect_scene` picks the fused path for CUDA tensors and the plain
  one for CPU tensors;
- `intersect_mesh` is one mesh's candidate: the dense-scan kernel K5
  (ops/kernels/tri_scan.py) for a dense mesh of CUDA tensors, else
  `intersect_mesh_plain`, the per-mesh half of the spec.

Replicated reference quirks:
- mesh hits keep object-space t and are compared with the world-space t
  of other primitives (the ray is not renormalized, geometry.rs:304-310);
- plane normals flip toward the ray origin with Rust signum
  (geometry.rs:477-478);
- a volume samples its scatter distance inside the test (geometry.rs:517)
  and returns a zero normal (geometry.rs:520).
Ties across classes go to the earlier class in the order spheres →
planes → triangles → volumes → general volumes → meshes in the plain
spec; the fused path merges the general volumes after the meshes, at a
strictly smaller t (intersect.py:692-707 in the JAX package).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from cs397raytracingsp22_tpu_torch.models import materials as mat
from cs397raytracingsp22_tpu_torch.models.scene import MeshBlock, SceneData, resolve_order
from cs397raytracingsp22_tpu_torch.ops import bvh as bvhlib
from cs397raytracingsp22_tpu_torch.utils import profiling
from cs397raytracingsp22_tpu_torch.utils import vecmath as vm

_BIG = float("inf")
CODE_MESH0 = 4  # winner code of mesh k in the fused path: 0-3 analytic classes, 4 + k
CODE_GVOL0 = 1 << 20  # winner code of general volume g in the fused path: CODE_GVOL0 + g
MAT_FIELDS = ("mtype", "albedo", "emission", "roughness", "metallic", "ior")
# (ray, triangle) pairs of one block of the general-volume entry/exit scan
GVOL_BLOCK = 1 << 24


@dataclasses.dataclass
class HitRecord:
    """Flat per-ray hit (the RayHit of tracing.rs:109-134, with the
    material dereferenced into its parameters)."""

    valid: torch.Tensor  # (N,) bool
    t: torch.Tensor  # (N,) raw hit distance (object-space for meshes)
    point: torch.Tensor  # (N, 3) world hitpoint
    normal: torch.Tensor  # (N, 3) world shading normal (0 for volume hits)
    frontface: torch.Tensor  # (N,) bool
    mtype: torch.Tensor  # (N,) int32 material type enum
    albedo: torch.Tensor  # (N, 3)
    emission: torch.Tensor  # (N, 3)
    roughness: torch.Tensor  # (N,)
    metallic: torch.Tensor  # (N,)
    ior: torch.Tensor  # (N,)


def _gather_material(scene: SceneData, mid: torch.Tensor) -> dict:
    mid = mid.long()
    return dict(
        mtype=scene.mat_type[mid],
        albedo=scene.mat_albedo[mid],
        emission=scene.mat_emission[mid],
        roughness=scene.mat_roughness[mid],
        metallic=scene.mat_metallic[mid],
        ior=scene.mat_ior[mid],
    )


def texel_index(off, w, h, uv) -> torch.Tensor:
    """The atlas row of the nearest texel (texture.rs:26-32) at (N, 2) uv
    for per-ray (or scalar) int32 atlas offset, width and height: u
    clamped to [0, 0.999], v flipped after the same clamp, truncating
    casts, then min(size - 1). (N,) int64."""
    u = torch.clamp(uv[:, 0], 0.0, 0.999)
    v = torch.clamp(uv[:, 1], 0.0, 0.999)
    x = torch.minimum((u * w).to(torch.int32), w - 1)
    y = torch.minimum(((1.0 - v) * h).to(torch.int32), h - 1)
    return (off + y * w + x).long()


def sample_texture_dyn(scene: SceneData, off, w, h, uv) -> torch.Tensor:
    """The nearest texel at uv (texel_index) as (N, 3) float32 in [0, 1]."""
    return scene.tex_pixels[texel_index(off, w, h, uv)].to(torch.float32) / 255.0


def sample_texture(scene: SceneData, tex_id: int, uv) -> torch.Tensor:
    """sample_texture_dyn of one texture, atlas id tex_id."""
    return sample_texture_dyn(scene, scene.tex_offset[tex_id], scene.tex_width[tex_id],
                              scene.tex_height[tex_id], uv)


def _col(x, like: torch.Tensor) -> torch.Tensor:
    """A scalar-or-(N,) t bound as a column against (N, K) candidates."""
    x = vm.as_f32(x, like)
    return x[:, None] if x.ndim == 1 else x


def _pick(t: torch.Tensor, valid: torch.Tensor):
    """Per-row nearest valid candidate: (t, idx, valid), the earliest
    index on ties (argmin returns the first minimum)."""
    t_m = torch.where(valid, t, torch.full_like(t, _BIG))
    idx = torch.argmin(t_m, dim=1)
    rows = torch.arange(t.shape[0], device=t.device)
    return t_m[rows, idx], idx.to(torch.int32), valid[rows, idx]


def _sphere_roots(o, d, center, radius):
    """Ray/sphere quadratic roots (geometry.rs:395-407): o, d (N, 1, 3),
    center (S, 3), radius (S,) → (disc_ok, t1, t2), each (N, S)."""
    f = o - center
    a = vm.magnitude2(d)
    b = 2.0 * vm.dot(f, d)
    c = vm.magnitude2(f) - radius * radius
    disc = b * b - 4.0 * a * c
    ok = disc >= 0.0
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    t1 = (-b - sq) / (2.0 * a)
    t2 = (-b + sq) / (2.0 * a)
    return ok, t1, t2


def _live(n_real: int, k: int, like: torch.Tensor) -> torch.Tensor:
    return torch.arange(k, device=like.device) < n_real


def intersect_spheres(scene: SceneData, o, d, t_min, t_max):
    t_min, t_max = _col(t_min, o), _col(t_max, o)
    ok, t1, t2 = _sphere_roots(o[:, None, :], d[:, None, :], scene.sph_center, scene.sph_radius)
    # root selection: t1 if t1 >= t_min else t2 (geometry.rs:406-410)
    t = torch.where(t1 >= t_min, t1, t2)
    valid = ok & (t >= t_min) & (t <= t_max)
    valid = valid & _live(scene.n_spheres, t.shape[1], o)
    return _pick(t, valid)


def intersect_planes(scene: SceneData, o, d, t_min, t_max):
    t_min, t_max = _col(t_min, o), _col(t_max, o)
    od = vm.dot(o[:, None, :] - scene.pln_point, scene.pln_normal)
    n = vm.signum(od)[..., None] * scene.pln_normal  # flipped toward the origin
    dd = vm.dot(d[:, None, :], n)
    t = torch.abs(od) / torch.abs(dd)
    valid = (dd < 0.0) & (t >= t_min) & (t <= t_max)
    valid = valid & _live(scene.n_planes, t.shape[1], o)
    return _pick(t, valid)


def intersect_triangles(scene: SceneData, o, d, t_min, t_max):
    valid, t, _, _ = bvhlib.moller_trumbore(
        o[:, None, :], d[:, None, :], scene.tri_a, scene.tri_b, scene.tri_c,
        _col(t_min, o), _col(t_max, o),
    )
    valid = valid & _live(scene.n_tris, t.shape[1], o)
    return _pick(t, valid)


def intersect_volumes(scene: SceneData, o, d, t_min, t_max, u_vol):
    """Nearest participating-medium scatter event (geometry.rs:502-525):
    entry/exit are the sphere roots, the span is clipped to
    [t_min, t_max], and the ray scatters when -ln(U)/density fits."""
    t_min, t_max = _col(t_min, o), _col(t_max, o)
    ok, t1, t2 = _sphere_roots(o[:, None, :], d[:, None, :], scene.vol_center, scene.vol_radius)
    exit_ok = ok & (t2 >= t1 + 1e-4)
    in_range = (t2 >= t_min) & (t1 <= t_max)
    t_start = torch.maximum(t1, t_min)
    t_end = torch.minimum(t2, t_max)
    dist = (-1.0 / scene.vol_density) * torch.log(torch.clamp(u_vol, min=1e-38))
    valid = ok & exit_ok & in_range & (dist < t_end - t_start)
    valid = valid & _live(scene.n_volumes, t1.shape[1], o)
    return _pick(t_start + dist, valid)


def intersect_general_volume(tri_table, density, o, d, t_min, t_max, u, eps=bvhlib.MT_EPSILON):
    """One general-boundary ConvexVolume (geometry.rs:502-525 with a
    Triangle or StaticMesh boundary): the entry is the nearest boundary hit
    over (-inf, inf) (geometry.rs:505), the exit the nearest at least 1e-4
    past it (geometry.rs:508), then the free flight of the sphere volumes.

    tri_table: (T, 9) world-space [a, e1, e2] rows; density a scalar; u
    (N,) uniforms; eps the world-space Möller–Trumbore epsilon
    (SceneData.gvol_eps). The (ray, triangle) scan runs in blocks of at
    most GVOL_BLOCK pairs; entry and exit are minima, exact in any order,
    so the blocks change no bit. Returns (t, valid), both (N,)."""
    n, n_rows = o.shape[0], tri_table.shape[0]
    step = max(1, GVOL_BLOCK // max(n, 1))

    def boundary_t(r0):  # (N, B) boundary hits of rows r0.., inf where none
        rows = tri_table[r0:r0 + step]
        a = rows[:, 0:3]
        ok, t, _, _ = bvhlib.moller_trumbore(o[:, None, :], d[:, None, :], a, a + rows[:, 3:6],
                                             a + rows[:, 6:9], -_BIG, _BIG, eps=eps)
        return ok, torch.where(ok, t, torch.full_like(t, _BIG))

    starts = range(0, n_rows, step)
    if len(starts) == 1:  # one block: scan it once for both passes
        only = boundary_t(0)
        scan = lambda r0: only  # noqa: E731
    else:  # the exit pass needs the entry first: scan every block twice
        scan = boundary_t
    t_entr = torch.full((n,), _BIG, dtype=torch.float32, device=o.device)
    entered = torch.zeros((n,), dtype=torch.bool, device=o.device)
    for r0 in starts:
        ok, t_all = scan(r0)
        t_entr = torch.minimum(t_entr, t_all.min(dim=1).values)
        entered = entered | ok.any(dim=1)
    t_exit = torch.full_like(t_entr, _BIG)
    for r0 in starts:
        t_all = scan(r0)[1]
        t_all = torch.where(t_all >= t_entr[:, None] + 1e-4, t_all, torch.full_like(t_all, _BIG))
        t_exit = torch.minimum(t_exit, t_all.min(dim=1).values)
    t_min, t_max = vm.as_f32(t_min, o), vm.as_f32(t_max, o)
    in_range = (t_exit >= t_min) & (t_entr <= t_max)
    t_start = torch.maximum(t_entr, t_min)
    t_end = torch.minimum(t_exit, t_max)
    dist = (-1.0 / density) * torch.log(torch.clamp(u, min=1e-38))
    valid = entered & torch.isfinite(t_exit) & in_range & (dist < t_end - t_start)
    return t_start + dist, valid


def _synthesized_material(n: int, like: torch.Tensor, albedo=None, emission=None, metallic=None,
                          roughness=None) -> dict:
    """A material synthesized from a mesh's texture slots
    (geometry.rs:253-271): PARAMETERIZED, each unbound slot at its
    default (albedo and emission 0, metallic 0, roughness 1), ior 1.5."""
    zero3 = torch.zeros((n, 3), dtype=torch.float32, device=like.device)
    return dict(
        mtype=torch.full((n,), mat.PARAMETERIZED, dtype=torch.int32, device=like.device),
        albedo=zero3 if albedo is None else albedo,
        emission=zero3 if emission is None else emission,
        roughness=torch.ones((n,), dtype=torch.float32, device=like.device)
        if roughness is None else roughness,
        metallic=torch.zeros((n,), dtype=torch.float32, device=like.device)
        if metallic is None else metallic,
        ior=torch.full((n,), 1.5, dtype=torch.float32, device=like.device),
    )


def _normal_mapped(n_flip, tan_approx, nm_rgb):
    """The TBN normal map (geometry.rs:274-296): a Gram–Schmidt frame from
    the per-triangle tangent, the map's rgb to [-1, 1]."""
    nm = 2.0 * nm_rgb - 1.0
    bitangent = vm.normalize(vm.cross(n_flip, tan_approx), eps=1e-30)
    tangent = vm.normalize(vm.cross(bitangent, n_flip), eps=1e-30)
    return tangent * nm[:, 0:1] + bitangent * nm[:, 1:2] + n_flip * nm[:, 2:3]


def resolve_mesh_hit(mesh: MeshBlock, scene: SceneData, o_obj, d_obj, t, tri, u, v):
    """Shading resolve of one mesh's hits from (t, tri, u, v) in object
    space (geometry.rs:274-321): smooth normal (geometry.rs:350-351), front
    face against the object-space direction, texcoords (geometry.rs:355),
    the normal map where slot 4 is bound, the normal matrix
    (geometry.rs:297), the world point (geometry.rs:307), and the mesh's
    material: its table row, or one synthesized from its textures."""
    tri = torch.clamp(tri, min=0).long()
    n = t.shape[0]
    n_smooth = vm.normalize(_barycentric(mesh.tri_normals[tri].reshape(n, 9), u, v), eps=1e-30)
    frontface = vm.dot(n_smooth, d_obj) < 0.0
    n_flip = torch.where(frontface[:, None], n_smooth, -n_smooth)
    uv = _barycentric(mesh.tri_uvs[tri].reshape(n, 6), u, v)
    n_obj = n_flip
    if mesh.tex_ids[4] >= 0:
        n_obj = _normal_mapped(n_flip, mesh.tri_tangent[tri],
                               sample_texture(scene, mesh.tex_ids[4], uv))
    n_world = vm.normalize(vm.apply_mat4_vector(mesh.normal_mat, n_obj), eps=1e-30)
    p_obj = o_obj + t[:, None] * d_obj
    p_world = vm.apply_mat4_point(mesh.transform, p_obj)
    if mesh.mat_id >= 0:
        m = _gather_material(scene, torch.full(t.shape, mesh.mat_id, dtype=torch.int32,
                                               device=t.device))
    else:
        s = {name: sample_texture(scene, mesh.tex_ids[slot], uv) if mesh.tex_ids[slot] >= 0
             else None for slot, name in enumerate(("albedo", "emission", "metallic", "roughness"))}
        for name in ("metallic", "roughness"):
            s[name] = None if s[name] is None else s[name][:, 0]
        m = _synthesized_material(t.shape[0], t, **s)
    return dict(point=p_world, normal=n_world, frontface=frontface, **m)


def object_rays(mesh: MeshBlock, o, d):
    """World rays in the mesh's object space, the direction not
    renormalized (geometry.rs:304), so t compares across objects."""
    return vm.apply_mat4_point(mesh.inv_transform, o), vm.apply_mat4_vector(mesh.inv_transform, d)


def _mesh_candidate(mesh: MeshBlock, scene: SceneData, o_obj, d_obj, hit, t, tri, u, v) -> dict:
    """The candidate fields of one mesh's nearest hits (t inf on a miss),
    its material's fields among them."""
    fields = resolve_mesh_hit(mesh, scene, o_obj, d_obj, t, tri, u, v)
    fields["valid"] = hit
    fields["t"] = torch.where(hit, t, torch.full_like(t, _BIG))
    return fields


def intersect_mesh_plain(mesh: MeshBlock, scene: SceneData, o, d, t_min, t_max) -> dict:
    """One mesh by the plain scans on any device: the dense scan (at most
    DENSE_MESH_MAX_TRIS triangles) or the BVH traversal, then the shading
    resolve. t stays in object space. intersect_scene_plain, the spec that
    K1's and K2's card checks run, takes this path."""
    o_obj, d_obj = object_rays(mesh, o, d)
    if mesh.tri_verts.shape[0] <= bvhlib.DENSE_MESH_MAX_TRIS:
        hit, t, tri, u, v = bvhlib.intersect_tris_scan(o_obj, d_obj, mesh.tri_verts, t_min, t_max)
    else:
        hit, t, tri, u, v = bvhlib.traverse(
            o_obj, d_obj, t_min, t_max, mesh.bounds_min, mesh.bounds_max, mesh.skip,
            mesh.leaf_start, mesh.leaf_count, mesh.tri_verts, mesh.leaf_size,
        )
    return _mesh_candidate(mesh, scene, o_obj, d_obj, hit, t, tri, u, v)


def intersect_mesh(mesh: MeshBlock, scene: SceneData, o, d, t_min, t_max) -> dict:
    """One mesh, as intersect_mesh of the JAX package (intersect.py:279):
    for CUDA tensors a dense mesh goes through the dense-scan kernel K5
    (ops/kernels/tri_scan.py, on the mesh's tri_table rows); CPU tensors
    and big meshes take intersect_mesh_plain."""
    if o.device.type != "cuda" or mesh.tri_verts.shape[0] > bvhlib.DENSE_MESH_MAX_TRIS:
        return intersect_mesh_plain(mesh, scene, o, d, t_min, t_max)
    from cs397raytracingsp22_tpu_torch.ops.kernels import tri_scan

    o_obj, d_obj = object_rays(mesh, o, d)
    hit, t, tri, u, v = tri_scan.tri_scan_cuda(mesh, o_obj.contiguous(), d_obj.contiguous(),
                                               t_min, t_max)
    return _mesh_candidate(mesh, scene, o_obj, d_obj, hit, t, tri, u, v)


def analytic_candidates(scene: SceneData, o, d, t_min, t_max, u_vol,
                        stats: dict | None = None) -> list[dict]:
    """The nearest hit of each analytic class (spheres, planes, triangles,
    volumes), each a dict of valid, t (inf when invalid), idx, point,
    normal (front-facing; zero for volumes), frontface and mat (id). The
    spheres of a scene with a sphere tree by its walk (walk_spheres, the
    scan's bits), of any other by the scan. stats: when a dict, receives
    the walk's per-ray tests, "sph_nodes" and "sph_spheres" (zero on a
    scene without a tree)."""
    n = o.shape[0]
    dev = o.device
    out = []

    if scene.sph_tree_leaves:
        walk = walk_spheres(scene, o, d, t_min, t_max)
        t_s, i_s, v_s = walk.t, walk.idx, walk.hit
        counts = (walk.nodes, walk.spheres)
    else:
        t_s, i_s, v_s = intersect_spheres(scene, o, d, t_min, t_max)
        counts = (0, 0)
    if stats is not None:
        for key, x in zip(("sph_nodes", "sph_spheres"), counts):
            stats[key] = stats.get(key, 0) + x
    center = scene.sph_center[i_s.long()]
    p = o + t_s[:, None] * d
    n_out = vm.normalize(p - center, eps=1e-30)
    ff = vm.dot(n_out, d) < 0.0
    out.append(dict(valid=v_s, t=t_s, idx=i_s, point=p,
                    normal=torch.where(ff[:, None], n_out, -n_out), frontface=ff,
                    mat=scene.sph_mat[i_s.long()]))

    t_p, i_p, v_p = intersect_planes(scene, o, d, t_min, t_max)
    pln_n = scene.pln_normal[i_p.long()]
    pln_pt = scene.pln_point[i_p.long()]
    n_pre = vm.signum(vm.dot(o - pln_pt, pln_n))[:, None] * pln_n
    ff = vm.dot(n_pre, d) < 0.0
    out.append(dict(valid=v_p, t=t_p, idx=i_p, point=o + t_p[:, None] * d,
                    normal=torch.where(ff[:, None], n_pre, -n_pre), frontface=ff,
                    mat=scene.pln_mat[i_p.long()]))

    t_t, i_t, v_t = intersect_triangles(scene, o, d, t_min, t_max)
    it = i_t.long()
    e1 = scene.tri_b[it] - scene.tri_a[it]
    e2 = scene.tri_c[it] - scene.tri_a[it]
    n_geo = vm.normalize(vm.cross(e1, e2), eps=1e-30)
    ff = vm.dot(n_geo, d) < 0.0
    out.append(dict(valid=v_t, t=t_t, idx=i_t, point=o + t_t[:, None] * d,
                    normal=torch.where(ff[:, None], n_geo, -n_geo), frontface=ff,
                    mat=scene.tri_mat[it]))

    n_vcols = scene.vol_center.shape[0]
    t_v, i_v, v_v = intersect_volumes(scene, o, d, t_min, t_max, u_vol[:, :n_vcols])
    out.append(dict(valid=v_v, t=t_v, idx=i_v, point=o + t_v[:, None] * d,
                    normal=torch.zeros((n, 3), dtype=torch.float32, device=dev),
                    frontface=torch.zeros((n,), dtype=torch.bool, device=dev),
                    mat=scene.vol_mat[i_v.long()]))
    return out


def _slab(lo, hi, o, inv, t_min, far) -> torch.Tensor:
    """The kernels' box test (csrc/intersect.cuh::node_reached): does the
    ray (origin o, inverse direction inv) meet the box [lo, hi] within
    [t_min, far]? Arguments broadcast; fmin / fmax drop a NaN slab as
    fminf / fmaxf do."""
    t0, t1 = (lo - o) * inv, (hi - o) * inv
    near, fa = torch.fmin(t0, t1), torch.fmax(t0, t1)
    lo_t = torch.fmax(torch.fmax(near[..., 0], near[..., 1]), torch.fmax(near[..., 2], t_min))
    hi_t = torch.fmin(torch.fmin(fa[..., 0], fa[..., 1]), torch.fmin(fa[..., 2], far))
    return hi_t >= lo_t


def superleaf_tree_rows(scene: SceneData, k: int) -> torch.Tensor:
    """Dense mesh k's superleaf tree: its 2S - 1 rows of scene.ksl_tree
    (models/scene.py::superleaf_tree), node j (1-based heap order) at row
    j - 1, [lo, 0, hi, 0] each."""
    first, s = scene.ksl_ranges[k]
    return scene.ksl_tree[2 * first - k:2 * first - k + 2 * s - 1]


def tree_preorder(s: int) -> list[int]:
    """The heap indices of a superleaf tree over s superleaves in the order
    the kernels' walk visits them when it enters every node: after node j
    it goes to 2j (an inner node, j < s) or, past j's subtree, strips j's
    trailing one bits and adds 1; back at the root it is done."""
    order, j = [], 1
    while True:
        order.append(j)
        if j < s:
            j *= 2
            continue
        j = (j >> (((~j) & (j + 1)).bit_length() - 1)) + 1
        if j == 1:
            return order


def tree_leaf(j: int, s: int) -> int:
    """The superleaf (rank in row order) of leaf j of a tree over s
    superleaves: the deepest level (from 2^D, the largest power of two
    <= 2s - 1) holds the first ones, the level above the rest."""
    top = 1 << ((2 * s - 1).bit_length() - 1)
    return j - top + (s if j < top else 0)


class MeshWalk(NamedTuple):
    """One dense mesh's nearest hits by the superleaf-tree walk."""

    hit: torch.Tensor  # (N,) bool
    t: torch.Tensor  # (N,) the nearest t, t_max on a miss
    row: torch.Tensor  # (N,) int32 the mesh's own row (tri_verts order), -1 on a miss
    u: torch.Tensor  # (N,)
    v: torch.Tensor  # (N,)
    nodes: torch.Tensor  # (N,) int64 tree nodes tested
    tris: torch.Tensor  # (N,) int64 triangle rows tested (16 a superleaf reached)
    leaves: torch.Tensor  # (N, S) bool the superleaves whose rows were tested


def walk_dense_mesh(scene: SceneData, k: int, o_obj, d_obj, t_min, t_max) -> MeshWalk:
    """The plain version of csrc/intersect.cuh::scan_dense_mesh on dense
    mesh k, for object-space rays o_obj, d_obj (N, 3) and t_min, t_max
    (scalars or (N,)): the stackless preorder walk of the mesh's superleaf
    tree against a running best that starts at t_max, each node tested
    with the kernels' box test within [t_min, best], then Möller–Trumbore
    over the 16 kmesh_tri rows of each superleaf reached, a hit kept only
    when t < best strictly (tri_scan_plain's arithmetic and order). Rows
    are met in ascending order, so ties keep the lowest row, as
    bvh.intersect_tris_scan does. The spec of the device function, which
    scans each reached superleaf with the whole warp and keeps the least t
    against the bound at the leaf's entry, the lowest row on ties: the row
    this serial scan keeps. The tests and the work counts use it; no card
    path calls it."""
    from cs397raytracingsp22_tpu_torch.ops.kernels.tri_scan import tri_scan_plain

    n, dev = o_obj.shape[0], o_obj.device
    first, s = scene.ksl_ranges[k]
    start = scene.kmesh_ranges[k][0]
    tree = superleaf_tree_rows(scene, k)
    t_min = torch.broadcast_to(vm.as_f32(t_min, o_obj), (n,))
    t_max = torch.broadcast_to(vm.as_f32(t_max, o_obj), (n,))
    inv = 1.0 / d_obj
    best = t_max.clone()
    row = torch.full((n,), -1, dtype=torch.int32, device=dev)
    u = torch.zeros((n,), dtype=torch.float32, device=dev)
    v = torch.zeros_like(u)
    nodes = torch.zeros((n,), dtype=torch.int64, device=dev)
    leaves = torch.zeros((n, s), dtype=torch.bool, device=dev)
    entered = torch.zeros((n, 2 * s), dtype=torch.bool, device=dev)  # by heap index
    for j in tree_preorder(s):
        tested = torch.ones((n,), dtype=torch.bool, device=dev) if j == 1 else entered[:, j // 2]
        nodes += tested
        box = tree[j - 1]
        entered[:, j] = tested & _slab(box[0:3], box[4:7], o_obj, inv, t_min, best)
        if j < s:
            continue
        g = tree_leaf(j, s)
        leaves[:, g] = entered[:, j]
        sel = entered[:, j].nonzero()[:, 0]
        r0 = start + 16 * g
        hit_l, t_l, tri_l, u_l, v_l = tri_scan_plain(
            scene.kmesh_tri[r0:r0 + 16], o_obj[sel], d_obj[sel], t_min[sel], best[sel], chunk=16)
        idx = sel[hit_l]
        best[idx], row[idx] = t_l[hit_l], 16 * g + tri_l[hit_l]
        u[idx], v[idx] = u_l[hit_l], v_l[hit_l]
    return MeshWalk(row >= 0, best, row, u, v, nodes, 16 * leaves.sum(dim=1), leaves)


class SphereWalk(NamedTuple):
    """The nearest sphere hits by the sphere-tree walk."""

    hit: torch.Tensor  # (N,) bool
    t: torch.Tensor  # (N,) the nearest t, inf on a miss
    idx: torch.Tensor  # (N,) int32 the sphere's index, 0 on a miss
    nodes: torch.Tensor  # (N,) int64 tree nodes tested
    spheres: torch.Tensor  # (N,) int64 spheres tested


SPHERE_PAD = 2.0 ** -9  # csrc/intersect.cuh::kSphPad


def walk_spheres(scene: SceneData, o, d, t_min, t_max) -> SphereWalk:
    """The plain version of csrc/intersect.cuh::walk_spheres on the scene's
    sphere tree (models/scene.py::sphere_tree), for world rays o, d (N, 3)
    and t_min, t_max (scalars or (N,)): the stackless preorder walk, each
    node's box grown by SPHERE_PAD · (|o|_inf + the tree's reach) and tested
    within [t_min, min(best, t_max)], and at each leaf reached its spheres
    by intersect_spheres' arithmetic, a hit kept when (t, index) is below
    the best so far. It gives intersect_spheres' (t, index) on every ray,
    ties to the lowest index included; the tests hold it to that. The rays
    walk together, node by node: a node no ray reaches is passed over with
    its subtree, and a leaf's spheres are tested at once, its least (t,
    index) kept, which is what testing them one after another keeps. On a
    scene with a sphere tree the plain intersection (analytic_candidates)
    takes this walk, as K1 and K2 do on the card."""
    g = scene.sph_tree_leaves
    if not g:
        raise ValueError("the scene has no sphere tree")
    n, dev = o.shape[0], o.device
    tbl = scene.ksph_tree
    leaf = 4 * g  # the slots' first row
    slots = tbl[leaf:leaf + leaf]
    ids = tbl[leaf + leaf:].reshape(-1).to(torch.int64)
    t_min = torch.broadcast_to(vm.as_f32(t_min, o), (n,))
    t_max = torch.broadcast_to(vm.as_f32(t_max, o), (n,))
    pad = vm.as_f32(SPHERE_PAD, o) * (o.abs().amax(dim=1) + tbl[0, 0])
    lo_o, hi_o = o + pad[:, None], o - pad[:, None]
    inv = 1.0 / d
    best = torch.full((n,), _BIG, dtype=torch.float32, device=dev)
    idx = torch.zeros((n,), dtype=torch.int64, device=dev)
    nodes = torch.zeros((n,), dtype=torch.int64, device=dev)
    spheres = torch.zeros_like(nodes)
    entered = torch.zeros((n, 2 * g), dtype=torch.bool, device=dev)  # by heap index
    j = 1
    while True:
        sel = (torch.arange(n, device=dev) if j == 1 else entered[:, j // 2].nonzero()[:, 0])
        reached = sel.numel() > 0
        if reached:
            nodes[sel] += 1
            t0 = (tbl[2 * j, :3] - lo_o[sel]) * inv[sel]
            t1 = (tbl[2 * j + 1, :3] - hi_o[sel]) * inv[sel]
            near, fa = torch.fmin(t0, t1), torch.fmax(t0, t1)
            lo_t = torch.fmax(torch.fmax(near[:, 0], near[:, 1]),
                              torch.fmax(near[:, 2], t_min[sel]))
            hi_t = torch.fmin(torch.fmin(fa[:, 0], fa[:, 1]),
                              torch.fmin(fa[:, 2], torch.fmin(best[sel], t_max[sel])))
            sel = sel[hi_t >= lo_t]
            entered[sel, j] = True
            reached = sel.numel() > 0
        if reached and j < g:
            j *= 2  # an inner node some ray entered: its first child
            continue
        if reached:  # a leaf: its spheres, the slots before the first empty one
            first = 4 * (j - g)
            own = ids[first:first + 4]
            k = int((own >= 0).sum())
            spheres[sel] += k
            ok, r1, r2 = _sphere_roots(o[sel][:, None, :], d[sel][:, None, :],
                                       slots[first:first + k, :3], slots[first:first + k, 3])
            t = torch.where(r1 >= t_min[sel, None], r1, r2)
            valid = ok & (t >= t_min[sel, None]) & (t <= t_max[sel, None])
            t_l, c, v_l = _pick(t, valid)  # the leaf's least t, its lowest slot on ties
            s_l = own[c.long()]
            b, i = best[sel], idx[sel]
            keep = v_l & ((t_l < b) | ((t_l == b) & (s_l < i)))
            best[sel] = torch.where(keep, t_l, b)
            idx[sel] = torch.where(keep, s_l, i)
        j = (j >> (((~j) & (j + 1)).bit_length() - 1)) + 1  # past j's subtree
        if j == 1:
            break
    hit = best < _BIG
    return SphereWalk(hit, best, torch.where(hit, idx, 0).to(torch.int32), nodes, spheres)


def tree_entered(tree: torch.Tensor, s: int, o_obj, inv, t_min, far, live) -> torch.Tensor:
    """(N, 2s - 1) bool: the nodes of a superleaf tree over s superleaves
    (rows in heap order) that a walk culling against the fixed far bound
    `far` (N,) enters: a node whose box the ray meets within [t_min, far]
    and whose ancestors it entered; a ray not `live` enters none."""
    entered = _slab(tree[:, 0:3], tree[:, 4:7], o_obj[:, None], inv[:, None], t_min[:, None],
                    far[:, None])
    entered[:, 0] &= live
    j = 2
    while j <= 2 * s - 1:  # level by level: node j's parent j // 2 is decided first
        cols = torch.arange(j, min(2 * j, 2 * s), device=tree.device)
        entered[:, cols - 1] &= entered[:, cols // 2 - 1]
        j *= 2
    return entered


def dense_scan_counts(scene: SceneData, o, d, t_min, t_max, t_hit, stats: dict) -> None:
    """Add to stats (per-ray int64) the tests that the CUDA kernels'
    dense-mesh walk (csrc/intersect.cuh::scan_dense_mesh) needs for rays
    whose nearest hit is at t_hit (inf on a miss), culling against
    [t_min, min(t_hit, t_max)]:
    - "nodes": the superleaf-tree nodes the preorder walk tests: the root,
      and both children of every inner node it enters;
    - "tris": the 16 rows of each superleaf it reaches;
    - "boxes": every superleaf box of every dense mesh, the tests of the
      flat scan that the walk replaced (the old yardstick).
    The kernels cull against a running best that only falls to t_hit, so
    they test at least as many. The walk reaches exactly the superleaves
    that the flat scan reaches, so "tris" counts both. A ray with an empty
    window (t_max < t_min: a dead ray) needs none."""
    n = o.shape[0]
    t_min = torch.broadcast_to(vm.as_f32(t_min, o), (n,))
    t_max = torch.broadcast_to(vm.as_f32(t_max, o), (n,))
    far = torch.fmin(t_hit, t_max)
    live = t_max >= t_min
    boxes = torch.zeros((n,), dtype=torch.int64, device=o.device)
    nodes, tris = torch.zeros_like(boxes), torch.zeros_like(boxes)
    for k, mi in enumerate(scene.dense_mesh_ids):
        o_obj, d_obj = object_rays(scene.meshes[mi], o, d)
        s = scene.ksl_ranges[k][1]
        entered = tree_entered(superleaf_tree_rows(scene, k), s, o_obj, 1.0 / d_obj, t_min, far,
                               live)
        boxes += s * live
        nodes += live + 2 * entered[:, :s - 1].sum(dim=1)
        tris += 16 * entered[:, s - 1:].sum(dim=1)
    for key, x in (("boxes", boxes), ("nodes", nodes), ("tris", tris)):
        stats[key] = stats.get(key, 0) + x


def big_walk_counts(scene: SceneData, o, d, t_min, t_max, t_hit, stats: dict) -> None:
    """Add to stats (per-ray int64) the tests that K1's walk of the big
    meshes (csrc/intersect.cuh::walk_big_mesh) needs for rays whose nearest
    hit is at t_hit (inf on a miss): each big mesh's BVH walked as
    ops/bvh.py::traverse_packed walks it, step for step as the kernel,
    within [t_min, min(t_hit, t_max)]:
    - "big_nodes": the BVH boxes it tests (an interior root's, and both
      children's of every interior node it opens);
    - "big_tris": the triangles it tests.
    K1 walks against a running best that only falls to t_hit, so it tests
    at least as many. A ray with an empty window (a dead ray) needs none.
    Both are zero on a scene without a big mesh."""
    n = o.shape[0]
    t_min = torch.broadcast_to(vm.as_f32(t_min, o), (n,))
    t_max = torch.broadcast_to(vm.as_f32(t_max, o), (n,))
    far = torch.fmin(t_hit, t_max)
    live = t_max >= t_min
    nodes = torch.zeros((n,), dtype=torch.int64, device=o.device)
    tris = torch.zeros_like(nodes)
    for mi, mesh in enumerate(scene.meshes):
        if mi in scene.dense_mesh_ids:
            continue
        o_obj, d_obj = object_rays(mesh, o, d)
        walk: dict = {}
        bvhlib.traverse_packed(o_obj, d_obj, t_min, far, mesh.bvh_nodes, mesh.bvh_tri4,
                               mesh.bvh_depth, stats=walk)
        nodes += walk["boxes"] * live
        tris += walk["tris"] * live
    for key, x in (("big_nodes", nodes), ("big_tris", tris)):
        stats[key] = stats.get(key, 0) + x


def select_winner(candidates: list[dict], fields):
    """(winner (N,) int64, {field: the winner's value}): the argmin of t
    across candidates, the earlier candidate on ties."""
    winner = torch.argmin(torch.stack([c["t"] for c in candidates], dim=1), dim=1)

    def select(field):
        out = candidates[0][field]
        for g in range(1, len(candidates)):
            sel = winner == g
            if out.ndim > 1:
                sel = sel[:, None]
            out = torch.where(sel, candidates[g][field], out)
        return out

    return winner, {f: select(f) for f in fields}


def gvol_candidates(scene: SceneData, o, d, t_min, t_max, u_vol) -> list[dict]:
    """Each general volume's scatter event as a candidate (valid, t inf
    when invalid, point, zero normal, no front face, mat: its material id),
    as analytic_candidates gives the other volumes'; its uniforms are
    u_vol's columns after the V sphere-volume columns."""
    n, n_vcols = o.shape[0], scene.vol_center.shape[0]
    out = []
    for g in range(scene.n_gvols):
        t_g, v_g = intersect_general_volume(scene.gvol_tri[g], scene.gvol_density[g], o, d, t_min,
                                            t_max, u_vol[:, n_vcols + g], eps=scene.gvol_eps[g])
        out.append(dict(valid=v_g, t=torch.where(v_g, t_g, torch.full_like(t_g, _BIG)),
                        point=o + t_g[:, None] * d, normal=torch.zeros_like(o),
                        frontface=torch.zeros_like(v_g), mat=scene.gvol_mat[g].expand(n)))
    return out


def intersect_scene_plain(scene: SceneData, o, d, t_min, t_max, u_vol,
                          stats: dict | None = None) -> HitRecord:
    """Nearest hit across every primitive class (tracing.rs:326-350).

    o, d: (N, 3) world rays (directions may be unnormalized); t_min,
    t_max: scalars or (N,); u_vol: (N, V + G) free-flight uniforms, V the
    padded volume-table length, G the general volumes. stats: when a dict,
    receives the per-ray test counts of the sphere tree's walk
    (analytic_candidates), of the dense meshes' walks (dense_scan_counts)
    and of the big meshes' (big_walk_counts).
    """
    n = o.shape[0]
    candidates = (analytic_candidates(scene, o, d, t_min, t_max, u_vol, stats=stats)
                  + gvol_candidates(scene, o, d, t_min, t_max, u_vol))
    for c in candidates:
        c.update(_gather_material(scene, c["mat"]))
    for mesh in scene.meshes:
        candidates.append(intersect_mesh_plain(mesh, scene, o, d, t_min, t_max))

    # winner: argmin of raw t across classes, the earlier class on ties
    # (object-space mesh t against world t — the reference's quirk)
    winner, sel = select_winner(candidates, ("t", "point", "normal", "frontface") + MAT_FIELDS)
    if stats is not None:
        dense_scan_counts(scene, o, d, t_min, t_max, sel["t"], stats)
        big_walk_counts(scene, o, d, t_min, t_max, sel["t"], stats)
    valid = torch.zeros((n,), dtype=torch.bool, device=o.device)
    for g, c in enumerate(candidates):
        valid = valid | ((winner == g) & c["valid"])
    return HitRecord(valid=valid, **sel)


def intersect_scene_fused(scene: SceneData, o, d, t_min, t_max, u_vol) -> HitRecord:
    """The staged path's intersection: K2 over the analytic classes and the
    dense meshes, K3 per big mesh, the general volumes, and one merged
    resolve of the mesh winners (intersect.py:559 in the JAX package).
    Same semantics as intersect_scene_plain.

    Each big mesh is traversed with t_max = min(t_max, t so far) per ray —
    hits already found cull its BVH (t is a valid bound because the ray
    parameter is transform-invariant) — and replaces the running winner
    only at a strictly smaller t; so does each general volume after them
    (its winner code CODE_GVOL0 + g). K2 writes a dense mesh's material id
    for its winners, -1 for a material synthesized from textures: the ids
    are clipped to the table before the gather, and the resolve (R1)
    overwrites every mesh winner. The wrappers launch their kernels for CUDA
    tensors and run their plain versions for CPU tensors.
    """
    from cs397raytracingsp22_tpu_torch.ops.kernels import resolve, scene_intersect, tri_scan_big

    n = o.shape[0]
    o, d = o.contiguous(), d.contiguous()
    t_min = torch.broadcast_to(vm.as_f32(t_min, o), (n,)).contiguous()
    t_max = torch.broadcast_to(vm.as_f32(t_max, o), (n,)).contiguous()
    t, code, idx, mat_id, u, v, normal, ff = scene_intersect.scene_intersect_cuda(
        scene, o, d, t_min, t_max, u_vol[:, :scene.vol_center.shape[0]].contiguous())
    valid = code >= 0

    n_dense = len(scene.dense_mesh_ids)
    mesh_order = resolve_order(scene.dense_mesh_ids, len(scene.meshes))
    for j, mi in enumerate(mesh_order[n_dense:]):
        o_obj, d_obj = object_rays(scene.meshes[mi], o, d)
        hit_m, t_m, tri_m, u_m, v_m = tri_scan_big.tri_scan_big_cuda(
            scene.meshes[mi], o_obj.contiguous(), d_obj.contiguous(), t_min,
            torch.minimum(t_max, t))
        better = hit_m & (t_m < t)
        t = torch.where(better, t_m, t)
        code = torch.where(better, torch.full_like(code, CODE_MESH0 + n_dense + j), code)
        idx = torch.where(better, tri_m, idx)
        u = torch.where(better, u_m, u)
        v = torch.where(better, v_m, v)
        valid = valid | better

    for g, c in enumerate(gvol_candidates(scene, o, d, t_min, t_max, u_vol)):
        better = c["valid"] & (c["t"] < torch.where(valid, t, torch.full_like(t, _BIG)))
        t = torch.where(better, c["t"], t)
        code = torch.where(better, torch.full_like(code, CODE_GVOL0 + g), code)
        mat_id = torch.where(better, c["mat"], mat_id)
        normal = torch.where(better[:, None], 0.0, normal)
        ff = ff & ~better
        valid = valid | better

    fields = dict(point=o + t[:, None] * d, normal=normal, frontface=ff, mat=mat_id)
    if mesh_order:
        with profiling.span("mesh_resolve"):
            fields = resolve.resolve_winners(scene, o, d, code, t, idx, u, v, fields)
    else:
        fields.update(_gather_material(scene, _table_ids(scene, fields.pop("mat"))))
    return HitRecord(valid=valid, t=torch.where(valid, t, torch.full_like(t, _BIG)), **fields)


def _table_ids(scene: SceneData, mid):
    """Material ids clipped to the table: K2 writes -1 for a winner whose
    material is synthesized from textures, and torch would wrap it to the
    last row (the resolve replaces those winners' fields)."""
    return torch.clamp(mid, 0, scene.mat_type.shape[0] - 1)


def _per_ray(values: list, masks: list, shape: tuple = ()) -> torch.Tensor:
    """(N, *shape): values[j] (a row, a per-ray tensor or a scalar) on the
    rays of masks[j], values[0] on every other ray (the caller masks those
    out)."""
    dev = masks[0].device
    out = torch.as_tensor(values[0], device=dev)
    for val, mask in zip(values[1:], masks[1:]):
        out = torch.where(mask.reshape(-1, *[1] * len(shape)), torch.as_tensor(val, device=dev),
                          out)
    return torch.broadcast_to(out, (masks[0].shape[0], *shape))


class MeshWinners(NamedTuple):
    """The merged resolve's per-ray view of the mesh winners."""

    is_mesh: torch.Tensor  # (N,) bool: a mesh won the ray
    masks: list  # per mesh of resolve_order, (N,) bool: that mesh won
    rows: torch.Tensor  # (N, 18) the winner's kmesh_res row


def mesh_winners(scene: SceneData, code, idx) -> MeshWinners:
    """The mesh winners of codes `code` (mesh j of resolve_order at
    CODE_MESH0 + j) and their triangles idx (clamped to their mesh): one
    gather of their kmesh_res rows."""
    order = resolve_order(scene.dense_mesh_ids, len(scene.meshes))
    masks = [code == CODE_MESH0 + j for j in range(len(order))]
    first = [0]
    for mi in order:
        first.append(first[-1] + scene.meshes[mi].tri_normals.shape[0])
    row = _per_ray([first[j] + torch.clamp(idx, 0, first[j + 1] - first[j] - 1)
                    for j in range(len(order))], masks)
    is_mesh = masks[0]
    for mask in masks[1:]:
        is_mesh = is_mesh | mask
    return MeshWinners(is_mesh, masks, scene.kmesh_res[row.long()])


def _barycentric(corners, u, v):
    """u·b + v·c + (1 - u - v)·a of (N, 3K) rows of corners [a, b, c]
    (geometry.rs:350, 355)."""
    k = corners.shape[1] // 3
    w = 1.0 - u - v
    return (u[:, None] * corners[:, k:2 * k] + v[:, None] * corners[:, 2 * k:]
            + w[:, None] * corners[:, :k])


def _slot(scene: SceneData, win: MeshWinners, slot: int):
    """(offset, width, height, bound) of texture slot `slot` of each
    winner's mesh (kmesh_tex); an unbound slot reads texel 0 of a 1 × 1
    texture."""
    bind = _per_ray(list(scene.kmesh_tex[:len(win.masks), 3 * slot:3 * slot + 3]), win.masks,
                    (3,))
    bound = win.is_mesh & (bind[:, 0] >= 0)
    one = torch.ones_like(bound, dtype=torch.int32)
    return (torch.where(bound, bind[:, 0], torch.zeros_like(one)),
            torch.where(bound, bind[:, 1], one), torch.where(bound, bind[:, 2], one), bound)


def mesh_texels(scene: SceneData, code, idx, u, v, slot: int = 0) -> torch.Tensor:
    """The atlas row that the merged resolve samples for texture slot
    `slot` of each mesh winner (code, idx, u, v as the scene-intersection
    kernels return them), -1 where no mesh won or the slot is unbound."""
    win = mesh_winners(scene, code, idx)
    uv = _barycentric(win.rows[:, 9:15], u, v)
    off, w, h, bound = _slot(scene, win, slot)
    return torch.where(bound, texel_index(off, w, h, uv), -1)


def resolve_mesh_winners(scene: SceneData, obj_rays: dict, code, t, idx, u, v,
                         fields: dict) -> dict:
    """The shading resolve of every mesh winner at once (intersect.py:751
    in the JAX package, `_resolve_mesh_winners_merged`; the values of
    resolve_mesh_hit, bit for bit): one gather of the winners' triangle
    rows from scene.kmesh_res (mesh_winners), per-ray selects of each
    winner's object-space ray, transform rows (kmesh_xfm) and texture
    bindings (kmesh_tex) over the few meshes, one atlas gather per texture
    slot that some mesh binds, then one gather of the material rows.

    obj_rays: mesh index → that mesh's object-space (o, d). fields: point,
    normal, frontface and mat (the material id) of every ray. Returns
    point, normal, frontface and the material's fields (MAT_FIELDS), the
    mesh winners' in place: their mesh's material row, or the material
    synthesized from its textures."""
    order = resolve_order(scene.dense_mesh_ids, len(scene.meshes))
    meshes = [scene.meshes[mi] for mi in order]
    n = code.shape[0]
    win = mesh_winners(scene, code, idx)
    o_obj = _per_ray([obj_rays[mi][0] for mi in order], win.masks, (3,))
    d_obj = _per_ray([obj_rays[mi][1] for mi in order], win.masks, (3,))
    n_smooth = vm.normalize(_barycentric(win.rows[:, 0:9], u, v), eps=1e-30)
    frontface = vm.dot(n_smooth, d_obj) < 0.0
    n_flip = torch.where(frontface[:, None], n_smooth, -n_smooth)
    if any(t_id >= 0 for m in meshes for t_id in m.tex_ids):
        uv = _barycentric(win.rows[:, 9:15], u, v)

    def sample_slot(slot):  # (rgb, bound): the slot's texel where the winner's mesh binds one
        off, w, h, bound = _slot(scene, win, slot)
        return sample_texture_dyn(scene, off, w, h, uv), bound

    n_obj = n_flip
    if any(m.tex_ids[4] >= 0 for m in meshes):
        nm_rgb, nm_bound = sample_slot(4)
        n_obj = torch.where(nm_bound[:, None], _normal_mapped(n_flip, win.rows[:, 15:18], nm_rgb),
                            n_flip)

    def mat3(r, p):  # rows r (N, 9) row-major times p, apply_mat4_vector's order
        return r[:, 0::3] * p[:, 0:1] + r[:, 1::3] * p[:, 1:2] + r[:, 2::3] * p[:, 2:3]

    xfm = _per_ray(list(scene.kmesh_xfm[:len(order), :21]), win.masks, (21,))
    is_mesh = win.is_mesh
    out = dict(
        point=torch.where(is_mesh[:, None],
                          mat3(xfm[:, 9:18], o_obj + t[:, None] * d_obj) + xfm[:, 18:21],
                          fields["point"]),
        normal=torch.where(is_mesh[:, None], vm.normalize(mat3(xfm[:, 0:9], n_obj), eps=1e-30),
                           fields["normal"]),
        frontface=torch.where(is_mesh, frontface, fields["frontface"]),
    )
    mesh_mat = _per_ray([m.mat_id for m in meshes], win.masks)
    out.update(_gather_material(scene, _table_ids(scene, torch.where(is_mesh, mesh_mat,
                                                                     fields["mat"]))))
    if any(m.mat_id < 0 for m in meshes):  # materials synthesized from textures
        synth = is_mesh & (mesh_mat < 0)
        tm = _synthesized_material(n, t)
        for slot, name in enumerate(("albedo", "emission", "metallic", "roughness")):
            if any(m.mat_id < 0 and m.tex_ids[slot] >= 0 for m in meshes):
                rgb, bound = sample_slot(slot)
                if name in ("albedo", "emission"):
                    tm[name] = torch.where(bound[:, None], rgb, tm[name])
                else:
                    tm[name] = torch.where(bound, rgb[:, 0], tm[name])
        for f in MAT_FIELDS:
            out[f] = torch.where(synth[:, None] if out[f].ndim > 1 else synth, tm[f], out[f])
    return out


def intersect_scene(scene: SceneData, o, d, t_min, t_max, u_vol) -> HitRecord:
    """The fused path (K2 + K3) for CUDA tensors, the plain spec for CPU
    tensors. A scene with a sphere tree (64 spheres or more) takes K2's
    tree route on the card and the tree's plain walk on the CPU. Profiler
    traces show the call as the span "render.intersect"."""
    with profiling.span("render.intersect"):
        if o.device.type == "cuda":
            return intersect_scene_fused(scene, o, d, t_min, t_max, u_vol)
        return intersect_scene_plain(scene, o, d, t_min, t_max, u_vol)
