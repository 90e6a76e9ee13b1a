"""Scene-level intersection: per-class batched tests and the nearest-hit
resolve.

Mirrors `cs397raytracingsp22_tpu/ops/intersect.py` for scenes without
textures or general-boundary volumes:
- `intersect_scene_plain` is `intersect_scene_jnp`, in plain torch: the
  spec, the intersection half of the mega-bounce kernel's plain version
  (render/integrator.py::path_trace), and what CPU tensors run;
- `intersect_scene_fused` is the staged path's intersection on the card:
  the scene-intersection kernel K2 (ops/kernels/scene_intersect.py: every
  analytic class and the dense meshes), then the big-mesh traversal
  kernel K3 per mesh beyond the dense budget (ops/kernels/tri_scan_big.py)
  with the running best t as its far bound, the merge, and one shading
  resolve of the mesh winners;
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
planes → triangles → volumes → meshes.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from cs397raytracingsp22_tpu_torch.models.scene import MeshBlock, SceneData
from cs397raytracingsp22_tpu_torch.ops import bvh as bvhlib
from cs397raytracingsp22_tpu_torch.utils import vecmath as vm

_BIG = float("inf")
CODE_MESH0 = 4  # winner code of mesh k in the fused path: 0-3 analytic classes, 4 + k


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


def resolve_mesh_hit(mesh: MeshBlock, o_obj, d_obj, t, tri, u, v):
    """Shading resolve of mesh hits from (t, tri, u, v) in object space:
    smooth normal (geometry.rs:350-351), front face against the
    object-space direction, normal matrix (geometry.rs:297), world point
    from the object-space point (geometry.rs:307)."""
    tri = torch.clamp(tri, min=0).long()
    w = 1.0 - u - v
    nabc = mesh.tri_normals[tri]
    n_smooth = vm.normalize(
        u[:, None] * nabc[:, 1] + v[:, None] * nabc[:, 2] + w[:, None] * nabc[:, 0],
        eps=1e-30,
    )
    frontface = vm.dot(n_smooth, d_obj) < 0.0
    n_flip = torch.where(frontface[:, None], n_smooth, -n_smooth)
    n_world = vm.normalize(vm.apply_mat4_vector(mesh.normal_mat, n_flip), eps=1e-30)
    p_obj = o_obj + t[:, None] * d_obj
    p_world = vm.apply_mat4_point(mesh.transform, p_obj)
    return dict(point=p_world, normal=n_world, frontface=frontface)


def object_rays(mesh: MeshBlock, o, d):
    """World rays in the mesh's object space, the direction not
    renormalized (geometry.rs:304), so t compares across objects."""
    return vm.apply_mat4_point(mesh.inv_transform, o), vm.apply_mat4_vector(mesh.inv_transform, d)


def _mesh_candidate(mesh: MeshBlock, o_obj, d_obj, hit, t, tri, u, v) -> dict:
    """The candidate fields of one mesh's nearest hits (t inf on a miss)."""
    fields = resolve_mesh_hit(mesh, o_obj, d_obj, t, tri, u, v)
    fields["mat"] = torch.full(t.shape, mesh.mat_id, dtype=torch.int32, device=t.device)
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
    return _mesh_candidate(mesh, o_obj, d_obj, hit, t, tri, u, v)


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
    return _mesh_candidate(mesh, o_obj, d_obj, hit, t, tri, u, v)


def analytic_candidates(scene: SceneData, o, d, t_min, t_max, u_vol) -> list[dict]:
    """The nearest hit of each analytic class (spheres, planes, triangles,
    volumes), each a dict of valid, t (inf when invalid), idx, point,
    normal (front-facing; zero for volumes), frontface and mat (id)."""
    n = o.shape[0]
    dev = o.device
    out = []

    t_s, i_s, v_s = intersect_spheres(scene, o, d, t_min, t_max)
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


def intersect_scene_plain(scene: SceneData, o, d, t_min, t_max, u_vol,
                          stats: dict | None = None) -> HitRecord:
    """Nearest hit across every primitive class (tracing.rs:326-350).

    o, d: (N, 3) world rays (directions may be unnormalized); t_min,
    t_max: scalars or (N,); u_vol: (N, V) free-flight uniforms, V the
    padded volume-table length. stats: when a dict, receives the dense
    meshes' per-ray test counts (dense_scan_counts).
    """
    n = o.shape[0]
    candidates = analytic_candidates(scene, o, d, t_min, t_max, u_vol)
    for mesh in scene.meshes:
        candidates.append(intersect_mesh_plain(mesh, scene, o, d, t_min, t_max))

    # winner: argmin of raw t across classes, the earlier class on ties
    # (object-space mesh t against world t — the reference's quirk)
    winner, sel = select_winner(candidates, ("t", "point", "normal", "frontface", "mat"))
    if stats is not None:
        dense_scan_counts(scene, o, d, t_min, t_max, sel["t"], stats)
    valid = torch.zeros((n,), dtype=torch.bool, device=o.device)
    for g, c in enumerate(candidates):
        valid = valid | ((winner == g) & c["valid"])
    return HitRecord(
        valid=valid, t=sel["t"], point=sel["point"], normal=sel["normal"],
        frontface=sel["frontface"], **_gather_material(scene, sel["mat"]),
    )


def intersect_scene_fused(scene: SceneData, o, d, t_min, t_max, u_vol) -> HitRecord:
    """The staged path's intersection: K2 over the analytic classes and the
    dense meshes, K3 per big mesh, merge, and one resolve of mesh winners
    (intersect.py:559 in the JAX package, without textures and general
    volumes). Same semantics as intersect_scene_plain.

    Each big mesh is traversed with t_max = min(t_max, t so far) per ray —
    hits already found cull its BVH (t is a valid bound because the ray
    parameter is transform-invariant) — and replaces the running winner
    only at a strictly smaller t. The wrappers launch their kernels for
    CUDA tensors and run their plain versions for CPU tensors.
    """
    from cs397raytracingsp22_tpu_torch.ops.kernels import scene_intersect, tri_scan_big

    n = o.shape[0]
    o, d = o.contiguous(), d.contiguous()
    t_min = torch.broadcast_to(vm.as_f32(t_min, o), (n,)).contiguous()
    t_max = torch.broadcast_to(vm.as_f32(t_max, o), (n,)).contiguous()
    u_vol = u_vol[:, :scene.vol_center.shape[0]].contiguous()
    t, code, idx, mat, u, v, normal, ff = scene_intersect.scene_intersect_cuda(
        scene, o, d, t_min, t_max, u_vol)
    valid = code >= 0

    n_dense = len(scene.dense_mesh_ids)
    big_ids = [i for i in range(len(scene.meshes)) if i not in scene.dense_mesh_ids]
    mesh_order = list(scene.dense_mesh_ids) + big_ids
    obj_rays = {mi: object_rays(scene.meshes[mi], o, d) for mi in mesh_order}
    for j, mi in enumerate(big_ids):
        o_obj, d_obj = obj_rays[mi]
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

    point = o + t[:, None] * d
    # mesh winners: shading resolve per mesh under its winner mask
    for k, mi in enumerate(mesh_order):
        mesh = scene.meshes[mi]
        mask = code == CODE_MESH0 + k
        o_obj, d_obj = obj_rays[mi]
        tri = torch.clamp(idx, 0, mesh.tri_verts.shape[0] - 1)
        res = resolve_mesh_hit(mesh, o_obj, d_obj, t, tri, u, v)
        point = torch.where(mask[:, None], res["point"], point)
        normal = torch.where(mask[:, None], res["normal"], normal)
        ff = torch.where(mask, res["frontface"], ff)
        mat = torch.where(mask, torch.full_like(mat, mesh.mat_id), mat)
    return HitRecord(
        valid=valid, t=torch.where(valid, t, torch.full_like(t, _BIG)), point=point,
        normal=normal, frontface=ff, **_gather_material(scene, mat),
    )


def intersect_scene(scene: SceneData, o, d, t_min, t_max, u_vol) -> HitRecord:
    """The fused path (K2 + K3) for CUDA tensors, the plain spec for CPU
    tensors."""
    if o.device.type == "cuda":
        return intersect_scene_fused(scene, o, d, t_min, t_max, u_vol)
    return intersect_scene_plain(scene, o, d, t_min, t_max, u_vol)
