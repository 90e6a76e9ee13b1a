"""Scene-level intersection in plain torch: per-class batched tests and the
nearest-hit resolve.

Mirrors `cs397raytracingsp22_tpu/ops/intersect.py::intersect_scene_jnp`
for the scenes this slice runs (no textures, no general volumes, dense
meshes only). It is the intersection half of the plain version of the
mega-bounce kernel (ops/kernels/bounce.py).

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

import torch

from cs397raytracingsp22_tpu_torch.models.scene import MeshBlock, SceneData
from cs397raytracingsp22_tpu_torch.ops import bvh as bvhlib
from cs397raytracingsp22_tpu_torch.utils import vecmath as vm

_BIG = float("inf")


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
    x = torch.as_tensor(x, dtype=torch.float32, device=like.device)
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


def intersect_mesh(mesh: MeshBlock, scene: SceneData, o, d, t_min, t_max) -> dict:
    """One dense mesh: object-space scan plus the shading resolve. t stays
    in object space (comparable with world t because the direction is
    transformed without renormalization, geometry.rs:304)."""
    o_obj = vm.apply_mat4_point(mesh.inv_transform, o)
    d_obj = vm.apply_mat4_vector(mesh.inv_transform, d)
    hit, t, tri, u, v = bvhlib.intersect_tris_scan(o_obj, d_obj, mesh.tri_verts, t_min, t_max)
    fields = resolve_mesh_hit(mesh, o_obj, d_obj, t, tri, u, v)
    fields.update(
        _gather_material(scene, torch.full(t.shape, mesh.mat_id, dtype=torch.int32, device=t.device))
    )
    fields["valid"] = hit
    fields["t"] = torch.where(hit, t, torch.full_like(t, _BIG))
    return fields


def intersect_scene_plain(scene: SceneData, o, d, t_min, t_max, u_vol) -> HitRecord:
    """Nearest hit across every primitive class (tracing.rs:326-350).

    o, d: (N, 3) world rays (directions may be unnormalized); t_min,
    t_max: scalars or (N,); u_vol: (N, V) free-flight uniforms, V the
    padded volume-table length.
    """
    n = o.shape[0]
    dev = o.device
    zeros3 = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    candidates: list[dict] = []

    t_s, i_s, v_s = intersect_spheres(scene, o, d, t_min, t_max)
    center = scene.sph_center[i_s.long()]
    p = o + t_s[:, None] * d
    n_out = vm.normalize(p - center, eps=1e-30)
    ff = vm.dot(n_out, d) < 0.0
    candidates.append(dict(
        valid=v_s, t=t_s, point=p,
        normal=torch.where(ff[:, None], n_out, -n_out), frontface=ff,
        **_gather_material(scene, scene.sph_mat[i_s.long()]),
    ))

    t_p, i_p, v_p = intersect_planes(scene, o, d, t_min, t_max)
    pln_n = scene.pln_normal[i_p.long()]
    pln_pt = scene.pln_point[i_p.long()]
    n_pre = vm.signum(vm.dot(o - pln_pt, pln_n))[:, None] * pln_n
    ff = vm.dot(n_pre, d) < 0.0
    candidates.append(dict(
        valid=v_p, t=t_p, point=o + t_p[:, None] * d,
        normal=torch.where(ff[:, None], n_pre, -n_pre), frontface=ff,
        **_gather_material(scene, scene.pln_mat[i_p.long()]),
    ))

    t_t, i_t, v_t = intersect_triangles(scene, o, d, t_min, t_max)
    it = i_t.long()
    e1 = scene.tri_b[it] - scene.tri_a[it]
    e2 = scene.tri_c[it] - scene.tri_a[it]
    n_geo = vm.normalize(vm.cross(e1, e2), eps=1e-30)
    ff = vm.dot(n_geo, d) < 0.0
    candidates.append(dict(
        valid=v_t, t=t_t, point=o + t_t[:, None] * d,
        normal=torch.where(ff[:, None], n_geo, -n_geo), frontface=ff,
        **_gather_material(scene, scene.tri_mat[it]),
    ))

    n_vcols = scene.vol_center.shape[0]
    t_v, i_v, v_v = intersect_volumes(scene, o, d, t_min, t_max, u_vol[:, :n_vcols])
    candidates.append(dict(
        valid=v_v, t=t_v, point=o + t_v[:, None] * d,
        normal=zeros3, frontface=torch.zeros((n,), dtype=torch.bool, device=dev),
        **_gather_material(scene, scene.vol_mat[i_v.long()]),
    ))

    for mesh in scene.meshes:
        candidates.append(intersect_mesh(mesh, scene, o, d, t_min, t_max))

    # winner: argmin of raw t across classes, the earlier class on ties
    # (object-space mesh t against world t — the reference's quirk)
    winner = torch.argmin(torch.stack([c["t"] for c in candidates], dim=1), dim=1)

    def select(field):
        out = candidates[0][field]
        for g in range(1, len(candidates)):
            sel = winner == g
            if out.ndim > 1:
                sel = sel[:, None]
            out = torch.where(sel, candidates[g][field], out)
        return out

    valid = torch.zeros((n,), dtype=torch.bool, device=dev)
    for g, c in enumerate(candidates):
        valid = valid | ((winner == g) & c["valid"])
    return HitRecord(
        valid=valid,
        **{f: select(f) for f in ("t", "point", "normal", "frontface", "mtype",
                                  "albedo", "emission", "roughness", "metallic", "ior")},
    )
