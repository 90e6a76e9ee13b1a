"""Mesh acceleration: host-side BVH build, the dense triangle scan and the
threaded-BVH traversal.

Mirrors `cs397raytracingsp22_tpu/ops/bvh.py`. The BVH build (C++ through
utils/native.py, or the Python median split below) orders a mesh's
triangles so that consecutive rows are spatial neighbours; the compiled
scene keeps that order, and the superleaf boxes over 16 consecutive rows
(models/scene.py) cull whole groups in the CUDA kernels. Dense meshes are
intersected by the Möller–Trumbore scan (`intersect_tris_scan`), the spec
of the mega-bounce and scene-intersection kernels; meshes beyond the dense
budget by the stackless traversal of the threaded BVH (`traverse`), the
plain version of the big-mesh traversal kernel (ops/kernels/tri_scan_big.py).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from cs397raytracingsp22_tpu_torch.utils import vecmath as vm

MT_EPSILON = 1e-4  # Möller–Trumbore parallel-ray epsilon (geometry.rs:335)

# Meshes at or below this many triangles (and at most this many in total
# over a scene's meshes) take the dense path. Larger meshes are traversed
# through their BVH on the staged path.
DENSE_MESH_MAX_TRIS = 8192


def tri_rows_aabb(rows: np.ndarray) -> np.ndarray:
    """Eps-padded AABB [lo, hi] (6,) over (K, 9) [a, e1, e2] triangle rows.
    The pad absorbs the slab test's strict inequality on flat groups and
    the rounding of the corner sums. Empty input gives a never-hit box."""
    if rows.shape[0] == 0:
        return np.array([1e30] * 3 + [-1e30] * 3, np.float32)
    a = rows[:, 0:3]
    b = a + rows[:, 3:6]
    c = a + rows[:, 6:9]
    pts = np.concatenate([a, b, c], axis=0)
    lo = pts.min(axis=0)
    hi = pts.max(axis=0)
    pad = 1e-4 + 1e-4 * np.abs(np.stack([lo, hi])).max(axis=0)
    return np.concatenate([lo - pad, hi + pad]).astype(np.float32)


@dataclasses.dataclass
class FlatBVH:
    """Host-side build result (numpy), threaded in DFS pre-order."""

    bounds_min: np.ndarray  # (NN, 3) float32
    bounds_max: np.ndarray  # (NN, 3) float32
    skip: np.ndarray  # (NN,) int32 — next node on AABB miss
    leaf_start: np.ndarray  # (NN,) int32 — first tri (reordered ids); -1 interior
    leaf_count: np.ndarray  # (NN,) int32
    tri_order: np.ndarray  # (NT,) int32 — reordered position → original tri id


def build_bvh(tri_verts: np.ndarray, leaf_size: int = 4, use_native: bool = True) -> FlatBVH:
    """Threaded flat BVH over (NT, 3, 3) vertices: median split on the
    largest centroid-extent axis. Uses the C++ builder when available;
    this Python version is the specification and fallback."""
    nt = tri_verts.shape[0]
    assert nt > 0, "cannot build BVH over empty mesh"
    if use_native:
        from cs397raytracingsp22_tpu_torch.utils import native

        raw = native.bvh_build(tri_verts, leaf_size) if native.available() else None
        if raw is not None:
            return FlatBVH(**raw)
    tmin = tri_verts.min(axis=1)
    tmax = tri_verts.max(axis=1)
    centroids = 0.5 * (tmin + tmax)

    bounds_min: list[np.ndarray] = []
    bounds_max: list[np.ndarray] = []
    skip: list[int] = []
    leaf_start: list[int] = []
    leaf_count: list[int] = []
    order: list[np.ndarray] = []

    def rec(ids: np.ndarray, out_base: int) -> None:
        node = len(skip)
        bounds_min.append(tmin[ids].min(axis=0))
        bounds_max.append(tmax[ids].max(axis=0))
        skip.append(-1)  # patched after the subtree is emitted
        if len(ids) <= leaf_size:
            leaf_start.append(out_base)
            leaf_count.append(len(ids))
            order.append(ids)
        else:
            leaf_start.append(-1)
            leaf_count.append(0)
            c = centroids[ids]
            axis = int(np.argmax(c.max(axis=0) - c.min(axis=0)))
            mid = len(ids) // 2
            part = np.argsort(c[:, axis], kind="stable")
            rec(ids[part[:mid]], out_base)
            rec(ids[part[mid:]], out_base + mid)
        skip[node] = len(skip)

    rec(np.arange(nt, dtype=np.int64), 0)
    return FlatBVH(
        bounds_min=np.stack(bounds_min).astype(np.float32),
        bounds_max=np.stack(bounds_max).astype(np.float32),
        skip=np.asarray(skip, np.int32),
        leaf_start=np.asarray(leaf_start, np.int32),
        leaf_count=np.asarray(leaf_count, np.int32),
        tri_order=np.concatenate(order).astype(np.int32),
    )


def slab_test(o, d, bmin, bmax, t_min, t_max):
    """Vectorized AABB slab test (geometry.rs:52-68): o, d, bmin, bmax
    (..., 3), t_min, t_max broadcastable to (...). Returns a bool mask.

    A NaN lane (0·inf where a direction component is zero on a face) must
    not constrain the interval, as Rust's f32::max/min ignore NaN: lo is
    washed to -inf and hi to +inf with fmax/fmin."""
    inv_d = 1.0 / d
    t0 = (bmin - o) * inv_d
    t1 = (bmax - o) * inv_d
    neg = inv_d < 0.0
    lo = torch.where(neg, t1, t0)
    hi = torch.where(neg, t0, t1)
    inf = torch.tensor(float("inf"), dtype=lo.dtype, device=lo.device)
    tmin = torch.maximum(torch.amax(torch.fmax(lo, -inf), dim=-1), vm.as_f32(t_min, lo))
    tmax = torch.minimum(torch.amin(torch.fmin(hi, inf), dim=-1), vm.as_f32(t_max, lo))
    return tmax > tmin


def traverse(o, d, t_min, t_max, bounds_min, bounds_max, skip, leaf_start, leaf_count,
             tri_verts, leaf_size: int, stats: dict | None = None):
    """Stackless threaded-BVH traversal for a ray batch (the spec of the
    big-mesh traversal kernel).

    o, d: (N, 3) rays in the mesh's object space; t_min, t_max: scalars or
    (N,); node arrays as in FlatBVH; tri_verts (NT, 3, 3) in BVH order.
    Returns (hit, t, tri_idx, u, v), tri_idx a row of tri_verts.

    Each ray starts at the root. An interior node whose box the ray meets
    within [t_min, best t] is entered (node + 1), otherwise skipped
    (skip[node]). A leaf skips the box test, like the reference
    (geometry.rs:95-97: flat axis-aligned triangles would fail the strict
    slab test), tests its ≤ leaf_size triangles in order, each accepted at
    t <= the running best (a later triangle at equal t wins), and moves
    to skip[node]. All rays step in lockstep until every one is past the
    last node.

    stats: when a dict, receives per-ray int64 counts "boxes" (interior
    nodes whose box was tested) and "tris" (triangles tested).
    """
    n = o.shape[0]
    nn = bounds_min.shape[0]
    nt = tri_verts.shape[0]
    dev = o.device
    t_min = vm.as_f32(t_min, o)
    node = torch.zeros((n,), dtype=torch.int64, device=dev)
    best_t = torch.broadcast_to(vm.as_f32(t_max, o), (n,)).clone()
    best_tri = torch.full((n,), -1, dtype=torch.int32, device=dev)
    best_u = torch.zeros((n,), dtype=torch.float32, device=dev)
    best_v = torch.zeros((n,), dtype=torch.float32, device=dev)
    if stats is not None:
        stats["boxes"] = torch.zeros((n,), dtype=torch.int64, device=dev)
        stats["tris"] = torch.zeros((n,), dtype=torch.int64, device=dev)
    skip = skip.long()
    while True:
        active = node < nn
        if not bool(active.any()):
            break
        node_c = torch.clamp(node, max=nn - 1)
        ls = leaf_start[node_c].long()
        lc = leaf_count[node_c].long()
        is_leaf = ls >= 0
        box_hit = slab_test(o, d, bounds_min[node_c], bounds_max[node_c], t_min, best_t)
        for k in range(leaf_size):
            tid = torch.clamp(ls + k, 0, nt - 1)
            verts = tri_verts[tid]
            valid, t, u, v = moller_trumbore(
                o, d, verts[:, 0], verts[:, 1], verts[:, 2], t_min, best_t
            )
            valid = valid & active & is_leaf & (k < lc)
            best_tri = torch.where(valid, (ls + k).to(torch.int32), best_tri)
            best_u = torch.where(valid, u, best_u)
            best_v = torch.where(valid, v, best_v)
            best_t = torch.where(valid, t, best_t)
        if stats is not None:
            stats["boxes"] += (active & ~is_leaf).long()
            stats["tris"] += torch.where(active & is_leaf, lc, 0)
        nxt = torch.where(is_leaf | ~box_hit, skip[node_c], node_c + 1)
        node = torch.where(active, nxt, node)
    return best_tri >= 0, best_t, best_tri, best_u, best_v


def moller_trumbore(o, d, va, vb, vc, t_min, t_max, eps=MT_EPSILON):
    """Batched Möller–Trumbore (geometry.rs:331-349 semantics).

    o, d, va, vb, vc: broadcastable (..., 3). Returns (valid, t, u, v).
    Rejects |det| < eps, u < 0, v < 0, u+v > 1 and t outside
    [t_min, t_max], exactly as the reference.
    """
    e1 = vb - va
    e2 = vc - va
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
    e1x, e1y, e1z = e1[..., 0], e1[..., 1], e1[..., 2]
    e2x, e2y, e2z = e2[..., 0], e2[..., 1], e2[..., 2]
    qx = dy * e2z - dz * e2y
    qy = dz * e2x - dx * e2z
    qz = dx * e2y - dy * e2x
    det = e1x * qx + e1y * qy + e1z * qz
    det_ok = torch.abs(det) >= eps
    f = 1.0 / torch.where(det_ok, det, torch.ones_like(det))
    s = o - va
    sx, sy, sz = s[..., 0], s[..., 1], s[..., 2]
    u = f * (sx * qx + sy * qy + sz * qz)
    rx = sy * e1z - sz * e1y
    ry = sz * e1x - sx * e1z
    rz = sx * e1y - sy * e1x
    v = f * (dx * rx + dy * ry + dz * rz)
    t = f * (e2x * rx + e2y * ry + e2z * rz)
    valid = det_ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t >= t_min) & (t <= t_max)
    return valid, t, u, v


def intersect_tris_scan(o, d, tri_verts, t_min, t_max, chunk: int = 256):
    """Dense chunked all-triangles intersection with a running nearest hit:
    within a chunk the earliest index of the least t wins, and a later
    chunk replaces the running hit only when strictly nearer.

    o, d: (N, 3); tri_verts: (NT, 3, 3); t_min, t_max: scalars or (N,).
    Returns (hit, t, tri_idx, u, v)."""
    nt = tri_verts.shape[0]
    n = o.shape[0]
    dev = o.device
    n_chunks = (nt + chunk - 1) // chunk
    pad = n_chunks * chunk - nt
    if pad:
        tri_verts = torch.cat(
            [tri_verts, torch.zeros((pad, 3, 3), dtype=tri_verts.dtype, device=dev)]
        )
    chunks = tri_verts.reshape(n_chunks, chunk, 3, 3)
    t_min = torch.as_tensor(t_min, dtype=torch.float32, device=dev)
    if t_min.ndim == 1:
        t_min = t_min[:, None]
    best_t = torch.broadcast_to(
        torch.as_tensor(t_max, dtype=torch.float32, device=dev), (n,)
    ).clone()
    best_tri = torch.full((n,), -1, dtype=torch.int32, device=dev)
    best_u = torch.zeros((n,), dtype=torch.float32, device=dev)
    best_v = torch.zeros((n,), dtype=torch.float32, device=dev)
    rows = torch.arange(n, device=dev)
    lane = torch.arange(chunk, dtype=torch.int32, device=dev)
    o1 = o[:, None, :]
    d1 = d[:, None, :]
    for ci in range(n_chunks):
        tv = chunks[ci]
        valid, t, u, v = moller_trumbore(
            o1, d1, tv[None, :, 0], tv[None, :, 1], tv[None, :, 2],
            t_min, best_t[:, None],
        )
        valid = valid & ((ci * chunk + lane) < nt)[None, :]
        t_m = torch.where(valid, t, torch.full_like(t, float("inf")))
        k = torch.argmin(t_m, dim=1)
        better = valid[rows, k] & (t[rows, k] < best_t)
        best_tri = torch.where(better, ci * chunk + k.to(torch.int32), best_tri)
        best_u = torch.where(better, u[rows, k], best_u)
        best_v = torch.where(better, v[rows, k], best_v)
        best_t = torch.where(better, t[rows, k], best_t)
    return best_tri >= 0, best_t, best_tri, best_u, best_v
