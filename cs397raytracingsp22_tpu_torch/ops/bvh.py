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
spec that the big-mesh traversal kernel (ops/kernels/tri_scan_big.py) and
the mega-bounce kernel's big-mesh walk are held to. Both walk the same tree
packed into child-pair rows (`pack_bvh`) in ray order, nearer child first,
with a stack (csrc/bvh_walk.cuh); their plain version is
`traverse_packed`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from cs397raytracingsp22_tpu_torch.utils import vecmath as vm

MT_EPSILON = 1e-4  # Möller–Trumbore parallel-ray epsilon (geometry.rs:335)

# Meshes at or below this many triangles (and at most this many in total
# over a scene's meshes) take the dense path. Larger meshes are traversed
# through their BVH: by the mega-bounce kernel (K1), or by K3 on the staged
# path.
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
    return _slab_entry(o, 1.0 / d, bmin, bmax, vm.as_f32(t_min, o), vm.as_f32(t_max, o))[0]


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


# The child-pair node table of the big-mesh kernel (csrc/bvh_traverse.cu).
# A row holds two child slots of 8 floats, [lo.xyz, ref, hi.xyz, 0]: ref is
# an interior child's row (>= 1) or a leaf's ~(first row << 4 | count), and
# row 0 holds the root in its first slot. Interior rows are numbered
# breadth first, so the top levels of the tree are the first rows.
NODE_ROW = 16
LEAF_COUNT_BITS = 4  # a leaf reference carries at most 15 triangles


def pack_bvh(bounds_min, bounds_max, skip, leaf_start, leaf_count) -> tuple[np.ndarray, int]:
    """(table (NI + 1, NODE_ROW) float32, depth) of a threaded BVH
    (FlatBVH's numpy arrays) for the ordered walk: the same boxes and rows,
    each interior node's two children in one 64-byte row, the int32
    references stored bit for bit. depth is the deepest leaf's count of
    interior ancestors, which bounds the walk's stack.

    Raises ValueError unless the tree is binary (interior node i has
    children i + 1 and skip[i + 1]), its leaves hold 1 to 15 triangles and
    meet the rows in increasing order in preorder, each leaf starting where
    the one before ended: the ordered walk returns the threaded walk's
    winner only then (its tie rule stands in for preorder)."""
    nn = int(skip.shape[0])
    sk = np.asarray(skip, np.int64)
    ls = np.asarray(leaf_start, np.int64)
    lc = np.asarray(leaf_count, np.int64)
    leaf = ls >= 0
    leaves = np.flatnonzero(leaf)
    starts, counts = ls[leaves], lc[leaves]
    if (counts < 1).any() or (counts >= 1 << LEAF_COUNT_BITS).any():
        raise ValueError(f"a leaf holds {counts.min()}..{counts.max()} triangles, not 1..15")
    if starts[0] != 0 or (starts[1:] != starts[:-1] + counts[:-1]).any():
        raise ValueError("the leaves do not meet the rows in increasing order in preorder")
    if int(starts[-1] + counts[-1]) >= 1 << (31 - LEAF_COUNT_BITS):
        raise ValueError(f"{int(starts[-1] + counts[-1])} triangles exceed the leaf references")
    inner = np.flatnonzero(~leaf)
    left = inner + 1
    if sk[0] != nn or (left >= nn).any():
        raise ValueError("the BVH's skip links do not thread one tree")
    right = sk[left]
    if ((right <= left) | (right >= sk[inner]) | (sk[np.minimum(right, nn - 1)] != sk[inner])).any():
        raise ValueError("the BVH is not binary")
    depth = np.zeros(nn, np.int64)
    for i, a, b in zip(inner.tolist(), left.tolist(), right.tolist()):  # parents come first
        depth[a] = depth[b] = depth[i] + 1
    bfs = [0] if not leaf[0] else []
    for i in bfs:  # grows while it is walked
        bfs.extend(c for c in (i + 1, int(sk[i + 1])) if not leaf[c])
    row = np.zeros(nn, np.int64)
    row[bfs] = np.arange(1, len(bfs) + 1)
    ref = np.where(leaf, ~((ls << LEAF_COUNT_BITS) | lc), row)
    table = np.zeros((len(bfs) + 1, NODE_ROW), np.float32)
    refs = table.view(np.int32)

    def put(rows, slot, nodes):
        c = 8 * slot
        table[rows, c:c + 3] = bounds_min[nodes]
        refs[rows, c + 3] = ref[nodes]
        table[rows, c + 4:c + 7] = bounds_max[nodes]

    put(0, 0, 0)
    b = np.asarray(bfs, np.int64)
    put(row[b], 0, b + 1)
    put(row[b], 1, sk[b + 1])
    return table, int(depth[leaves].max())


def _slab_entry(o, inv_d, lo, hi, t_min, best):
    """slab_test from the reciprocal direction: (hit, entry), entry the
    interval's start max(near, t_min)."""
    t0 = (lo - o) * inv_d
    t1 = (hi - o) * inv_d
    neg = inv_d < 0.0
    inf = torch.tensor(float("inf"), dtype=o.dtype, device=o.device)
    near = torch.amax(torch.fmax(torch.where(neg, t1, t0), -inf), dim=-1)
    far = torch.amin(torch.fmin(torch.where(neg, t0, t1), inf), dim=-1)
    entry = torch.maximum(near, t_min)
    return torch.minimum(far, best) > entry, entry


def traverse_packed(o, d, t_min, t_max, nodes, tri4, depth: int, stats: dict | None = None):
    """The ordered walk of the child-pair table (pack_bvh), step for step
    as the big-mesh kernel walks it: the plain version that the CPU tests
    and the kernel's bound count.

    o, d: (N, 3) object-space rays; t_min, t_max: scalars or (N,); nodes
    and depth from pack_bvh; tri4 (NT, 12) rows [a, e1, e2, 0, 0, 0] in
    BVH order. Returns traverse's (hit, t, tri, u, v).

    An interior root must pass its slab test. At an interior node both
    children take the slab test against [t_min, best t]; a leaf child is
    visited whatever its box says (geometry.rs:95-97), its box only orders
    the two. When both are visited, the nearer entry goes first (child 0
    on a tie) and the other is pushed with its entry (-inf for a leaf); a
    pushed interior node is dropped when popped unless best t > its entry,
    which is the slab test against the best t of that moment. A triangle
    is accepted at t < best t, or at t = best t from a larger row: among
    equal t the threaded walk's winner, the last row in preorder.

    stats: when a dict, receives per-ray int64 counts "boxes" (slab tests,
    the root's included), "nodes" (interior nodes opened), "tris"
    (triangles tested) and "pushes"."""
    n = o.shape[0]
    dev = o.device
    inv_d = 1.0 / d
    t_min = torch.broadcast_to(vm.as_f32(t_min, o), (n,))
    best = torch.broadcast_to(vm.as_f32(t_max, o), (n,)).clone()
    brow = torch.full((n,), -1, dtype=torch.int64, device=dev)
    bu = torch.zeros((n,), dtype=torch.float32, device=dev)
    bv = torch.zeros((n,), dtype=torch.float32, device=dev)
    refs = nodes.view(torch.int32)
    inf = torch.tensor(float("inf"), dtype=torch.float32, device=dev)
    root = int(refs[0, 3])
    ref = torch.full((n,), root, dtype=torch.int64, device=dev)
    counts = {k: torch.zeros((n,), dtype=torch.int64, device=dev)
              for k in ("boxes", "nodes", "tris", "pushes")}
    if root > 0:
        hit, _ = _slab_entry(o, inv_d, nodes[0, 0:3], nodes[0, 4:7], t_min, best)
        ref = torch.where(hit, ref, 0)
        counts["boxes"] += 1
    slots = max(depth, 1)
    stack_ref = torch.zeros((n, slots), dtype=torch.int64, device=dev)
    stack_lo = torch.zeros((n, slots), dtype=torch.float32, device=dev)
    sp = torch.zeros((n,), dtype=torch.int64, device=dev)
    lanes = torch.arange(n, device=dev)
    nt = tri4.shape[0]
    live = ref != 0
    while bool(live.any()):
        inner = live & (ref > 0)
        leaf = live & (ref < 0)
        nxt = torch.zeros_like(ref)
        if bool(inner.any()):
            row = nodes[torch.where(inner, ref, 0)]
            rr = refs[torch.where(inner, ref, 0)].long()
            h0, e0 = _slab_entry(o, inv_d, row[:, 0:3], row[:, 4:7], t_min, best)
            h1, e1 = _slab_entry(o, inv_d, row[:, 8:11], row[:, 12:15], t_min, best)
            r0, r1 = rr[:, 3], rr[:, 11]
            go0, go1 = h0 | (r0 < 0), h1 | (r1 < 0)
            swap = torch.where(h1, e1, inf) < torch.where(h0, e0, inf)
            both = inner & go0 & go1
            far = torch.where(swap, r0, r1)
            far_lo = torch.where(far < 0, -inf, torch.where(swap, e0, e1))
            if bool((sp[both] >= depth).any()):
                raise AssertionError(f"the walk outgrew its stack of depth {depth}")
            stack_ref[lanes[both], sp[both]] = far[both]
            stack_lo[lanes[both], sp[both]] = far_lo[both]
            sp = sp + both.long()
            nxt = torch.where(both, torch.where(swap, r1, r0),
                              torch.where(go0, r0, torch.where(go1, r1, 0)))
            nxt = torch.where(inner, nxt, 0)
            counts["boxes"] += 2 * inner.long()
            counts["nodes"] += inner.long()
            counts["pushes"] += both.long()
        if bool(leaf.any()):
            code = torch.where(leaf, ~ref, 0)
            first, cnt = code >> LEAF_COUNT_BITS, code & ((1 << LEAF_COUNT_BITS) - 1)
            for k in range(int(cnt.max())):
                row_k = first + k
                tri = tri4[torch.clamp(row_k, 0, nt - 1)]
                det_ok, t, u, v = moller_trumbore_edges(o, d, tri[:, 0:3], tri[:, 3:6], tri[:, 6:9])
                acc = (leaf & (k < cnt) & det_ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
                       & (t >= t_min) & ((t < best) | ((t == best) & (row_k > brow))))
                best = torch.where(acc, t, best)
                brow = torch.where(acc, row_k, brow)
                bu = torch.where(acc, u, bu)
                bv = torch.where(acc, v, bv)
            counts["tris"] += torch.where(leaf, cnt, 0)
        ref = nxt
        pop = live & (ref == 0)
        while bool(pop.any()):
            live = live & ~(pop & (sp == 0))
            pop = pop & (sp > 0)
            sp = sp - pop.long()
            top = torch.clamp(sp, max=slots - 1)
            take = pop & (best > stack_lo[lanes, top])
            ref = torch.where(take, stack_ref[lanes, top], ref)
            pop = pop & ~take
    if stats is not None:
        stats.update(counts)
    hit = brow >= 0
    return hit, best, brow.to(torch.int32), bu, bv


def moller_trumbore(o, d, va, vb, vc, t_min, t_max, eps=MT_EPSILON):
    """Batched Möller–Trumbore (geometry.rs:331-349 semantics).

    o, d, va, vb, vc: broadcastable (..., 3). Returns (valid, t, u, v).
    Rejects |det| < eps, u < 0, v < 0, u+v > 1 and t outside
    [t_min, t_max], exactly as the reference.
    """
    det_ok, t, u, v = moller_trumbore_edges(o, d, va, vb - va, vc - va, eps)
    valid = det_ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t >= t_min) & (t <= t_max)
    return valid, t, u, v


def moller_trumbore_edges(o, d, va, e1, e2, eps=MT_EPSILON):
    """Möller–Trumbore from a corner and the two edges, in the kernels'
    operation order. Returns (|det| >= eps, t, u, v) without the
    barycentric and window tests."""
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
    return det_ok, t, u, v


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
