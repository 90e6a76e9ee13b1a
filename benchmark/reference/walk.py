"""The work K1 (the mega-bounce kernel) needs, counted from the plain walk.

K1 walks each dense mesh's superleaf tree: the mesh's triangles in BVH
order (median split on the widest centroid axis, leaves of 4), 16
consecutive rows under one superleaf box, and a complete binary tree of
those boxes in heap order. This is the benchmark's own frozen copy of that
build and of the walk's count: for a ray whose nearest hit is at t_hit,
the walk tests the root and both children of every inner node whose box
it meets within [t_min, min(t_hit, t_max)], and the 16 rows of every
superleaf it reaches. K1 culls against a running best that only falls to
t_hit, so it tests at least as many: the count is a lower bound.

Operations per test, counted from the formulas of the kernels' intersection
code (an add, multiply, divide, square root, min, max or compare is one);
the shading, the RNG and integer work are not counted.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import tracer

OPS = dict(sphere=32, plane=24, triangle=53, volume=42, mesh_setup=21, box=24, mt=53)
SUPERLEAF = 16
# the H100 SXM's published peaks (NVIDIA data sheet, 700 W): FP32 outside
# the tensor cores, and HBM3 bandwidth
PEAK_FP32, PEAK_BYTES = 67e12, 3.35e12


def bvh_order(verts: np.ndarray, leaf_size: int = 4) -> np.ndarray:
    """Triangle order of the median-split BVH over (T, 3, 3) vertices."""
    tmin, tmax = verts.min(axis=1), verts.max(axis=1)
    cent = 0.5 * (tmin + tmax)
    order = []

    def rec(ids):
        if len(ids) <= leaf_size:
            order.append(ids)
            return
        c = cent[ids]
        axis = int(np.argmax(c.max(axis=0) - c.min(axis=0)))
        part = np.argsort(c[:, axis], kind="stable")
        mid = len(ids) // 2
        rec(ids[part[:mid]])
        rec(ids[part[mid:]])

    rec(np.arange(verts.shape[0], dtype=np.int64))
    return np.concatenate(order)


def _aabb(rows: np.ndarray) -> np.ndarray:
    """Eps-padded box [lo, hi] of (K, 3, 3) triangles."""
    pts = rows.reshape(-1, 3)
    lo, hi = pts.min(axis=0), pts.max(axis=0)
    pad = 1e-4 + 1e-4 * np.abs(np.stack([lo, hi])).max(axis=0)
    return np.concatenate([lo - pad, hi + pad]).astype(np.float32)


def superleaf_tree(verts: np.ndarray) -> tuple[np.ndarray, int]:
    """((2S - 1, 6) node boxes in heap order, S) of one dense mesh."""
    rv = verts[bvh_order(verts)]
    boxes = np.stack([_aabb(rv[s0:s0 + SUPERLEAF]) for s0 in range(0, len(rv), SUPERLEAF)])
    s = boxes.shape[0]
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
    return np.concatenate([lo[1:], hi[1:]], axis=1), s


def tree_counts(tree: torch.Tensor, s: int, o, d, t_min: float, far) -> tuple:
    """(nodes tested, superleaves reached) of each ray, (N,) int64 each."""
    inv = 1.0 / d
    t0 = (tree[None, :, 0:3] - o[:, None]) * inv[:, None]
    t1 = (tree[None, :, 3:6] - o[:, None]) * inv[:, None]
    near, fa = torch.fmin(t0, t1), torch.fmax(t0, t1)
    lo = torch.fmax(torch.fmax(near[..., 0], near[..., 1]),
                    torch.fmax(near[..., 2], torch.full_like(near[..., 2], t_min)))
    hi = torch.fmin(torch.fmin(fa[..., 0], fa[..., 1]), torch.fmin(fa[..., 2], far[:, None]))
    entered = hi >= lo
    j = 2
    while j <= 2 * s - 1:
        cols = torch.arange(j, min(2 * j, 2 * s), device=tree.device)
        entered[:, cols - 1] &= entered[:, cols // 2 - 1]
        j *= 2
    nodes = 1 + 2 * entered[:, :s - 1].sum(dim=1)
    return nodes, entered[:, s - 1:].sum(dim=1)


def k1_image_bound(cell_scene, seed: int, stride: int = 1021) -> dict:
    """The least seconds of K1 over every camera ray of one image of seed
    `seed`: the work of every `stride`-th ray, scaled to the image."""
    cam = cell_scene.camera
    n_px = cam["screen_width"] * cam["screen_height"]
    spp = cam["aa_sample_count"]
    dev = cell_scene.mat_type.device
    pix = torch.arange(n_px, device=dev)
    o, d, uids = tracer.camera_rays(cell_scene, seed, pix)
    idx = torch.arange(0, o.shape[0], stride, device=dev)
    stats: list = []
    tracer.trace(cell_scene, o[idx], d[idx], uids[idx], seed, False, stats=stats)
    dense = [m for m in cell_scene.meshes if m.a.shape[0] <= 8192]
    trees = [superleaf_tree(m.bounds) for m in dense]
    trees = [(torch.as_tensor(t, device=dev), s) for t, s in trees]
    segments = nodes = tris = 0
    for ob, db, t_hit in stats:
        segments += ob.shape[0]
        far = torch.fmin(t_hit, torch.full_like(t_hit, cam["max_trace_dist"]))
        for m, (tree, s) in zip(dense, trees):
            oo, dd = tracer.mat_point(m.inv_transform, ob), tracer.mat_vec(m.inv_transform, db)
            nd, lv = tree_counts(tree, s, oo, dd, tracer.T_MIN, far)
            nodes += int(nd.sum())
            tris += SUPERLEAF * int(lv.sum())
    sc = cell_scene
    analytic = (sc.spheres[2].numel() * OPS["sphere"] + sc.planes[2].numel() * OPS["plane"]
                + sc.triangles[3].numel() * OPS["triangle"] + sc.volumes[3].numel() * OPS["volume"]
                + len(dense) * OPS["mesh_setup"])
    scale = o.shape[0] / idx.numel()
    ops = scale * (segments * analytic + tris * OPS["mt"] + nodes * OPS["box"])
    # rays in (origin, direction, uid), radiance and segment count out; the
    # triangle rows [a, e1, e2], three oct normals and the tree nodes once
    n_tri = sum(m.a.shape[0] for m in dense)
    n_bytes = o.shape[0] * (12 + 12 + 4 + 12 + 4) + n_tri * (36 + 12) + sum(
        t.shape[0] * 32 for t, _ in trees)
    return dict(seconds=max(ops / PEAK_FP32, n_bytes / PEAK_BYTES), ops=ops, bytes=n_bytes,
                segments=segments * scale, nodes=nodes * scale, tris=tris * scale,
                rays=o.shape[0], sampled=idx.numel(), spp=spp)
