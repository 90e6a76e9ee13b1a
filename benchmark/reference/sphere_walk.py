"""The work K1 needs on a scene whose spheres it walks as a tree, counted
from the plain walk: the benchmark's own frozen count, whatever K1 does.

The spheres' tree: a median split on the widest centroid axis of a node's
spheres into halves of ceil and floor size, down to G leaves, G the least
power of two with G · LEAF >= the spheres, so every leaf holds at most
LEAF; node boxes are the unions of the spheres' boxes [c - r, c + r],
nodes in heap order (node k has children 2k and 2k + 1). For a ray whose
nearest hit is at t_hit, the walk tests the root and both children of
every inner node whose box it meets within [t_min, min(t_hit, t_max)],
and the spheres of every leaf it reaches. The dense meshes are counted by
walk.py's superleaf-tree walk, and the planes, triangles and volumes by a
plain scan (each on every segment). K1 culls against a running best that
only falls to t_hit, and grows its boxes against rounding, so it tests at
least as many: the count is a lower bound. walk.k1_image_bound charges
every sphere on every segment and is not this count.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import tracer, walk

LEAF = 4


def sphere_tree(center: np.ndarray, radius: np.ndarray) -> tuple[np.ndarray, int, np.ndarray]:
    """((2G - 1, 6) node boxes [lo, hi] in heap order, G, (G,) spheres a
    leaf) of the spheres (S, 3), (S,)."""
    n = center.shape[0]
    g = 1 << (-(-n // LEAF) - 1).bit_length()
    cent = center.astype(np.float64)
    lo_s = (center - radius[:, None]).astype(np.float32)
    hi_s = (center + radius[:, None]).astype(np.float32)
    lo = np.zeros((2 * g, 3), np.float32)
    hi = np.zeros((2 * g, 3), np.float32)
    counts = np.zeros(g, np.int64)

    def split(ids: np.ndarray, k: int) -> None:
        lo[k], hi[k] = lo_s[ids].min(axis=0), hi_s[ids].max(axis=0)
        if k >= g:
            counts[k - g] = ids.size
            return
        c = cent[ids]
        axis = int(np.argmax(c.max(axis=0) - c.min(axis=0)))
        part = ids[np.argsort(c[:, axis], kind="stable")]
        half = (ids.size + 1) // 2
        split(part[:half], 2 * k)
        split(part[half:], 2 * k + 1)

    split(np.arange(n), 1)
    return np.concatenate([lo[1:], hi[1:]], axis=1), g, counts


def sphere_counts(tree: torch.Tensor, g: int, counts: torch.Tensor, o, d, t_min: float, far):
    """(nodes tested, spheres tested) of each ray, (N,) int64 each."""
    inv = 1.0 / d
    t0 = (tree[None, :, 0:3] - o[:, None]) * inv[:, None]
    t1 = (tree[None, :, 3:6] - o[:, None]) * inv[:, None]
    near, fa = torch.fmin(t0, t1), torch.fmax(t0, t1)
    lo = torch.fmax(torch.fmax(near[..., 0], near[..., 1]),
                    torch.fmax(near[..., 2], torch.full_like(near[..., 2], t_min)))
    hi = torch.fmin(torch.fmin(fa[..., 0], fa[..., 1]), torch.fmin(fa[..., 2], far[:, None]))
    entered = hi >= lo
    j = 2
    while j <= 2 * g - 1:
        cols = torch.arange(j, min(2 * j, 2 * g), device=tree.device)
        entered[:, cols - 1] &= entered[:, cols // 2 - 1]
        j *= 2
    nodes = 1 + 2 * entered[:, :g - 1].sum(dim=1)
    return nodes, (entered[:, g - 1:].to(torch.int64) * counts).sum(dim=1)


def k1_tree_image_bound(cell_scene, seed: int, stride: int = 1021, block: int = 8192) -> dict:
    """The least seconds of K1 over every camera ray of one image of seed
    `seed` on a scene whose spheres it walks as a tree: the work of every
    `stride`-th ray, scaled to the image. The counts are taken `block`
    segments at a time."""
    cam = cell_scene.camera
    n_px = cam["screen_width"] * cam["screen_height"]
    dev = cell_scene.mat_type.device
    o, d, uids = tracer.camera_rays(cell_scene, seed, torch.arange(n_px, device=dev))
    idx = torch.arange(0, o.shape[0], stride, device=dev)
    n_rays = o.shape[0]
    o, d, uids = o[idx], d[idx], uids[idx]
    stats: list = []
    tracer.trace(cell_scene, o, d, uids, seed, False, stats=stats)
    center, radius, _ = cell_scene.spheres
    tree, g, counts = sphere_tree(center.cpu().numpy(), radius.cpu().numpy())
    tree, counts = torch.as_tensor(tree, device=dev), torch.as_tensor(counts, device=dev)
    dense = [m for m in cell_scene.meshes if m.a.shape[0] <= 8192]
    mesh_trees = [walk.superleaf_tree(m.bounds) for m in dense]
    mesh_trees = [(torch.as_tensor(t, device=dev), s) for t, s in mesh_trees]
    segments = sph_nodes = spheres = mesh_nodes = tris = 0
    for ob, db, t_hit in stats:
        segments += ob.shape[0]
        far = torch.fmin(t_hit, torch.full_like(t_hit, cam["max_trace_dist"]))
        for b0 in range(0, ob.shape[0], block):
            sl = slice(b0, b0 + block)
            nd, sp = sphere_counts(tree, g, counts, ob[sl], db[sl], tracer.T_MIN, far[sl])
            sph_nodes += int(nd.sum())
            spheres += int(sp.sum())
            for m, (mt, s) in zip(dense, mesh_trees):
                oo = tracer.mat_point(m.inv_transform, ob[sl])
                dd = tracer.mat_vec(m.inv_transform, db[sl])
                nd, lv = walk.tree_counts(mt, s, oo, dd, tracer.T_MIN, far[sl])
                mesh_nodes += int(nd.sum())
                tris += walk.SUPERLEAF * int(lv.sum())
    sc, ops_of = cell_scene, walk.OPS
    scans = (sc.planes[2].numel() * ops_of["plane"] + sc.triangles[3].numel() * ops_of["triangle"]
             + sc.volumes[3].numel() * ops_of["volume"] + len(dense) * ops_of["mesh_setup"])
    scale = n_rays / idx.numel()
    ops = scale * (segments * scans + spheres * ops_of["sphere"]
                   + (sph_nodes + mesh_nodes) * ops_of["box"] + tris * ops_of["mt"])
    # rays in (origin, direction, uid), radiance and segment count out; the
    # sphere rows [c, r] and index, the tree nodes, the triangle rows [a, e1,
    # e2] and three oct normals once
    n_tri = sum(m.a.shape[0] for m in dense)
    n_bytes = (n_rays * (12 + 12 + 4 + 12 + 4) + center.shape[0] * (16 + 4) + tree.shape[0] * 32
               + n_tri * (36 + 12) + sum(t.shape[0] * 32 for t, _ in mesh_trees))
    seg = max(segments, 1)
    return dict(seconds=max(ops / walk.PEAK_FP32, n_bytes / walk.PEAK_BYTES), ops=ops,
                bytes=n_bytes, segments=segments * scale, sphere_nodes=sph_nodes * scale,
                spheres=spheres * scale, mesh_nodes=mesh_nodes * scale, tris=tris * scale,
                sphere_nodes_per_segment=sph_nodes / seg, spheres_per_segment=spheres / seg,
                mesh_nodes_per_segment=mesh_nodes / seg, rays=n_rays, sampled=idx.numel())
