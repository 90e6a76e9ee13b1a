"""The work K1 needs on a scene whose meshes it walks whatever their size,
counted by the benchmark's own frozen superleaf-tree count
(walk.superleaf_tree, walk.tree_counts) applied to every mesh, so the
yardstick is the same work whatever walk K1 takes through a mesh: the
superleaf tree of a dense mesh, the BVH of one past the dense budget, or a
later design.

walk.k1_image_bound counts the meshes of at most 8,192 triangles alone, the
ones K1 walked when it was written; on a scene whose meshes all lie within
that it gives this count's nodes, triangles and bytes. For a ray whose
nearest hit is at t_hit, a mesh's count is the root and both children of
every inner node whose box the ray meets within [t_min, min(t_hit,
t_max)], and the 16 rows of every superleaf it reaches; planes,
triangles, spheres and volumes are a plain scan on every segment. Bytes
are the rays in and out, every mesh's triangle rows and three oct normals
once, and its tree once. The counts are taken `block` segments at a time.
"""

from __future__ import annotations

import torch

from benchmark.reference import tracer, walk


def k1_bigmesh_image_bound(cell_scene, seed: int, stride: int = 1021, block: int = 8192) -> dict:
    """The least seconds of K1 over every camera ray of one image of seed
    `seed`: the work of every `stride`-th ray, scaled to the image."""
    cam = cell_scene.camera
    n_px = cam["screen_width"] * cam["screen_height"]
    dev = cell_scene.mat_type.device
    o, d, uids = tracer.camera_rays(cell_scene, seed, torch.arange(n_px, device=dev))
    idx = torch.arange(0, o.shape[0], stride, device=dev)
    stats: list = []
    tracer.trace(cell_scene, o[idx], d[idx], uids[idx], seed, False, stats=stats)
    meshes = list(cell_scene.meshes)
    trees = [walk.superleaf_tree(m.bounds) for m in meshes]
    trees = [(torch.as_tensor(t, device=dev), s) for t, s in trees]
    segments = nodes = tris = 0
    for ob, db, t_hit in stats:
        segments += ob.shape[0]
        far = torch.fmin(t_hit, torch.full_like(t_hit, cam["max_trace_dist"]))
        for b0 in range(0, ob.shape[0], block):
            sl = slice(b0, b0 + block)
            for m, (tree, s) in zip(meshes, trees):
                oo = tracer.mat_point(m.inv_transform, ob[sl])
                dd = tracer.mat_vec(m.inv_transform, db[sl])
                nd, lv = walk.tree_counts(tree, s, oo, dd, tracer.T_MIN, far[sl])
                nodes += int(nd.sum())
                tris += walk.SUPERLEAF * int(lv.sum())
    sc, ops_of = cell_scene, walk.OPS
    analytic = (sc.spheres[2].numel() * ops_of["sphere"] + sc.planes[2].numel() * ops_of["plane"]
                + sc.triangles[3].numel() * ops_of["triangle"]
                + sc.volumes[3].numel() * ops_of["volume"] + len(meshes) * ops_of["mesh_setup"])
    scale = o.shape[0] / idx.numel()
    ops = scale * (segments * analytic + tris * ops_of["mt"] + nodes * ops_of["box"])
    # rays in (origin, direction, uid), radiance and segment count out; the
    # triangle rows [a, e1, e2], three oct normals and the tree nodes once
    n_tri = sum(m.a.shape[0] for m in meshes)
    n_bytes = o.shape[0] * (12 + 12 + 4 + 12 + 4) + n_tri * (36 + 12) + sum(
        t.shape[0] * 32 for t, _ in trees)
    return dict(seconds=max(ops / walk.PEAK_FP32, n_bytes / walk.PEAK_BYTES), ops=ops,
                bytes=n_bytes, segments=segments * scale, nodes=nodes * scale, tris=tris * scale,
                rays=o.shape[0], sampled=idx.numel(), spp=cam["aa_sample_count"])
