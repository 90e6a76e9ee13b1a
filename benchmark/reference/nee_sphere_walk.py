"""The work K2 (the scene-intersection kernel) needs for one image under
next-event estimation on a scene whose spheres it walks as a tree,
counted from the plain reference: the benchmark's own frozen count,
whatever K2 does.

The reference's NEE path tracer (tracer.trace with nee) intersects the
scene twice a bounce but the last: the live rays, then their shadow rays
(window [T_MIN, t_max], t_max = 0 where the vertex does not shoot, which
every test rejects); the last bounce has no shadow rays. K2 takes every
one of those calls. Each call's rays are counted as sphere_walk.py counts
K1's segments: the sphere tree's nodes and spheres (sphere_walk.
sphere_counts) and the dense meshes' superleaf-tree nodes and triangles
(walk.tree_counts) against [T_MIN, min(t_hit, t_max)], t_hit the ray's
nearest hit over every class, and the planes, triangles, volumes and mesh
set-ups by plain scan. K2 walks the spheres first, against a running best
of spheres alone that falls to their nearest hit, no nearer than t_hit,
and grows its boxes against rounding, so it tests at least as many: the
count is a lower bound. A ray with an empty window is counted as read and
written, with no test.
"""

from __future__ import annotations

import torch

from benchmark.reference import sphere_walk, tracer, walk

# bytes K2 moves a ray: o, d, t_min, t_max in (and a volume uniform a
# volume), t, code, idx, mat, u, v, normal, frontface out
RAY_IN, RAY_OUT, VOL_IN = 12 + 12 + 4 + 4, 4 * 6 + 12 + 1, 4


def nee_calls(cell_scene, o, d, uids, seed: int) -> list:
    """[(kind, o, d, t_max, t_hit)] of every scene intersection that the
    reference's NEE path trace of the rays (o, d, uids) makes, in order:
    kind "bounce" or "shadow", t_hit the nearest hit (inf on a miss). The
    calls are recorded around tracer.intersect, whose bounces alternate
    bounce and shadow rays."""
    calls = []
    inner = tracer.intersect

    def recording(scene, o, d, t_min, t_max, u_vol):
        hit = inner(scene, o, d, t_min, t_max, u_vol)
        kind = "shadow" if len(calls) % 2 else "bounce"
        t_hit = torch.where(hit["valid"], hit["t"], torch.full_like(hit["t"], tracer.BIG))
        calls.append((kind, o, d, t_max, t_hit))
        return hit

    tracer.intersect = recording
    try:
        tracer.trace(cell_scene, o, d, uids, seed, True)
    finally:
        tracer.intersect = inner
    return calls


def k2_tree_image_bound(cell_scene, seed: int, stride: int = 1021, block: int = 8192) -> dict:
    """The least seconds of K2 over one image of seed `seed` under NEE on a
    scene whose spheres it walks as a tree: the work of the paths of every
    `stride`-th camera ray, scaled to the image. The counts are taken
    `block` rays at a time."""
    cam = cell_scene.camera
    n_px = cam["screen_width"] * cam["screen_height"]
    dev = cell_scene.mat_type.device
    o, d, uids = tracer.camera_rays(cell_scene, seed, torch.arange(n_px, device=dev))
    n_rays = o.shape[0]
    idx = torch.arange(0, n_rays, stride, device=dev)
    calls = nee_calls(cell_scene, o[idx], d[idx], uids[idx], seed)
    center, radius, _ = cell_scene.spheres
    tree, g, counts = sphere_walk.sphere_tree(center.cpu().numpy(), radius.cpu().numpy())
    tree, counts = torch.as_tensor(tree, device=dev), torch.as_tensor(counts, device=dev)
    dense = [m for m in cell_scene.meshes if m.a.shape[0] <= 8192]
    mesh_trees = [walk.superleaf_tree(m.bounds) for m in dense]
    mesh_trees = [(torch.as_tensor(t, device=dev), s) for t, s in mesh_trees]
    keys = ("rays", "tested", "sphere_nodes", "spheres", "mesh_nodes", "tris")
    tally = {kind: dict.fromkeys(keys, 0) for kind in ("bounce", "shadow")}
    for kind, oc, dc, t_max, t_hit in calls:
        c = tally[kind]
        c["rays"] += oc.shape[0]
        live = (t_max >= tracer.T_MIN).nonzero()[:, 0]
        c["tested"] += live.numel()
        oc, dc, far = oc[live], dc[live], torch.fmin(t_hit[live], t_max[live])
        for b0 in range(0, oc.shape[0], block):
            sl = slice(b0, b0 + block)
            nd, sp = sphere_walk.sphere_counts(tree, g, counts, oc[sl], dc[sl], tracer.T_MIN,
                                               far[sl])
            c["sphere_nodes"] += int(nd.sum())
            c["spheres"] += int(sp.sum())
            for m, (mt, s) in zip(dense, mesh_trees):
                oo = tracer.mat_point(m.inv_transform, oc[sl])
                dd = tracer.mat_vec(m.inv_transform, dc[sl])
                nd, lv = walk.tree_counts(mt, s, oo, dd, tracer.T_MIN, far[sl])
                c["mesh_nodes"] += int(nd.sum())
                c["tris"] += walk.SUPERLEAF * int(lv.sum())
    sc, ops_of = cell_scene, walk.OPS
    scans = (sc.planes[2].numel() * ops_of["plane"] + sc.triangles[3].numel() * ops_of["triangle"]
             + sc.volumes[3].numel() * ops_of["volume"] + len(dense) * ops_of["mesh_setup"])
    scale = n_rays / idx.numel()
    total = {k: sum(c[k] for c in tally.values()) for k in keys}
    ops = scale * (total["tested"] * scans + total["spheres"] * ops_of["sphere"]
                   + (total["sphere_nodes"] + total["mesh_nodes"]) * ops_of["box"]
                   + total["tris"] * ops_of["mt"])
    # every ray of every call in and out; the sphere rows [c, r] and index,
    # the tree nodes, the triangle rows [a, e1, e2] and the superleaf nodes
    # once an image
    n_tri = sum(m.a.shape[0] for m in dense)
    n_bytes = (scale * total["rays"] * (RAY_IN + VOL_IN * sc.volumes[3].numel() + RAY_OUT)
               + center.shape[0] * (16 + 4) + tree.shape[0] * 32 + n_tri * (36 + 12)
               + sum(t.shape[0] * 32 for t, _ in mesh_trees))
    out = dict(seconds=max(ops / walk.PEAK_FP32, n_bytes / walk.PEAK_BYTES), ops=ops,
               bytes=n_bytes, rays=n_rays, sampled=idx.numel())
    for kind, c in tally.items():
        per = max(c["tested"], 1)
        out[kind] = dict(rays=c["rays"] * scale, tested=c["tested"] * scale,
                         sphere_nodes_per_ray=c["sphere_nodes"] / per,
                         spheres_per_ray=c["spheres"] / per,
                         mesh_nodes_per_ray=c["mesh_nodes"] / per, tris_per_ray=c["tris"] / per)
    return out
