"""The work of K1's superleaf-tree walk on neighbouring rays, bounce by
bounce: what one lane tests and what its warp pays for.

K1 (csrc/bounce.cu) runs one ray a thread, so a warp is 32 neighbouring
rays of a chunk (the 16-sample runs of one pixel and the next); a warp
takes as many walk steps as its longest lane. For the bench scene (teapot_6k)
at 128² × 16 spp, depth 8, the rays of `pixels` neighbouring pixels from
the image's middle are traced by the plain path (render/integrator.py),
and before each bounce every live ray walks the teapot's tree as K1 does:
against the running best of the analytic classes, which K1 tests first
(ops/intersect.py::walk_dense_mesh). Printed a bounce: superleaves scanned
a lane, and a warp's sum and maximum of them; tree nodes tested a lane,
and a warp's maximum; the rays that hit the teapot.

    python -m cs397raytracingsp22_tpu_torch.tools.walk_counts [pixels] [--device cpu]

Counts, not times: the plain path runs on any device (the card unless
--device cpu is given).
"""

from __future__ import annotations

import argparse

import torch

from cs397raytracingsp22_tpu_torch.models.scene import resolve_device
from cs397raytracingsp22_tpu_torch.ops import intersect as isect
from cs397raytracingsp22_tpu_torch.render import driver, integrator
from cs397raytracingsp22_tpu_torch.scenes import bench_scene
from cs397raytracingsp22_tpu_torch.utils import rng as rnglib
from cs397raytracingsp22_tpu_torch.utils import threefry

SIDE, SPP, DEPTH, WARP = 128, 16, 8, 32


def walk_counts(pixels: int = 256, device="cuda") -> list[dict]:
    """Per bounce: {"live", "leaves", "warp_leaves_sum", "warp_leaves_max",
    "nodes", "warp_nodes_max", "hits"} over the rays of `pixels`
    neighbouring pixels (a multiple of 2, so the rays fill whole warps)."""
    dev = resolve_device(device)
    sc = bench_scene.build(SIDE, SIDE, spp=SPP, path_depth=DEPTH)
    sd = sc.compile(device=dev)
    first = (SIDE * SIDE - pixels) // 2
    ids = torch.arange(first, first + pixels, dtype=torch.int32, device=dev)
    o, d, uid = driver._gen_chunk_rays(sc.camera, ids, 0, 0, SPP, 1)
    n = o.shape[0]
    key = threefry.key_words(0)
    thr, rad = torch.ones_like(o), torch.zeros_like(o)
    alive = torch.ones((n,), dtype=torch.bool, device=dev)
    t_min = torch.full((n,), integrator.PATH_T_MIN, device=dev)
    out = []
    for b in range(DEPTH):
        site = rnglib.SITE_BOUNCE0 + b
        u_vol = integrator._bounce_draws(sd, key, uid, site)[2]
        best = torch.stack([c["t"] for c in isect.analytic_candidates(
            sd, o, d, t_min, sc.camera.max_trace_dist, u_vol)], dim=1).amin(dim=1)
        far = torch.fmin(best, torch.full_like(best, sc.camera.max_trace_dist))
        o_obj, d_obj = isect.object_rays(sd.meshes[0], o, d)
        walk = isect.walk_dense_mesh(sd, 0, o_obj, d_obj, t_min, far)
        leaves = (walk.tris // 16) * alive
        nodes = walk.nodes * alive
        out.append(dict(
            live=int(alive.sum()), leaves=float(leaves.float().mean()),
            warp_leaves_sum=float(leaves.view(-1, WARP).sum(dim=1).float().mean()),
            warp_leaves_max=float(leaves.view(-1, WARP).amax(dim=1).float().mean()),
            nodes=float(nodes.float().mean()),
            warp_nodes_max=float(nodes.view(-1, WARP).amax(dim=1).float().mean()),
            hits=int((walk.hit & alive).sum())))
        o, d, thr, rad, alive, _, _ = integrator.bounce_update(
            sd, o, d, thr, rad, alive, uid, key, b, sc.camera.max_trace_dist,
            intersect=isect.intersect_scene_plain)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("pixels", nargs="?", type=int, default=256)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    print(f"bench teapot_6k {SIDE}²x{SPP}spp depth {DEPTH}: {args.pixels} pixels "
          f"({args.pixels * SPP} rays, warps of {WARP}), walk against the analytic best")
    for b, r in enumerate(walk_counts(args.pixels, args.device)):
        print(f"bounce {b}: {r['live']} live; superleaves a lane {r['leaves']:.3f}, a warp sum "
              f"{r['warp_leaves_sum']:.2f} max {r['warp_leaves_max']:.2f}; nodes a lane "
              f"{r['nodes']:.2f}, a warp max {r['warp_nodes_max']:.2f}; {r['hits']} teapot hits")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
