"""The work of K1's mesh walks on neighbouring rays, bounce by bounce:
what one lane tests and what its warp pays for.

K1 (csrc/bounce.cu) runs one ray a thread, so a warp is 32 neighbouring
rays of a chunk (the 16-sample runs of one pixel and the next); a warp
takes as many walk steps as its longest lane. For the bench scene at
128² × 16 spp, depth 8, the rays of `pixels` neighbouring pixels from the
image's middle are traced by the plain path (render/integrator.py), and
before each bounce every live ray walks the teapot as K1 does: against
the running best of the analytic classes, which K1 tests first. The
6,144-triangle teapot (`--mesh 6k`, the default) is dense: K1 walks its
superleaf tree (ops/intersect.py::walk_dense_mesh). The 32,832-triangle
one (`--mesh 32k`, scenes/bench_teapot_32k.py) is a big mesh: K1 walks its
BVH (ops/bvh.py::traverse_packed, the walk's plain version). Printed a
bounce: superleaves scanned a lane (dense) or triangles tested a lane
(big), and a warp's sum and maximum of them; tree nodes (dense) or BVH
boxes (big) tested a lane, and a warp's maximum; the rays that hit the
teapot.

    python -m cs397raytracingsp22_tpu_torch.tools.walk_counts [pixels] [--mesh 6k|32k] [--device cpu]

With `--scene rtnw-nee` it counts instead the sphere-tree walk that K2
takes under next-event estimation on The Next Week's final scene
(scenes/rtnw_final.py, 800² × 64 spp, depth 40, 1,006 spheres): the rays
of `pixels` neighbouring pixels go through the NEE executor
(render/integrator.py::path_trace_shrink) with the plain intersection,
whose stats count the walk's nodes and spheres a ray (ops/intersect.py::
walk_spheres); printed a bounce, for its bounce rays and its shadow rays
apart: the rays, those with a window (a shadow ray that does not shoot
has none), and the nodes and spheres a ray tests, with a warp's maximum.

    python -m cs397raytracingsp22_tpu_torch.tools.walk_counts [pixels] --scene rtnw-nee [--device cpu]

Counts, not times: the plain path runs on any device (the card unless
--device cpu is given).
"""

from __future__ import annotations

import argparse

import torch

from cs397raytracingsp22_tpu_torch.models.scene import resolve_device
from cs397raytracingsp22_tpu_torch.ops import bvh
from cs397raytracingsp22_tpu_torch.ops import intersect as isect
from cs397raytracingsp22_tpu_torch.render import driver, integrator
from cs397raytracingsp22_tpu_torch.scenes import bench_scene, bench_teapot_32k, rtnw_final
from cs397raytracingsp22_tpu_torch.utils import rng as rnglib
from cs397raytracingsp22_tpu_torch.utils import threefry

SIDE, SPP, DEPTH, WARP = 128, 16, 8, 32


def _walk(sd, o_obj, d_obj, t_min, far):
    """(leaves or triangles, nodes or boxes, hit), per ray, of the walk K1
    takes through the scene's one mesh: the superleaf tree of a dense
    mesh, the BVH of a big one."""
    if sd.dense_mesh_ids:
        walk = isect.walk_dense_mesh(sd, 0, o_obj, d_obj, t_min, far)
        return walk.tris // 16, walk.nodes, walk.hit
    m, counts = sd.meshes[0], {}
    hit = bvh.traverse_packed(o_obj, d_obj, t_min, far, m.bvh_nodes, m.bvh_tri4, m.bvh_depth,
                              stats=counts)[0]
    return counts["tris"], counts["boxes"], hit


def walk_counts(pixels: int = 256, device="cuda", mesh: str = "6k") -> list[dict]:
    """Per bounce: {"live", "leaves", "warp_leaves_sum", "warp_leaves_max",
    "nodes", "warp_nodes_max", "hits"} over the rays of `pixels`
    neighbouring pixels (a multiple of 2, so the rays fill whole warps).
    With mesh "32k" (a big mesh), "leaves" counts the triangles tested and
    "nodes" the BVH boxes."""
    dev = resolve_device(device)
    obj = bench_scene.TEAPOT_6K if mesh == "6k" else bench_scene.teapot_obj(bench_teapot_32k.TARGET)
    sc = bench_scene.build(SIDE, SIDE, spp=SPP, path_depth=DEPTH, obj_path=obj)
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
        leaves, nodes, hit = _walk(sd, o_obj, d_obj, t_min, far)
        leaves, nodes = leaves * alive, nodes * alive
        out.append(dict(
            live=int(alive.sum()), leaves=float(leaves.float().mean()),
            warp_leaves_sum=float(leaves.view(-1, WARP).sum(dim=1).float().mean()),
            warp_leaves_max=float(leaves.view(-1, WARP).amax(dim=1).float().mean()),
            nodes=float(nodes.float().mean()),
            warp_nodes_max=float(nodes.view(-1, WARP).amax(dim=1).float().mean()),
            hits=int((hit & alive).sum())))
        o, d, thr, rad, alive, _, _ = integrator.bounce_update(
            sd, o, d, thr, rad, alive, uid, key, b, sc.camera.max_trace_dist,
            intersect=isect.intersect_scene_plain)
    return out


def rtnw_nee_counts(pixels: int = 64, device="cuda", side: int = 800, spp: int = 64,
                    depth: int = 40) -> list[dict]:
    """Per intersection call of the NEE executor on `pixels` neighbouring
    pixels from the middle of The Next Week's final scene at side² × spp,
    in call order: {"kind" ("bounce" or "shadow"), "bounce" (its index), "rays",
    "windows" (rays with t_max >= t_min), "nodes", "spheres" (means over
    those), "warp_nodes_max", "warp_spheres_max"}: the sphere tree's walk
    as K2 takes it (its plain version's counts)."""
    dev = resolve_device(device)
    sc = rtnw_final.build(side, side, spp, depth)
    sd = sc.compile(device=dev)
    first = (side * side - pixels) // 2 + side // 2
    ids = torch.arange(first, first + pixels, dtype=torch.int32, device=dev)
    key = threefry.key_words(0)
    o, d, uid = driver._gen_chunk_rays(sc.camera, ids, key, 0, spp, 1)
    out = []

    def counted(scene, o, d, t_min, t_max, u_vol):
        st: dict = {}
        hit = isect.intersect_scene_plain(scene, o, d, t_min, t_max, u_vol, stats=st)
        # a bounce's rays, then its shadow rays (none after the last bounce)
        shadow = len(out) % 2 == 1
        n = o.shape[0]
        win = t_max >= t_min
        nodes, spheres = st["sph_nodes"] * win, st["sph_spheres"] * win
        pad = -n % WARP  # whole warps, as the executor's launches tile them
        warp = [torch.nn.functional.pad(x, (0, pad)).view(-1, WARP).amax(dim=1).float().mean()
                for x in (nodes, spheres)]
        per = max(int(win.sum()), 1)
        out.append(dict(kind="shadow" if shadow else "bounce", bounce=len(out) // 2,
                        rays=n, windows=int(win.sum()), nodes=float(nodes.sum()) / per,
                        spheres=float(spheres.sum()) / per, warp_nodes_max=float(warp[0]),
                        warp_spheres_max=float(warp[1])))
        return hit

    integrator.path_trace_shrink(sd, o, d, uid, key, depth, sc.camera.max_trace_dist, nee=True,
                                 intersect=counted)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("pixels", nargs="?", type=int, default=256)
    ap.add_argument("--mesh", choices=("6k", "32k"), default="6k")
    ap.add_argument("--scene", choices=("bench", "rtnw-nee"), default="bench")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.scene == "rtnw-nee":
        print(f"rtnw final scene 800²x64spp depth 40 under NEE: {args.pixels} pixels "
              f"({args.pixels * 64} rays, warps of {WARP}), K2's sphere-tree walk a call")
        for r in rtnw_nee_counts(args.pixels, args.device):
            print(f"bounce {r['bounce']} {r['kind']} rays: {r['rays']}, {r['windows']} with a "
                  f"window; sphere-tree nodes a ray {r['nodes']:.2f} (a warp max "
                  f"{r['warp_nodes_max']:.2f}), spheres a ray {r['spheres']:.2f} (a warp max "
                  f"{r['warp_spheres_max']:.2f})")
        return 0
    leaf, node = ("superleaves", "nodes") if args.mesh == "6k" else ("triangles", "BVH boxes")
    print(f"bench teapot_{args.mesh} {SIDE}²x{SPP}spp depth {DEPTH}: {args.pixels} pixels "
          f"({args.pixels * SPP} rays, warps of {WARP}), walk against the analytic best")
    for b, r in enumerate(walk_counts(args.pixels, args.device, args.mesh)):
        print(f"bounce {b}: {r['live']} live; {leaf} a lane {r['leaves']:.3f}, a warp sum "
              f"{r['warp_leaves_sum']:.2f} max {r['warp_leaves_max']:.2f}; {node} a lane "
              f"{r['nodes']:.2f}, a warp max {r['warp_nodes_max']:.2f}; {r['hits']} teapot hits")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
