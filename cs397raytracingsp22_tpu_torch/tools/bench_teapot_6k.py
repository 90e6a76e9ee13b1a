"""Where the mega-bounce kernel's dense walk (K1's superleaf-tree walk)
stops beating its BVH walk of a big mesh on the card: the bench scene
(scenes/bench_scene.py) with its teapot subdivided to each size, rendered
through both routes (mirrors the JAX package's tools/bench_teapot_6k.py,
which located the TPU's crossover against its staged path).

    python -m cs397raytracingsp22_tpu_torch.tools.bench_teapot_6k [SIZE ...] [--dense-max-tris N]

The route follows from `compile_scene(dense_max_tris=...)`, the port's
argument in place of the JAX package's RT_DENSE_MAX_TRIS: a mesh within
the threshold is dense and K1 walks its superleaf tree ("dense"), a mesh
beyond it is a big mesh and K1 walks its BVH ("bvh"); a scene K1's gates
refuse takes the staged path ("staged"). For each size (6,144 is
assets/teapot_6k.obj, larger sizes `bench_scene.teapot_obj(n)`) the tool
renders 512² × 64 spp, depth 8, through render_to_image: once with the
threshold at the mesh's triangles (the subdivision reaches about the
size asked), padded to 16 rows as the budget counts them ("dense"), and
once at 0 ("bvh"), or, with `--dense-max-tris`, once at that threshold.
It prints a JSON line a size and route (seconds an image, least of the
timed renders after a warm one, Mrays/s of segments, K1's resident blocks
an SM with the scene staged) and where K1's gates refuse a size: beyond
ops/bvh.py's DENSE_MESH_MAX_TRIS (8,192) the dense meshes' superleaf trees
pass the 1,023 nodes (models/scene.py TREE_MAX_NODES) that K1 and K2 stage
in shared memory, and the compile raises. Then the crossover: the least
size at which the BVH route is faster. On the CPU (`run(device="cpu",
...)`) it rehearses the plain versions at a size the caller passes.
"""

from __future__ import annotations

import argparse
import json
import sys

SIZES = (6144, 7000, 8000, 8192, 9000, 12000, 16384, 32768)
FRAME = dict(width=512, height=512, spp=64, path_depth=8)


def scene_for(n: int, frame: dict):
    from cs397raytracingsp22_tpu_torch.scenes import bench_scene

    path = bench_scene.TEAPOT_6K if n == 6144 else bench_scene.teapot_obj(n)
    return bench_scene.build(obj_path=path, **frame)


def compile_route(scene, device, dense_max_tris: int | None = None):
    """(scene data, "dense", "bvh" or "staged") at the threshold
    (ops/bvh.py's DENSE_MESH_MAX_TRIS when None)."""
    from cs397raytracingsp22_tpu_torch.ops import bvh
    from cs397raytracingsp22_tpu_torch.ops.kernels import bounce

    limit = bvh.DENSE_MESH_MAX_TRIS if dense_max_tris is None else dense_max_tris
    data = scene.compile(device=device, dense_max_tris=limit)
    if not bounce.scene_is_simple(data):
        return data, "staged"
    return data, ("bvh" if bounce.big_meshes(data) else "dense")


def measure(scene, data, device, reps: int) -> dict:
    """A warm render, then `reps` timed ones through render_to_image."""
    from cs397raytracingsp22_tpu_torch.render.driver import render_to_image

    render = lambda: render_to_image(scene, device=device, seed=0, verbose=False,  # noqa: E731
                                     scene_data=data)
    render()
    runs = [render()[1] for _ in range(reps)]
    best = min(runs, key=lambda s: s.wall_seconds)
    return dict(seconds=[s.wall_seconds for s in runs], least_s=best.wall_seconds,
                segments=best.path_segments, chunks=best.chunks,
                mrays=best.path_segments / best.wall_seconds / 1e6)


def run(device="cuda", sizes=SIZES, dense_max_tris: int | None = None, frame: dict = FRAME,
        reps: int = 2, verbose: bool = True) -> list:
    """One row a size and route: {"tris", "route", "threshold", and the
    measure() fields, or "refused"}. With dense_max_tris each size renders
    once at that threshold; without, at the mesh's size (dense) and at 0
    (staged)."""
    import torch

    from cs397raytracingsp22_tpu_torch import StaticMesh
    from cs397raytracingsp22_tpu_torch.ops.kernels import bounce

    rows = []
    for size in sizes:
        scene = scene_for(size, frame)
        # the subdivision reaches about `size`; the dense budget counts the
        # mesh's rows padded to 16
        n = sum(o.mesh.num_triangles for o in scene.objects if isinstance(o, StaticMesh))
        thresholds = [dense_max_tris] if dense_max_tris is not None else [-(-n // 16) * 16, 0]
        for limit in thresholds:
            try:
                data, route = compile_route(scene, device, limit)
            except ValueError as e:  # the superleaf trees beyond K1's cap
                row = dict(tris=n, route="dense", threshold=limit, refused=str(e))
            else:
                row = dict(tris=n, route=route, threshold=limit)
                if route != "staged" and torch.device(device).type == "cuda":
                    row["k1_blocks_per_sm"] = bounce.resident_blocks(data)
                row.update(measure(scene, data, device, reps))
            rows.append(row)
            if verbose:
                print(json.dumps(row), flush=True)
    if verbose:
        print(json.dumps(dict(crossover_tris=crossover(rows))), flush=True)
    return rows


def crossover(rows: list):
    """The least size at which the BVH route renders faster than the
    dense one, or None where it never does (or no size has both)."""
    by = {}
    for r in rows:
        if "least_s" in r:
            by.setdefault(r["tris"], {})[r["route"]] = r["least_s"]
    wins = [n for n, t in sorted(by.items()) if "dense" in t and "bvh" in t
            and t["bvh"] < t["dense"]]
    return wins[0] if wins else None


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("sizes", nargs="*", type=int, help=f"triangle counts (default {SIZES})")
    p.add_argument("--dense-max-tris", type=int,
                   help="one threshold for every size, in place of both routes")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    from cs397raytracingsp22_tpu_torch.models.scene import resolve_device

    resolve_device(args.device)  # no card: raise, never fall back to the CPU
    run(args.device, tuple(args.sizes) or SIZES, args.dense_max_tris)
    return 0


if __name__ == "__main__":
    sys.exit(main())
