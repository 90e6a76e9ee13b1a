"""Command-line renderer for the port:

    python -m cs397raytracingsp22_tpu_torch.cli [scene.py] -o out.png

A scene is any Python file exposing `build(**overrides) -> Scene` that
builds with this package; without one, the bench scene with its
32,832-triangle teapot (scenes/bench_teapot_32k.py) renders, on the
mega-bounce kernel, which walks the teapot's BVH (with `--nee`, on the
staged path). Renders on
the GPU by default; `--device cpu` runs the plain torch version. A scene
shades as its camera says (path tracing, or Phong shading with hard
shadows); `--nee` turns on next-event estimation (render/nee.py), whose
bounce and shadow rays K2 intersects, walking a scene's sphere tree from
64 spheres on (The Next Week's final scene: 1,006), so sphere-heavy
scenes keep their NEE cost to a few dozen tests a ray;
`--checkpoint PATH` keeps the HDR accumulator in PATH after every spp
chunk (`--spp-chunk`) and resumes from it. `--profile-dir DIR` writes a
torch.profiler Chrome trace of the render into DIR (utils/profiling.py).

Several devices (parallel/): `--mesh DPxSP` splits each chunk's pixels
over DP ranks and its samples over SP. Started under torchrun, or with
`--distributed` (and `--coordinator`, `--num-processes`, `--process-id`
off torchrun), the process joins the group and renders its shard; without
either, `--mesh` spawns DP·SP ranks on this host: one a card under NCCL,
or gloo ranks with `--device cpu`. Only rank 0 writes the PNG and the
stats.
"""

from __future__ import annotations

import argparse
import ast
import dataclasses
import importlib.util
import json
import os
import sys

import torch
import torch.distributed as dist

DEFAULT_SCENE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "scenes",
                             "bench_teapot_32k.py")


def load_scene_module(path: str):
    spec = importlib.util.spec_from_file_location("user_scene", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    if not hasattr(mod, "build"):
        raise SystemExit(f"{path} must define build(**overrides) -> Scene")
    return mod


def parse_args(argv):
    p = argparse.ArgumentParser(description="PyTorch + CUDA path tracer")
    p.add_argument("scene", nargs="?", default=DEFAULT_SCENE,
                   help="scene script exposing build(**overrides) (default: %(default)s)")
    p.add_argument("-o", "--output", default="render.png")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--width", type=int)
    p.add_argument("--height", type=int)
    p.add_argument("--spp", type=int)
    p.add_argument("--depth", type=int, help="path depth (bounces)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--stats-json", help="write render stats to this path")
    p.add_argument(
        "--set", action="append", default=[], metavar="KEY=VALUE", dest="set_overrides",
        help="extra build(**overrides) kwarg, repeatable; VALUE is parsed as a "
        "Python literal, else kept as a string",
    )
    p.add_argument("--checkpoint", help="HDR accumulator checkpoint (.npz) for resume")
    p.add_argument("--spp-chunk", type=int, help="samples per accumulation (and checkpoint) chunk")
    p.add_argument("--pixel-chunk", type=int, help="pixels per chunk (default: a work budget)")
    p.add_argument("--nee", action="store_true",
                   help="next-event estimation (explicit light sampling): the same converged "
                   "image at equal depth, less noise on small-light scenes (render/nee.py)")
    p.add_argument("--mesh", help="render over a DPxSP mesh of ranks, e.g. --mesh 2x2 (pixels "
                   "split over DP, samples over SP)")
    p.add_argument("--distributed", action="store_true",
                   help="join a torch.distributed group and render this rank's shard (run the "
                   "same command in every process; under torchrun the group is found from its "
                   "environment, elsewhere pass --coordinator, --num-processes, --process-id); "
                   "without --mesh the pixels split over every rank")
    p.add_argument("--coordinator", help="host:port of rank 0")
    p.add_argument("--num-processes", type=int)
    p.add_argument("--process-id", type=int)
    p.add_argument("--profile-dir", help="write a torch.profiler Chrome trace of the render into "
                   "this directory (utils/profiling.device_trace)")
    p.add_argument("-q", "--quiet", action="store_true")
    return p.parse_args(argv)


def mesh_shape(spec: str) -> tuple[int, int]:
    try:
        n_dp, n_sp = (int(x) for x in spec.lower().split("x"))
    except ValueError:
        raise SystemExit(f"--mesh must look like 4x2, got {spec!r}")
    return n_dp, n_sp


def render(args) -> int:
    """Build the scene and render it: over a mesh of the group's ranks when
    this process is in one, else on one device. Rank 0 writes the output."""
    overrides = {}
    for key in ("width", "height", "spp"):
        if getattr(args, key):
            overrides[key] = getattr(args, key)
    if args.depth:
        overrides["path_depth"] = args.depth
    for kv in args.set_overrides:
        key, eq, value = kv.partition("=")
        if not eq or not key:
            raise SystemExit(f"--set expects KEY=VALUE, got {kv!r}")
        try:
            overrides[key] = ast.literal_eval(value)
        except (ValueError, SyntaxError):
            overrides[key] = value

    scene = load_scene_module(args.scene).build(**overrides)
    if args.nee:
        scene = dataclasses.replace(scene, camera=dataclasses.replace(scene.camera, nee=True))

    from cs397raytracingsp22_tpu_torch.render.driver import render_to_image, save_png
    from cs397raytracingsp22_tpu_torch.utils.profiling import device_trace

    mesh, rank = None, 0
    if dist.is_initialized():
        from cs397raytracingsp22_tpu_torch.parallel import sharding

        n_dp, n_sp = mesh_shape(args.mesh) if args.mesh else (None, 1)
        mesh, rank = sharding.make_device_mesh(n_dp, n_sp), dist.get_rank()
    with device_trace(args.profile_dir):
        img, stats = render_to_image(scene, device=args.device, seed=args.seed,
                                     pixel_chunk=args.pixel_chunk, spp_chunk=args.spp_chunk,
                                     checkpoint_path=args.checkpoint, verbose=not args.quiet,
                                     mesh=mesh)
    if rank:
        return 0
    save_png(img, args.output)
    if not args.quiet:
        print(f"[cli] wrote {args.output}")
    if args.stats_json:
        with open(args.stats_json, "w") as f:
            json.dump(
                {
                    "width": stats.width,
                    "height": stats.height,
                    "spp": stats.spp,
                    "path_depth": stats.path_depth,
                    "device": stats.device,
                    "device_count": stats.device_count,
                    "wall_seconds": stats.wall_seconds,
                    "compile_seconds": stats.compile_seconds,
                    "primary_rays": stats.primary_rays,
                    "path_segments": stats.path_segments,
                    "primary_mrays_per_sec": stats.primary_mrays_per_sec,
                    "segment_mrays_per_sec": stats.segment_mrays_per_sec,
                },
                f,
                indent=2,
            )
    return 0


def rank_main(rank: int, world: int, port: int, argv: list) -> None:
    """One spawned rank of `--mesh` on this host."""
    from cs397raytracingsp22_tpu_torch.parallel import multihost

    args = parse_args(argv)
    multihost.initialize(f"127.0.0.1:{port}", world, rank, device=args.device)
    try:
        render(args)
    finally:
        dist.destroy_process_group()


def spawn_mesh(argv: list, device: str, n_dp: int, n_sp: int) -> int:
    """Render over DP·SP ranks spawned on this host, one a card under NCCL
    (or gloo ranks on the CPU); fails when any rank fails."""
    import torch.multiprocessing as mp

    from cs397raytracingsp22_tpu_torch.parallel import multihost

    n = n_dp * n_sp
    if torch.device(device).type == "cuda" and n > torch.cuda.device_count():
        raise SystemExit(f"mesh {n_dp}x{n_sp} needs {n} devices, have "
                         f"{torch.cuda.device_count()} (is n_sp larger than the device count?)")
    try:
        mp.start_processes(rank_main, args=(n, multihost.free_port(), argv), nprocs=n,
                           start_method="spawn")
    except (mp.ProcessRaisedException, mp.ProcessExitedException) as e:
        raise SystemExit(f"[cli] a rank failed: {e}")
    return 0


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    args = parse_args(argv)
    shape = mesh_shape(args.mesh) if args.mesh else None
    if args.distributed or dist.is_torchelastic_launched():
        from cs397raytracingsp22_tpu_torch.parallel import multihost

        multihost.initialize(coordinator_address=args.coordinator,
                             num_processes=args.num_processes, process_id=args.process_id,
                             device=args.device)
        try:
            return render(args)
        finally:
            dist.destroy_process_group()
    if shape:
        return spawn_mesh(argv, args.device, *shape)
    return render(args)


if __name__ == "__main__":
    sys.exit(main())
