"""The benchmark of the PyTorch + CUDA path tracer: one run of one cell.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (process start to the end of one warm image) is `setup_s`. With
--trace 0 the run then renders whole images back to back for --seconds
(closed loop, one image at a time) and reports the cell's end-to-end
metrics; with --trace 1 it profiles the number of images set in the
cell's file and reports the cell's per-layer metrics, with `busy_s`,
`window_s` and a breakdown. Either way the images it rendered are then
judged against the plain reference (benchmark/check.py), each compared
number printed beside its limit on standard error and, last, in the result
line. The result is the last line of standard output, one JSON object.

A run needs a CUDA device (as many as the cell's chips) and fails without
one; nothing falls back to the CPU. A cell on several chips starts one
process a further rank (benchmark/rank.py, reaped by benchmark/procs.py).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "cs397raytracingsp22_tpu")


def process_start() -> float:
    """This process's start on the time.time() clock, from /proc."""
    with open("/proc/self/stat") as f:
        ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return time.time() - uptime + ticks / os.sysconf("SC_CLK_TCK")


T0 = process_start()


def environment() -> None:
    """Caches of the program and of its libraries at fixed directories
    inside the checkout; no library may load JAX; NCCL's shared-memory
    transport (files in /dev/shm) off: the cards of a host talk over
    NVLink."""
    cache = os.path.join(ROOT, "build", "benchmark", "cache")
    for key, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "cuda")):
        os.environ[key] = os.path.join(cache, sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["NCCL_SHM_DISABLE"] = "1"


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def device_info(device, n: int) -> dict:
    """The result's device: the card's name, or "cpu" for the harness's own
    CPU tests (a CPU run never prints a result)."""
    import torch

    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": n}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": n}


def run(cell, args, device, ranks=None) -> dict:
    """The run's record: what the metric readers and the result line need.
    On a mesh the caller has started the other ranks."""
    from benchmark import check, session

    mesh = None
    if cell.mesh is not None:
        from cs397raytracingsp22_tpu_torch.parallel import sharding

        mesh = sharding.make_device_mesh(*cell.mesh)
    sess = session.Session(cell, device, mesh)
    sess.setup(args.seed)
    rec = {"cell": cell, "seed": args.seed, "setup_s": time.time() - T0, "trace": None,
           "device": device, "notes": {}}
    if args.trace:
        rec["trace"], images = session.traced(sess, args.seed, int(cell.spec["trace_images"]))
        rec["images"] = len(images)
    else:
        rec["window_s"], rec["image_times"], images = session.window(sess, args.seed,
                                                                     args.seconds)
        rec["images"] = len(images)
    peak, setup_peak = sess.peaks()
    if ranks is not None:
        ranks.wait(120.0)
    rec["peak_bytes"] = peak
    rec["memory_peak_bytes"] = max(peak, setup_peak)
    sess.free()
    rec["correct"], rec["compared"] = check.judge(cell, args.seed, images, device)
    return rec


def result(rec: dict, e2e: list, per_layer: list) -> dict:
    from benchmark import cells

    metrics = {}
    for m in (per_layer if rec["trace"] is not None else e2e):
        value = cells.metric_reader(m["name"]).read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = dict(device_info(rec["device"], rec["cell"].chips),
                  memory_peak_bytes=rec["memory_peak_bytes"])
    out = {"correct": bool(rec["correct"]), "attempted": rec["images"], "failed": 0,
           "metrics": metrics, "device": device}
    if rec["trace"] is not None:
        tr = rec["trace"]
        device["busy_s"], device["window_s"] = tr.busy_s, tr.window_s
        out["breakdown"] = tr.breakdown()
    out["compared"] = rec["compared"]
    return out


def main(argv=None) -> int:
    environment()
    args = parse(argv)
    from benchmark import cells

    cell = cells.load_cell(args.workload)
    e2e, per_layer = cells.cell_metrics(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: cell {args.workload} needs {cell.chips} CUDA device(s), found {have}",
              file=sys.stderr)
        return 2
    if cell.mesh is None:
        rec = run(cell, args, torch.device("cuda", 0))
    else:
        rec = run_mesh(cell, args, "cuda")
    out = result(rec, e2e, per_layer)
    return finish(out, rec)


def finish(out: dict, rec: dict) -> int:
    """Refuse a run that loaded JAX or left a process alive; else print the
    compared numbers on standard error and the result line."""
    from benchmark import procs

    found = forbidden_modules()
    if found:
        print(f"benchmark: modules {found} were loaded in the process", file=sys.stderr)
        return 3
    left = procs.descendants()
    if left:
        print(f"benchmark: processes {left} of the run are still alive", file=sys.stderr)
        return 4
    for key, val in rec["notes"].items():
        print(f"note {key} {json.dumps(val)}", file=sys.stderr)
    for name, v in out["compared"].items():
        print(f"compared {name} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    print(json.dumps(out))
    return 0


def run_mesh(cell, args, kind: str) -> dict:
    """Rank 0 of a cell on several devices of `kind` ("cuda": one card a
    rank; "cpu" only for the harness's own tests): start ranks 1.., join
    the group, run, and reap the ranks on every exit path."""
    import torch

    from benchmark import cells, procs
    from cs397raytracingsp22_tpu_torch.parallel import multihost

    cells.files_of(cell.config)  # the stand-ins, written once before any rank reads them
    world = cell.chips
    port = procs.free_port()
    with procs.Ranks("benchmark.rank", [args.workload, str(args.seed), str(port), str(world),
                                        kind], world) as ranks:
        ranks.watch()
        device = torch.device(kind, 0) if kind == "cuda" else torch.device("cpu")
        multihost.initialize(coordinator_address=f"127.0.0.1:{port}", num_processes=world,
                             process_id=0, device=device)
        return run(cell, args, device, ranks)


if __name__ == "__main__":
    sys.exit(main())
