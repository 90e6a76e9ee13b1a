"""Smoke run of the torch port's main path on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one line and raising on failure (any failure exits
nonzero):
  1. device: a CUDA card is required; prints its name and power limit;
  2. build: nvcc builds the mega-bounce kernel (K1) from csrc/;
  3. K1 against its plain torch version on the card, bench scene
     (teapot_6k) at 64² × 4 spp, depth 8;
  4. the goldens (tests/goldens, seed 42) rendered through K1;
  5. timing of K1 and the plain version at 128² × 16 spp, depth 8;
  6. the main path at full size: bench scene 512² × 64 spp, depth 8,
     through render_chunk (one warm pass, then timed passes);
  7. time-to-64spp: Cornell 512² × 64 spp, depth 10, through
     render_to_image (best of 2 after a warm run);
  8. a torch.profiler trace of one bench frame and one time-to-64spp
     render: device busy time, first-to-last kernel span, the device's
     idle share inside it and K1's share of the busy time (traces are
     written to build/chip_smoke/).
Phases 6 and 7 first hold a full-size K1 launch (all of the chunk's
rays, uids and depth) to the plain version on a strided sample of its
rays: a ray's path depends only on its own o, d and uid, so the sample
traced alone must give the same rows, bit for bit, and those rows must
match the plain version within phase 3's tolerance.
Then one JSON line describing the kernels, the card's nvidia-smi line,
and the last line {"ok": true, "device": {...}}.

The launch count in the kernels line is that of the main path only
(the timed frames of phase 6 and the renders of phase 7): the counter
is reset just before each and read just after; the launches that
compare K1 with its plain version fall outside.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDENS = {
    "cornell_16": dict(width=16, height=16, spp=8, path_depth=4),
    "cornell_metal_glass_16": dict(width=16, height=16, spp=8, path_depth=4),
}
RTOL, ATOL, MIN_FRAC = 1e-3, 1e-4, 0.995
SAMPLE_STRIDE = 1021  # prime, so the sample covers every sub-pixel index


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of fn() over reps runs, by CUDA events (after one
    warm run)."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def compare(rad, segs, ref_rad, ref_segs, depth):
    """K1's parity contract (tests/test_torch_bounce_kernel.py)."""
    rad, ref_rad = rad.cpu().numpy(), ref_rad.cpu().numpy()
    if not np.isfinite(rad).all():
        raise AssertionError("K1 radiance has non-finite values")
    ok = np.isclose(rad, ref_rad, rtol=RTOL, atol=ATOL).all(axis=1)
    n_bad = int((~ok).sum())
    seg_diff = abs(int(segs) - int(ref_segs))
    if ok.mean() < MIN_FRAC:
        raise AssertionError(f"{n_bad} of {len(ok)} rays outside rtol {RTOL} / atol {ATOL}")
    if seg_diff > depth * n_bad:
        raise AssertionError(f"segments {int(segs)} vs {int(ref_segs)}")
    return n_bad, float(np.abs(rad - ref_rad).max()), seg_diff


def check_full_launch(bounce, integrator, data, o, d, uids, key, depth, max_dist, rad_full):
    """Hold a full-size K1 launch (rad_full, from o, d, uids) to the plain
    version on every SAMPLE_STRIDE-th ray. Returns (sample size, compare())."""
    idx = torch.arange(0, o.shape[0], SAMPLE_STRIDE, device=o.device)
    so, sd, su = o[idx].contiguous(), d[idx].contiguous(), uids[idx].contiguous()
    rows = rad_full[idx]
    rad_s, segs_s = bounce.path_trace_cuda(data, so, sd, su, key, depth, max_dist)
    if not torch.equal(rad_s, rows):
        n = int((rad_s != rows).any(dim=1).sum())
        raise AssertionError(f"{n} sampled rays traced alone differ from the full-size launch")
    ref_rad, ref_segs = integrator.path_trace(data, so, sd, su, key, depth, max_dist)
    return int(idx.numel()), compare(rows, segs_s, ref_rad, ref_segs, depth)


def device_trace(name: str, fn) -> dict:
    """Run fn() once under torch.profiler and read the device's kernels
    from the trace: busy time (union of kernel intervals), the span from
    the first kernel's start to the last one's end, the idle share inside
    that span, and K1's share of the busy time."""
    from torch.profiler import ProfilerActivity, profile

    path = os.path.join(ROOT, "build", "chip_smoke", f"trace_{name}.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kern = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
                  for e in events if e.get("cat") == "kernel" and e.get("ph") == "X")
    if not kern:
        raise AssertionError(f"trace {name}: the profiler saw no kernel on the device")
    busy, cur_s, cur_e = 0.0, kern[0][0], kern[0][1]
    for s, e, _ in kern[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    span = max(e for _, e, _ in kern) - kern[0][0]
    k1 = sum(e - s for s, e, n in kern if "bounce_kernel" in n)
    if k1 == 0.0:
        raise AssertionError(f"trace {name}: K1 does not appear in the trace")
    return dict(kernels=len(kern), wall_ms=wall * 1e3, busy_ms=busy / 1e3, span_ms=span / 1e3,
                idle=1.0 - busy / span, k1_ms=k1 / 1e3, k1_share=k1 / busy)


def main() -> int:
    # ---- 1. device ----
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    smi = nvidia_smi()
    dev = torch.device("cuda")
    log("device", f"{torch.cuda.get_device_name(0)} | nvidia-smi: {smi} | torch "
        f"{torch.__version__} CUDA {torch.version.cuda}")

    sys.path.insert(0, ROOT)
    from PIL import Image

    from cs397raytracingsp22_tpu_torch.ops.kernels import _build, bounce
    from cs397raytracingsp22_tpu_torch.render import driver, integrator
    from cs397raytracingsp22_tpu_torch.scenes import bench_scene, cornell
    from cs397raytracingsp22_tpu_torch.utils import threefry

    # ---- 2. build ----
    t0 = time.perf_counter()
    bounce.library()
    build_s = time.perf_counter() - t0
    regs, spill = bounce.kernel_attrs()
    ptxas = [ln.strip() for ln in _build.BUILD_INFO["bounce"]["log"].splitlines()
             if "registers" in ln or "spill" in ln]
    log("build", f"K1 built in {build_s:.2f}s ({_build.BUILD_INFO['bounce']['seconds']:.2f}s nvcc); "
        f"{regs} registers/thread, {spill} B local; ptxas: {' | '.join(ptxas)}")

    # ---- 3. K1 vs plain on the card ----
    depth = 8
    scene = bench_scene.build(64, 64, spp=4, path_depth=depth)
    data = scene.compile(device=dev)
    ids = torch.arange(64 * 64, dtype=torch.int32, device=dev)
    o, d, uids = driver._gen_chunk_rays(scene.camera, ids, 7, 0, 4, 1)
    rad, segs = bounce.path_trace_cuda(data, o, d, uids, 7, depth, 100.0)
    torch.cuda.synchronize()
    ref_rad, ref_segs = integrator.path_trace(data, o, d, uids, 7, depth, 100.0)
    n_bad, max_abs_err, seg_diff = compare(rad, segs, ref_rad, ref_segs, depth)
    log("parity", f"bench teapot_6k 64²x4spp depth {depth} ({o.shape[0]} rays): "
        f"{o.shape[0] - n_bad}/{o.shape[0]} rays within rtol {RTOL} atol {ATOL} "
        f"(need {MIN_FRAC:.1%}), max |diff| {max_abs_err:.3g}, segments {int(segs)} vs "
        f"{int(ref_segs)} (diff {seg_diff} <= {depth}x{n_bad})")

    # ---- 4. goldens through K1 ----
    before = bounce.LAUNCHES
    results = []
    for name, kw in GOLDENS.items():
        build = cornell.build if name == "cornell_16" else cornell.build_config3
        img, _ = driver.render_to_image(build(**kw), device=dev, seed=42, verbose=False)
        golden = np.asarray(Image.open(os.path.join(ROOT, "tests", "goldens", f"{name}.png"))
                            .convert("RGB"))
        diff = np.abs(img.astype(int) - golden.astype(int))
        within, mean = float((diff <= 1).mean()), float(diff.mean())
        if within < 0.99 or mean > 0.05:
            raise AssertionError(f"golden {name}: {within:.4f} within 1 u8, mean |diff| {mean:.4f}")
        results.append(f"{name} {within:.4f} within 1 u8, mean |diff| {mean:.4f}")
    grew = bounce.LAUNCHES - before
    if grew < len(GOLDENS):
        raise AssertionError("the golden renders did not launch K1")
    log("goldens", f"{'; '.join(results)} (K1 launches {grew})")

    # ---- 5. K1 and plain timing at 128² x 16 spp ----
    scene = bench_scene.build(128, 128, spp=16, path_depth=depth)
    data = scene.compile(device=dev)
    ids = torch.arange(128 * 128, dtype=torch.int32, device=dev)
    o, d, uids = driver._gen_chunk_rays(scene.camera, ids, 0, 0, 16, 1)
    k_ms = cuda_ms(lambda: bounce.path_trace_cuda(data, o, d, uids, 0, depth, 100.0), 5)
    p_ms = cuda_ms(lambda: integrator.path_trace(data, o, d, uids, 0, depth, 100.0), 2)
    torch.cuda.synchronize()
    log("timing", f"bench teapot_6k 128²x16spp depth {depth} ({o.shape[0]} rays): "
        f"K1 {k_ms:.3f} ms, plain torch {p_ms:.3f} ms ({p_ms / k_ms:.1f}x)")

    # ---- 6. main path at full size ----
    width = height = 512
    spp = 64
    scene = bench_scene.build(width, height, spp=spp, path_depth=depth)
    data = scene.compile(device=dev)
    n_px = width * height
    chunk_px = min(n_px, (1 << 24) // spp)
    chunks = [torch.arange(c, min(c + chunk_px, n_px), dtype=torch.int32, device=dev)
              for c in range(0, n_px, chunk_px)]
    # per-layer split of one chunk by CUDA events, before the counted run
    o, d, uids = driver._gen_chunk_rays(scene.camera, chunks[0], 0, 0, spp, 1)
    raygen_ms = cuda_ms(lambda: driver._gen_chunk_rays(scene.camera, chunks[0], 0, 0, spp, 1), 2)
    k1_full_ms = cuda_ms(lambda: bounce.path_trace_cuda(data, o, d, uids, 0, depth, 100.0), 2)
    rad_full, _ = bounce.path_trace_cuda(data, o, d, uids, 0, depth, 100.0)
    sum_ms = cuda_ms(lambda: rad_full.reshape(-1, spp, 3).sum(dim=1), 5)
    n_s, (n_bad, err, seg_diff) = check_full_launch(
        bounce, integrator, data, o, d, uids, 0, depth, 100.0, rad_full)
    max_abs_err = max(max_abs_err, err)
    log("parity-full", f"bench teapot_6k {width}²x{spp}spp depth {depth}, one launch of "
        f"{o.shape[0]} rays (uids {int(uids.min())}..{int(uids.max())}): every "
        f"{SAMPLE_STRIDE}th ray ({n_s}) traced alone is bit-identical to the launch's rows; "
        f"{n_s - n_bad}/{n_s} within rtol {RTOL} atol {ATOL} of the plain version, "
        f"max |diff| {err:.3g}, segment diff {seg_diff} <= {depth}x{n_bad}")
    del o, d, uids, rad_full

    def frame():
        out, seg = [], 0
        for ids in chunks:
            r, s = driver.render_chunk(data, scene.camera, ids, 0, 0, spp, 1)
            out.append(r)
            seg = seg + s
        return out, seg

    bounce.LAUNCHES = 0  # the main path's count starts here
    frame()  # warm
    torch.cuda.synchronize()
    reps = 3
    t0 = time.perf_counter()
    for _ in range(reps):
        sums, seg = frame()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / reps
    launches = bounce.LAUNCHES  # the main path's count, read just after
    segments = int(seg)
    full = torch.cat(sums)
    img = driver._finalize_image([full], n_px, spp, scene.camera.gamma).cpu().numpy()
    if not bool(torch.isfinite(full).all()) or img.max() == 0:
        raise AssertionError("full-size image is not finite or all zero")
    log("full", f"bench teapot_6k {width}²x{spp}spp depth {depth}: {len(chunks)} chunk(s) of "
        f"{chunk_px * spp} rays, {segments} segments in {wall:.4f} s = "
        f"{segments / wall / 1e6:.2f} Mrays/s of segments; K1 launches {launches}; "
        f"image finite, mean radiance sum {full.mean().item():.4f}, u8 max {img.max()}, "
        f"mean {img.mean():.2f}; split per chunk: raygen {raygen_ms:.2f} ms, K1 "
        f"{k1_full_ms:.2f} ms, pixel sum {sum_ms:.2f} ms")

    # ---- 7. time-to-64spp ----
    sc64 = cornell.build(width=512, height=512, spp=64, path_depth=10)
    d64 = sc64.compile(device=dev)
    cam = sc64.camera
    # chunk 0 of render_to_image(seed=0), as it builds it, through one K1 launch
    key = threefry.key_words(0)
    px_chunk = driver.chunk_pixels(d64, cam, cam.aa_sample_count)
    n_chunks = (n_px + px_chunk - 1) // px_chunk
    ids = torch.arange(px_chunk, dtype=torch.int32, device=dev) * n_chunks
    o, d, uids = driver._gen_chunk_rays(cam, ids, key, 0, cam.aa_sample_count, 1)
    rad_full, _ = bounce.path_trace_cuda(d64, o, d, uids, key, cam.path_depth,
                                         cam.max_trace_dist)
    n_s, (n_bad, err, seg_diff) = check_full_launch(
        bounce, integrator, d64, o, d, uids, key, cam.path_depth, cam.max_trace_dist, rad_full)
    max_abs_err = max(max_abs_err, err)
    log("parity-t64", f"Cornell 512²x64spp depth {cam.path_depth}, chunk 0 of {n_chunks}: one "
        f"launch of {o.shape[0]} rays (uids {int(uids.min())}..{int(uids.max())}): every "
        f"{SAMPLE_STRIDE}th ray ({n_s}) traced alone is bit-identical to the launch's rows; "
        f"{n_s - n_bad}/{n_s} within rtol {RTOL} atol {ATOL} of the plain version, "
        f"max |diff| {err:.3g}, segment diff {seg_diff} <= {cam.path_depth}x{n_bad}")
    del o, d, uids, rad_full
    driver.render_to_image(sc64, device=dev, seed=0, verbose=False, scene_data=d64)
    bounce.LAUNCHES = 0  # the main path's count starts here again
    runs = [driver.render_to_image(sc64, device=dev, seed=0, verbose=False, scene_data=d64)
            for _ in range(2)]
    launches += bounce.LAUNCHES
    t64 = min(st.wall_seconds for _, st in runs)
    img64, st64 = runs[0]
    if img64.max() == 0:
        raise AssertionError("time-to-64spp image is all zero")
    log("t64", f"Cornell 512²x64spp depth 10 via render_to_image: best of 2 {t64:.4f} s "
        f"({st64.chunks} chunk(s), {st64.path_segments} segments, "
        f"{st64.path_segments / t64 / 1e6:.2f} Mrays/s)")

    if launches < 1:
        raise AssertionError("the main path launched K1 no time")

    # ---- 8. device trace ----
    for name, fn in (("bench_frame", frame),
                     ("t64", lambda: driver.render_to_image(sc64, device=dev, seed=0,
                                                            verbose=False, scene_data=d64))):
        tr = device_trace(name, fn)
        log("trace", f"{name}: {tr['kernels']} kernels, device busy {tr['busy_ms']:.3f} ms in a "
            f"{tr['span_ms']:.3f} ms first-to-last span (idle share {tr['idle']:.2%}), "
            f"{tr['wall_ms']:.3f} ms wall under the profiler; K1 {tr['k1_ms']:.3f} ms "
            f"({tr['k1_share']:.1%} of busy)")
    print(json.dumps({"kernels": [{
        "name": "mega_bounce",
        "route": "cuda",
        "source": "cs397raytracingsp22_tpu_torch/csrc/bounce.cu",
        "replaces": "cs397raytracingsp22_tpu/ops/pallas/bounce.py:1480",
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": k_ms,
        "plain_ms": p_ms,
    }]}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
