"""Smoke run of the torch port's main path on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one line and raising on failure (any failure exits
nonzero):
  1. device: a CUDA card is required; prints its name and power limit;
  2. build: nvcc builds the mega-bounce kernel (K1), the wavefront kernel
     (K4), the scene-intersection kernel (K2), the big-mesh BVH traversal
     kernel (K3) and the dense-mesh scan (K5) from csrc/, one nvcc each, all
     started together; prints registers and spills (K4's two variants), and
     fails if K1, whose bounce body K4 shares, has more registers than
     before or spills;
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
     idle share inside it, and the shares of K1 and of raygen (the
     package's "raygen" span) in the busy time (traces are written to
     build/chip_smoke/).
  9. K2 and K3 against their plain versions on the card, on bounce-0
     and bounce-2 rays of one full-size chunk (4,194,304 rays) of the
     bench scene with teapot_6k (a dense mesh: K2's mesh scan) and with
     the 32,832-triangle teapot (scenes/bench_teapot_32k.py: K2, then K3
     on the teapot's object-space rays, as the staged path calls them);
     then K3 on 4,194,304 rays aimed at the 32k teapot's box (t_max cut
     to K2's t, as the staged path does), of which at least a tenth of
     the sample must hit the teapot (the camera rays rarely reach it);
 10. the staged main path at full size: scenes/bench_teapot_32k.py at
     512² × 64 spp, depth 8, through render_to_image (4 chunks of
     4,194,304 rays), after one chunk's staged run is held to the plain
     path on a strided sample; one warm render, then timed renders; peak
     device memory;
 11. K2 and K3 timed against their plain versions on that chunk's
     bounce-0 inputs, and K3 on the aimed rays;
 12. bounds: the work of each kernel on these inputs (the tests that the
     plain versions count with their `stats` on a strided sample, scaled
     to the launch) and the least time the card could take for it;
 13. a torch.profiler trace of one 32k render: device busy time, idle
     share, and the shares of K2, K3, the compaction's sorts and the
     package's "bounce_rng" and "raygen" spans.
Then this slice's paths, K4 and K5:
 14. K4 against K1 on the same rays at full width, through
     path_trace_wavefront: the bench frame (16,777,216 rays, depth 8, one
     K4 launch per bounce) and chunk 0 of the Cornell time-to-64spp render
     (the rays render_chunk makes, depth 10): rows bit-identical to K1's,
     K1's contract, segment totals, and the live share entering each
     bounce; compact=False gives the same bits; a strided sample of each
     traced alone and held to integrator.path_trace;
 15. K4 timing by CUDA events against K1 on the bench frame, in turns, and
     one frame step by step (pack, each launch, each partition,
     un-permute), and the same on the Cornell chunk; K4, K1 and the plain
     wavefront at 128² × 16 spp (the
     launch of K1's row in the kernels line);
 16. a torch.profiler trace of one K4 frame: busy, idle share, and the
     shares of K4 and of the partition (the package's span
     "wavefront_partition");
 17. K5 through intersect_mesh on 4,194,304 camera rays (chunk 0 of 4 of
     the bench frame) against the 6k teapot, the sample held to
     tri_scan_plain, and K5 timed against it;
 18. the bounds of K4 (K1's counted work plus the bytes of its state) and
     K5 (rays × triangles × 53 FP32 operations).
Then this slice's path, the roofline probes P1-P5 (csrc/vpu_peak.cu,
csrc/dtype_rate.cu, csrc/bw_scan.cu), which no render path runs; their
path is the port's tools:
 19. (after phase 2's lines) the probe kernels' registers and spills;
 20. the SASS check: `cuobjdump -sass` of each probe library and the count
     of FFMA, FMUL, HFMA2, HMMA, IMAD, IADD3, LOP3, LDS, LDC, ULDC, LDG and
     MUFU in each instantiation; fails if a chain holds fewer operations a
     thread than its tool counts (a probe the compiler folded), and prints
     the loads a FMA of P3's tables;
 21. each probe kernel against its plain version at a small size: chains
     within rtol 1e-3 up to unroll 12, integers bit-exact; P4 f32 within
     rtol 1e-6, bf16 within 8 ulps; P5's scalar kernel the same key as
     bw_scan_plain once the low 12 bits are dropped on >= 99.9% of rays,
     its mma kernel the same winner as bw_mma_plain with TF32 operands on
     >= 99.9%, and hits of the two kernels agreeing on >= 99%;
 22. P1 (tools/vpu_peak.py, every mix at unroll 256 and 1024) and P2
     (tools/vpu_peak_shape.py) at full size through their entry points,
     with nvidia-smi's SM clock, power draw and limit sampled beside each
     run, every full-size output held to the plain version on a strided
     sample, a sustained run of the row's kernel, rates, plain times and
     bounds;
 23. P3 (tools/vpu_peak_smem.py) and P4 (tools/profile_split.py, all four
     sections) the same way;
 24. P5 (tools/bench_mxu_scan.py): its parity line and both rates, a
     strided sample traced alone and held to bw_scan_plain, the bounds.
Phases 6, 7, 9, 10, 14 and 17 first hold a full-size launch (all of the chunk's
rays, uids and depth) to the plain version on a strided sample of its
rays: a ray's result depends only on its own inputs, so the sample
traced alone must give the same rows, bit for bit, and those rows must
match the plain version within the kernel's tolerance (K1 and the staged
path and K4: phase 3's; K2, K3 and K5: the same winner on >= 99.9% of
rays, t, u, v within rtol 1e-4 / atol 1e-5 where it agrees).
Then one JSON line describing the kernels, the card's nvidia-smi line,
and the last line {"ok": true, "device": {...}}.

The launch counts in the kernels line are those of the main paths only:
K1's of the timed frames of phase 6 and the renders of phase 7, K2's and
K3's of the timed renders of phase 10, K4's of the two wavefront runs of
phase 14, K5's of the intersect_mesh call of phase 17, and P1-P5's of their
tools' runs in phases 22-24. Each counter is reset just before its path
runs and read just after; the launches that compare a kernel with its
plain version fall outside.
"""

from __future__ import annotations

import json
import os
import re
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
# K2 and K3 against their plain versions: the same winner on >= 99.9% of
# rays (a ray grazing an edge may flip when one rounding differs), and t,
# u, v and the normals within rtol 1e-4 / atol 1e-5 where the winners
# agree. Both kernels are built without FMA contraction and follow the
# plain version's operation order, so most rows come out bit-identical;
# the count of those is printed too.
HIT_MIN_SAME, HIT_RTOL, HIT_ATOL = 0.999, 1e-4, 1e-5
# the H100's published peaks (NVIDIA data sheet, SXM, 700 W): FP32 outside
# the tensor cores and HBM3 bandwidth
PEAK_FP32, PEAK_BYTES = 67e12, 3.35e12
# FP32 operations per test, counted from the formulas of csrc/intersect.cuh
# and csrc/bvh_traverse.cu (an add, multiply, divide, square root, min, max
# or compare is one). The bounds count only the intersection tests, not
# the shading, the RNG or integer work, so they are lower bounds.
# the launch of K1's (and K4's) row in the kernels line: 128² x 16 spp
ROW_SIDE, ROW_SPP = 128, 16
# nvcc 12.9 allots K1 64 registers with no spills; sharing its bounce
# body with K4 (csrc/bounce.cuh) must not raise that
K1_REGS = 64
OPS = dict(sphere=32, plane=24, triangle=53, volume=42, mesh_setup=21, box=24, mt=53,
           mt_verts=59)


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
    k1 = lambda o_, d_, u_: bounce.path_trace_cuda(data, o_, d_, u_, key, depth, max_dist)  # noqa: E731
    sub, (rad_s, segs_s) = sample_alone("K1", k1, (rad_full,), (o, d, uids), idx)
    ref_rad, ref_segs = integrator.path_trace(data, *sub, key, depth, max_dist)
    return int(idx.numel()), compare(rad_s, segs_s, ref_rad, ref_segs, depth)


def device_trace(name: str, fn, kernels: dict, spans: tuple = ()) -> dict:
    """Run fn() once under torch.profiler and read the device's kernels
    from the trace: busy time (union of kernel intervals), the span from
    the first kernel's start to the last one's end, the idle share inside
    that span, and for each label of `kernels` (label → a substring of the
    kernel's name in any case, e.g. "bounce_kernel") the time of the
    kernels so named and their share of the busy time; each must appear.

    spans: labels of the record_function spans that the package opens
    (driver._gen_chunk_rays: "raygen"; integrator._bounce_draws:
    "bounce_rng"); the kernels launched inside them (matched to their
    launch calls by the trace's correlation ids) are reported under the
    label the same way."""
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
    kern = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"],
                   e.get("args", {}).get("correlation"))
                  for e in events if e.get("cat") == "kernel" and e.get("ph") == "X")
    if not kern:
        raise AssertionError(f"trace {name}: the profiler saw no kernel on the device")
    busy, cur_s, cur_e = 0.0, kern[0][0], kern[0][1]
    for s, e, _, _ in kern[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    span = max(k[1] for k in kern) - kern[0][0]
    out = dict(kernels=len(kern), wall_ms=wall * 1e3, busy_ms=busy / 1e3, span_ms=span / 1e3,
               idle=1.0 - busy / span, parts={})
    for label, sub in kernels.items():
        ms = sum(e - s for s, e, n, _ in kern if sub.lower() in n.lower()) / 1e3
        if ms == 0.0:
            raise AssertionError(f"trace {name}: no kernel named *{sub}* in the trace")
        out["parts"][label] = ms
    launches = [(float(e["ts"]), e.get("args", {}).get("correlation")) for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver") and e.get("ph") == "X"]
    for label in spans:
        marks = [(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
                 if e.get("cat") == "user_annotation" and e.get("name") == label]
        corr = {c for ts, c in launches if any(a <= ts <= b for a, b in marks)}
        ms = sum(e - s for s, e, _, c in kern if c in corr) / 1e3
        if ms == 0.0:
            raise AssertionError(f"trace {name}: no kernel launched inside {label}")
        out["parts"][label] = ms
    out["shares"] = {k: v / (busy / 1e3) for k, v in out["parts"].items()}
    return out


def compare_hits(what: str, win, ref_win, vals, ref_vals) -> tuple[int, int, int, float]:
    """A kernel's winners (tuple of int or bool tensors) and float outputs
    (dict name → tensor) against its plain version's on the same rays: the
    same winner on at least HIT_MIN_SAME of the rays, and every float
    within HIT_RTOL / HIT_ATOL where the winners agree. Returns (rays,
    rays with the same winner, rays whose every output is bit-identical,
    max |diff| where the winners agree)."""
    same = torch.ones_like(win[0], dtype=torch.bool)
    for a, b in zip(win, ref_win):
        same &= a == b
    exact = same.clone()
    n, n_same = same.numel(), int(same.sum())
    if n_same < HIT_MIN_SAME * n:
        raise AssertionError(f"{what}: {n - n_same} of {n} winners differ from the plain version")
    err = 0.0
    for name, a in vals.items():
        b = ref_vals[name]
        exact &= (a == b) if a.ndim == 1 else (a == b).all(dim=1)
        a, b = a[same].double(), b[same].double()
        if a.numel() == 0:
            continue
        diff = (a - b).abs()
        bad = int((diff > HIT_ATOL + HIT_RTOL * b.abs()).sum())
        if bad:
            raise AssertionError(f"{what}: {bad} values of {name} outside rtol {HIT_RTOL} atol "
                                 f"{HIT_ATOL}, max |diff| {float(diff.max()):.3g}")
        err = max(err, float(diff.max()))
    return n, n_same, int(exact.sum()), err


def sample_alone(what: str, fn, full, inputs, idx):
    """fn on the rows idx of its inputs alone must give the rows idx of its
    full-size outputs, bit for bit. Returns the sample's inputs and
    outputs."""
    sub = [x[idx].contiguous() for x in inputs]
    alone = fn(*sub)
    for a, b in zip(alone, full):
        if not torch.equal(a, b[idx]):
            raise AssertionError(f"{what}: the {idx.numel()} sampled rays traced alone differ "
                                 "from the full-size launch's rows")
    return sub, alone


def bound(n_bytes: float, n_ops: float, peak: float = PEAK_FP32) -> tuple[float, str]:
    """(least milliseconds on the card, "bytes" or "operations"): operations
    at `peak` a second (FP32 unless given)."""
    t_b, t_o = n_bytes / PEAK_BYTES, n_ops / peak
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def analytic_ops(data) -> int:
    """FP32 operations of one ray's analytic tests (every primitive)."""
    return (data.n_spheres * OPS["sphere"] + data.n_planes * OPS["plane"]
            + data.n_tris * OPS["triangle"] + data.n_volumes * OPS["volume"]
            + len(data.dense_mesh_ids) * OPS["mesh_setup"])


def k1_bound(data, o, d, uids, key, depth, max_dist, stride):
    """(bound ms, bound_by, work) of one K1 launch on (o, d, uids): bytes =
    o, d, uids in, radiance and segment counts out, the scene tables read
    once; operations = the tests that a strided sample's segments need
    (every analytic primitive, and the dense scan's boxes and triangles
    from the plain path's stats), scaled to the launch."""
    from cs397raytracingsp22_tpu_torch.render import integrator

    idx = torch.arange(0, o.shape[0], stride, device=o.device)
    st = {}
    _, segs = integrator.path_trace(data, o[idx], d[idx], uids[idx], key, depth, max_dist,
                                    stats=st)
    w = dict(segments=int(segs), boxes=int(st["boxes"].sum()), tris=int(st["tris"].sum()))
    scale = o.shape[0] / idx.numel()
    ops = scale * (w["segments"] * analytic_ops(data) + w["boxes"] * OPS["box"]
                   + w["tris"] * OPS["mt"])
    n_bytes = (o.shape[0] * (12 + 12 + 4 + 12 + 4)
               + nbytes(data.kscene, data.kmesh_tri, data.kmesh_nrm, data.ksl_bounds))
    ms, by = bound(n_bytes, ops)
    w.update(rays=idx.numel(), scale=scale, ops=ops, bytes=n_bytes)
    return ms, by, w


def k3_bound(mesh, ins, idx) -> tuple[float, str, dict]:
    """(bound ms, bound_by, work) of one K3 launch on ins = (o, d, t_min,
    t_max): bytes = the rays in, hit, t, tri, u, v out, the mesh's node
    arrays and triangles once; operations = the interior boxes and
    triangles that the plain traversal tests on the rays idx, scaled to
    the launch, and the three reciprocals of each ray."""
    from cs397raytracingsp22_tpu_torch.ops.kernels import tri_scan_big

    n = ins[0].shape[0]
    st = {}
    tri_scan_big.tri_scan_big_plain(mesh, *[x[idx] for x in ins], stats=st)
    w = dict(boxes=int(st["boxes"].sum()), tris=int(st["tris"].sum()),
             max_boxes=int(st["boxes"].max()), max_tris=int(st["tris"].max()))
    ops = n / idx.numel() * (w["boxes"] * OPS["box"] + w["tris"] * OPS["mt_verts"]) + n * 3
    n_bytes = (nbytes(*ins) + n * (1 + 4 + 4 + 4 + 4)
               + nbytes(mesh.bounds_min, mesh.bounds_max, mesh.skip, mesh.leaf_start,
                        mesh.leaf_count, mesh.tri_verts))
    ms, by = bound(n_bytes, ops)
    w.update(ops=ops, bytes=n_bytes)
    return ms, by, w


def aimed_rays(mesh, n: int, dev, seed: int = 0):
    """n world rays of the bench scene that aim at a big mesh: from uniform
    points of the room (the box of tests/test_torch_staged_kernels.py::
    scene_rays) toward uniform points of the mesh's world-space root box."""
    from cs397raytracingsp22_tpu_torch.utils import vecmath as vm

    g = torch.Generator(device=dev).manual_seed(seed)
    sel = torch.tensor([[x, y, z] for x in (0, 1) for y in (0, 1) for z in (0, 1)],
                       dtype=torch.float32, device=dev)
    corners = vm.apply_mat4_point(mesh.transform,
                                  mesh.bounds_min[0] * (1.0 - sel) + mesh.bounds_max[0] * sel)
    lo, hi = corners.amin(dim=0), corners.amax(dim=0)
    room_lo = torch.tensor([-2.4, 0.05, -2.4], device=dev)
    room_hi = torch.tensor([2.4, 4.95, 3.0], device=dev)
    o = room_lo + (room_hi - room_lo) * torch.rand((n, 3), generator=g, device=dev)
    d = lo + (hi - lo) * torch.rand((n, 3), generator=g, device=dev) - o
    return o.contiguous(), d.contiguous()


def staged_phases(dev, data6k, width: int, height: int, spp: int, depth: int) -> list:
    """Phases 9-11 and 13 and the bounds of K2 and K3 (see the module
    docstring): data6k is the bench scene with teapot_6k compiled at
    width x height; the 32k bench scene is built at the same size. Returns
    the kernels line's entries of K2 and K3."""
    from cs397raytracingsp22_tpu_torch.ops import intersect as isect
    from cs397raytracingsp22_tpu_torch.ops.kernels import scene_intersect, tri_scan_big
    from cs397raytracingsp22_tpu_torch.render import driver, integrator
    from cs397raytracingsp22_tpu_torch.scenes import bench_teapot_32k
    from cs397raytracingsp22_tpu_torch.utils import rng as rnglib
    from cs397raytracingsp22_tpu_torch.utils import threefry

    n_px = width * height
    # ---- 9. K2 and K3 against their plain versions on the card ----
    max_dist = 100.0
    key = threefry.key_words(0)
    sc32 = bench_teapot_32k.build(width, height, spp=spp, path_depth=depth)
    sd32 = sc32.compile(device=dev)
    cam32 = sc32.camera
    mesh32 = sd32.meshes[0]
    if sd32.dense_mesh_ids or mesh32.tri_verts.shape[0] != 32832:
        raise AssertionError("the 32k bench scene must hold one big mesh of 32,832 triangles")
    px32 = driver.chunk_pixels(sd32, cam32, spp)
    nch32 = (n_px + px32 - 1) // px32
    ids32 = torch.arange(px32, dtype=torch.int32, device=dev) * nch32  # chunk 0 of the render
    o32, dir32, uid32 = driver._gen_chunk_rays(cam32, ids32, key, 0, spp, 1)
    n32 = o32.shape[0]
    idx = torch.arange(0, n32, SAMPLE_STRIDE, device=dev)
    k2_err = k3_err = 0.0
    k2_in = k3_in = None

    def k2(sd):
        return lambda *a: scene_intersect.scene_intersect_cuda(sd, *a)

    for label, sd in (("teapot_6k", data6k), ("teapot_32k", sd32)):
        o, d, thr = o32, dir32, torch.ones_like(o32)
        rad = torch.zeros_like(o32)
        alive = torch.ones((n32,), dtype=torch.bool, device=dev)
        for b in range(3):
            site = rnglib.SITE_BOUNCE0 + b
            if b in (0, 2):
                u_vol = integrator._bounce_draws(sd, key, uid32, site)[2].contiguous()
                t_min = torch.full((n32,), integrator.PATH_T_MIN, device=dev)
                t_max = torch.where(alive, torch.full_like(t_min, max_dist), torch.zeros_like(t_min))
                inputs = (o.contiguous(), d.contiguous(), t_min, t_max, u_vol)
                full_out = k2(sd)(*inputs)
                sub, alone = sample_alone(f"K2 {label} bounce {b}", k2(sd), full_out, inputs, idx)
                ref = scene_intersect.scene_intersect_plain(sd, *sub)
                n, n_same, n_exact, err = compare_hits(
                    f"K2 {label} bounce {b}", alone[1:4], ref[1:4],
                    *(dict(t=x[0], u=x[4], v=x[5], normal=x[6]) for x in (alone, ref)))
                k2_err = max(k2_err, err)
                codes = alone[1]
                log("parity-k2", f"{label} bounce {b}: one K2 launch of {n32} rays "
                    f"({int(alive.sum())} live); every {SAMPLE_STRIDE}th ray ({n}) alone is "
                    f"bit-identical to the launch's rows; {n_same}/{n} same (code, idx, mat) as "
                    f"the plain version, {n_exact}/{n} bit-identical, t/u/v/normal max |diff| "
                    f"{err:.3g}; sampled winners: "
                    f"{int((codes < 0).sum())} miss, {int((codes == 4).sum())} dense mesh")
                if label == "teapot_32k":
                    o_obj, d_obj = (x.contiguous() for x in isect.object_rays(mesh32, *inputs[:2]))
                    t3 = torch.minimum(t_max, full_out[0])
                    ins3 = (o_obj, d_obj, t_min, t3)
                    k3f = lambda *a: tri_scan_big.tri_scan_big_cuda(mesh32, *a)  # noqa: E731
                    full3 = k3f(*ins3)
                    sub3, alone3 = sample_alone(f"K3 bounce {b}", k3f, full3, ins3, idx)
                    ref3 = tri_scan_big.tri_scan_big_plain(mesh32, *sub3)
                    n, n_same, n_exact, err = compare_hits(
                        f"K3 bounce {b}", (alone3[0], alone3[2]), (ref3[0], ref3[2]),
                        *(dict(t=x[1], u=x[3], v=x[4]) for x in (alone3, ref3)))
                    k3_err = max(k3_err, err)
                    log("parity-k3", f"teapot_32k bounce {b}: one K3 launch of {n32} object-space "
                        f"rays (t_max = min(t_max, K2's t)); every {SAMPLE_STRIDE}th ray ({n}) "
                        f"alone is bit-identical to the launch's rows; {n_same}/{n} same (hit, "
                        f"tri) as traverse, {n_exact}/{n} bit-identical, t/u/v max |diff| "
                        f"{err:.3g}; {int(alone3[0].sum())} "
                        f"sampled hits")
                    if b == 0:
                        k2_in, k3_in = inputs, ins3
            if b < 2:  # on to the next bounce through the staged path (K2 + K3)
                o, d, thr, rad, alive, _ = integrator._bounce_update(
                    sd, o, d, thr, rad, alive, uid32, key, site, max_dist,
                    intersect=isect.intersect_scene)
        del o, d, thr, rad, alive

    # K2 then K3 on full-width rays aimed at the teapot, as the staged path
    # calls them: the camera rays above rarely reach it
    o_a, d_a = aimed_rays(mesh32, n32, dev)
    t_min = torch.full((n32,), integrator.PATH_T_MIN, device=dev)
    t_max = torch.full_like(t_min, max_dist)
    u_vol = torch.full((n32, sd32.vol_center.shape[0]), 0.5, device=dev)  # the scene has no volume
    t2 = scene_intersect.scene_intersect_cuda(sd32, o_a, d_a, t_min, t_max, u_vol)[0]
    o_obj, d_obj = (x.contiguous() for x in isect.object_rays(mesh32, o_a, d_a))
    aim_in = (o_obj, d_obj, t_min, torch.minimum(t_max, t2))
    k3f = lambda *a: tri_scan_big.tri_scan_big_cuda(mesh32, *a)  # noqa: E731
    full3 = k3f(*aim_in)
    sub3, alone3 = sample_alone("K3 aimed", k3f, full3, aim_in, idx)
    ref3 = tri_scan_big.tri_scan_big_plain(mesh32, *sub3)
    n, n_same, n_exact, err = compare_hits(
        "K3 aimed", (alone3[0], alone3[2]), (ref3[0], ref3[2]),
        *(dict(t=x[1], u=x[3], v=x[4]) for x in (alone3, ref3)))
    k3_err = max(k3_err, err)
    n_hit = int(alone3[0].sum())
    if n_hit < n // 10:
        raise AssertionError(f"K3 aimed: only {n_hit} of {n} sampled rays hit the teapot")
    log("parity-k3", f"teapot_32k, rays aimed at the teapot's box: one K3 launch of {n32} "
        f"object-space rays (t_max = min(t_max, K2's t)); every {SAMPLE_STRIDE}th ray ({n}) alone "
        f"is bit-identical to the launch's rows; {n_same}/{n} same (hit, tri) as traverse, "
        f"{n_exact}/{n} bit-identical, t/u/v max |diff| {err:.3g}; {n_hit} sampled hits "
        f"({int(full3[0].sum())} in the launch)")
    del o_a, d_a, t2, full3

    # ---- 10. the staged main path at full size ----
    rad_full, _ = integrator.path_trace_shrink(sd32, o32, dir32, uid32, key, depth, max_dist)
    stage = lambda o, d, u: integrator.path_trace_shrink(  # noqa: E731
        sd32, o, d, u, key, depth, max_dist)
    sub, (rad_s, segs_s) = sample_alone("staged chunk", stage, (rad_full,), (o32, dir32, uid32), idx)
    ref_rad, ref_segs = integrator.path_trace(sd32, *sub, key, depth, max_dist)
    n_bad, err, seg_diff = compare(rad_s, segs_s, ref_rad, ref_segs, depth)
    log("parity-staged", f"teapot_32k {width}²x{spp}spp depth {depth}, chunk 0 of {nch32}: one "
        f"staged run of {n32} rays (uids {int(uid32.min())}..{int(uid32.max())}); every "
        f"{SAMPLE_STRIDE}th ray ({idx.numel()}) traced alone is bit-identical to the run's rows; "
        f"{idx.numel() - n_bad}/{idx.numel()} within rtol {RTOL} atol {ATOL} of the plain path "
        f"(integrator.path_trace on the card), max |diff| {err:.3g}, segments {int(segs_s)} vs "
        f"{int(ref_segs)}")
    del rad_full, ref_rad

    def render32():
        return driver.render_to_image(sc32, device=dev, seed=0, verbose=False, scene_data=sd32)

    render32()  # warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    scene_intersect.LAUNCHES = tri_scan_big.LAUNCHES = 0  # the staged main path's counts
    runs32 = [render32() for _ in range(3)]
    k2_launches, k3_launches = scene_intersect.LAUNCHES, tri_scan_big.LAUNCHES  # read just after
    peak = torch.cuda.max_memory_allocated()
    if k2_launches < 1 or k3_launches < 1:
        raise AssertionError("the staged main path launched K2 or K3 no time")
    img32, st32 = runs32[0]
    if img32.max() == 0 or any(not np.array_equal(im, img32) for im, _ in runs32):
        raise AssertionError("the 32k renders are all zero or differ from each other")
    walls = [st.wall_seconds for _, st in runs32]
    mean32 = sum(walls) / len(walls)
    log("full-32k", f"bench teapot_32k {width}²x{spp}spp depth {depth} via render_to_image: "
        f"{st32.chunks} chunks of {px32 * spp} rays, {st32.path_segments} segments; "
        f"{mean32:.4f} s per image (mean of {len(walls)}: {', '.join(f'{w:.4f}' for w in walls)}) "
        f"= {st32.path_segments / mean32 / 1e6:.2f} Mrays/s of segments; per image K2 launches "
        f"{k2_launches // len(runs32)}, K3 launches {k3_launches // len(runs32)}; peak device "
        f"memory {peak / 2**30:.2f} GiB; image u8 max {img32.max()}, mean {img32.mean():.2f}")

    # ---- 11. K2 and K3 timing at the main path's shapes ----
    k2_ms = cuda_ms(lambda: scene_intersect.scene_intersect_cuda(sd32, *k2_in), 10)
    k2_plain_ms = cuda_ms(lambda: scene_intersect.scene_intersect_plain(sd32, *k2_in), 2)
    k3_ms = cuda_ms(lambda: tri_scan_big.tri_scan_big_cuda(mesh32, *k3_in), 10)
    k3_plain_ms = cuda_ms(lambda: tri_scan_big.tri_scan_big_plain(mesh32, *k3_in), 1)
    k3_aim_ms = cuda_ms(lambda: tri_scan_big.tri_scan_big_cuda(mesh32, *aim_in), 10)
    log("timing-staged", f"teapot_32k chunk 0 bounce 0 ({n32} rays): K2 {k2_ms:.3f} ms, plain "
        f"{k2_plain_ms:.3f} ms ({k2_plain_ms / k2_ms:.1f}x); K3 {k3_ms:.3f} ms, plain "
        f"{k3_plain_ms:.3f} ms ({k3_plain_ms / k3_ms:.1f}x); K3 on {n32} rays aimed at the "
        f"teapot {k3_aim_ms:.3f} ms")

    # ---- 12. bounds of K2 and K3 at phase 11's inputs ----
    st2 = {}
    scene_intersect.scene_intersect_plain(sd32, *[x[idx] for x in k2_in], stats=st2)
    scale = n32 / idx.numel()
    k2_ops = n32 * analytic_ops(sd32) + scale * (int(st2["boxes"].sum()) * OPS["box"]
                                                 + int(st2["tris"].sum()) * OPS["mt"])
    # what the kernel moves: o, d, t_min, t_max and one u_vol column per
    # volume in (it reads no padding column), 37 B of outputs out, the
    # scene table and any dense-mesh rows once
    k2_bytes = (n32 * (12 + 12 + 4 + 4 + 4 * sd32.n_volumes + 37) + nbytes(sd32.kscene)
                + (nbytes(sd32.kmesh_tri, sd32.ksl_bounds) if sd32.dense_mesh_ids else 0))
    k2_bound, k2_by = bound(k2_bytes, k2_ops)
    log("bound-k2", f"teapot_32k chunk 0 bounce 0 ({n32} rays): {analytic_ops(sd32)} FP32 ops of "
        f"analytic tests per ray, {int(st2['tris'].sum()) / idx.numel():.2f} dense-mesh triangles "
        f"per sampled ray; {k2_ops:.4g} ops, {k2_bytes:.4g} B -> bound {k2_bound:.4f} ms "
        f"({k2_by})")
    k3b = {}
    for what, ins3, ms in (("chunk 0 bounce 0", k3_in, k3_ms), ("aimed at the teapot", aim_in,
                                                                  k3_aim_ms)):
        b_ms, b_by, w = k3b[what] = k3_bound(mesh32, ins3, idx)
        log("bound-k3", f"teapot_32k {what} ({n32} object-space rays); every {SAMPLE_STRIDE}th "
            f"ray ({idx.numel()}) traversed by the plain version: {w['boxes'] / idx.numel():.2f} "
            f"interior boxes and {w['tris'] / idx.numel():.2f} triangles tested per ray (max "
            f"{w['max_boxes']} and {w['max_tris']}); {w['ops']:.4g} ops, {w['bytes']:.4g} B -> "
            f"bound {b_ms:.4f} ms ({b_by}); K3 {ms:.3f} ms")

    # ---- 13. device trace of one 32k render ----
    tr = device_trace("teapot_32k", render32,
                      {"K2": "scene_intersect_kernel", "K3": "bvh_traverse_kernel", "sort": "sort"},
                      spans=("bounce_rng", "raygen"))
    log("trace", "teapot_32k: " + f"{tr['kernels']} kernels, device busy {tr['busy_ms']:.3f} ms in "
        f"a {tr['span_ms']:.3f} ms first-to-last span (idle share {tr['idle']:.2%}), "
        f"{tr['wall_ms']:.3f} ms wall under the profiler; " + ", ".join(
            f"{k} {v:.3f} ms ({tr['shares'][k]:.1%} of busy)" for k, v in tr["parts"].items()))
    return [{
        "name": "scene_intersect",
        "route": "cuda",
        "source": "cs397raytracingsp22_tpu_torch/csrc/scene_intersect.cu",
        "replaces": "cs397raytracingsp22_tpu/ops/pallas/scene_intersect.py:464",
        "launches": k2_launches,
        "max_abs_err": k2_err,
        "ms": k2_ms,
        "plain_ms": k2_plain_ms,
        "bound_ms": k2_bound,
        "bound_by": k2_by,
        "library_ms": None,
    }, {
        "name": "bvh_traverse",
        "route": "cuda",
        "source": "cs397raytracingsp22_tpu_torch/csrc/bvh_traverse.cu",
        "replaces": "cs397raytracingsp22_tpu/ops/pallas/tri_scan_big.py:251",
        "launches": k3_launches,
        "max_abs_err": k3_err,
        "ms": k3_ms,
        "plain_ms": k3_plain_ms,
        "bound_ms": k3b["chunk 0 bounce 0"][0],
        "bound_by": k3b["chunk 0 bounce 0"][1],
        "library_ms": None,
    }]


def k1_bounds(dev, depth: int, launches) -> dict:
    """Phase 12 for K1: its bound at each (width, height, spp, sample
    stride) of `launches` on the bench scene with teapot_6k (seed 0).
    Returns {(width, spp): (ms, bound_by, work)}."""
    from cs397raytracingsp22_tpu_torch.render import driver
    from cs397raytracingsp22_tpu_torch.scenes import bench_scene

    out = {}
    for w_, h_, spp_, stride in launches:
        sc = bench_scene.build(w_, h_, spp=spp_, path_depth=depth)
        sd = sc.compile(device=dev)
        ids = torch.arange(w_ * h_, dtype=torch.int32, device=dev)
        o, d, uids = driver._gen_chunk_rays(sc.camera, ids, 0, 0, spp_, 1)
        ms, by, w = out[(w_, spp_)] = k1_bound(sd, o, d, uids, 0, depth, 100.0, stride)
        log("bound-k1", f"bench teapot_6k {w_}²x{spp_}spp depth {depth}, {o.shape[0]} rays; every "
            f"{stride}th ray ({w['rays']}): {w['segments']} segments, per segment "
            f"{w['boxes'] / w['segments']:.2f} superleaf boxes and {w['tris'] / w['segments']:.2f} "
            f"triangles tested; launch {w['ops']:.4g} FP32 ops, {w['bytes']:.4g} B -> bound "
            f"{ms:.4f} ms ({by})")
    return out


def compare_k1(what: str, rad, segs, k1_rad, k1_segs, depth: int) -> tuple[int, int, float]:
    """K4's rows against K1's on the same rays, by K1's contract (compare()).
    Returns (rows bit-identical to K1's, rows outside the tolerance, max
    |diff|)."""
    n_bad, err, seg_diff = compare(rad, segs, k1_rad, k1_segs, depth)
    same = int((rad == k1_rad).all(dim=1).sum())
    log("k4-vs-k1", f"{what}: {same}/{rad.shape[0]} rows bit-identical to K1's, "
        f"{rad.shape[0] - n_bad} within rtol {RTOL} atol {ATOL}, max |diff| {err:.3g}; segments "
        f"K4 {int(segs)}, K1 {int(k1_segs)} (diff {seg_diff} <= {depth}x{n_bad})")
    return same, n_bad, err


def wavefront_split(wavefront, data, o, d, uids, key, depth: int, max_dist: float) -> dict:
    """One wavefront frame run step by step as path_trace_wavefront runs it,
    with CUDA events around each part: ms of packing the state, of each K4
    launch, of each partition and of the un-permute."""
    from cs397raytracingsp22_tpu_torch.render import integrator
    from cs397raytracingsp22_tpu_torch.utils import threefry

    # ev[1 + 2b] -> ev[2 + 2b]: launch b; ev[2 + 2b] -> ev[3 + 2b]: partition b
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2 * depth + 3)]
    key_pair = threefry.key_pair(key)
    torch.cuda.synchronize()
    ev[0].record()
    rows, alive = wavefront.pack_state(o, d, uids)
    ev[1].record()
    for b in range(depth):
        wavefront.step_cuda(data, rows, alive, key_pair, b, b == depth - 1,
                            integrator.PATH_T_MIN, max_dist)
        ev[2 + 2 * b].record()
        if b < depth - 1:
            rows, alive = wavefront.stable_partition(alive, rows)
        ev[3 + 2 * b].record()
    wavefront.radiance_in_caller_order(rows)
    ev[-1].record()
    torch.cuda.synchronize()
    return dict(pack=ev[0].elapsed_time(ev[1]),
                k4=[ev[1 + 2 * b].elapsed_time(ev[2 + 2 * b]) for b in range(depth)],
                partition=[ev[2 + 2 * b].elapsed_time(ev[3 + 2 * b]) for b in range(depth - 1)],
                unpermute=ev[2 * depth + 1].elapsed_time(ev[-1]))


def k4_state_bytes(n: int, live: list) -> int:
    """The bytes K4's state adds on top of K1's: per launch the 4-byte alive
    flag of every ray and, for each live ray, its 64-byte row read, 48 bytes
    written (16 on the emission-only last launch) and its alive written; per
    partition alive, every row read and written and the new alive."""
    launches = sum(n * 4 + m * (64 + 48 + 4) for m in live[:-1]) + n * 4 + live[-1] * (64 + 16 + 4)
    return launches + (len(live) - 1) * n * (4 + 64 + 64 + 4)


def wavefront_phases(dev, k1b: dict, width: int, height: int, spp: int, depth: int) -> list:
    """Phases 14-18 (see the module docstring): K4 and K5. k1b: phase 12's
    K1 bounds by (width, spp). Returns the kernels line's entries of K4 and
    K5, and K5's ray-triangle tests a second in billions (Gtri-tests/s)."""
    from cs397raytracingsp22_tpu_torch.ops import intersect as isect
    from cs397raytracingsp22_tpu_torch.ops.kernels import bounce, tri_scan, wavefront
    from cs397raytracingsp22_tpu_torch.render import driver, integrator
    from cs397raytracingsp22_tpu_torch.scenes import bench_scene, cornell
    from cs397raytracingsp22_tpu_torch.utils import threefry

    # ---- 14. K4 against K1 at full width, on its own main path ----
    n_px = width * height
    sc = bench_scene.build(width, height, spp=spp, path_depth=depth)
    data = sc.compile(device=dev)
    o, d, uids = driver._gen_chunk_rays(sc.camera, torch.arange(n_px, dtype=torch.int32,
                                                                device=dev), 0, 0, spp, 1)
    max_dist = 100.0
    k1_rad, k1_segs = bounce.path_trace_cuda(data, o, d, uids, 0, depth, max_dist)
    st = {}
    wavefront.LAUNCHES = 0  # the wavefront path's count starts here
    rad, segs = wavefront.path_trace_wavefront(data, o, d, uids, 0, depth, max_dist, stats=st)
    torch.cuda.synchronize()
    k4_launches = wavefront.LAUNCHES  # read just after
    if k4_launches != depth:
        raise AssertionError(f"the bench frame launched K4 {k4_launches} times, not {depth}")
    n = o.shape[0]
    live6k = [int(x) for x in st["live"]]
    compare_k1(f"bench teapot_6k {width}²x{spp}spp depth {depth}, one chunk of {n} rays, "
               f"{k4_launches} K4 launches", rad, segs, k1_rad, k1_segs, depth)
    log("k4-live", "bench teapot_6k: live share entering each bounce " + ", ".join(
        f"{m / n:.6f}" for m in live6k) + f" ({live6k[-1]} of {n} rays reach bounce {depth - 1})")
    rad_nc, segs_nc = wavefront.path_trace_wavefront(data, o, d, uids, 0, depth, max_dist,
                                                     compact=False)
    if not torch.equal(rad_nc, rad) or int(segs_nc) != int(segs):
        raise AssertionError("K4 with compact=False differs from compact=True")
    log("k4-compact", f"bench teapot_6k: compact=False gives the same {n} rows bit for bit and "
        f"the same {int(segs)} segments as compact=True")
    idx = torch.arange(0, n, SAMPLE_STRIDE, device=dev)
    k4 = lambda o_, d_, u_: wavefront.path_trace_wavefront(data, o_, d_, u_, 0, depth, max_dist)  # noqa: E731
    sub, (rad_s, segs_s) = sample_alone("K4", k4, (rad,), (o, d, uids), idx)
    ref_rad, ref_segs = integrator.path_trace(data, *sub, 0, depth, max_dist)
    n_bad, k4_err, seg_diff = compare(rad_s, segs_s, ref_rad, ref_segs, depth)
    log("parity-k4", f"bench teapot_6k: every {SAMPLE_STRIDE}th ray ({idx.numel()}) traced alone "
        f"through K4 is bit-identical to the full launch's rows; {idx.numel() - n_bad}/"
        f"{idx.numel()} within rtol {RTOL} atol {ATOL} of integrator.path_trace, max |diff| "
        f"{k4_err:.3g}, segment diff {seg_diff} <= {depth}x{n_bad}")
    del rad_nc, rad_s, ref_rad

    sc64 = cornell.build(width=512, height=512, spp=64, path_depth=10)
    d64 = sc64.compile(device=dev)
    cam = sc64.camera
    key = threefry.key_words(0)
    px_chunk = driver.chunk_pixels(d64, cam, cam.aa_sample_count)
    n_chunks = (512 * 512 + px_chunk - 1) // px_chunk
    ids = torch.arange(px_chunk, dtype=torch.int32, device=dev) * n_chunks
    o64, d64r, u64 = driver._gen_chunk_rays(cam, ids, key, 0, cam.aa_sample_count, 1)
    c_rad, c_segs = bounce.path_trace_cuda(d64, o64, d64r, u64, key, cam.path_depth,
                                           cam.max_trace_dist)
    st64 = {}
    before = wavefront.LAUNCHES
    w_rad, w_segs = wavefront.path_trace_wavefront(d64, o64, d64r, u64, key, cam.path_depth,
                                                   cam.max_trace_dist, stats=st64)
    torch.cuda.synchronize()
    k4_launches += wavefront.LAUNCHES - before
    n64 = o64.shape[0]
    compare_k1(f"Cornell 512²x64spp depth {cam.path_depth}, chunk 0 of {n_chunks} ({n64} rays)",
               w_rad, w_segs, c_rad, c_segs, cam.path_depth)
    live64 = [int(x) for x in st64["live"]]
    log("k4-live", "Cornell: live share entering each bounce " + ", ".join(
        f"{m / n64:.6f}" for m in live64))
    sub, (rad_s, segs_s) = sample_alone(
        "K4 Cornell", lambda o_, d_, u_: wavefront.path_trace_wavefront(
            d64, o_, d_, u_, key, cam.path_depth, cam.max_trace_dist),
        (w_rad,), (o64, d64r, u64), idx[idx < n64])
    ref_rad, ref_segs = integrator.path_trace(d64, *sub, key, cam.path_depth, cam.max_trace_dist)
    n_bad, err, seg_diff = compare(rad_s, segs_s, ref_rad, ref_segs, cam.path_depth)
    k4_err = max(k4_err, err)  # max |K4 - plain| over both samples
    log("parity-k4", f"Cornell: every {SAMPLE_STRIDE}th ray ({rad_s.shape[0]}) traced alone "
        f"through K4 is bit-identical to the full launch's rows; {rad_s.shape[0] - n_bad}/"
        f"{rad_s.shape[0]} within rtol {RTOL} atol {ATOL} of integrator.path_trace, max |diff| "
        f"{err:.3g}")
    del c_rad, w_rad
    c_k1 = lambda: bounce.path_trace_cuda(d64, o64, d64r, u64, key, cam.path_depth,  # noqa: E731
                                          cam.max_trace_dist)
    c_k4 = lambda: wavefront.path_trace_wavefront(d64, o64, d64r, u64, key,  # noqa: E731
                                                  cam.path_depth, cam.max_trace_dist)
    c_times = {"K1": [], "K4": []}
    for name, fn in (("K1", c_k1), ("K4", c_k4), ("K4", c_k4), ("K1", c_k1)):
        c_times[name].append(cuda_ms(fn, 3))
    c_split = wavefront_split(wavefront, d64, o64, d64r, u64, key, cam.path_depth,
                              cam.max_trace_dist)
    log("timing-k4", f"Cornell chunk ({n64} rays, depth {cam.path_depth}), CUDA events, mean of 3 "
        f"after a warm run, in turns K1, K4, K4, K1: K1 "
        f"{', '.join(f'{t:.3f}' for t in c_times['K1'])} ms; K4 path "
        f"{', '.join(f'{t:.3f}' for t in c_times['K4'])} ms "
        f"({sum(c_times['K4']) / sum(c_times['K1']):.2f}x K1); step by step: pack "
        f"{c_split['pack']:.3f} ms, K4 launches {sum(c_split['k4']):.3f} ms, partitions "
        f"{sum(c_split['partition']):.3f} ms, un-permute {c_split['unpermute']:.3f} ms")
    del o64, d64r, u64

    # ---- 15. K4 timing against K1 on the same rays, the partition apart ----
    run_k1 = lambda: bounce.path_trace_cuda(data, o, d, uids, 0, depth, max_dist)  # noqa: E731
    run_k4 = lambda: wavefront.path_trace_wavefront(data, o, d, uids, 0, depth, max_dist)  # noqa: E731
    turns = [("K1", run_k1), ("K4", run_k4), ("K4", run_k4), ("K1", run_k1)]
    times = {"K1": [], "K4": []}
    for name, fn in turns:
        times[name].append(cuda_ms(fn, 3))
    split = wavefront_split(wavefront, data, o, d, uids, 0, depth, max_dist)
    k4_sum, part_sum = sum(split["k4"]), sum(split["partition"])
    k4_frame = sum(times["K4"]) / 2
    log("timing-k4", f"bench teapot_6k frame ({n} rays, depth {depth}), CUDA events, mean of 3 "
        f"after a warm run, in turns K1, K4, K4, K1: K1 {', '.join(f'{t:.3f}' for t in times['K1'])}"
        f" ms; K4 path {', '.join(f'{t:.3f}' for t in times['K4'])} ms "
        f"({k4_frame / (sum(times['K1']) / 2):.3f}x K1); one frame step by step: pack "
        f"{split['pack']:.3f} ms, K4 launches {k4_sum:.3f} ms ("
        + ", ".join(f"{t:.3f}" for t in split["k4"]) + f"), partitions {part_sum:.3f} ms ("
        + ", ".join(f"{t:.3f}" for t in split["partition"]) + f"), un-permute "
        f"{split['unpermute']:.3f} ms; partition share {part_sum / k4_frame:.1%} of the K4 path")

    # at the shape of K1's row in the kernels line
    sc_s = bench_scene.build(ROW_SIDE, ROW_SIDE, spp=ROW_SPP, path_depth=depth)
    data_s = sc_s.compile(device=dev)
    o_s, d_s, u_s = driver._gen_chunk_rays(
        sc_s.camera, torch.arange(ROW_SIDE**2, dtype=torch.int32, device=dev), 0, 0, ROW_SPP, 1)
    st_s = {}
    wavefront.path_trace_wavefront(data_s, o_s, d_s, u_s, 0, depth, max_dist, stats=st_s)
    k4_ms = cuda_ms(lambda: wavefront.path_trace_wavefront(data_s, o_s, d_s, u_s, 0, depth,
                                                           max_dist), 5)
    k1_ms = cuda_ms(lambda: bounce.path_trace_cuda(data_s, o_s, d_s, u_s, 0, depth, max_dist), 5)
    k4_plain_ms = cuda_ms(lambda: wavefront.path_trace_wavefront_plain(
        data_s, o_s, d_s, u_s, 0, depth, max_dist), 1)
    log("timing-k4", f"bench teapot_6k {ROW_SIDE}²x{ROW_SPP}spp depth {depth} ({o_s.shape[0]} rays): K4 path "
        f"{k4_ms:.3f} ms, K1 {k1_ms:.3f} ms, plain wavefront {k4_plain_ms:.3f} ms")

    # ---- 18. K4's bound: K1's counted work plus the state's bytes ----
    k4b = {}
    for (w_, spp_), nr, live in (((ROW_SIDE, ROW_SPP), o_s.shape[0],
                                  [int(x) for x in st_s["live"]]),
                                 ((width, spp), n, live6k)):
        _, _, w = k1b[(w_, spp_)]
        extra = k4_state_bytes(nr, live)
        k4b[(w_, spp_)] = bound(w["bytes"] + extra, w["ops"])
        log("bound-k4", f"bench teapot_6k {w_}²x{spp_}spp depth {depth} ({nr} rays): K1's "
            f"{w['ops']:.4g} FP32 ops and {w['bytes']:.4g} B plus {extra:.4g} B of state -> bound "
            f"{k4b[(w_, spp_)][0]:.4f} ms ({k4b[(w_, spp_)][1]})")

    # ---- 16. device trace of one K4 frame ----
    tr = device_trace("wavefront_frame", run_k4, {"K4": "wavefront_kernel"},
                      spans=("wavefront_partition",))
    log("trace", "wavefront_frame: " + f"{tr['kernels']} kernels, device busy {tr['busy_ms']:.3f} "
        f"ms in a {tr['span_ms']:.3f} ms first-to-last span (idle share {tr['idle']:.2%}), "
        f"{tr['wall_ms']:.3f} ms wall under the profiler; " + ", ".join(
            f"{k} {v:.3f} ms ({tr['shares'][k]:.1%} of busy)" for k, v in tr["parts"].items()))
    del o, d, uids, k1_rad, rad

    # ---- 17. K5 at 4,194,304 rays, through intersect_mesh ----
    mesh = data.meshes[data.dense_mesh_ids[0]]
    nt = mesh.tri_table.shape[0]
    ids = torch.arange(n_px // 4, dtype=torch.int32, device=dev) * 4  # chunk 0 of 4, as the staged path
    o5, d5, _ = driver._gen_chunk_rays(sc.camera, ids, key, 0, spp, 1)
    n5 = o5.shape[0]
    tri_scan.LAUNCHES = 0  # the dense-mesh entry point's count starts here
    f = isect.intersect_mesh(mesh, data, o5, d5, integrator.PATH_T_MIN, max_dist)
    torch.cuda.synchronize()
    k5_launches = tri_scan.LAUNCHES  # read just after
    if k5_launches != 1:
        raise AssertionError(f"intersect_mesh launched K5 {k5_launches} times, not once")
    o_obj, d_obj = (x.contiguous() for x in isect.object_rays(mesh, o5, d5))
    ins = (o_obj, d_obj, torch.full((n5,), integrator.PATH_T_MIN, device=dev),
           torch.full((n5,), max_dist, device=dev))
    k5f = lambda *a: tri_scan.tri_scan_cuda(mesh, *a)  # noqa: E731
    full5 = k5f(*ins)
    if not torch.equal(full5[0], f["valid"]) or not torch.equal(full5[1], f["t"]):
        raise AssertionError("intersect_mesh's hits differ from K5's on the same rays")
    idx5 = torch.arange(0, n5, SAMPLE_STRIDE, device=dev)
    sub5, alone5 = sample_alone("K5", k5f, full5, ins, idx5)
    ref5 = tri_scan.tri_scan_plain(mesh.tri_table, *sub5)

    def hits_only(x):
        return {k: torch.where(x[0], x[j], torch.zeros_like(x[j]))
                for k, j in (("t", 1), ("u", 3), ("v", 4))}

    n_s, n_same, n_exact, k5_err = compare_hits(
        "K5", (alone5[0], alone5[2]), (ref5[0], ref5[2]), hits_only(alone5), hits_only(ref5))
    log("parity-k5", f"bench teapot_6k ({nt} triangles), chunk 0 of 4 of the frame ({n5} camera "
        f"rays, {int(full5[0].sum())} hit the teapot) through intersect_mesh: {k5_launches} K5 "
        f"launch; every {SAMPLE_STRIDE}th ray ({n_s}) alone is bit-identical to the launch's rows; "
        f"{n_same}/{n_s} same (hit, tri) as tri_scan_plain, {n_exact}/{n_s} bit-identical, t/u/v "
        f"max |diff| {k5_err:.3g}; {int(alone5[0].sum())} sampled hits")
    k5_ms = cuda_ms(lambda: tri_scan.tri_scan_cuda(mesh, *ins), 5)
    k5_plain_ms = cuda_ms(lambda: tri_scan.tri_scan_plain(mesh.tri_table, *ins, chunk=16), 1)
    k5_ops = n5 * nt * OPS["mt"]
    k5_bytes = nbytes(*ins) + n5 * (1 + 4 + 4 + 4 + 4) + nbytes(mesh.tri_table)
    k5_bound, k5_by = bound(k5_bytes, k5_ops)
    log("timing-k5", f"{n5} rays x {nt} triangles: K5 {k5_ms:.3f} ms, plain {k5_plain_ms:.3f} ms "
        f"({k5_plain_ms / k5_ms:.1f}x); bound {k5_ops:.4g} FP32 ops ({OPS['mt']} a test), "
        f"{k5_bytes:.4g} B -> {k5_bound:.4f} ms ({k5_by}), K5 at {k5_bound / k5_ms:.1%} of it")

    k4_bound, k4_by = k4b[(ROW_SIDE, ROW_SPP)]
    return [{
        "name": "wavefront",
        "route": "cuda",
        "source": "cs397raytracingsp22_tpu_torch/csrc/wavefront.cu",
        "replaces": "cs397raytracingsp22_tpu/ops/pallas/bounce.py:1670",
        "launches": k4_launches,
        "max_abs_err": k4_err,
        "ms": k4_ms,
        "plain_ms": k4_plain_ms,
        "bound_ms": k4_bound,
        "bound_by": k4_by,
        "library_ms": None,
    }, {
        "name": "tri_scan",
        "route": "cuda",
        "source": "cs397raytracingsp22_tpu_torch/csrc/tri_scan.cu",
        "replaces": "cs397raytracingsp22_tpu/ops/pallas/tri_scan.py:100",
        "launches": k5_launches,
        "max_abs_err": k5_err,
        "ms": k5_ms,
        "plain_ms": k5_plain_ms,
        "bound_ms": k5_bound,
        "bound_by": k5_by,
        "library_ms": None,
    }], n5 * nt / k5_ms / 1e6


# ---- the roofline probes P1-P5 (phases 19-24) ----

# the H100's published dense tensor-core peaks (the same data sheet): bf16,
# the only bf16 rate it gives (the SIMT cores' packed bf16 has none, so P4's
# bf16 bound is a loose lower bound), and TF32
PEAK_BF16, PEAK_TF32 = 989e12, 495e12
PROBE_LIBS = ("vpu_peak", "dtype_rate", "bw_scan")
SASS_OPS = ("FFMA", "FMUL", "FADD", "HFMA2", "HMMA", "IMAD", "IADD3", "VIADD", "LOP3", "LDS",
            "LDC", "ULDC", "LDG", "MUFU")
INT_ADDS = ("IADD3", "VIADD", "IMAD")  # an integer add may issue as any of these
_SASS_LINE = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_]*)")


class ClockSampler:
    """`nvidia-smi --query-gpu=clocks.sm,power.draw,power.limit` every 100 ms
    while the block runs (it starts sampling before the block begins)."""

    def __enter__(self):
        import threading

        self.proc = subprocess.Popen(
            ["nvidia-smi", "-i", "0", "--query-gpu=clocks.sm,power.draw,power.limit",
             "--format=csv,noheader,nounits", "-lms", "100"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        self.lines: list = []
        self._first = threading.Event()

        def read():
            for line in self.proc.stdout:
                self.lines.append(line.strip())
                self._first.set()

        self._thread = threading.Thread(target=read, daemon=True)
        self._thread.start()
        if not self._first.wait(20):
            self.__exit__(None, None, None)
            raise AssertionError("nvidia-smi printed no clock sample within 20 s")
        self._start = len(self.lines)
        return self

    def __exit__(self, *exc):
        time.sleep(0.25)  # one more sample after the work
        self.proc.terminate()
        try:
            self.proc.wait(10)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait(10)
        self._thread.join(5)
        return False

    def summary(self) -> str:
        rows = []
        for line in self.lines[self._start:]:
            try:
                rows.append([float(x) for x in line.split(",")])
            except ValueError:
                continue
        if not rows:
            raise AssertionError("no clock sample fell inside the run")
        clk, draw, limit = (np.array(c) for c in zip(*rows))
        return (f"SM clock {clk.min():.0f}/{np.median(clk):.0f}/{clk.max():.0f} MHz (min/median/"
                f"max), power draw median {np.median(draw):.1f} W max {draw.max():.1f} W, limit "
                f"{limit[0]:.2f} W ({len(rows)} samples)")


def sass_counts(name: str, loop: bool = False) -> dict:
    """{function name: {opcode: count}} of the built library's SASS, from
    `cuobjdump -sass` (opcodes without their modifiers). loop=True counts
    only the body of each function's loop that holds the most FFMA (from a
    backward branch's target to the branch), and leaves out functions
    without one."""
    from cs397raytracingsp22_tpu_torch.ops.kernels import _build

    tool = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    out = subprocess.run([tool, "-sass", _build.BUILD_INFO[name]["path"]], capture_output=True,
                         text=True, timeout=300, check=True).stdout
    funcs: dict = {}  # name -> [(address, opcode, line)]
    cur = None
    for line in out.splitlines():
        if "Function : " in line:
            cur = funcs.setdefault(line.split("Function : ", 1)[1].strip(), [])
            continue
        m = _SASS_LINE.search(line) if cur is not None else None
        if m:
            cur.append((int(re.search(r"/\*([0-9a-f]+)\*/", line).group(1), 16), m.group(1), line))
    if not funcs:
        raise AssertionError(f"cuobjdump found no function in lib{name}")
    counts = {}
    for fn, ins in funcs.items():
        if loop:
            best = (-1, 0, -1)
            for addr, op, line in ins:
                t = re.search(r"BRA\s+0x([0-9a-f]+)", line) if op == "BRA" else None
                if t and int(t.group(1), 16) < addr:
                    lo = int(t.group(1), 16)
                    n_ffma = sum(1 for a, o, _ in ins if lo <= a <= addr and o == "FFMA")
                    best = max(best, (n_ffma, lo, addr))
            if best[0] <= 0:
                continue  # no loop holds an FFMA
            ins = [x for x in ins if best[1] <= x[0] <= best[2]]
        c: dict = {}
        for _, op, _ in ins:
            c[op] = c.get(op, 0) + 1
        counts[fn] = c
    return counts


def ptxas_summary(name: str) -> str:
    from cs397raytracingsp22_tpu_torch.ops.kernels import _build

    lines = [ln.strip() for ln in _build.BUILD_INFO[name]["log"].splitlines()
             if "registers" in ln or "spill" in ln]
    regs = [int(m) for ln in lines for m in re.findall(r"Used (\d+) registers", ln)]
    spills = [int(m) for ln in lines for m in re.findall(r"(\d+) bytes spill stores", ln)]
    return (f"{len(regs)} kernels, registers {min(regs)}-{max(regs)}, spill stores "
            f"{sum(spills)} B" if regs else "built earlier, no ptxas output")


def probe_build_and_sass(build_s: float) -> None:
    """Phases 19 and 20: registers and spills of the probe kernels, and the
    SASS check."""
    from cs397raytracingsp22_tpu_torch.ops.kernels import _build, bw_scan, dtype_rate, vpu_peak

    attrs = {"vpu_peak": [(f"chain<{m},{u},{c}>", vpu_peak.kernel_attrs(m, u, c))
                          for m, u, c in (("fma", 1024, "const"), ("i32", 1024, "const"),
                                          ("both", 1024, "const"), ("fma", 176, "const"),
                                          ("fma", 1, "shared"), ("fma", 1, "constant"),
                                          ("fma", 1, "ldg"))],
             "dtype_rate": [(f"dtype_rate<{t}>", dtype_rate.kernel_attrs(dt))
                            for t, dt in (("f32", torch.float32), ("bf16", torch.bfloat16))],
             "bw_scan": [(k, bw_scan.kernel_attrs(mma)) for k, mma in (("scalar", False),
                                                                        ("mma", True))]}
    for name in PROBE_LIBS:
        log("build", f"csrc/{name}.cu ({_build.BUILD_INFO[name]['seconds']:.2f}s nvcc, all "
            f"{len(_build.KERNELS)} in {build_s:.2f}s): ptxas {ptxas_summary(name)}; "
            + ", ".join(f"{k} {r} registers/{s} B local" for k, (r, s) in attrs[name]))

    chains = {}
    for fn, ops in sass_counts("vpu_peak").items():
        m = re.search(r"chainILi(\d+)ELi(\d+)ELi(\d+)E", fn)
        if m:
            mix, u, mem = int(m.group(1)), int(m.group(2)), int(m.group(3))
            chains[(vpu_peak.MIXES[mix], u, vpu_peak.MEMORIES[mem])] = ops
    if set(chains) != set(vpu_peak.VARIANTS):
        raise AssertionError(f"libvpu_peak's SASS holds {sorted(chains)}, expected "
                             f"{sorted(vpu_peak.VARIANTS)}")

    def fmt(ops):
        return " ".join(f"{k} {ops[k]}" for k in SASS_OPS if ops.get(k))

    for (mix, u, mem), ops in sorted(chains.items(), key=lambda kv: (kv[0][2], kv[0][0], kv[0][1])):
        # what one step of the 8 chains must issue a thread: the lane-ops the
        # tools count
        need = {"fma": [("FFMA",), 8 * u], "mul": [("FMUL",), 8 * u],
                "i32": [("LOP3",), 8 * u, INT_ADDS, 8 * u],
                "both": [("FFMA",), 4 * u, ("LOP3",), 4 * u, INT_ADDS, 4 * u]}[mix]
        for names, count in zip(need[::2], need[1::2]):
            have = sum(ops.get(k, 0) for k in names)
            if have < count:
                raise AssertionError(f"chain<{mix},{u},{mem}> holds {have} {'+'.join(names)}, "
                                     f"fewer than the {count} a thread that the tool counts: the "
                                     f"compiler folded the probe (its SASS: {sorted(ops.items())})")
        log("sass", f"chain<{mix},{u},{mem}>: {fmt(ops)} (needs " + ", ".join(
            f"{'+'.join(k)} >= {c}" for k, c in zip(need[::2], need[1::2])) + ")")
    bodies = {}
    for fn, ops in sass_counts("vpu_peak", loop=True).items():
        m = re.search(r"chainILi0ELi1ELi(\d+)E", fn)
        if m:
            bodies[vpu_peak.MEMORIES[int(m.group(1))]] = ops
    n_load = lambda ops: sum(ops.get(k, 0) for k in ("LDS", "LDC", "ULDC", "LDG"))  # noqa: E731
    if set(bodies) != set(vpu_peak.MEMORIES):
        raise AssertionError(f"no FFMA loop found in P3's SASS for {set(vpu_peak.MEMORIES) - set(bodies)}")
    for mem in vpu_peak.MEMORIES:
        ops = bodies[mem]
        log("sass", f"P3 {mem}: the loop body holds {ops['FFMA']} FFMA, {n_load(ops)} loads "
            f"({', '.join(f'{k} {ops.get(k, 0)}' for k in ('LDS', 'LDC', 'ULDC', 'LDG'))}) = "
            f"{n_load(ops) / ops['FFMA']:.3f} loads per FMA, {sum(ops.values())} instructions "
            f"in all: {fmt(ops)}")
    # each kernel must hold the instruction it measures: FFMA and HFMA2 in
    # P4's two instantiations, MUFU.RCP in both scans, the 6 HMMA of a tile
    for lib, want in (("dtype_rate", {"dtype_rateIf": "FFMA", "dtype_rateI14": "HFMA2"}),
                      ("bw_scan", {"bw_scalar_kernel": "MUFU", "bw_mma_kernel": "HMMA"})):
        for fn, ops in sass_counts(lib).items():
            log("sass", f"{lib} {fn}: {fmt(ops)}")
            need = [op for key, op in want.items() if key in fn]
            if not need or ops.get(need[0], 0) < (6 if need[0] == "HMMA" else 1):
                raise AssertionError(f"{fn} holds too few {need or list(want.values())}")


def probe_parity(dev) -> dict:
    """Phase 21: each probe kernel against its plain version on the card at
    a small size. Returns max |kernel - plain| per row."""
    from cs397raytracingsp22_tpu_torch.ops.kernels import bw_scan, dtype_rate, vpu_peak
    from cs397raytracingsp22_tpu_torch.tools import bench_mxu_scan, vpu_peak_smem

    rng = np.random.default_rng(0)
    err = {}
    tiny = float(np.finfo(np.float32).tiny)

    def close(what, out, ref, rtol, exact=False):
        out, ref = out.double(), ref.double()
        same = int((out == ref).sum())
        if exact:
            ok = out == ref
        else:
            ok = (out - ref).abs() <= rtol * ref.abs() + 8 * tiny
        if not bool(ok.all()):
            raise AssertionError(f"{what}: {int((~ok).sum())} of {ok.numel()} elements outside "
                                 f"{'bit-exact' if exact else f'rtol {rtol}'}")
        d = float((out - ref).abs().max())
        log("parity-probes", f"{what}: {same}/{out.numel()} bit-identical, max |diff| {d:.3g}")
        return d

    for mix in vpu_peak.MIXES:
        span = 5000.0 if mix == "i32" else 0.3
        x = torch.from_numpy(rng.uniform(-span, span, (1024, 128)).astype(np.float32)).to(dev)
        for unroll in (4, 12):
            e = close(f"P1 chain<{mix},{unroll}> on 131,072 random x in ±{span:g}",
                      vpu_peak.chain_cuda(x, mix, unroll), vpu_peak.chain_plain(x, mix, unroll),
                      1e-3, exact=mix == "i32")
            if (mix, unroll) == ("fma", 4):
                err["P1"] = e
    x = torch.from_numpy(rng.uniform(-0.3, 0.3, (1024, 128)).astype(np.float32)).to(dev)
    for u, steps in ((2, 3), (1, 5), (8, 1)):
        e = close(f"P2 loop of {steps} x {u} rounds", vpu_peak.looped_cuda(x, u, steps),
                  vpu_peak.looped_plain(x, u, steps), 1e-3)
        err.setdefault("P2", e)
    coefs = vpu_peak_smem.coefficients(dev)
    ref = vpu_peak.table_plain(x, coefs, 8)
    for mem in vpu_peak_smem.MEMORIES:
        e = close(f"P3 {mem} table, 8 steps", vpu_peak.table_cuda(x, coefs, 8, mem), ref, 1e-3)
        if mem == "shared":
            err["P3"] = e
    xr = torch.from_numpy(rng.uniform(0.5, 0.9, (512, 128)).astype(np.float32)).to(dev)
    for dtype in dtype_rate.DTYPES:
        for iters in (8, 2000):
            xd = xr.to(dtype)
            out, ref = dtype_rate.dtype_rate_cuda(xd, iters), dtype_rate.dtype_rate_plain(xd, iters)
            if dtype == torch.float32:
                close(f"P4 f32, {iters} rounds", out, ref, 1e-6)
                continue
            a, b = out.float(), ref.float()
            e = torch.floor(torch.log2(torch.maximum(a.abs(), b.abs()).clamp(min=1e-30)))
            ulps = float(((a - b).abs() / 2.0 ** (e - 7)).max())
            if ulps > 8 or not bool(torch.isfinite(a).all()):
                raise AssertionError(f"P4 bf16, {iters} rounds: {ulps} ulps from the plain version")
            d = float((a - b).abs().max())
            log("parity-probes", f"P4 bf16, {iters} rounds: {int((a == b).sum())}/{a.numel()} "
                f"bit-identical, max {ulps:.0f} bf16 ulps, max |diff| {d:.3g} (within 8 ulps)")
            if iters == 8:
                err["P4"] = d
    a = bench_mxu_scan.inputs(dev, nblk=4)
    key = bw_scan.bw_scan_cuda(a["bw"], a["o4"], a["d4"])
    ref = bw_scan.bw_scan_plain(a["bw"], a["o4"], a["d4"])
    same = float(((key & -4096) == (ref & -4096)).double().mean())
    hit, t = bw_scan.hit_t(key, False)
    hit_r, t_r = bw_scan.hit_t(ref, False)
    both = hit & hit_r
    rel = ((t[both] - t_r[both]).abs() / t_r[both]).double().cpu()
    if same < 0.999:
        raise AssertionError(f"P5 scalar: the same key (low 12 bits dropped) on {same:.5f} of rays")
    err["P5"] = float((t[both] - t_r[both]).abs().max())
    log("parity-probes", f"P5 scalar on {key.numel()} rays x 256 triangles: same key (low 12 bits "
        f"dropped) on {same:.5f} of rays (need 0.999), bit-identical on "
        f"{float((key == ref).double().mean()):.5f}, {int(both.sum())} hit; t rel diff p99 "
        f"{float(torch.quantile(rel, 0.99)):.2e}, max {float(rel.max()):.2e}")
    km = bw_scan.bw_mma_cuda(a["lhs_o"], a["lhs_d"], a["o4"], a["d4"])
    for tf32 in (True, False):
        kp = bw_scan.bw_mma_plain(a["lhs_o"], a["lhs_d"], a["o4"], a["d4"], tf32=tf32)
        hm, _ = bw_scan.hit_t(km, True)
        hp, _ = bw_scan.hit_t(kp, True)
        win = float(((hm == hp) & (~hm | ((km & 4095) == (kp & 4095)))).double().mean())
        if tf32 and win < 0.999:
            raise AssertionError(f"P5 mma: the same winner as bw_mma_plain(tf32) on {win:.5f}")
        log("parity-probes", f"P5 mma against bw_mma_plain({'TF32' if tf32 else 'f32'} operands): "
            f"same winner on {win:.5f} of rays{' (need 0.999)' if tf32 else ''}, same key on "
            f"{float((km == kp).double().mean()):.5f}")
    hm, _ = bw_scan.hit_t(km, True)
    agree = float((hm == hit).double().mean())
    if agree < 0.99:
        raise AssertionError(f"P5 mma against scalar: hits agree on {agree:.5f} (need 0.99)")
    log("parity-probes", f"P5 mma against the scalar kernel: hits agree on {agree:.5f} (need 0.99)")
    return err


def plain_ms(fn) -> float:
    """One call of a plain version, by CUDA events (no warm run: its torch
    kernels are warm from the parity phase)."""
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def sustained(what: str, fn, ms_hint: float, seconds: float = 1.5) -> float:
    """fn() repeated for ~`seconds` (at most 20,000 launches) under the clock
    sampler, timed as the tools time (tools/timing.py); prints the clocks
    beside the mean milliseconds a call."""
    from cs397raytracingsp22_tpu_torch.tools import timing

    reps = min(20000, max(3, int(seconds * 1e3 / max(ms_hint, 1e-3))))
    with ClockSampler() as smi:
        ms = timing.seconds(fn, reps, torch.device("cuda")) * 1e3
    log("clocks", f"{what}: {ms:.4f} ms a launch over {reps} launches; {smi.summary()}")
    return ms


def probe_row(name: str, source: str, replaces: str, launches: int, err: float, ms: float,
              plain: float, bnd: tuple) -> dict:
    """One probe's entry of the kernels line; its tool must have launched
    the kernel."""
    if launches < 1:
        raise AssertionError(f"{name}: its tool launched the kernel no time")
    return {"name": name, "route": "cuda",
            "source": f"cs397raytracingsp22_tpu_torch/csrc/{source}", "replaces": replaces,
            "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain,
            "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": None}


def probe_phases(dev, err: dict, k5_gtests: float) -> list:
    """Phases 22-24: each probe tool at full size through its entry point,
    with clocks, each full-size output held to its plain version on a
    strided sample, the rows' plain times, and the bounds. err: phase 21's
    max |kernel - plain| by row; k5_gtests: K5's ray-triangle tests a
    second in phase 17. Returns the kernels line's entries of P1-P5."""
    from cs397raytracingsp22_tpu_torch.ops.kernels import bw_scan, dtype_rate, vpu_peak
    from cs397raytracingsp22_tpu_torch.tools import bench_mxu_scan, profile_split
    from cs397raytracingsp22_tpu_torch.tools import vpu_peak as p1_tool
    from cs397raytracingsp22_tpu_torch.tools import vpu_peak_shape, vpu_peak_smem

    rows = []
    x = torch.full((p1_tool.N_ROWS, p1_tool.LANES), 0.3, dtype=torch.float32, device=dev)
    n = x.numel()
    sample = slice(None, None, 4099)  # rows of the full-size output

    def held(what, out, ref_fn):
        """A full-size output, all of whose elements have the same input 0.3:
        every element equal, and the sample's inf/0 pattern (and value
        within rtol 1e-3 where finite) as the plain version's."""
        first = out.reshape(-1)[0]
        if not bool((out == first).all()):
            raise AssertionError(f"{what}: the elements of one input differ")
        ref = ref_fn(x[sample])
        o = out[sample]
        fin = torch.isfinite(ref) & (ref != 0)
        ok = (torch.equal(torch.isinf(o), torch.isinf(ref)) and torch.equal(o == 0, ref == 0)
              and bool(((o[fin] - ref[fin]).abs() <= 1e-3 * ref[fin].abs()).all()))
        if not ok:
            raise AssertionError(f"{what}: the full-size output differs from the plain version")
        return float(first)

    # ---- 22. P1 and P2 ----
    vpu_peak.LAUNCHES = 0  # P1's tool starts here
    with ClockSampler() as smi:
        p1 = {mix: p1_tool.marginal(mix, 1024, device=dev) for mix in vpu_peak.MIXES}
    p1_launches = vpu_peak.LAUNCHES  # read just after
    log("clocks", f"P1 tool (4 mixes x unroll 256 and 1024, 10 launches each after a warm one): "
        f"{smi.summary()}")
    for mix in vpu_peak.MIXES:
        for unroll in (256, 1024):
            v = held(f"P1 {mix} unroll {unroll}", vpu_peak.chain_cuda(x, mix, unroll),
                     lambda xs: vpu_peak.chain_plain(xs, mix, unroll))
            log("full-probes", f"P1 {mix} unroll {unroll}: {n} elements, each {v:.6g} as in the "
                "plain version on every 4099th row")
    fma_ms = p1["fma"][2][0] * 1e3
    sus = sustained("P1 fma unroll 1024", lambda: vpu_peak.chain_cuda(x, "fma", 1024), fma_ms)
    for mix, (rate, _, (w2, o2)) in p1.items():
        flop = f", {2 * o2 / w2 / 1e12:.2f} TFLOP/s = {2 * o2 / w2 / PEAK_FP32:.1%} of 67" \
            if mix == "fma" else (f", {o2 / w2 / 1e12:.2f} TFLOP/s" if mix == "mul" else
                                  " (no published INT32 peak)")
        log("rate", f"P1 {mix} unroll 1024: {w2 * 1e3:.3f} ms, {o2 / w2 / 1e12:.3f} T lane-ops/s"
            f"{flop}; marginal (256 -> 1024) {rate / 1e12:.3f} T lane-ops/s")
    ops = 2 * p1_tool.lane_ops("fma", 1024, n)
    b_ms, b_by = bound(8 * n, ops)
    p1_plain = plain_ms(lambda: vpu_peak.chain_plain(x, "fma", 1024))
    rows.append(probe_row("vpu_peak_p1", "vpu_peak.cu", "tools/vpu_peak.py:49", p1_launches,
                          err["P1"], fma_ms, p1_plain, (b_ms, b_by)))
    log("bound-probes", f"P1 fma unroll 1024: {ops:.4g} FP32 ops, {8 * n:.4g} B -> bound "
        f"{b_ms:.4f} ms ({b_by}); kernel {fma_ms:.4f} ms (sustained {sus:.4f} ms), plain "
        f"{p1_plain:.1f} ms")

    vpu_peak.LAUNCHES = 0  # P2's tool starts here
    with ClockSampler() as smi:
        p2 = {u: vpu_peak_shape.run(u, steps, device=dev) for u, steps in vpu_peak_shape.PAIRS}
    p2_launches = vpu_peak.LAUNCHES
    log("clocks", f"P2 tool (5 body sizes): {smi.summary()}")
    for u, steps in vpu_peak_shape.PAIRS:
        held(f"P2 body {u} x {steps}", vpu_peak.looped_cuda(x, u, steps),
             lambda xs: vpu_peak.looped_plain(xs, u, steps))
        w, o = p2[u]
        log("rate", f"P2 body {8 * u} FMAs x {steps}: {w * 1e3:.3f} ms, {o / w / 1e12:.3f} T FMA/s "
            f"= {2 * o / w / 1e12:.2f} TFLOP/s = {2 * o / w / PEAK_FP32:.1%} of 67")
    w, o = p2[176]
    b_ms, b_by = bound(8 * n, 2 * o)
    p2_plain = plain_ms(lambda: vpu_peak.looped_plain(x, 176, 23))
    rows.append(probe_row("vpu_peak_p2", "vpu_peak.cu", "tools/vpu_peak_shape.py:23",
                          p2_launches, err["P2"], w * 1e3, p2_plain, (b_ms, b_by)))
    log("bound-probes", f"P2 body 1,408 FMAs x 23: {2 * o:.4g} FP32 ops -> bound {b_ms:.4f} ms "
        f"({b_by}); kernel {w * 1e3:.4f} ms, plain {p2_plain:.1f} ms")

    # ---- 23. P3 and P4 ----
    vpu_peak.LAUNCHES = 0  # P3's tool starts here
    with ClockSampler() as smi:
        p3 = {m: vpu_peak_smem.run(m, device=dev) for m in ("const",) + vpu_peak_smem.MEMORIES}
    p3_launches = vpu_peak.LAUNCHES
    log("clocks", f"P3 tool (control and 3 tables): {smi.summary()}")
    coefs = vpu_peak_smem.coefficients(dev)
    for mem in ("const",) + vpu_peak_smem.MEMORIES:
        held(f"P3 {mem}", vpu_peak.table_cuda(x, coefs, vpu_peak_smem.STEPS, mem),
             lambda xs: vpu_peak.table_plain(xs, None if mem == "const" else coefs,
                                             vpu_peak_smem.STEPS))
    fmas = n * 8 * vpu_peak_smem.STEPS
    for mem in vpu_peak_smem.MEMORIES:
        extra_ns = (p3[mem] - p3["const"]) * 1e9
        log("rate", f"P3 {mem}: {p3[mem] * 1e3:.3f} ms against the control's "
            f"{p3['const'] * 1e3:.3f} ms (+{(p3[mem] / p3['const'] - 1):.1%}); one uniform load "
            f"an FMA costs {(p3[mem] / p3['const'] - 1):.3f} FMA issue slots, "
            f"{extra_ns / fmas * 1e3:.4f} ps a load across the card")
    b_ms, b_by = bound(8 * n + 4 * vpu_peak.TABLE, 2 * fmas)
    p3_plain = plain_ms(lambda: vpu_peak.table_plain(x, coefs, vpu_peak_smem.STEPS))
    rows.append(probe_row("vpu_peak_p3", "vpu_peak.cu", "tools/vpu_peak_smem.py:21",
                          p3_launches, err["P3"], p3["shared"] * 1e3, p3_plain, (b_ms, b_by)))
    log("bound-probes", f"P3 shared table: {2 * fmas:.4g} FP32 ops -> bound {b_ms:.4f} ms "
        f"({b_by}); kernel {p3['shared'] * 1e3:.4f} ms, plain {p3_plain:.1f} ms")
    del x

    dtype_rate.LAUNCHES = 0  # P4's tool (all four sections) starts here
    with ClockSampler() as smi:
        p4 = profile_split.run(dev)
    p4_launches = dtype_rate.LAUNCHES
    log("clocks", f"P4 tool (render split, sorts, bf16 vs f32): {smi.summary()}")
    cap = torch.cuda.get_device_properties(dev)
    cap = cap.multi_processor_count * cap.max_threads_per_multi_processor
    for r in sorted({r for r, _ in p4["dtype"]}):
        (w32, o), (w16, _) = p4["dtype"][(r, torch.float32)], p4["dtype"][(r, torch.bfloat16)]
        log("rate", f"P4 ({r}, 128) x {profile_split.P4_ITERS} rounds: f32 {w32 * 1e3:.4f} ms "
            f"({o / w32 / 1e12:.2f} T ops/s, {r * 128} threads of {cap}), bf16x2 "
            f"{w16 * 1e3:.4f} ms ({o / w16 / 1e12:.2f} T ops/s, {r * 64} threads); bf16 / f32 "
            f"time {w16 / w32:.3f}")
    xb = torch.ones((512, 128), dtype=torch.bfloat16, device=dev) * 0.5
    full = dtype_rate.dtype_rate_cuda(xb, profile_split.P4_ITERS)
    ref = dtype_rate.dtype_rate_plain(xb, profile_split.P4_ITERS)
    if not bool(torch.isfinite(full.float()).all()) or float((full.float() - ref.float()).abs()
                                                              .max()) > 2.0 ** -6:
        raise AssertionError("P4 bf16 at the tool's size differs from the plain version")
    log("full-probes", f"P4 bf16 (512, 128) x 2000 rounds from 0.5: kernel {float(full[0, 0]):.6g}, "
        f"plain {float(ref[0, 0]):.6g} (within 2^-6)")
    w16, o = p4["dtype"][(512, torch.bfloat16)]
    b_ms, b_by = bound(4 * 512 * 128, o, PEAK_BF16)
    sus = sustained("P4 bf16 (512, 128)",
                    lambda: dtype_rate.dtype_rate_cuda(xb, profile_split.P4_ITERS), w16 * 1e3)
    p4_plain = plain_ms(lambda: dtype_rate.dtype_rate_plain(xb, profile_split.P4_ITERS))
    rows.append(probe_row("dtype_rate_p4", "dtype_rate.cu", "tools/profile_split.py:106",
                          p4_launches, err["P4"], w16 * 1e3, p4_plain, (b_ms, b_by)))
    log("bound-probes", f"P4 bf16 (512, 128): {o:.4g} ops against the data sheet's bf16 "
        f"{PEAK_BF16 / 1e12:.0f} TFLOP/s (tensor cores), {4 * 512 * 128} B -> bound {b_ms:.6f} ms "
        f"({b_by}); kernel {w16 * 1e3:.4f} ms (sustained {sus:.4f} ms), plain {p4_plain:.1f} ms")

    # ---- 24. P5 ----
    bw_scan.LAUNCHES = bw_scan.MMA_LAUNCHES = 0  # P5's tool starts here
    with ClockSampler() as smi:
        p5 = bench_mxu_scan.run(dev)
    p5_launches, p5_mma_launches = bw_scan.LAUNCHES, bw_scan.MMA_LAUNCHES
    log("clocks", f"P5 tool (parity, scalar and mma rates): {smi.summary()}")
    a = bench_mxu_scan.inputs(dev)
    nr, g = p5["rays"], bench_mxu_scan.G
    idx = torch.arange(0, nr, SAMPLE_STRIDE, device=dev)
    sub = {k: (v[:, idx].contiguous() if k in ("o4", "d4") else v) for k, v in a.items()}
    ks = bw_scan.bw_scan_cuda(sub["bw"], sub["o4"], sub["d4"])
    km = bw_scan.bw_mma_cuda(sub["lhs_o"], sub["lhs_d"], sub["o4"], sub["d4"])
    if not (torch.equal(ks, p5["keys"]["scalar"][idx]) and torch.equal(km, p5["keys"]["mma"][idx])):
        raise AssertionError("P5: the sampled rays alone differ from the full launch's keys")
    kp = bw_scan.bw_scan_plain(sub["bw"], sub["o4"], sub["d4"])
    same = float(((ks & -4096) == (kp & -4096)).double().mean())
    if same < 0.999:
        raise AssertionError(f"P5 full size: the same scalar key on {same:.5f} of sampled rays")
    log("full-probes", f"P5 at {nr} rays x {g} triangles: every {SAMPLE_STRIDE}th ray "
        f"({idx.numel()}) alone gives the full launch's keys; scalar key as bw_scan_plain's (low 12 "
        f"bits dropped) on {same:.5f}; mma launches {p5_mma_launches}")
    ts, tm = p5["scalar"][0], p5["mma"][0]
    log("rate", f"P5 scalar {ts * 1e3:.4f} ms = {nr * g / ts / 1e9:.1f} Gtri-tests/s; mma "
        f"{tm * 1e3:.4f} ms = {nr * g / tm / 1e9:.1f} Gtri-tests/s ({ts / tm:.2f}x the scalar's "
        f"rate); K5 (phase 17) {k5_gtests:.1f} Gtri-tests/s")
    n_bytes = nr * (4 * 4 + 4 * 4 + 4) + nbytes(a["bw"])
    b_ms, b_by = bound(n_bytes, nr * g * bw_scan.SCALAR_OPS)
    mb_ops = max(nr * g * bw_scan.MMA_EPILOGUE_OPS / PEAK_FP32,
                 nr * g * bw_scan.MMA_PRODUCT_OPS / PEAK_TF32)
    log("bound-probes", f"P5 scalar: {nr * g * bw_scan.SCALAR_OPS:.4g} FP32 ops "
        f"({bw_scan.SCALAR_OPS} a test), {n_bytes:.4g} B -> bound {b_ms:.4f} ms ({b_by}); mma: "
        f"{bw_scan.MMA_EPILOGUE_OPS} FP32 ops a test on the SIMT cores and "
        f"{bw_scan.MMA_PRODUCT_OPS} on the tensor cores (TF32) -> bound "
        f"{max(mb_ops, n_bytes / PEAK_BYTES) * 1e3:.4f} ms")
    p5_plain = plain_ms(lambda: bw_scan.bw_scan_plain(a["bw"], a["o4"], a["d4"], chunk=65536))
    rows.append(probe_row("bw_scan_p5", "bw_scan.cu", "tools/bench_mxu_scan.py:32",
                          p5_launches, err["P5"], ts * 1e3, p5_plain, (b_ms, b_by)))
    return rows

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

    from cs397raytracingsp22_tpu_torch.ops.kernels import _build, bounce, scene_intersect
    from cs397raytracingsp22_tpu_torch.ops.kernels import tri_scan, tri_scan_big, wavefront
    from cs397raytracingsp22_tpu_torch.render import driver, integrator
    from cs397raytracingsp22_tpu_torch.scenes import bench_scene, cornell
    from cs397raytracingsp22_tpu_torch.utils import threefry

    # ---- 2. build ----
    t0 = time.perf_counter()
    _build.build_all(_build.KERNELS)
    build_s = time.perf_counter() - t0
    for kid, name, mod, kw in (("K1", "bounce", bounce, {}),
                               ("K4", "wavefront", wavefront, {"last": False}),
                               ("K4 last", "wavefront", wavefront, {"last": True}),
                               ("K2", "scene_intersect", scene_intersect, {}),
                               ("K3", "bvh_traverse", tri_scan_big, {}),
                               ("K5", "tri_scan", tri_scan, {})):
        regs, spill = mod.kernel_attrs(**kw)
        ptxas = [ln.strip() for ln in _build.BUILD_INFO[name]["log"].splitlines()
                 if "registers" in ln or "spill" in ln]
        log("build", f"{kid} csrc/{name}.cu ({_build.BUILD_INFO[name]['seconds']:.2f}s nvcc, all "
            f"{len(_build.KERNELS)} in {build_s:.2f}s): {regs} registers/thread, {spill} B local; "
            f"ptxas: {' | '.join(ptxas)}")
        if kid == "K1" and (regs > K1_REGS or spill):
            raise AssertionError(f"K1 has {regs} registers and {spill} B of spills; it had "
                                 f"{K1_REGS} and none before its body moved to csrc/bounce.cuh")
    # ---- 19-20. the probes' registers and spills; the SASS check ----
    probe_build_and_sass(build_s)

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
        tr = device_trace(name, fn, {"K1": "bounce_kernel"}, spans=("raygen",))
        log("trace", f"{name}: {tr['kernels']} kernels, device busy {tr['busy_ms']:.3f} ms in a "
            f"{tr['span_ms']:.3f} ms first-to-last span (idle share {tr['idle']:.2%}), "
            f"{tr['wall_ms']:.3f} ms wall under the profiler; " + ", ".join(
                f"{k} {v:.3f} ms ({tr['shares'][k]:.1%} of busy)" for k, v in tr["parts"].items()))
    del sums, full, frame

    # ---- 9-11 and 13: the staged path (K2 and K3); 12: bounds ----
    staged = staged_phases(dev, data, width, height, spp, depth)
    k1b = k1_bounds(dev, depth, ((128, 128, 16, 16), (width, height, spp, SAMPLE_STRIDE)))
    k1_bound_ms, k1_by, _ = k1b[(128, 16)]
    # ---- 14-18: the wavefront kernel K4 and the dense-mesh scan K5 ----
    k45, k5_gtests = wavefront_phases(dev, k1b, width, height, spp, depth)
    # ---- 21-24: the roofline probes P1-P5 ----
    probes = probe_phases(dev, probe_parity(dev), k5_gtests)
    print(json.dumps({"kernels": [{
        "name": "mega_bounce",
        "route": "cuda",
        "source": "cs397raytracingsp22_tpu_torch/csrc/bounce.cu",
        "replaces": "cs397raytracingsp22_tpu/ops/pallas/bounce.py:1480",
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": k_ms,
        "plain_ms": p_ms,
        "bound_ms": k1_bound_ms,
        "bound_by": k1_by,
        "library_ms": None,
    }] + staged + k45 + probes}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
