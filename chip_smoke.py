"""Smoke run of the torch port's main path on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one line and raising on failure (any failure exits
nonzero):
  1. device: a CUDA card is required; prints its name and power limit;
  2. build: nvcc builds the mega-bounce kernel (K1), the wavefront kernel
     (K4), the scene-intersection kernel (K2), the big-mesh BVH traversal
     kernel (K3) and the dense-mesh scan (K5) from csrc/, one nvcc each, all
     started together; prints registers and spills (K4's four
     instantiations: with and without the dense-mesh walk, each with the
     emission-only last bounce) and K1's and K4's resident blocks an SM with
     the bench scene's and the Cornell box's tables staged, and fails if K1,
     whose bounce body K4 shares, spills, has more registers than keep
     K1_BLOCKS blocks of 128 threads on an SM (K1_MAX_REGS), or has fewer
     resident blocks, or if any K4 instantiation, K3 or K5 spills;
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
     the sample must hit the teapot (the camera rays rarely reach it).
     K3 walks the child-pair rows in ray order (csrc/bvh_traverse.cu) and
     is held to traverse, the threaded walk;
 10. the staged main path at full size: scenes/bench_teapot_32k.py at
     512² × 64 spp, depth 8, through render_to_image (4 chunks of
     4,194,304 rays) with K1's gate closed for the call (the scene's own
     route is K1, which walks the teapot's BVH), after one chunk's staged
     run is held to the plain path on a strided sample; one warm render,
     then timed renders; peak device memory; then K1 on its own route
     (`parity-32k-k1`): one launch of bounce_kernel_big on that chunk,
     every K1_BIG_STRIDE-th ray traced alone bit-identical to the
     launch's rows and held to the plain path (integrator.path_trace on
     the card) by K1's contract with segments compared ray by ray (rtol
     1e-3 / atol 1e-4 and the same segment count, each on >= 99.5% of
     the sample), the launch timed beside its bound (the BVH walk's node
     and triangle tests that the plain path counts); then the image on
     that route (`full-32k-k1`): K1 alone launches, one a chunk, and its
     image lies within 1 u8 of the staged one on K1_BIG_IMAGE_FRAC of
     the subpixels;
 11. K2 and K3 timed against their plain versions on that chunk's
     bounce-0 inputs, and K3 on the bounce-2 and aimed rays; K3's
     registers, spills, resident blocks, stack depth and shared memory;
     K2's (`config-k2`): registers, spills, and for the bench scenes,
     config 4 and the kitchen sink the bytes a block stages, resident
     blocks an SM and the persistent grid (32-ray tiles from a ticket);
 12. bounds: the work of each kernel on these inputs (the tests that the
     plain versions count with their `stats` on a strided sample, scaled
     to the launch) and the least time the card could take for it; K1's
     from the superleaf-tree walk's node tests, with the bound of the flat
     superleaf scan it replaced (every box on every segment) beside it,
     and node and triangle tests a segment; K3's from the threaded walk's
     counts (traverse, the row's yardstick) with the bound of the ordered
     walk's own counts (traverse_packed: slab tests, triangles, pushes)
     beside it;
 13. a torch.profiler trace of one staged 32k render: device busy time,
     idle share, and the shares of K2, K3, the compaction's sorts and the
     package's "bounce_rng" and "raygen" spans.
Then this slice's paths, K4 and K5:
 14. K4 against K1 on the same rays at full width, through
     path_trace_wavefront: the bench frame (16,777,216 rays, depth 8, one
     K4 launch per bounce, compacting inside the launch) and chunk 0 of the
     Cornell time-to-64spp render (the rays render_chunk makes, depth 10,
     K4 without the dense-mesh walk): rows bit-identical to K1's on >= 99.6%
     (K4_MIN_SAME), K1's contract, segment totals, the live share entering
     each bounce, and the tiles each launch walked (the device counter)
     against ceil(live / 128); compact=False gives the same bits; a strided
     sample of each traced alone and held to integrator.path_trace;
 14b. the open teapot frame (scenes/teapot.py under the path tracer,
     512² × 64 spp, depth 6, 16,777,216 rays; most rays escape by bounce
     2): K4 against K1, segments and the live rays entering each bounce
     (K1's from its per-ray segment counts), the rays whose path length
     differs counted (winner flips), and both timed in turns;
 15. K4 timing by CUDA events against K1 on the bench frame, in turns, and
     one frame launch by launch (the workspace, each launch), and the same
     on the Cornell chunk; K4, K1 and the plain wavefront at 128² × 16 spp
     (the launch of K1's row in the kernels line);
 16. a torch.profiler trace of one K4 frame: busy, idle share, and the
     share of K4; no kernel runs inside the package's partition span
     "wavefront_partition" (the CUDA path has no host partition);
 17. K5 through intersect_mesh on 4,194,304 camera rays (chunk 0 of 4 of
     the bench frame) against the 6k teapot, the sample held to
     tri_scan_plain, and K5 timed against it, with the SM clock sampled;
     the SASS instructions of one test (`cuobjdump -sass` of the row
     loop's body over the tests it holds) and the issue floor they set
     (instructions over 128 lanes an SM a clock), beside the bound;
 18. the bounds of K4 (K1's counted work plus the least state: each ray's
     64-byte row written and read once for every bounce it enters after the
     first, the live counts; printed beside the count of the design before
     compaction moved into the kernel) and K5 (rays × triangles × 53 FP32
     operations).
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
Then the paths of next-event estimation (render/nee.py) and Phong shading,
whose camera, bounce and shadow rays K2 intersects (and K3 on a big mesh):
 25. the NEE frame: the bench scene with teapot_6k at 512² × 64 spp,
     depth 8, Camera(nee=True), through render_to_image: chunk 0 through
     the NEE executor (integrator.path_trace_shrink, nee=True) held to the plain one
     (intersect_scene_plain on the card) on a strided sample; a warm render
     that writes a checkpoint and a resume from it that traces nothing and
     gives the same image; two timed renders (seconds, segments with the
     shadow rays, Mrays/s, peak memory); K2 launched chunks × (2·depth − 1)
     times an image, or the phase fails; a torch.profiler trace (busy, idle
     share, the shares of K2 and of the spans raygen, bounce_rng and
     nee_rng, the NEE draws); the frame's mean HDR radiance of a sample
     beside the K1 frame's of phase 6, which has the same expectation: it
     fails beyond 5% apart;
 26. NEE on chunk 0 of scenes/bench_teapot_32k.py (4,194,304 rays): K2 on
     every bounce and shadow bounce (2·depth − 1 launches) and K3 on the
     same rays (two launches a call), timed, peak memory, and the strided
     sample held to the plain NEE executor;
 27. the Phong frame: config 2 (scenes/teapot.py, Phong shading) at 512² ×
     64 spp through render_to_image: chunk 0 through phong_trace held to
     the plain phong_trace on a strided sample; two timed renders (seconds,
     Mrays/s of camera rays); K2 launched 2 × chunks times an image; an
     image that is not all zero; a trace with K2's share.
Then textures, normal maps and general-boundary volumes on the staged
path, whose rays K2 and K3 intersect and whose mesh winners one merged
resolve shades (ops/intersect.py::resolve_mesh_winners, span
"mesh_resolve"):
 28. textured-parity: the kitchen sink (scenes/kitchen_sink.py) at 256² ×
     16 spp, depth 5, one chunk of 1,048,576 rays: K2 and K3 (its
     8,450-triangle textured, normal-mapped grid) against their plain
     versions on the bounce-0 and bounce-2 rays, and the texels that the
     resolve samples for their mesh winners (every 16th ray) against the
     plain versions' (identical on >= 99.9% of mesh hits); K2 and K3 timed
     on the bounce-0 rays by CUDA events, beside their bounds; the staged
     executor against integrator.path_trace on the strided sample; one
     render through render_to_image (K2 and K3 launches, time);
 29. config4-frame: BASELINE config 4 (scenes/textured_spheres.py) on its
     stand-in assets at 512² × 32 spp, depth 8, lens radius 0.08 through
     render_to_image: chunk 0's staged run held to the plain path on the
     strided sample, and K2 timed on its bounce-0 rays beside its bound;
     every texture slot bound to its map's pixels; a warm
     render, then two timed (seconds per image, Mrays/s of segments, peak
     memory, K2 launches; K3 none); a trace (kernels an image, idle share,
     the shares of K2 and the spans bounce_rng, raygen and mesh_resolve);
     non-finite tangents and pixels counted; a lit image (mean HDR
     radiance > 0); then one NEE chunk of the scene (2·depth − 1 K2
     launches) held to the plain NEE executor;
 30. gvol: a scene with a 12-triangle cube boundary and a cube scaled by
     0.002 (the per-volume epsilon 1e-4·|det M|), built in code, at 256² ×
     16 spp: intersect_scene_fused (K2, then the general volumes' merge)
     against intersect_scene_plain on one chunk's camera rays (the same
     valid flag and material type on >= 99.9%), and the staged executor
     against the plain path on the strided sample.
Then the sharded driver (parallel/: pixels over the mesh's dp axis,
samples over sp, render_to_image(mesh=...)), whose ranks launch K1, K2
and K3 on their shards:
 31. mesh-nccl: a world of one on NCCL (multihost.initialize on
     tcp://127.0.0.1, a free port) and make_device_mesh(1, 1): the bench
     frame (512² × 64 spp, depth 8, K1) and the 32k image (4 chunks, K1
     walking the teapot's BVH, traced as bounce_kernel_big), each launching
     K1 and neither K2 nor K3, through render_to_image(mesh=...), the u8
     image and the HDR
     accumulator (the checkpoint each render writes) bit-identical to the
     one-device render's; both timed in turns (mean of 2 after a warm
     render): what the sharded path costs, with stats.device_count; one
     render of each traced: kernels, busy, idle share, and the all_reduce
     calls' host time;
 32. mesh-ranks: 4 gloo ranks on the one card (torch.multiprocessing,
     spawned after phase 2 built the kernels), mesh 2x2: the bench frame,
     one 4,194,304-ray chunk of the 32k scene (256² × 64 spp, K1), the NEE
     frame at 256² × 16 spp (K2) and the 32k scene's NEE frame at the same
     size (the staged path: K2 and K3 on the teapot), every rank's image
     and rank 0's accumulator
     bit-identical to one device at spp_chunk / 2, no checkpoint but rank
     0's; then mesh-resume: 2 ranks (mesh 1x2) killed at the first chunk
     of their second spp chunk and resumed from the file in rank 0's
     directory only, bit-identical to the uninterrupted one-device render
     at spp_chunk / 2; each rank's K1, K2 and K3 launches, of which the
     sharded phases must hold at least one each. With more than
     one card the same renders run with one NCCL rank a card
     (mesh-nccl-cards). Four ranks sharing one card measure no scaling.
Then config 5, the reference's demo scene (scenes/drone_demo.py), and the
port's tools:
 33. config5: config 5 at 1024² x 64 spp, depth 10 (the spec's 1000 spp
     cut to 64). Without its meshes (K1's scene): chunk 0 through one K1
     launch held to integrator.path_trace on the strided sample, then one
     render. On its stand-in assets (the staged path): K2 and K3 (the
     32,512-triangle sphere) against their plain versions on chunk 0's
     bounce-0 and bounce-2 rays, and the texels of their mesh winners, as
     phase 28 (staged_bounce_parity); K2 and K3 timed on the bounce-0 rays
     beside their bounds; the chunk against the plain path on the strided
     sample; the camera rays that reach the sphere and lose it to the
     reference's absolute |det| >= 1e-4 (ROADMAP C4) counted on every 256th
     ray; a warm render, a timed one (seconds, Mrays/s of segments,
     peak memory, non-finite pixels) and a trace through
     utils/profiling.device_trace (kernels an image, idle share, the
     shares of K2, K3 and the spans bounce_rng, raygen, mesh_resolve);
     then a render at GATE_SPP (256) spp whose region means
     (tools/compare_reference_render.py) must lie within 6.0 u8 of the JAX
     package's full-spec render artifacts/config5_demo_1024_1000spp_tpu.png
     on sphere_grid, cyan_emitter and glass_area (the other regions hold
     stand-in meshes and maps, and are printed);
 34. tools: make_artifacts' default recipes (configs 1-5 and the bench
     frame, through K1, K2 and K3) into build/chip_smoke/artifacts/, each
     with its agreement with the committed _tpu.png; preview_checkpoint on
     the checkpoint of a two-chunk config-5 render: its PNG the tonemap of
     the kept accumulator and within 1 u8 of the render's image. The
     script's time so far is printed after phase 34.
 35. draws (run right after phase 2): D1, the draws kernels
     (csrc/draws.cu), each entry point at the main path's shapes, 1,048,576
     and 4,194,304 rays: the bench camera's rays (64 spp), a bounce's draws
     with 0 and 2 volume uniforms (the bench scene's and config 5's) and NEE's
     4 and 6 uniforms; every output bit-identical to the plain version's on
     the same rays; the kernel's ms (CUDA events) beside its bound (bytes
     written and read once, or the Threefry blocks' integer operations at
     INT_PEAK) and the plain version's ms. It is also the guard of the
     device functions D1 shares with K1 and K4 (csrc/bounce.cuh's
     threefry2x32, sincos_2pi and cbrt_fast): on the card the plain
     versions that the later phases and the `-m gpu` tests hold K1, K4
     and the executors to (integrator.path_trace, wavefront.step_plain)
     draw through D1, so only this phase, run before them, and
     tests/test_torch_draws.py hold those functions to the int64 torch
     emulation.
 37. resolve (run right after phase 36): R1, the merged-resolve kernel
     (csrc/resolve.cu), on the resolve calls of config 5's chunk 0 at bounce
     0 and bounce 2 (path_trace_shrink on the stand-ins: three meshes,
     textures, normal maps, synthesized materials) and of the bench teapot's
     NEE chunk 0 at bounce 0 and its shadow rays (nee=True): every
     output bit-identical to ops/intersect.py::resolve_mesh_winners on the
     same card (NaN where it has NaN), R1's ms (CUDA events) beside its
     bound (bytes: what each ray needs read once, the outputs written once)
     and the plain version's ms. Phase 2 prints R1's registers and fails on
     spills.
 38. shade (run right after phase 37): S1, the per-bounce shading kernel
     (csrc/shade.cu), on the shading calls of config 5's chunk 0 at bounce 0
     (4,194,304 rays, the path's instantiation) and of the bench teapot's NEE
     chunk 0 at bounce 0 (1,048,576 rays, NEE's): every output
     bit-identical to ops/bsdf.py::shade_plain on the same card (NaN where
     it has NaN), S1's ms (CUDA events) beside its bound (bytes: what each
     ray needs read once, the outputs written once) and the plain version's
     ms. Phase 2 prints S1's registers and fails on spills.
 39. nee (run right after phase 38): N1, NEE's light-sample kernel
     (csrc/nee.cu), on the first NEE bounce of the bench teapot's NEE chunk 0
     (1,048,576 rays): N1a's outputs (the NEE flags, the shadow rays, the
     pending contribution) and, after the shadow rays' intersection, N1b's
     contribution bit-identical to render/nee.py::nee_sample_plain and
     nee_contrib_plain on the same card (NaN where they have NaN), each
     entry's ms (CUDA events) beside its bound (bytes: what each ray needs
     read once, the outputs written once) and the plain versions' ms.
     Phase 2 prints N1's registers and fails on spills.
 40. rtnw-nee (run right after phase 36): K2's sphere tree on the final scene
     of The Next Week under NEE (800² × 64 spp, depth 40, 1,006 spheres): on
     the NEE executor's bounce 0 of chunk 0 (262,144 rays, the benchmark's
     chunk) and its shadow rays, K2's rows on the tree route bit-identical to
     its rows on the flat route (the tree turned off inside the phase), every
     SAMPLE_STRIDE-th ray traced alone bit for bit and held to the plain
     version (the same winner on >= HIT_MIN_SAME, t, u, v within HIT_RTOL /
     HIT_ATOL); both routes timed by CUDA events beside the bound of the
     plain walk's counts (k2_tree_bound), each route's share of it, both
     routes' registers and spills (fails if the tree route spills); the
     same scene without its ground mesh (1,048,576 rays a chunk), whose
     scenes take the tree route's instantiation without the dense-mesh walk:
     its rows held to the flat route's bit for bit, its spills; then
     render_to_image under NEE on a 128² × 64-spp cut (4 chunks of 262,144
     rays), whose K2 launches (depth to 2 · depth − 1 a chunk, all counted
     on the tree route by `scene_intersect.TREE_LAUNCHES`) are the kernels
     line's row `scene_intersect_tree`.
 36. rtnw (run right after phase 35): K1's sphere tree on the final scene of
     The Next Week (scenes/rtnw_final.py, 800² × 64 spp, depth 40, 1,006
     spheres): on chunk 0's camera rays and the rays entering bounce 3 of
     the plain path trace from them, K1's rows with the tree bit-identical
     to K1's rows with its sphere scan (the gate forced open inside the
     phase), every RTNW_STRIDE-th ray traced alone bit for bit and within
     rtol / atol of the plain version on at least RTNW_MIN_FRAC of them,
     segment totals within RTNW_SEG_RTOL (paths of depth 40 flip more
     winners than phase 3's depth 8); both
     timed; K1's registers and resident blocks.
Phases 6, 7, 9, 10, 14, 17, 25-27, 28-30, 33 and 36 first hold a full-size
launch (all of the chunk's rays, uids and depth) to the plain version on a
strided sample of its rays: a ray's result depends only on its own inputs, so the sample
traced alone must give the same rows, bit for bit, and those rows must
match the plain version within the kernel's tolerance (K1 and the staged
path and K4, the NEE executor and Phong: phase 3's; K2, K3 and K5: the
same winner on >= 99.9% of rays, t, u, v within rtol 1e-4 / atol 1e-5
where it agrees).
Then one JSON line describing the kernels, the card's nvidia-smi line,
and the last line {"ok": true, "device": {...}}.

The launch counts in the kernels line are those of the main paths only:
K1's of the timed frames of phase 6 and the renders of phase 7 (and
bounce_kernel_big's own row, mega_bounce_big, of the timed 32k renders of
phase 10 on K1's route); K2's the
sum of the timed renders of phase 10, the timed NEE renders of phase 25,
the NEE chunk of phase 26, the timed Phong renders of phase 27, the
kitchen-sink render of phase 28, the timed config-4 renders and its NEE
chunk of phase 29; K3's of phases 10, 26 and 28 (K3's counts both its
kernels, the screen and the walk: two a call); and, for K1, K2 and K3,
the sharded renders of phase 31, every rank's renders of phase 32, and
the config-5 renders of phase 33 and the tools' renders of phase 34;
K4's of the two wavefront runs of phase 14, K5's of the intersect_mesh
call of phase 17, P1-P5's of their tools' runs in phases 22-24, and D1's
(a counter an entry point) of the timed frames of phase 6 and the renders
of phase 7 (camera rays), the timed renders of phase 10 (camera rays,
bounce draws) and the timed NEE renders of phase 25 (all three); R1's
(one per intersect_scene call on a scene with meshes) of the windows of
K2's in this process: phases 10, 25-29, 31, 33 and 34 (phase 32's ranks
do not report it); S1's (one a bounce of the staged and NEE executors) and
N1's (both entries, one each a NEE bounce) of the same windows. Each
counter is reset just before its path
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
# phase 10's sample of K1 on the 32k chunk (prime, 16,711 rays: the teapot
# fills a small part of the frame), and the share of the 32k image's
# subpixels that K1's image must keep within 1 u8 of the staged one's (K1 and
# the staged path round apart near C4's |det| reject: 99.9982% on seed 0)
K1_BIG_STRIDE = 251
K1_BIG_IMAGE_FRAC = 0.9999
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
# K4's rows bit-identical to K1's on at least this share (the design before
# compaction moved into the kernel: 99.86% on the bench frame, 99.66% on the
# Cornell chunk)
K4_MIN_SAME = 0.996
# K1 (and K4, which shares its bounce body csrc/bounce.cuh) runs 128-thread
# blocks, each staging the scene table and the superleaf tree (24,544 B for
# the bench scene's teapot). nvcc 12.9 allots it 87 registers with no
# spills: 5 blocks, 20 warps, an SM; up to 96 registers a thread (allotted
# in steps of 8) keep those 5 blocks in the SM's 65,536 registers
K1_MAX_REGS, K1_BLOCKS = 96, 5
# the H100's integer issue rate: an SM's 64 INT32 lanes (Hopper white
# paper) and the 64 lanes of its FMA pipe that issue IMAD, which takes an
# add, x 132 SMs x 1.98 GHz (the larger combined rate: whatever pipe the
# compiler gives each add, no launch is faster); the int32 operations of one
# Threefry-2x32-20 block in csrc/bounce.cuh that depend on a thread's
# counter (the counter's 2 adds, 20 rounds of add, funnel-shift rotate and
# xor, 5 key injections of 2 adds); and the key schedule's (ks2's 2 xors,
# 5 adds of a constant), which depends on the launch's key alone, counted
# once a thread
INT_PEAK = 132 * 128 * 1.98e9
THREEFRY_OPS, KEY_SCHEDULE_OPS = 2 + 20 * 3 + 5 * 2, 2 + 5
# phase 36: every RTNW_STRIDE-th ray of the final scene's chunk against the
# plain version: within rtol / atol on at least RTNW_MIN_FRAC of them, and
# segment totals within RTNW_SEG_RTOL. Paths of depth 40 flip a winner at a
# grazing hit or a Fresnel draw more often than the depth-8 scenes of
# MIN_FRAC (0.30% of the camera rays, 0.06% of the bounce-3 rays), and a
# path goes on with zero throughput after the light quad (albedo 0), where
# a flip changes its length and not its radiance (5.6% of the camera rays,
# 1.3% of their segments), so depth × the rays outside does not bound the
# segments (PERF.md §6)
RTNW_STRIDE, RTNW_MIN_FRAC, RTNW_SEG_RTOL = 61, 0.99, 0.05
# D1's launches on the main paths, an entry point each: what draws_read adds
# up after each main path's window
D1_MAIN = {"camera_rays": 0, "bounce_draws": 0, "counter_uniforms": 0}
# R1's launches on the main paths: what r1_read adds up after each window
R1_MAIN = [0]
# S1's launches on the same windows (one a bounce of the staged and NEE
# executors)
S1_MAIN = [0]
# N1's launches on the same windows, both entries (one each a NEE bounce)
N1_MAIN = [0]
OPS = dict(sphere=32, plane=24, triangle=53, volume=42, mesh_setup=21, box=24, mt=53,
           mt_verts=59)
# multiplies in one Möller–Trumbore test of csrc/tri_scan.cu (q 6, det 3,
# u 4, r 6, v 4, t 4): the count that finds the tests in a loop body's SASS
K5_FMUL = 27


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


def trace_file(name: str) -> str:
    """The Chrome trace that device_trace(name, ...) writes in this process."""
    from cs397raytracingsp22_tpu_torch.utils import profiling

    return profiling.trace_path(os.path.join(ROOT, "build", "chip_smoke", f"trace_{name}"))


def device_trace(name: str, fn, kernels: dict, spans: tuple = (), absent: tuple = ()) -> dict:
    """Run fn() once under utils/profiling.device_trace (torch.profiler, its
    trace in trace_file(name)) and read the device's kernels from the
    trace: busy time (union of kernel intervals), the span from
    the first kernel's start to the last one's end, the idle share inside
    that span, and for each label of `kernels` (label → a substring of the
    kernel's name in any case, e.g. "bounce_kernel") the time of the
    kernels so named (the union of their intervals: K3's walk runs beside
    its screen) and their share of the busy time; each must appear.

    spans: labels of the record_function spans that the package opens
    (driver._gen_chunk_rays: "raygen"; integrator._bounce_draws:
    "bounce_rng"); the kernels launched inside them (matched to their
    launch calls by the trace's correlation ids) are reported under the
    label the same way. absent: span labels inside which no kernel may run
    (each is reported as "<label> spans" and "<label> kernels", both
    counted)."""
    from cs397raytracingsp22_tpu_torch.utils import profiling

    torch.cuda.synchronize()
    with profiling.device_trace(os.path.dirname(trace_file(name))):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    with open(trace_file(name)) as f:
        events = json.load(f)["traceEvents"]
    kern = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"],
                   e.get("args", {}).get("correlation"))
                  for e in events if e.get("cat") == "kernel" and e.get("ph") == "X")
    if not kern:
        raise AssertionError(f"trace {name}: the profiler saw no kernel on the device")

    def union(intervals) -> float:  # µs covered by sorted (start, end, ...) intervals
        total, cur_s, cur_e = 0.0, None, None
        for s, e, *_ in intervals:
            if cur_e is None or s > cur_e:
                total += 0.0 if cur_e is None else cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        return total + (0.0 if cur_e is None else cur_e - cur_s)

    busy = union(kern)
    span = max(k[1] for k in kern) - kern[0][0]
    out = dict(kernels=len(kern), wall_ms=wall * 1e3, busy_ms=busy / 1e3, span_ms=span / 1e3,
               idle=1.0 - busy / span, parts={})
    for label, sub in kernels.items():
        ms = union(k for k in kern if sub.lower() in k[2].lower()) / 1e3
        if ms == 0.0:
            raise AssertionError(f"trace {name}: no kernel named *{sub}* in the trace")
        out["parts"][label] = ms
    launches = [(float(e["ts"]), e.get("args", {}).get("correlation")) for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver") and e.get("ph") == "X"]
    for label in spans:
        marks = [(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
                 if e.get("cat") == "user_annotation" and e.get("name") == label]
        corr = {c for ts, c in launches if any(a <= ts <= b for a, b in marks)}
        ms = union(k for k in kern if k[3] in corr) / 1e3
        if ms == 0.0:
            raise AssertionError(f"trace {name}: no kernel launched inside {label}")
        out["parts"][label] = ms
    out["shares"] = {k: v / (busy / 1e3) for k, v in out["parts"].items()}
    for label in absent:
        marks = [(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
                 if e.get("cat") == "user_annotation" and e.get("name") == label]
        corr = {c for ts, c in launches if any(a <= ts <= b for a, b in marks)}
        inside = sum(1 for k in kern if k[3] in corr)
        if inside:
            raise AssertionError(f"trace {name}: {inside} kernels ran inside {label}")
        out[f"{label} spans"], out[f"{label} kernels"] = len(marks), inside
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


def k2_ms(sd, ins, reps: int = 10) -> float:
    """K2's milliseconds a launch on ins = (o, d, t_min, t_max, u_vol) by
    CUDA events, the outputs allocated once and the wrapper's checks left
    out (scene_intersect.launch): on a busy host the wrapper's Python work
    can outlast a 0.1 ms launch, and the events would time the host."""
    from cs397raytracingsp22_tpu_torch.ops.kernels import scene_intersect

    out = scene_intersect.empty_outputs(ins[0].shape[0], ins[0].device)
    return cuda_ms(lambda: scene_intersect.launch(sd, ins, out), reps)


def draws_reset() -> None:
    """Zero D1's counters just before a main path runs."""
    from cs397raytracingsp22_tpu_torch.ops.kernels import draws
    draws.LAUNCHES.update(dict.fromkeys(draws.LAUNCHES, 0))


def draws_read() -> None:
    """Add D1's counters, read just after a main path ran, to D1_MAIN."""
    from cs397raytracingsp22_tpu_torch.ops.kernels import draws
    for entry, n in draws.LAUNCHES.items():
        D1_MAIN[entry] += n


def r1_reset() -> None:
    """Zero R1's, S1's and N1's counters just before a main path runs."""
    from cs397raytracingsp22_tpu_torch.ops.kernels import nee, resolve, shade
    resolve.LAUNCHES["resolve"] = 0
    shade.LAUNCHES["shade"] = 0
    nee.LAUNCHES.update(dict.fromkeys(nee.LAUNCHES, 0))


def r1_read() -> None:
    """Add R1's, S1's and N1's counters, read just after a main path ran, to
    R1_MAIN, S1_MAIN and N1_MAIN."""
    from cs397raytracingsp22_tpu_torch.ops.kernels import nee, resolve, shade
    R1_MAIN[0] += resolve.LAUNCHES["resolve"]
    S1_MAIN[0] += shade.LAUNCHES["shade"]
    N1_MAIN[0] += sum(nee.LAUNCHES.values())


def rtnw_phase(dev) -> None:
    """Phase 36: K1's sphere tree on the final scene of The Next Week
    (scenes/rtnw_final.py, 800² × 64 spp, depth 40: 1,006 spheres, the
    scene takes K1 through its tree). On chunk 0's camera rays (131,072)
    and the rays entering bounce 3 of the plain path trace from them: K1's
    rows with the tree bit-identical to K1's rows with its sphere scan (the
    gate forced open here: no tree, every sphere counted against enough
    lanes), the segments equal; every SAMPLE_STRIDE-th ray traced alone
    bit for bit and within the parity contract of the plain version; both
    K1 builds timed on the camera rays by CUDA events; its resident
    blocks."""
    from cs397raytracingsp22_tpu_torch.models import scene as scene_mod
    from cs397raytracingsp22_tpu_torch.ops import intersect as isect
    from cs397raytracingsp22_tpu_torch.ops.kernels import bounce
    from cs397raytracingsp22_tpu_torch.render import driver, integrator
    from cs397raytracingsp22_tpu_torch.scenes import rtnw_final
    from cs397raytracingsp22_tpu_torch.utils import threefry

    depth, t_max = 40, 20000.0
    scene = rtnw_final.build(800, 800, 64, depth)
    sd = scene.compile(device=dev)
    if not (bounce.scene_is_simple(sd) and sd.sph_tree_leaves):
        raise AssertionError("the final scene does not take K1 through its sphere tree")
    cam = scene.camera
    key = threefry.key_words(0)
    px = driver.chunk_pixels(sd, cam, cam.aa_sample_count)
    n_chunks = -(-cam.screen_width * cam.screen_height // px)
    ids = torch.arange(px, dtype=torch.int32, device=dev) * n_chunks
    cam_rays = driver._gen_chunk_rays(cam, ids, key, 0, cam.aa_sample_count, 1)
    o, d, uids = cam_rays
    thr, rad = torch.ones_like(o), torch.zeros_like(o)
    alive = torch.ones((o.shape[0],), dtype=torch.bool, device=dev)
    for b in range(3):
        o, d, thr, rad, alive, _, _ = integrator.bounce_update(
            sd, o, d, thr, rad, alive, uids, key, b, t_max,
            intersect=isect.intersect_scene_plain)
    keep = alive.nonzero()[:, 0]
    b3_rays = (o[keep].contiguous(), d[keep].contiguous(), uids[keep].contiguous())
    k1 = lambda rays: bounce.path_trace_cuda(sd, *rays, key, depth, t_max)  # noqa: E731
    tree = {name: k1(rays) for name, rays in (("camera", cam_rays), ("bounce-3", b3_rays))}
    torch.cuda.synchronize()
    tree_ms = cuda_ms(lambda: k1(cam_rays), 3)
    regs, spill = bounce.kernel_attrs(dense=True, sph_tree=True)
    blocks = bounce.resident_blocks(sd)
    saved = scene_mod.SPHERE_TREE_MIN, bounce.LANES
    scene_mod.SPHERE_TREE_MIN, bounce.LANES = 1 << 20, 4096
    try:
        scan = {name: k1(rays) for name, rays in (("camera", cam_rays), ("bounce-3", b3_rays))}
        scan_ms = cuda_ms(lambda: k1(cam_rays), 3)
        scan_blocks = bounce.resident_blocks(sd)
    finally:
        scene_mod.SPHERE_TREE_MIN, bounce.LANES = saved
    for name, rays in (("camera", cam_rays), ("bounce-3", b3_rays)):
        (rad_t, segs_t), (rad_s, segs_s) = tree[name], scan[name]
        differ = int((rad_t != rad_s).any(dim=1).sum())
        if differ or int(segs_t) != int(segs_s):
            raise AssertionError(f"rtnw {name}: {differ} of {rad_t.shape[0]} K1 rows with the "
                                 f"sphere tree differ from its sphere scan's (segments "
                                 f"{int(segs_t)} vs {int(segs_s)})")
        idx = torch.arange(0, rad_t.shape[0], RTNW_STRIDE, device=dev)
        sub, (rad_s, segs_s) = sample_alone("K1 sphere tree", lambda *r: k1(r), (rad_t,), rays,
                                            idx)
        got, want = {}, {}
        bounce.path_trace_cuda(sd, *sub, key, depth, t_max, stats=got)
        ref_rad, ref_segs = integrator.path_trace(sd, *sub, key, depth, t_max, stats=want)
        ok = torch.isclose(rad_s, ref_rad, rtol=RTOL, atol=ATOL).all(dim=1)
        same = ok & (got["segs"] == want["segs"])
        n, seg_diff = int(idx.numel()), abs(int(segs_s) - int(ref_segs))
        log("rtnw", f"{name} rays ({rad_t.shape[0]}): K1 with the sphere tree bit-identical to "
            f"its sphere scan, {int(segs_t)} segments; every {RTNW_STRIDE}th ray ({n}) traced "
            f"alone bit for bit; against the plain version {int(ok.sum())}/{n} "
            f"({float(ok.float().mean()):.2%}, need {RTNW_MIN_FRAC:.0%}) within rtol {RTOL} atol "
            f"{ATOL}, {int(same.sum())}/{n} also of the same segments; segments {int(segs_s)} vs "
            f"{int(ref_segs)} (diff {seg_diff / max(int(ref_segs), 1):.2%}, at most "
            f"{RTNW_SEG_RTOL:.0%})")
        if float(ok.float().mean()) < RTNW_MIN_FRAC or seg_diff > RTNW_SEG_RTOL * int(ref_segs):
            raise AssertionError(f"rtnw {name}: K1 outside its parity contract with the plain "
                                 "version")
    staged = bounce.k1_staged_bytes(sd)
    log("rtnw", f"K1 sphere tree: {regs} registers, {spill} B local, {staged} B "
        f"staged, {blocks} resident blocks an SM (the scan's {scan_blocks}); camera rays "
        f"{tree_ms:.3f} ms with the tree, {scan_ms:.3f} ms with the scan")


def k2_tree_bound(sd, ins, idx) -> tuple[float, str, dict]:
    """(bound ms, bound_by, work) of one K2 launch on the tree route on ins
    = (o, d, t_min, t_max, u_vol): operations = the sphere tree's nodes and
    spheres and the dense meshes' nodes and triangles that the plain walk
    counts on the rays idx (scene_intersect_plain's stats), scaled to the
    launch, and the planes, triangles and volumes of every ray with a
    window; bytes = o, d, t_min, t_max and a u_vol column a volume in, 37 B
    out, the tables once (the sphere tree's nodes, slots and indices, the
    scene table, the dense-mesh rows and superleaf trees). The work holds
    the counts a sampled ray with a window."""
    from cs397raytracingsp22_tpu_torch.ops.kernels import scene_intersect

    n = ins[0].shape[0]
    st = {}
    sub = [x[idx] for x in ins]
    scene_intersect.scene_intersect_plain(sd, *sub, stats=st)
    win = sub[3] >= sub[2]
    scale = n / idx.numel()
    counted = {k: int((st[k] * win).sum()) for k in ("sph_nodes", "sph_spheres", "nodes", "tris")}
    tested = scale * int(win.sum())
    ops = (tested * (sd.n_planes * OPS["plane"] + sd.n_tris * OPS["triangle"]
                     + sd.n_volumes * OPS["volume"] + len(sd.dense_mesh_ids) * OPS["mesh_setup"])
           + scale * ((counted["sph_nodes"] + counted["nodes"]) * OPS["box"]
                      + counted["sph_spheres"] * OPS["sphere"] + counted["tris"] * OPS["mt"]))
    n_bytes = (n * (12 + 12 + 4 + 4 + 4 * sd.n_volumes + 37)
               + nbytes(sd.kscene, sd.ksph_tree, sd.kmesh_tri, sd.ksl_tree))
    ms, by = bound(n_bytes, ops)
    per = max(int(win.sum()), 1)
    return ms, by, dict(ops=ops, bytes=n_bytes, windows=tested,
                        **{f"{k}_per_ray": v / per for k, v in counted.items()})


def nee_bounce0_calls(scene, dev, t_max: float) -> tuple:
    """(scene's tables on `dev`, the K2 inputs of the NEE executor's bounce
    0 of chunk 0 and of its shadow rays, each (o, d, t_min, t_max, u_vol))
    at the chunk render_to_image gives `scene`."""
    from cs397raytracingsp22_tpu_torch.ops import intersect as isect
    from cs397raytracingsp22_tpu_torch.render import driver, integrator
    from cs397raytracingsp22_tpu_torch.utils import threefry

    sd = scene.compile(device=dev)
    cam = scene.camera
    key = threefry.key_words(0)
    px = driver.chunk_pixels(sd, cam, cam.aa_sample_count)
    n_chunks = -(-cam.screen_width * cam.screen_height // px)
    ids = torch.arange(px, dtype=torch.int32, device=dev) * n_chunks
    o, d, uids = driver._gen_chunk_rays(cam, ids, key, 0, cam.aa_sample_count, 1)
    calls = []

    def recording(scene_, o_, d_, t_min, t_max_, u_vol):
        n = o_.shape[0]
        calls.append((o_.contiguous(), d_.contiguous(),
                      torch.full((n,), t_min, dtype=torch.float32, device=dev),
                      t_max_.contiguous(), u_vol[:, :sd.vol_center.shape[0]].contiguous()))
        return isect.intersect_scene(scene_, o_, d_, t_min, t_max_, u_vol)

    alive = torch.ones((o.shape[0],), dtype=torch.bool, device=dev)
    integrator.bounce_update(sd, o, d, torch.ones_like(o), torch.zeros_like(o), alive, uids, key,
                             0, t_max, intersect=recording, do_nee=True)
    return sd, calls


def k2_routes_differ(names, tree: dict, flat: dict) -> None:
    """Raise where a K2 row on the tree route differs from the flat
    route's."""
    for name in names:
        for key_, a, b in zip(("t", "code", "idx", "mat", "u", "v", "normal", "ff"), tree[name],
                              flat[name]):
            same = (a == b) if a.ndim == 1 else (a == b).all(dim=1)
            if not bool(same.all()):
                raise AssertionError(f"rtnw-nee {name}: {int((~same).sum())} of {same.numel()} "
                                     f"K2 rows ({key_}) on the tree route differ from the flat "
                                     "route's")


def rtnw_nee_phase(dev) -> dict:
    """Phase 40: K2's sphere tree on the final scene of The Next Week under
    NEE. On the NEE executor's bounce 0 of chunk 0 and its shadow rays: the
    tree route's rows bit-identical to the flat route's, every
    SAMPLE_STRIDE-th ray traced alone bit for bit and held to the plain
    version; both routes timed (CUDA events) beside the plain walk's bound;
    then the same without the ground's mesh (the tree route's instantiation
    without the dense-mesh walk) held to the flat route; then
    render_to_image under NEE on a 128² × 64-spp cut of the scene (chunks
    of the benchmark's 262,144 rays), its K2 launches counted on each
    route. Returns the kernels line's row of K2's tree route."""
    import dataclasses

    from cs397raytracingsp22_tpu_torch import StaticMesh
    from cs397raytracingsp22_tpu_torch.models import scene as scene_mod
    from cs397raytracingsp22_tpu_torch.ops.kernels import scene_intersect
    from cs397raytracingsp22_tpu_torch.render import driver
    from cs397raytracingsp22_tpu_torch.scenes import rtnw_final

    depth, t_max = 40, 20000.0
    scene = rtnw_final.build(800, 800, 64, depth)
    sd, calls = nee_bounce0_calls(scene, dev, t_max)
    if not sd.sph_tree_leaves or not sd.dense_mesh_ids:
        raise AssertionError("the final scene lacks its sphere tree or its ground mesh")
    names = ("bounce 0", "shadow rays")
    tree = {name: scene_intersect.scene_intersect_cuda(sd, *ins) for name, ins in zip(names, calls)}
    tree_ms = {name: k2_ms(sd, ins) for name, ins in zip(names, calls)}
    regs, spill = scene_intersect.kernel_attrs(dense=True, sph_tree=True)
    staged = scene_intersect.staged_bytes(sd)
    blocks = scene_intersect.occupancy(sd)[0]
    saved = scene_mod.SPHERE_TREE_MIN
    scene_mod.SPHERE_TREE_MIN = 1 << 20
    try:
        flat = {name: scene_intersect.scene_intersect_cuda(sd, *ins)
                for name, ins in zip(names, calls)}
        flat_ms = {name: k2_ms(sd, ins) for name, ins in zip(names, calls)}
        flat_blocks = scene_intersect.occupancy(sd)[0]
    finally:
        scene_mod.SPHERE_TREE_MIN = saved
    f_regs, f_spill = scene_intersect.kernel_attrs(dense=True)
    k2_routes_differ(names, tree, flat)
    err, plain_ms, bound_ms, bound_by = 0.0, 0.0, 0.0, set()
    for name, ins in zip(names, calls):
        idx = torch.arange(0, ins[0].shape[0], SAMPLE_STRIDE, device=dev)
        sub, alone = sample_alone("K2 sphere tree",
                                  lambda *x: scene_intersect.scene_intersect_cuda(sd, *x),
                                  tree[name], ins, idx)
        ref = scene_intersect.scene_intersect_plain(sd, *sub)
        n_r, n_same, n_exact, e = compare_hits(
            f"rtnw-nee {name}", (alone[1], alone[2]), (ref[1], ref[2]),
            dict(t=alone[0], u=alone[4], v=alone[5]), dict(t=ref[0], u=ref[4], v=ref[5]))
        err = max(err, e)
        p_ms = cuda_ms(lambda: scene_intersect.scene_intersect_plain(sd, *sub), 1)
        b_ms, b_by, w = k2_tree_bound(sd, ins, idx)
        plain_ms, bound_ms = plain_ms + p_ms, bound_ms + b_ms
        bound_by.add(b_by)
        log("rtnw-nee", f"{name} ({ins[0].shape[0]} rays, {w['windows']:.0f} with a window): K2's "
            f"tree rows bit-identical to its flat rows; every {SAMPLE_STRIDE}th ray ({n_r}) "
            f"traced alone bit for bit, {n_same}/{n_r} the plain version's winner, {n_exact} "
            f"bit-identical; tree {tree_ms[name]:.4f} ms, flat {flat_ms[name]:.4f} ms "
            f"({flat_ms[name] / tree_ms[name]:.1f}x); bound {b_ms:.4f} ms ({b_by}; "
            f"{w['sph_nodes_per_ray']:.2f} sphere-tree nodes, {w['sph_spheres_per_ray']:.2f} "
            f"spheres, {w['nodes_per_ray']:.2f} superleaf nodes, {w['tris_per_ray']:.2f} "
            f"triangles a ray): tree at {b_ms / tree_ms[name]:.2%} of it, flat at "
            f"{b_ms / flat_ms[name]:.2%}; the plain version {p_ms:.2f} ms on the sample")
    log("rtnw-nee", f"K2 tree route {regs} registers, {spill} B local, {staged} B staged, {blocks} "
        f"blocks an SM; flat route {f_regs} registers, {f_spill} B local, {flat_blocks} blocks "
        "an SM")
    if spill:
        raise AssertionError(f"K2's tree route spills {spill} B")

    # without the ground's mesh: scene_intersect_tree_kernel<false>
    bare = dataclasses.replace(scene, objects=[ob for ob in scene.objects
                                               if not isinstance(ob, StaticMesh)])
    bsd, bcalls = nee_bounce0_calls(bare, dev, t_max)
    if bsd.dense_mesh_ids or not bsd.sph_tree_leaves:
        raise AssertionError("the final scene without its ground has a dense mesh or no tree")
    before = scene_intersect.TREE_LAUNCHES
    b_tree = {name: scene_intersect.scene_intersect_cuda(bsd, *ins)
              for name, ins in zip(names, bcalls)}
    if scene_intersect.TREE_LAUNCHES != before + len(bcalls):
        raise AssertionError("K2 did not take the tree route on the scene without its ground")
    scene_mod.SPHERE_TREE_MIN = 1 << 20
    try:
        b_flat = {name: scene_intersect.scene_intersect_cuda(bsd, *ins)
                  for name, ins in zip(names, bcalls)}
    finally:
        scene_mod.SPHERE_TREE_MIN = saved
    if scene_intersect.TREE_LAUNCHES != before + len(bcalls):
        raise AssertionError("K2 counted a flat launch on the tree route")
    k2_routes_differ(names, b_tree, b_flat)
    b_regs, b_spill = scene_intersect.kernel_attrs(dense=False, sph_tree=True)
    log("rtnw-nee", f"without the ground's mesh ({bcalls[0][0].shape[0]} rays a chunk): K2's "
        f"tree rows bit-identical to its flat rows on bounce 0 and its "
        f"{bcalls[1][0].shape[0]} shadow rays; tree route without the mesh walk {b_regs} "
        f"registers, {b_spill} B local, {scene_intersect.staged_bytes(bsd)} B staged, "
        f"{scene_intersect.occupancy(bsd)[0]} blocks an SM")
    if b_spill:
        raise AssertionError(f"K2's tree route without the mesh walk spills {b_spill} B")

    # the main path: render_to_image under NEE, chunks of the benchmark's shape
    cut = rtnw_final.build(128, 128, 64, depth)
    cut = dataclasses.replace(cut, camera=dataclasses.replace(cut.camera, nee=True))
    px = driver.chunk_pixels(cut.compile(device=dev), cut.camera, cut.camera.aa_sample_count)
    chunks = -(-128 * 128 // px)
    scene_intersect.LAUNCHES = scene_intersect.TREE_LAUNCHES = 0  # the NEE render's counts
    t0 = time.perf_counter()
    img, _ = driver.render_to_image(cut, device=dev, seed=23, verbose=False)
    torch.cuda.synchronize()
    render_s = time.perf_counter() - t0
    launches, on_tree = scene_intersect.LAUNCHES, scene_intersect.TREE_LAUNCHES  # read just after
    most = chunks * (2 * depth - 1)
    if on_tree != launches or not chunks * depth <= launches <= most or not img.max() > 0:
        raise AssertionError(f"the NEE render launched K2 {launches} times ({on_tree} on the tree "
                             f"route), not {chunks * depth} to {most} all on the tree, or its "
                             "image is black")
    log("rtnw-nee", f"render_to_image under NEE, 128² × 64 spp ({chunks} chunks of "
        f"{px * 64} rays): {render_s:.3f} s, {launches} K2 launches ({most} at most), {on_tree} "
        "of them on the tree route")
    return {"name": "scene_intersect_tree", "route": "cuda",
            "source": "cs397raytracingsp22_tpu_torch/csrc/scene_intersect.cu",
            "replaces": "cs397raytracingsp22_tpu/ops/pallas/scene_intersect.py:464",
            "launches": launches, "max_abs_err": err, "ms": sum(tree_ms.values()),
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": " and ".join(sorted(bound_by)),
            "library_ms": None, "flat_ms": sum(flat_ms.values()),
            "share": bound_ms / sum(tree_ms.values()),
            "flat_share": bound_ms / sum(flat_ms.values()), "registers": regs,
            "spill_bytes": spill, "flat_registers": f_regs, "flat_spill_bytes": f_spill,
            "bare_registers": b_regs, "bare_spill_bytes": b_spill}


# phase 37's NEE frame: the bench.nee cell's
RESOLVE_NEE_FRAME = dict(width=512, height=512, spp=64, path_depth=8)


class _Captured(Exception):
    """Raised by resolve_phase's recorder once it holds the calls it needs."""


def resolve_inputs(run, calls: tuple) -> dict:
    """The inputs of the merged-resolve calls numbered `calls` (in the
    order a render path makes them) while run() runs, each as (scene, ins)
    with ins the launch's (o, d, code, t, idx, u, v, fields), cloned; run()
    is stopped after the last."""
    from cs397raytracingsp22_tpu_torch.ops.kernels import resolve

    real, got, count = resolve.resolve_winners, {}, [0]

    def recorder(scene, *ins):
        if count[0] in calls:
            got[count[0]] = (scene, tuple(x.clone() for x in ins[:7])
                             + ({k: x.clone() for k, x in ins[7].items()},))
        count[0] += 1
        if len(got) == len(calls):
            raise _Captured
        return real(scene, *ins)

    resolve.resolve_winners = recorder
    try:
        run()
    except _Captured:
        pass
    finally:
        resolve.resolve_winners = real
    return got


def resolve_bytes(sd, ins) -> int:
    """The bytes a resolve over these inputs needs, each once: a mesh
    winner's code, ray, t, idx, u, v (44 B), the words of its kmesh_res row
    that its mesh needs (36 B of corner normals, 24 B of corner uvs where it
    samples a texel, 12 B of tangent under a normal map) and 3 B a texel it
    samples (slot 4 where bound; slots 0-3 where bound and its material is
    synthesized); any other ray's code, point, normal, front face and
    material id (33 B); every ray's 65 B of outputs; the tables once."""
    from cs397raytracingsp22_tpu_torch.ops import intersect as isect

    code, m = ins[2], len(sd.meshes)
    j = code.long() - isect.CODE_MESH0
    is_mesh = (j >= 0) & (j < m)
    bound = sd.kmesh_tex[:m, 0::3] >= 0  # (M, 5): the slots each mesh binds
    synth = sd.kmesh_xfm[:m, 35] < 0
    texels = bound[:, :4].sum(dim=1) * synth + bound[:, 4]  # a winner of each mesh samples
    row = 36 + 24 * (texels > 0) + 12 * bound[:, 4]
    jm = j[is_mesh]
    n_mesh = int(is_mesh.sum())
    tables = sum(x.numel() * x.element_size() for x in (sd.kmesh_xfm, sd.kmesh_tex))
    return (n_mesh * 44 + int(row[jm].sum()) + 3 * int(texels[jm].sum())
            + (code.numel() - n_mesh) * 33 + code.numel() * 65 + tables
            + 40 * int(sd.mat_type.shape[0]))


def resolve_phase(dev) -> dict:
    """Phase 37: R1 against resolve_mesh_winners on the resolve calls of
    config 5's chunk 0 (bounces 0 and 2) and of the NEE bench chunk 0
    (bounce 0 and its shadow rays); returns the kernels line's row (config
    5's bounce 0)."""
    import dataclasses

    from cs397raytracingsp22_tpu_torch.models.scene import resolve_order
    from cs397raytracingsp22_tpu_torch.ops import intersect as isect
    from cs397raytracingsp22_tpu_torch.ops.kernels import resolve
    from cs397raytracingsp22_tpu_torch.render import integrator
    from cs397raytracingsp22_tpu_torch.scenes import bench_scene, drone_demo
    from cs397raytracingsp22_tpu_torch.utils import threefry

    key = threefry.key_words(2**33 + 37)
    sc5 = drone_demo.build(**CONFIG5)
    sc6 = bench_scene.build(**RESOLVE_NEE_FRAME)
    sc6 = dataclasses.replace(sc6, camera=dataclasses.replace(sc6.camera, nee=True))
    cases = []
    for sc, name, calls in (
            (sc5, "config 5", {0: "bounce 0", 2: "bounce 2"}),
            (sc6, "bench NEE", {0: "bounce 0", 1: "shadow rays"})):
        sd = sc.compile(device=dev)
        cam = sc.camera
        _, (o, d, uids) = chunk0(sd, cam, key)
        got = resolve_inputs(lambda: integrator.path_trace_shrink(
            sd, o, d, uids, key, cam.path_depth, cam.max_trace_dist, nee=cam.nee), tuple(calls))
        cases += [(f"{name} {calls[c]}", sd, got[c][1]) for c in sorted(calls)]
        del o, d, uids
    row = None
    for what, sd, ins in cases:
        o, d = ins[0], ins[1]
        obj = {mi: isect.object_rays(sd.meshes[mi], o, d)
               for mi in resolve_order(sd.dense_mesh_ids, len(sd.meshes))}
        plain = lambda: isect.resolve_mesh_winners(sd, obj, *ins[2:])  # noqa: E731
        before = resolve.LAUNCHES["resolve"]
        out, want = resolve.resolve_winners(sd, *ins), plain()
        torch.cuda.synchronize()
        if resolve.LAUNCHES["resolve"] != before + 1:
            raise AssertionError(f"R1 {what}: the resolve did not launch R1 once")
        for f, (dtype, _) in resolve.OUTPUTS.items():
            a, b = out[f], want[f]
            if a.dtype != dtype or a.shape != b.shape:
                raise AssertionError(f"R1 {what}: {f} is {a.dtype} {tuple(a.shape)}, the plain "
                                     f"version's {b.dtype} {tuple(b.shape)}")
            if dtype == torch.float32:
                same = (a.view(torch.int32) == b.view(torch.int32)) | (a.isnan() & b.isnan())
            else:
                same = a == b
            if not bool(same.all()):
                bad = int((~same).reshape(a.shape[0], -1).any(dim=1).sum())
                raise AssertionError(f"R1 {what}: {f} differs from the plain version on {bad} of "
                                     f"{a.shape[0]} rays")
        n = ins[2].numel()
        n_mesh = int(((ins[2] >= isect.CODE_MESH0) & (ins[2] < isect.CODE_MESH0
                                                      + len(sd.meshes))).sum())
        k_ms = cuda_ms(lambda: resolve.launch(sd, ins, out), 20)
        p_ms = cuda_ms(plain, 3)
        b_ms, by = bound(resolve_bytes(sd, ins), 0)
        cfg = resolve.launch_config(sd, n)
        nan = int(out["normal"].isnan().any(dim=1).sum())
        log("resolve", f"R1 {what} ({n} rays, {n_mesh} mesh winners, instantiation "
            f"{cfg['variant']}, grid {cfg['grid']} x {cfg['threads']}, {cfg['blocks_per_sm']} "
            f"blocks an SM, {cfg['smem_bytes']} B staged): every output bit-identical to "
            f"resolve_mesh_winners ({nan} NaN normals in both); {k_ms:.4f} ms (bound "
            f"{b_ms:.4f} ms, {by}: {b_ms / k_ms:.1%}), plain torch {p_ms:.3f} ms "
            f"({p_ms / k_ms:.0f}x)")
        if row is None:
            row = {"name": "resolve", "route": "cuda",
                   "source": "cs397raytracingsp22_tpu_torch/csrc/resolve.cu", "replaces": None,
                   "launches": 0, "max_abs_err": 0.0, "ms": k_ms, "plain_ms": p_ms,
                   "bound_ms": b_ms, "bound_by": by, "library_ms": None}
    return row


def shade_bytes(hit, state: dict, nee_inputs: dict) -> int:
    """The bytes a shading over these inputs needs, each once: every ray's
    alive and valid flags, thr and rad (26 B) and its rad, o, d, thr and
    live flag written (49 B); a live hit's point, normal, type, albedo, d,
    ball and branch uniform (68 B), its roughness (Metal, Parameterized),
    metallic (Parameterized), ior and front face (Dielectric), and its
    emission where it counts (12 B); any other ray's o and d (24 B); a live
    hit's NEE flag (1 B) where the flags are given; with a sample every
    ray's flag written (1 B) and a live hit's contrib and did (13 B)."""
    from cs397raytracingsp22_tpu_torch.models import materials as mat

    live = state["alive"] & hit.valid
    n, n_live = live.numel(), int(live.sum())
    mt = hit.mtype[live]
    per_type = torch.zeros(8, dtype=torch.int64, device=mt.device)
    per_type[mat.METAL], per_type[mat.DIELECTRIC], per_type[mat.PARAMETERIZED] = 4, 5, 8
    emit = live if nee_inputs["prev_nee"] is None else live & ~nee_inputs["prev_nee"]
    total = (75 * n + 68 * n_live + int(per_type[mt.clamp(0, 7).long()].sum())
             + 12 * int(emit.sum()) + 24 * (n - n_live))
    if nee_inputs["prev_nee"] is not None:
        total += n_live
    if nee_inputs["contrib"] is not None:
        total += n + 13 * n_live
    return total


def shade_phase(dev) -> dict:
    """Phase 38: S1 against shade_plain on the shading calls of config 5's
    chunk 0 (bounce 0) and of the NEE bench chunk 0 (bounce 0); returns the
    kernels line's row (config 5's)."""
    import dataclasses

    from cs397raytracingsp22_tpu_torch.ops import bsdf
    from cs397raytracingsp22_tpu_torch.ops.kernels import shade
    from cs397raytracingsp22_tpu_torch.render import integrator
    from cs397raytracingsp22_tpu_torch.scenes import bench_scene, drone_demo
    from cs397raytracingsp22_tpu_torch.utils import threefry

    key = threefry.key_words(2**33 + 38)
    sc5 = drone_demo.build(**CONFIG5)
    sc6 = bench_scene.build(**RESOLVE_NEE_FRAME)
    sc6 = dataclasses.replace(sc6, camera=dataclasses.replace(sc6.camera, nee=True))
    row = None
    for sc, what in ((sc5, "config 5 bounce 0"), (sc6, "bench NEE bounce 0")):
        sd = sc.compile(device=dev)
        cam = sc.camera
        _, (o, d, uids) = chunk0(sd, cam, key)
        real, got = shade.shade_update, {}

        def recorder(hit, o_, d_, thr, rad, alive, ball, u_choice, prev_nee=None, nee=None):
            got["args"] = (hit, dict(o=o_, d=d_, thr=thr, rad=rad, alive=alive, ball=ball,
                                     u_choice=u_choice), prev_nee, nee)
            raise _Captured

        shade.shade_update = recorder
        try:
            integrator.path_trace_shrink(sd, o, d, uids, key, cam.path_depth,
                                         cam.max_trace_dist, nee=cam.nee)
        except _Captured:
            pass
        finally:
            shade.shade_update = real
        del o, d, uids
        hit, state, prev_nee, sample = got["args"]
        before = shade.LAUNCHES["shade"]
        out = shade.shade_update(hit, **state, prev_nee=prev_nee, nee=sample)
        want = bsdf.shade_plain(hit, **state, prev_nee=prev_nee, nee=sample)
        torch.cuda.synchronize()
        if shade.LAUNCHES["shade"] != before + 1:
            raise AssertionError(f"S1 {what}: the shading did not launch S1 once")
        for name, a, b in zip(("o", "d", "thr", "rad", "live_hit", "prev_nee"), out, want):
            if (a is None) != (b is None):
                raise AssertionError(f"S1 {what}: {name} is {a} where the plain version's is {b}")
            if a is None:
                continue
            if a.dtype != b.dtype or a.shape != b.shape:
                raise AssertionError(f"S1 {what}: {name} is {a.dtype} {tuple(a.shape)}, the "
                                     f"plain version's {b.dtype} {tuple(b.shape)}")
            if a.dtype == torch.float32:
                same = (a.view(torch.int32) == b.view(torch.int32)) | (a.isnan() & b.isnan())
            else:
                same = a == b
            if not bool(same.all()):
                bad = int((~same).reshape(a.shape[0], -1).any(dim=1).sum())
                raise AssertionError(f"S1 {what}: {name} differs from the plain version on {bad} "
                                     f"of {a.shape[0]} rays")
        contrib, did = sample if sample is not None else (None, None)
        nee_inputs = dict(prev_nee=prev_nee, contrib=contrib, did=did)
        bufs = dict(zip(("o_out", "d_out", "thr_out", "rad_out", "live_hit", "prev_out"), out))
        n = state["alive"].numel()
        n_live = int(out[4].sum())
        k_ms = cuda_ms(lambda: shade.launch(hit, state, nee_inputs, bufs), 20)
        p_ms = cuda_ms(lambda: bsdf.shade_plain(hit, **state, prev_nee=prev_nee, nee=sample), 3)
        b_ms, by = bound(shade_bytes(hit, state, nee_inputs), 0)
        regs, spill = shade.kernel_attrs(nee=sample is not None)
        log("shade", f"S1 {what} ({n} rays, {n_live} live hits, "
            f"{'NEE' if sample is not None else 'path'} instantiation, {regs} registers, "
            f"{spill} B local): every output bit-identical to shade_plain; {k_ms:.4f} ms (bound "
            f"{b_ms:.4f} ms, {by}: {b_ms / k_ms:.1%}), plain torch {p_ms:.3f} ms "
            f"({p_ms / k_ms:.0f}x)")
        if row is None:
            row = {"name": "shade", "route": "cuda",
                   "source": "cs397raytracingsp22_tpu_torch/csrc/shade.cu", "replaces": None,
                   "launches": 0, "max_abs_err": 0.0, "ms": k_ms, "plain_ms": p_ms,
                   "bound_ms": b_ms, "bound_by": by, "library_ms": None}
    return row


def nee_bytes(sd, hit, live, out) -> tuple[int, int]:
    """The bytes N1a and N1b need on these inputs, each once. N1a: every
    ray's live flag (1 B) and its outputs (did, shoot, the shadow ray's
    origin, direction and window end, pending: 42 B); a live ray's valid
    flag (1 B); a live hit's normal and type (16 B); a Parameterized one's
    incoming direction, branch uniform, roughness and metallic (24 B); a
    sampling vertex's four draws and point (28 B); a shooting one's albedo
    (12 B); the light rows once. N1b: every ray's valid flag in and
    contribution out (13 B); pending where the flag is false (12 B)."""
    from cs397raytracingsp22_tpu_torch.models import materials as mat

    did, shoot, sh_valid = out
    live_hit = live & hit.valid
    par = live_hit & (hit.mtype == mat.PARAMETERIZED) & ((hit.normal * hit.normal).sum(1) > 0)
    n = live.numel()
    sample = (43 * n + int(live.sum()) + 16 * int(live_hit.sum()) + 24 * int(par.sum())
              + 28 * int(did.sum()) + 12 * int(shoot.sum())
              + 52 * sd.n_lt_tri + 28 * sd.n_lt_sph)
    contrib = 13 * n + 12 * int((~sh_valid).sum())
    return sample, contrib


def nee_phase(dev) -> dict:
    """Phase 39: N1 against its plain versions on the first NEE bounce of
    the NEE bench chunk 0; returns the kernels line's row."""
    import dataclasses

    from cs397raytracingsp22_tpu_torch.ops.intersect import intersect_scene
    from cs397raytracingsp22_tpu_torch.ops.kernels import nee as n1
    from cs397raytracingsp22_tpu_torch.render import integrator, nee
    from cs397raytracingsp22_tpu_torch.scenes import bench_scene
    from cs397raytracingsp22_tpu_torch.utils import threefry

    key = threefry.key_words(2**33 + 39)
    sc = bench_scene.build(**RESOLVE_NEE_FRAME)
    sc = dataclasses.replace(sc, camera=dataclasses.replace(sc.camera, nee=True))
    sd, cam = sc.compile(device=dev), sc.camera
    _, (o, d, uids) = chunk0(sd, cam, key)
    real, got = n1.nee_sample, {}

    def recorder(*args):
        got["args"] = args
        raise _Captured

    n1.nee_sample = recorder
    try:
        integrator.path_trace_shrink(sd, o, d, uids, key, cam.path_depth, cam.max_trace_dist,
                                     nee=True)
    except _Captured:
        pass
    finally:
        n1.nee_sample = real
    del o, d, uids
    args = got["args"]
    _, hit, d_in, u_choice, live, u, max_dist = args

    def check(name, a, b):
        if a.dtype != b.dtype or a.shape != b.shape:
            raise AssertionError(f"N1 {name} is {a.dtype} {tuple(a.shape)}, the plain "
                                 f"version's {b.dtype} {tuple(b.shape)}")
        if a.dtype == torch.float32:
            same = (a.view(torch.int32) == b.view(torch.int32)) | (a.isnan() & b.isnan())
        else:
            same = a == b
        if not bool(same.all()):
            bad = int((~same).reshape(a.shape[0], -1).any(dim=1).sum())
            raise AssertionError(f"N1 {name} differs from the plain version on {bad} of "
                                 f"{a.shape[0]} rays")

    before = dict(n1.LAUNCHES)
    out = n1.nee_sample(*args)
    want = nee.nee_sample_plain(*args)
    for name, a, b in zip(("did", "shoot", "sh_o", "sh_dir", "t_max", "pending"), out, want):
        check(name, a, b)
    did, shoot, sh_o, sh_dir, t_max, pending = out
    sh = intersect_scene(sd, sh_o, sh_dir, integrator.PATH_T_MIN, t_max, u[:, 4:].contiguous())
    contrib = n1.nee_contrib(sh.valid, pending)
    check("contrib", contrib, nee.nee_contrib_plain(sh.valid, pending))
    torch.cuda.synchronize()
    if n1.LAUNCHES != {k: v + 1 for k, v in before.items()}:
        raise AssertionError(f"N1: the calls launched {n1.LAUNCHES}, from {before}")
    n = live.numel()
    rays = dict(d_in=d_in, u_choice=u_choice, live=live)
    bufs = dict(zip(("did", "shoot", "sh_o", "sh_dir", "t_max", "pending"), out))
    a_ms = cuda_ms(lambda: n1.launch_sample(sd, hit, rays, u, max_dist, bufs), 20)
    b_ms = cuda_ms(lambda: n1.launch_contrib(sh.valid, pending, contrib), 20)
    pa_ms = cuda_ms(lambda: nee.nee_sample_plain(*args), 3)
    pb_ms = cuda_ms(lambda: nee.nee_contrib_plain(sh.valid, pending), 3)
    by_a, by_b = nee_bytes(sd, hit, live, (did, shoot, sh.valid))
    ba_ms, _ = bound(by_a, 0)
    bb_ms, _ = bound(by_b, 0)
    (ra, sa), (rb, sb) = n1.kernel_attrs("nee_sample"), n1.kernel_attrs("nee_contrib")
    log("nee", f"N1 bench NEE bounce 0 ({n} rays, {int(did.sum())} samples, {int(shoot.sum())} "
        f"shadow rays, {int((contrib.amax(dim=1) > 0).sum())} lit): every output bit-identical "
        f"to the plain versions; N1a ({ra} registers, {sa} B local) {a_ms:.4f} ms (bound "
        f"{ba_ms:.4f} ms, bytes: {ba_ms / a_ms:.1%}), plain torch {pa_ms:.3f} ms "
        f"({pa_ms / a_ms:.0f}x); N1b ({rb} registers, {sb} B local) {b_ms:.4f} ms (bound "
        f"{bb_ms:.4f} ms, bytes: {bb_ms / b_ms:.1%}), plain torch {pb_ms:.3f} ms")
    return {"name": "nee", "route": "cuda", "source": "cs397raytracingsp22_tpu_torch/csrc/nee.cu",
            "replaces": None, "launches": 0, "max_abs_err": 0.0, "ms": a_ms + b_ms,
            "plain_ms": pa_ms + pb_ms, "bound_ms": ba_ms + bb_ms, "bound_by": "bytes",
            "library_ms": None}


def draws_phase(dev) -> list:
    """Phase 35: D1's three entry points against their plain versions at
    the main path's shapes; returns the kernels line's rows."""
    from cs397raytracingsp22_tpu_torch.ops.kernels import draws
    from cs397raytracingsp22_tpu_torch.scenes import bench_scene
    from cs397raytracingsp22_tpu_torch.utils import rng as rnglib
    from cs397raytracingsp22_tpu_torch.utils import threefry

    cam = bench_scene.build(512, 512, spp=64, path_depth=8).camera
    key = threefry.key_words(2**33 + 5)
    rows = []
    for n in (1 << 20, 1 << 22):
        ids = torch.arange(n // 64, dtype=torch.int32, device=dev) * 3  # a strided chunk
        uids = torch.arange(n, dtype=torch.int32, device=dev) * 7919 - 2**30
        cases = [("camera_rays", "64 spp", lambda: draws.camera_rays(cam, key, ids, 64, 64),
                  lambda: cam.generate_rays_plain(key, ids, 64, 64), 4 * n // 64 + 24 * n, 2)]
        for v in (0, 2):
            site = rnglib.SITE_BOUNCE0 + 3
            cases.append(("bounce_draws", f"{v} volume uniforms",
                          lambda v=v, site=site: draws.bounce_draws(key, uids, site, v),
                          lambda v=v, site=site: draws.bounce_draws_plain(key, uids, site, v),
                          n * (4 + 12 + 4 + 4 * v), 1 + (v + 1) // 2))
        for m in (4, 6):
            site = rnglib.SITE_NEE0 + 3
            cases.append(("counter_uniforms", f"{m} uniforms",
                          lambda m=m, site=site: draws.counter_uniforms(key, uids, site, m),
                          lambda m=m, site=site: threefry.counter_uniforms(key, uids, site, m),
                          n * (4 + 4 * m), (m + 1) // 2))
        for entry, what, kern, plain, n_bytes, blocks in cases:
            got, want = kern(), plain()
            if torch.is_tensor(got):
                got, want = (got,), (want,)
            for a, b in zip(got, want):
                if not torch.equal(a.contiguous().view(torch.int32), b.contiguous().view(
                        torch.int32)):
                    raise AssertionError(f"D1 {entry} ({what}, {n} rays) differs from its plain "
                                         "version")
            k_ms, p_ms = cuda_ms(kern, 20), cuda_ms(plain, 3)
            t_b = n_bytes / PEAK_BYTES
            t_o = n * (blocks * THREEFRY_OPS + KEY_SCHEDULE_OPS) / INT_PEAK
            b_ms, by = max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "integer operations")
            log("draws", f"D1 {entry} ({what}) on {n} rays: bit-identical to the plain version; "
                f"{k_ms:.4f} ms (bound {b_ms:.4f} ms, {by}: {b_ms / k_ms:.1%}), plain torch "
                f"{p_ms:.3f} ms ({p_ms / k_ms:.0f}x)")
            if n == 1 << 22 and what in ("64 spp", "2 volume uniforms", "4 uniforms"):
                rows.append({"name": f"draws_{entry}", "route": "cuda",
                             "source": "cs397raytracingsp22_tpu_torch/csrc/draws.cu",
                             "replaces": None, "launches": 0, "max_abs_err": 0.0, "ms": k_ms,
                             "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": by,
                             "library_ms": None})
    return rows


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
    once, and a big mesh's BVH rows and triangle rows once; operations =
    the tests that a strided sample's segments need (every analytic
    primitive, the superleaf-tree walk's node tests and triangles and the
    big mesh's BVH walk's box tests and triangles, from the plain path's
    stats), scaled to the launch. The
    work also holds the flat superleaf scan's count ("boxes": every box
    on every segment), its operations and its bound (flat_ops, flat_ms),
    the yardstick of K1 before the tree."""
    from cs397raytracingsp22_tpu_torch.render import integrator

    idx = torch.arange(0, o.shape[0], stride, device=o.device)
    st = {}
    _, segs = integrator.path_trace(data, o[idx], d[idx], uids[idx], key, depth, max_dist,
                                    stats=st)
    w = {k: int(st[k].sum()) for k in ("boxes", "nodes", "tris", "big_nodes", "big_tris")}
    w["segments"] = int(segs)
    scale = o.shape[0] / idx.numel()
    common = (w["segments"] * analytic_ops(data) + (w["tris"] + w["big_tris"]) * OPS["mt"]
              + w["big_nodes"] * OPS["box"])
    ops = scale * (common + w["nodes"] * OPS["box"])
    flat_ops = scale * (common + w["boxes"] * OPS["box"])
    n_bytes = (o.shape[0] * (12 + 12 + 4 + 12 + 4)
               + nbytes(data.kscene, data.kmesh_tri, data.kmesh_nrm, data.ksl_tree)
               + sum(nbytes(m.bvh_nodes, m.bvh_tri4) for i, m in enumerate(data.meshes)
                     if i not in data.dense_mesh_ids))
    ms, by = bound(n_bytes, ops)
    w.update(rays=idx.numel(), scale=scale, ops=ops, bytes=n_bytes, flat_ops=flat_ops,
             flat_ms=bound(n_bytes, flat_ops)[0])
    return ms, by, w


def k2_bound_of(sd, ins, idx) -> tuple[float, str, dict]:
    """(bound ms, bound_by, work) of one K2 launch on ins = (o, d, t_min,
    t_max, u_vol): operations = every analytic test on every ray and the
    dense-mesh walk's node and triangle tests that the plain version counts
    on the rays idx, scaled to the launch; bytes = o, d, t_min, t_max and
    one u_vol column per volume in (it reads no padding column), 37 B of
    outputs out, the scene table and any dense-mesh rows and superleaf tree
    once. The work holds ops, bytes and the dense-mesh triangles a sampled
    ray ("tris")."""
    from cs397raytracingsp22_tpu_torch.ops.kernels import scene_intersect

    n = ins[0].shape[0]
    st = {}
    scene_intersect.scene_intersect_plain(sd, *[x[idx] for x in ins], stats=st)
    scale = n / idx.numel()
    ops = n * analytic_ops(sd) + scale * (int(st["nodes"].sum()) * OPS["box"]
                                          + int(st["tris"].sum()) * OPS["mt"])
    n_bytes = (n * (12 + 12 + 4 + 4 + 4 * sd.n_volumes + 37) + nbytes(sd.kscene)
               + (nbytes(sd.kmesh_tri, sd.ksl_tree) if sd.dense_mesh_ids else 0))
    ms, by = bound(n_bytes, ops)
    return ms, by, dict(ops=ops, bytes=n_bytes, tris=int(st["tris"].sum()) / idx.numel())


def k3_bound(mesh, ins, idx) -> tuple[float, str, dict]:
    """(bound ms, bound_by, work) of one K3 launch on ins = (o, d, t_min,
    t_max), counted on the threaded walk (traverse, the yardstick of the
    kernels line): bytes = the rays in, hit, t, tri, u, v out, the mesh's
    node arrays and triangles once; operations = the interior boxes and
    triangles that traverse tests on the rays idx, scaled to the launch,
    and the three reciprocals of each ray. The work also holds the ordered
    walk's own counts (traverse_packed, the kernel's walk: "*_p") and its
    bound over the packed rows (ms_p, by_p), triangles at OPS["mt"] since
    their edges come formed."""
    from cs397raytracingsp22_tpu_torch.ops.kernels import tri_scan_big

    n = ins[0].shape[0]
    scale = n / idx.numel()
    sub = [x[idx] for x in ins]
    st, sp = {}, {}
    tri_scan_big.tri_scan_big_plain(mesh, *sub, stats=st)
    tri_scan_big.tri_scan_big_packed(mesh, *sub, stats=sp)
    w = dict(boxes=int(st["boxes"].sum()), tris=int(st["tris"].sum()),
             max_boxes=int(st["boxes"].max()), max_tris=int(st["tris"].max()))
    w.update({f"{k}_p": int(sp[k].sum()) for k in ("boxes", "nodes", "tris", "pushes")})
    w.update(max_boxes_p=int(sp["boxes"].max()), max_tris_p=int(sp["tris"].max()))
    # divergence: a group of 32 rays costs what its busiest ray does (node
    # or box tests plus triangles, each a step with its own loads)
    for key, steps in (("warp", st["boxes"] + st["tris"]), ("warp_p", sp["nodes"] + sp["tris"])):
        g = steps[:steps.numel() // 32 * 32].view(-1, 32).double()
        w[key] = float(g.max(dim=1).values.mean() / g.mean())
    ops = scale * (w["boxes"] * OPS["box"] + w["tris"] * OPS["mt_verts"]) + n * 3
    io = nbytes(*ins) + n * (1 + 4 + 4 + 4 + 4)
    n_bytes = io + nbytes(mesh.bounds_min, mesh.bounds_max, mesh.skip, mesh.leaf_start,
                          mesh.leaf_count, mesh.tri_verts)
    ms, by = bound(n_bytes, ops)
    ops_p = scale * (w["boxes_p"] * OPS["box"] + w["tris_p"] * OPS["mt"]) + n * 3
    bytes_p = io + nbytes(mesh.bvh_nodes, mesh.bvh_tri4)
    ms_p, by_p = bound(bytes_p, ops_p)
    w.update(ops=ops, bytes=n_bytes, ops_p=ops_p, bytes_p=bytes_p, ms_p=ms_p, by_p=by_p)
    return ms, by, w


def k2_config(dev, scenes: dict) -> None:
    """Phase 11's config-k2 line: K2's registers and spills (both
    instantiations: the walk's few bytes of spill stay, PERF.md),
    and for each scene (`scenes`, then config 4 on its stand-ins and the
    kitchen sink, compiled here) the bytes a block stages, the resident
    blocks an SM, the persistent grid of a 1,048,576-ray and a
    4,194,304-ray launch and the tiles taken by the fixed rule before the
    ticket."""
    from cs397raytracingsp22_tpu_torch.ops.kernels import scene_intersect
    from cs397raytracingsp22_tpu_torch.scenes import kitchen_sink, textured_spheres

    scenes = dict(scenes)
    scenes["config 4"] = textured_spheres.build(
        16, 16, spp=1, asset_dir=textured_spheres.stand_in_dir()).compile(device=dev)
    scenes["kitchen sink"] = kitchen_sink.build().compile(device=dev)
    attrs = [scene_intersect.kernel_attrs(dense) for dense in (True, False)]
    parts = []
    for name, sd in scenes.items():
        c1, c4 = (scene_intersect.launch_config(sd, n) for n in (1 << 20, 1 << 22))
        parts.append(f"{name} {c1['smem_bytes']} B staged ({len(sd.dense_mesh_ids)} dense meshes, "
                     f"{sd.ksl_tree.shape[0]} tree nodes): {c1['blocks_per_sm']} blocks an SM "
                     f"({c1['blocks_per_sm'] * c1['threads'] // 32} warps), grid {c1['grid']} / "
                     f"{c4['grid']} blocks, {c1['static_tiles']} / {c4['static_tiles']} of "
                     f"{c1['tiles']} / {c4['tiles']} tiles by the fixed rule")
    log("config-k2", f"K2 {attrs[0][0]} registers/thread and {attrs[0][1]} B local with the "
        f"dense-mesh walk and the ticket, {attrs[1][0]} and {attrs[1][1]} B without; blocks of "
        f"{c1['threads']} threads on {c1['sms']} SMs, tiles of {c1['tile']} rays; grids for "
        f"1,048,576 / 4,194,304 rays; " + "; ".join(parts))


def staged_phases(dev, data6k, width: int, height: int, spp: int, depth: int) -> list:
    """Phases 9-11 and 13 and the bounds of K2 and K3 (see the module
    docstring): data6k is the bench scene with teapot_6k compiled at
    width x height; the 32k bench scene is built at the same size. Returns
    the kernels line's entries of K2, K3 and K1's big-mesh instantiation."""
    from cs397raytracingsp22_tpu_torch.ops import intersect as isect
    from cs397raytracingsp22_tpu_torch.ops.kernels import bounce, scene_intersect, tri_scan_big
    from cs397raytracingsp22_tpu_torch.render import driver, integrator
    from cs397raytracingsp22_tpu_torch.scenes import bench_teapot_32k
    from cs397raytracingsp22_tpu_torch.tools.compare_k3 import aimed_rays
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
    k2_in = None
    k3_ins = {}  # K3's inputs by bounce

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
                ms = k2_ms(sd, inputs)
                b_ms, b_by, _ = k2_bound_of(sd, inputs, idx)
                log("parity-k2", f"{label} bounce {b}: one K2 launch of {n32} rays "
                    f"({int(alive.sum())} live); every {SAMPLE_STRIDE}th ray ({n}) alone is "
                    f"bit-identical to the launch's rows; {n_same}/{n} same (code, idx, mat) as "
                    f"the plain version, {n_exact}/{n} bit-identical, t/u/v/normal max |diff| "
                    f"{err:.3g}; sampled winners: "
                    f"{int((codes < 0).sum())} miss, {int((codes == 4).sum())} dense mesh; K2 "
                    f"{ms:.4f} ms a launch (bound {b_ms:.4f} ms, {b_by}; K2 at {b_ms / ms:.1%} of "
                    f"it)")
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
                    k3_ins[b] = ins3
                    if b == 0:
                        k2_in = inputs
            if b < 2:  # on to the next bounce through the staged path (K2 + K3)
                o, d, thr, rad, alive, _, _ = integrator.bounce_update(
                    sd, o, d, thr, rad, alive, uid32, key, b, max_dist,
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

    def render32(staged: bool = True):
        """The 32k image through render_to_image: on the staged path (K1's
        gate closed for the call), or on the scene's own route, K1."""
        gate = bounce.scene_is_simple
        if staged:
            bounce.scene_is_simple = lambda scene: False
        try:
            return driver.render_to_image(sc32, device=dev, seed=0, verbose=False,
                                          scene_data=sd32)
        finally:
            bounce.scene_is_simple = gate

    render32()  # warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    scene_intersect.LAUNCHES = tri_scan_big.LAUNCHES = 0  # the staged main path's counts
    draws_reset()
    r1_reset()
    runs32 = [render32() for _ in range(3)]
    k2_launches, k3_launches = scene_intersect.LAUNCHES, tri_scan_big.LAUNCHES  # read just after
    draws_read()
    r1_read()
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

    if not bounce.scene_is_simple(sd32):
        raise AssertionError("K1's gate refuses the 32k bench scene")
    # K1 (bounce_kernel_big) on the chunk against the plain path, segments ray by ray
    k1_full = lambda: bounce.path_trace_cuda(sd32, o32, dir32, uid32, key, depth, max_dist)  # noqa: E731
    rad_full, _ = k1_full()
    idx_k1 = torch.arange(0, n32, K1_BIG_STRIDE, device=dev)
    sub = tuple(x[idx_k1].contiguous() for x in (o32, dir32, uid32))
    st_k1, st_ref = {}, {}
    rad_s, _ = bounce.path_trace_cuda(sd32, *sub, key, depth, max_dist, stats=st_k1)
    if not torch.equal(rad_s, rad_full[idx_k1]):
        raise AssertionError("K1 32k chunk: the sampled rays traced alone differ from the launch's rows")
    ref_rad, _ = integrator.path_trace(sd32, *sub, key, depth, max_dist, stats=st_ref)
    if not bool(torch.isfinite(rad_s).all()) or float(ref_rad.max()) <= 0.0:
        raise AssertionError("K1 32k chunk: non-finite radiance, or a black plain path")
    ok = torch.isclose(rad_s, ref_rad, rtol=RTOL, atol=ATOL).all(dim=1)
    same = st_k1["segs"] == st_ref["segs"]
    m = idx_k1.numel()
    if float(ok.float().mean()) < MIN_FRAC or float(same.float().mean()) < MIN_FRAC:
        raise AssertionError(f"K1 32k chunk: {int(ok.sum())}/{m} rays within rtol {RTOL} atol "
                             f"{ATOL}, {int(same.sum())}/{m} with the plain path's segments")
    reached = int((st_ref["big_tris"] > 0).sum())
    k1_big_err = float((rad_s - ref_rad).abs().max())
    k1_big_ms = cuda_ms(k1_full, 3)
    k1_big_bound, k1_big_by, wb = k1_bound(sd32, o32, dir32, uid32, key, depth, max_dist,
                                           SAMPLE_STRIDE)
    k1_sub_ms = cuda_ms(lambda: bounce.path_trace_cuda(sd32, *sub, key, depth, max_dist), 3)
    k1_big_plain_ms = cuda_ms(lambda: integrator.path_trace(sd32, *sub, key, depth, max_dist), 1)
    log("parity-32k-k1", f"teapot_32k {width}²x{spp}spp depth {depth}, chunk 0 of {nch32}: one "
        f"launch of bounce_kernel_big on {n32} rays; every {K1_BIG_STRIDE}th ray ({m}) traced "
        f"alone is bit-identical to the launch's rows; {int(ok.sum())}/{m} within rtol {RTOL} "
        f"atol {ATOL} of the plain path (integrator.path_trace on the card), {int(same.sum())}/{m} "
        f"with its segment count, max |diff| {k1_big_err:.3g}; {reached} sampled paths test the "
        f"teapot's triangles; K1 {k1_big_ms:.3f} ms a launch, bound {k1_big_bound:.4f} ms "
        f"({k1_big_by}; {wb['big_nodes'] / wb['segments']:.2f} BVH boxes and "
        f"{wb['big_tris'] / wb['segments']:.2f} teapot triangles a segment on every "
        f"{SAMPLE_STRIDE}th ray; K1 at {k1_big_bound / k1_big_ms:.1%} of it); on the {m} "
        f"sampled rays K1 {k1_sub_ms:.3f} ms, the plain path {k1_big_plain_ms:.1f} ms")
    del rad_full, rad_s, ref_rad
    render32(staged=False)  # warm
    k1_before, k2_before, k3_before = bounce.LAUNCHES, scene_intersect.LAUNCHES, tri_scan_big.LAUNCHES
    runs_k1 = [render32(staged=False) for _ in range(3)]
    k1_n = bounce.LAUNCHES - k1_before
    if k1_n != 3 * st32.chunks or (scene_intersect.LAUNCHES, tri_scan_big.LAUNCHES) != (
            k2_before, k3_before):
        raise AssertionError(f"the 32k renders on their own route launched K1 {k1_n} times for "
                             f"{3 * st32.chunks} chunks, or K2 or K3")
    img_k1 = runs_k1[0][0]
    diff = np.abs(img_k1.astype(np.int64) - img32.astype(np.int64))
    if (diff <= 1).mean() < K1_BIG_IMAGE_FRAC:
        raise AssertionError(f"K1's 32k image lies within 1 u8 of the staged one on "
                             f"{(diff <= 1).mean():.4f} of the subpixels")
    walls_k1 = [st.wall_seconds for _, st in runs_k1]
    log("full-32k-k1", f"bench teapot_32k via render_to_image on its own route: {k1_n // 3} K1 "
        f"launches an image (bounce_kernel_big, {bounce.kernel_attrs(False, False, True)[0]} "
        f"registers), no K2 or K3; {sum(walls_k1) / 3:.4f} s per image (mean of 3: "
        f"{', '.join(f'{w:.4f}' for w in walls_k1)}) against the staged {mean32:.4f} s; image "
        f"within 1 u8 of the staged one on {(diff <= 1).mean():.4%} of the subpixels, mean "
        f"|diff| {diff.mean():.4f}")

    # ---- 11. K2 and K3 timing at the main path's shapes ----
    k2_dev_ms = k2_ms(sd32, k2_in)
    k2_wrap_ms = cuda_ms(lambda: scene_intersect.scene_intersect_cuda(sd32, *k2_in), 10)
    k2_plain_ms = cuda_ms(lambda: scene_intersect.scene_intersect_plain(sd32, *k2_in), 2)
    k3_in = k3_ins[0]
    k3_ms = cuda_ms(lambda: tri_scan_big.tri_scan_big_cuda(mesh32, *k3_in), 10)
    k3_plain_ms = cuda_ms(lambda: tri_scan_big.tri_scan_big_plain(mesh32, *k3_in), 1)
    k3_b2_ms = cuda_ms(lambda: tri_scan_big.tri_scan_big_cuda(mesh32, *k3_ins[2]), 10)
    k3_aim_ms = cuda_ms(lambda: tri_scan_big.tri_scan_big_cuda(mesh32, *aim_in), 10)
    k2_bound, k2_by, w2 = k2_bound_of(sd32, k2_in, idx)
    log("timing-staged", f"teapot_32k chunk 0 bounce 0 ({n32} rays): K2 {k2_dev_ms:.4f} ms "
        f"(bound {k2_bound:.4f} ms, {k2_by}; K2 at {k2_bound / k2_dev_ms:.1%} of it; "
        f"{k2_wrap_ms:.4f} ms a call through the wrapper), plain {k2_plain_ms:.3f} ms "
        f"({k2_plain_ms / k2_dev_ms:.1f}x); K3 {k3_ms:.3f} ms, plain "
        f"{k3_plain_ms:.3f} ms ({k3_plain_ms / k3_ms:.1f}x); K3 on the bounce-2 rays "
        f"{k3_b2_ms:.3f} ms; K3 on {n32} rays aimed at the teapot {k3_aim_ms:.3f} ms")
    regs, spill = tri_scan_big.kernel_attrs()
    cfg = tri_scan_big.launch_config(mesh32)
    log("config-k3", f"teapot_32k ({mesh32.bvh_nodes.shape[0]} node rows of 64 B, stack depth "
        f"{mesh32.bvh_depth}): {regs} registers/thread, {spill} B local; blocks of "
        f"{cfg['threads']} threads, {cfg['threads']} x {mesh32.bvh_depth} stack entries of 8 B: "
        f"{cfg['smem_bytes']} B of shared memory a block; "
        f"{cfg['blocks_per_sm']} resident blocks an SM ({cfg['blocks_per_sm'] * cfg['threads'] // 32}"
        f" warps)")
    if spill:
        raise AssertionError(f"K3 spills {spill} B")
    k2_config(dev, {"teapot_6k (NEE, Phong)": data6k, "teapot_32k": sd32})

    # ---- 12. bounds of K2 and K3 at phase 11's inputs ----
    log("bound-k2", f"teapot_32k chunk 0 bounce 0 ({n32} rays): {analytic_ops(sd32)} FP32 ops of "
        f"analytic tests per ray, {w2['tris']:.2f} dense-mesh triangles per sampled ray; "
        f"{w2['ops']:.4g} ops, {w2['bytes']:.4g} B -> bound {k2_bound:.4f} ms ({k2_by}); K2 "
        f"{k2_dev_ms:.4f} ms, at {k2_bound / k2_dev_ms:.1%} of it")
    k3b = {}
    for what, ins3, ms in (("chunk 0 bounce 0", k3_in, k3_ms),
                           ("chunk 0 bounce 2", k3_ins[2], k3_b2_ms),
                           ("aimed at the teapot", aim_in, k3_aim_ms)):
        b_ms, b_by, w = k3b[what] = k3_bound(mesh32, ins3, idx)
        m = idx.numel()
        log("bound-k3", f"teapot_32k {what} ({n32} object-space rays); every {SAMPLE_STRIDE}th "
            f"ray ({m}) traversed by the plain versions: the threaded walk (traverse) tests "
            f"{w['boxes'] / m:.2f} interior boxes and {w['tris'] / m:.2f} triangles per ray (max "
            f"{w['max_boxes']} and {w['max_tris']}); {w['ops']:.4g} ops, {w['bytes']:.4g} B -> "
            f"bound {b_ms:.4f} ms ({b_by}); the ordered walk (traverse_packed) opens "
            f"{w['nodes_p'] / m:.2f} nodes, takes {w['boxes_p'] / m:.2f} slab tests and "
            f"{w['tris_p'] / m:.2f} triangles and pushes {w['pushes_p'] / m:.2f} per ray (max "
            f"{w['max_boxes_p']} and {w['max_tris_p']}); {w['ops_p']:.4g} ops, "
            f"{w['bytes_p']:.4g} B -> bound {w['ms_p']:.4f} ms ({w['by_p']}); the busiest of 32 "
            f"sampled rays takes {w['warp']:.2f}x the mean steps (threaded), {w['warp_p']:.2f}x "
            f"(ordered); K3 {ms:.3f} ms")

    # ---- 13. device trace of one 32k render ----
    tr = device_trace("teapot_32k", render32,
                      {"K2": "scene_intersect_kernel", "K3": "bvh_", "sort": "sort"},
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
        "ms": k2_dev_ms,
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
    }, {
        "name": "mega_bounce_big",
        "route": "cuda",
        "source": "cs397raytracingsp22_tpu_torch/csrc/bounce.cu",
        "replaces": "cs397raytracingsp22_tpu/ops/pallas/bounce.py:1480",
        "launches": k1_n,
        "max_abs_err": k1_big_err,
        "ms": k1_big_ms,
        "plain_ms": None,  # on the sample only: parity-32k-k1
        "bound_ms": k1_big_bound,
        "bound_by": k1_big_by,
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
            f"{w['nodes'] / w['segments']:.4f} superleaf-tree nodes and "
            f"{w['tris'] / w['segments']:.4f} triangles tested (the flat scan: "
            f"{w['boxes'] / w['segments']:.2f} boxes); launch {w['ops']:.4g} FP32 ops, "
            f"{w['bytes']:.4g} B -> bound {ms:.4f} ms ({by}); the flat scan's "
            f"{w['flat_ops']:.4g} ops -> {w['flat_ms']:.4f} ms")
    return out


def compare_k1(what: str, rad, segs, k1_rad, k1_segs, depth: int) -> tuple[int, int, float]:
    """K4's rows against K1's on the same rays, by K1's contract (compare()).
    Returns (rows bit-identical to K1's, rows outside the tolerance, max
    |diff|)."""
    n_bad, err, seg_diff = compare(rad, segs, k1_rad, k1_segs, depth)
    same = int((rad == k1_rad).all(dim=1).sum())
    if same < K4_MIN_SAME * rad.shape[0]:
        raise AssertionError(f"{what}: {same}/{rad.shape[0]} rows bit-identical to K1's")
    log("k4-vs-k1", f"{what}: {same}/{rad.shape[0]} rows bit-identical to K1's, "
        f"{rad.shape[0] - n_bad} within rtol {RTOL} atol {ATOL}, max |diff| {err:.3g}; segments "
        f"K4 {int(segs)}, K1 {int(k1_segs)} (diff {seg_diff} <= {depth}x{n_bad})")
    return same, n_bad, err


def k4_tiles(wavefront, data, st: dict) -> str:
    """The tiles each K4 launch walked (its device counter) against
    ceil(live / the scene's tile); raises if they differ."""
    tiles, live, tile = st["tiles"].tolist(), st["live"].tolist(), wavefront.tile_rays(data)
    want = [-(-m // tile) for m in live]
    if tiles != want:
        raise AssertionError(f"K4 walked tiles {tiles}, not ceil(live / {tile}) {want}")
    return f"tiles walked a launch {tiles} = ceil(live / {tile})"


def k4_steps(wavefront, data, o, d, uids, key, depth: int, max_dist: float,
             rows_out: bool = False) -> dict:
    """One K4 frame run launch by launch as path_trace_wavefront runs it,
    with CUDA events around the set-up (workspace and buffers) and each
    launch: {"setup": ms, "k4": [ms a launch]}. With rows_out, instead of
    times, "alive": for each launch but the last, the caller indices of the
    rays it kept (read from its output rows)."""
    from cs397raytracingsp22_tpu_torch.render import integrator
    from cs397raytracingsp22_tpu_torch.utils import threefry

    ev = [torch.cuda.Event(enable_timing=True) for _ in range(depth + 2)]
    key_pair = threefry.key_pair(key)
    n = o.shape[0]
    torch.cuda.synchronize()
    ev[0].record()
    rad = torch.empty((n, 3), dtype=torch.float32, device=o.device)
    ws = wavefront.Workspace(n, depth, o.device)
    bufs = [torch.empty((n, wavefront.ROW), dtype=torch.float32, device=o.device)
            for _ in range(2)]
    ev[1].record()
    alive = []
    for b in range(depth):
        last = b == depth - 1
        wavefront.step_cuda(data, bufs[(b - 1) % 2] if b else None, None if last else bufs[b % 2],
                            rad, ws, key_pair, b, last, integrator.PATH_T_MIN, max_dist,
                            camera=None if b else (o, d, uids))
        ev[2 + b].record()
        if rows_out and not last:
            m = int(ws.live[b + 1])
            alive.append(bufs[b % 2][:m].view(torch.int32)[:, wavefront.STATE_IDX].long())
    torch.cuda.synchronize()
    if rows_out:
        return {"alive": alive, "live": ws.live[:depth].tolist()}
    return dict(setup=ev[0].elapsed_time(ev[1]),
                k4=[ev[1 + b].elapsed_time(ev[2 + b]) for b in range(depth)])


def k4_state_bytes(n: int, live: list) -> tuple[int, int]:
    """(the least state K4 moves beside K1's bytes, what the design before
    compaction moved into the kernel moved). The least: each ray entering a
    bounce after the first has its 64-byte row written once by the bounce
    before and read once, and the live counts (4 bytes each). The earlier
    design: per launch the 4-byte alive flag of every ray and, for each live
    ray, its 64-byte row read, 48 bytes written (16 on the emission-only
    last launch) and its alive written; per partition alive, every row read
    and written and the new alive."""
    least = sum(m * (64 + 64) for m in live[1:]) + 4 * (len(live) + 1)
    launches = sum(n * 4 + m * (64 + 48 + 4) for m in live[:-1]) + n * 4 + live[-1] * (64 + 16 + 4)
    return least, launches + (len(live) - 1) * n * (4 + 64 + 64 + 4)


def k4_ray_segments(wavefront, data, o, d, uids, key, depth: int, max_dist: float):
    """Each ray's segments in one K4 frame (1 + the launches that kept it),
    int64 (N,), and the live counts entering each bounce."""
    run = k4_steps(wavefront, data, o, d, uids, key, depth, max_dist, rows_out=True)
    segs = torch.ones((o.shape[0],), dtype=torch.int64, device=o.device)
    for idx in run["alive"]:
        segs[idx] += 1
    return segs, run["live"]


def open_frame_phase(dev, wavefront, bounce) -> None:
    """Phase 14b (see the module docstring): K4 against K1 on the open
    teapot frame. Its K4 launches do not count toward the kernels line."""
    from cs397raytracingsp22_tpu_torch import ShadingMode
    from cs397raytracingsp22_tpu_torch.render import driver
    from cs397raytracingsp22_tpu_torch.scenes import teapot

    side, spp = 512, 64
    sc = teapot.build(side, side, spp=spp, shading=ShadingMode.PATH_TRACE)
    data = sc.compile(device=dev)
    cam = sc.camera
    o, d, uids = driver._gen_chunk_rays(
        cam, torch.arange(side * side, dtype=torch.int32, device=dev), 0, 0, spp, 1)
    n, depth, max_dist = o.shape[0], cam.path_depth, cam.max_trace_dist
    st, k1_st = {}, {}
    rad, segs = wavefront.path_trace_wavefront(data, o, d, uids, 0, depth, max_dist, stats=st)
    k1_rad, k1_segs = bounce.path_trace_cuda(data, o, d, uids, 0, depth, max_dist, stats=k1_st)
    live = st["live"].tolist()
    k1_live = [int((k1_st["segs"] > b).sum()) for b in range(depth)]
    ray_segs, step_live = k4_ray_segments(wavefront, data, o, d, uids, 0, depth, max_dist)
    flips = int((ray_segs != k1_st["segs"]).sum())
    if step_live != live:
        raise AssertionError(f"open teapot frame: live {live}, launch by launch {step_live}")
    if flips > (1.0 - MIN_FRAC) * n or abs(int(segs) - int(k1_segs)) > depth * flips or any(
            abs(a - b) > flips for a, b in zip(live, k1_live)):
        raise AssertionError(f"open teapot frame: K4 segments {int(segs)} live {live}, K1 "
                             f"{int(k1_segs)} live {k1_live}, {flips} rays' paths differ")
    if not (bool(torch.isfinite(rad).all()) and torch.equal(rad, k1_rad)):
        raise AssertionError("open teapot frame: K4's radiance is not K1's")
    log("k4-open", f"open teapot {side}²x{spp}spp depth {depth} ({n} rays): K4 {int(segs)} "
        f"segments, K1 {int(k1_segs)}; live share entering each bounce " + ", ".join(
            f"{m / n:.6f}" for m in live)
        + f" (K1: {', '.join(f'{m / n:.6f}' for m in k1_live)}); "
        f"{flips} rays whose path length differs from K1's; {k4_tiles(wavefront, data, st)}; "
        "radiance equal to K1's (a black image: the scene's only light is Phong's)")
    run_k1 = lambda: bounce.path_trace_cuda(data, o, d, uids, 0, depth, max_dist)  # noqa: E731
    run_k4 = lambda: wavefront.path_trace_wavefront(data, o, d, uids, 0, depth, max_dist)  # noqa: E731
    times = {"K1": [], "K4": []}
    for name, fn in (("K1", run_k1), ("K4", run_k4), ("K4", run_k4), ("K1", run_k1)):
        times[name].append(cuda_ms(fn, 3))
    split = k4_steps(wavefront, data, o, d, uids, 0, depth, max_dist)
    log("timing-k4", f"open teapot frame ({n} rays, depth {depth}), CUDA events, mean of 3 after "
        f"a warm run, in turns K1, K4, K4, K1: K1 {', '.join(f'{t:.3f}' for t in times['K1'])} "
        f"ms; K4 path {', '.join(f'{t:.3f}' for t in times['K4'])} ms "
        f"({sum(times['K4']) / sum(times['K1']):.3f}x K1); launch by launch: set-up "
        f"{split['setup']:.3f} ms, K4 launches {sum(split['k4']):.3f} ms ("
        + ", ".join(f"{t:.3f}" for t in split["k4"]) + ")")


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
        f"{m / n:.6f}" for m in live6k) + f" ({live6k[-1]} of {n} rays reach bounce {depth - 1}); "
        + k4_tiles(wavefront, data, st))
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
        f"{m / n64:.6f}" for m in live64) + "; " + k4_tiles(wavefront, d64, st64))
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
    c_split = k4_steps(wavefront, d64, o64, d64r, u64, key, cam.path_depth, cam.max_trace_dist)
    log("timing-k4", f"Cornell chunk ({n64} rays, depth {cam.path_depth}), CUDA events, mean of 3 "
        f"after a warm run, in turns K1, K4, K4, K1: K1 "
        f"{', '.join(f'{t:.3f}' for t in c_times['K1'])} ms; K4 path "
        f"{', '.join(f'{t:.3f}' for t in c_times['K4'])} ms "
        f"({sum(c_times['K4']) / sum(c_times['K1']):.3f}x K1); launch by launch: set-up "
        f"{c_split['setup']:.3f} ms, K4 launches {sum(c_split['k4']):.3f} ms ("
        + ", ".join(f"{t:.3f}" for t in c_split["k4"]) + ")")
    del o64, d64r, u64
    open_frame_phase(dev, wavefront, bounce)

    # ---- 15. K4 timing against K1 on the same rays, launch by launch ----
    run_k1 = lambda: bounce.path_trace_cuda(data, o, d, uids, 0, depth, max_dist)  # noqa: E731
    run_k4 = lambda: wavefront.path_trace_wavefront(data, o, d, uids, 0, depth, max_dist)  # noqa: E731
    turns = [("K1", run_k1), ("K4", run_k4), ("K4", run_k4), ("K1", run_k1)]
    times = {"K1": [], "K4": []}
    for name, fn in turns:
        times[name].append(cuda_ms(fn, 3))
    split = k4_steps(wavefront, data, o, d, uids, 0, depth, max_dist)
    k4_frame = sum(times["K4"]) / 2
    log("timing-k4", f"bench teapot_6k frame ({n} rays, depth {depth}), CUDA events, mean of 3 "
        f"after a warm run, in turns K1, K4, K4, K1: K1 {', '.join(f'{t:.3f}' for t in times['K1'])}"
        f" ms; K4 path {', '.join(f'{t:.3f}' for t in times['K4'])} ms "
        f"({k4_frame / (sum(times['K1']) / 2):.3f}x K1); one frame launch by launch: set-up "
        f"{split['setup']:.3f} ms, K4 launches {sum(split['k4']):.3f} ms ("
        + ", ".join(f"{t:.3f}" for t in split["k4"]) + f"), launches "
        f"{sum(split['k4']) / k4_frame:.1%} of the K4 path")

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

    # ---- 18. K4's bound: K1's counted work plus the least state ----
    k4b = {}
    for (w_, spp_), nr, live in (((ROW_SIDE, ROW_SPP), o_s.shape[0],
                                  [int(x) for x in st_s["live"]]),
                                 ((width, spp), n, live6k)):
        _, _, w = k1b[(w_, spp_)]
        extra, old = k4_state_bytes(nr, live)
        k4b[(w_, spp_)] = bound(w["bytes"] + extra, w["ops"])
        old_ms, old_by = bound(w["bytes"] + old, w["ops"])
        log("bound-k4", f"bench teapot_6k {w_}²x{spp_}spp depth {depth} ({nr} rays): K1's "
            f"{w['ops']:.4g} FP32 ops and {w['bytes']:.4g} B plus {extra:.4g} B of state (each "
            f"row written and read once a bounce, the counts) -> bound "
            f"{k4b[(w_, spp_)][0]:.4f} ms ({k4b[(w_, spp_)][1]}); the count before compaction "
            f"moved into the kernel, {old:.4g} B of state (partitions included) -> "
            f"{old_ms:.4f} ms ({old_by})")

    # ---- 16. device trace of one K4 frame ----
    tr = device_trace("wavefront_frame", run_k4, {"K4": "wavefront_kernel"},
                      absent=("wavefront_partition",))
    log("trace", "wavefront_frame: " + f"{tr['kernels']} kernels, device busy {tr['busy_ms']:.3f} "
        f"ms in a {tr['span_ms']:.3f} ms first-to-last span (idle share {tr['idle']:.2%}), "
        f"{tr['wall_ms']:.3f} ms wall under the profiler; " + ", ".join(
            f"{k} {v:.3f} ms ({tr['shares'][k]:.1%} of busy)" for k, v in tr["parts"].items())
        + f"; wavefront_partition: {tr['wavefront_partition spans']} spans, "
        f"{tr['wavefront_partition kernels']} kernels")
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
    with ClockSampler() as smi:
        k5_ms = cuda_ms(lambda: tri_scan.tri_scan_cuda(mesh, *ins), 5)
    clock = smi.median_clock()
    k5_plain_ms = cuda_ms(lambda: tri_scan.tri_scan_plain(mesh.tri_table, *ins, chunk=16), 1)
    k5_ops = n5 * nt * OPS["mt"]
    k5_bytes = nbytes(*ins) + n5 * (1 + 4 + 4 + 4 + 4) + nbytes(mesh.tri_table)
    k5_bound, k5_by = bound(k5_bytes, k5_ops)
    regs, spill = tri_scan.kernel_attrs()
    log("timing-k5", f"{n5} rays x {nt} triangles: K5 {k5_ms:.3f} ms ({regs} registers/thread, "
        f"{spill} B local; {smi.summary()}), plain {k5_plain_ms:.3f} ms "
        f"({k5_plain_ms / k5_ms:.1f}x); bound {k5_ops:.4g} FP32 ops ({OPS['mt']} a test), "
        f"{k5_bytes:.4g} B -> {k5_bound:.4f} ms ({k5_by}), K5 at {k5_bound / k5_ms:.1%} of it")
    # the issue floor: every operation of a test is an instruction of its own
    # (-fmad=false), and an SM issues 4 warp instructions (128 lanes) a clock
    short, full, ops = k5_test_instructions()
    share = k5_reject_share(mesh.tri_table, *sub5[:2])
    per_test = share * short + (1.0 - share) * full
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    floor_ms = n5 * nt * per_test / (sms * 128 * clock * 1e6) * 1e3
    log("sass-k5", f"the row loop's body: {sum(ops.values())} instructions for "
        f"{ops['FMUL'] / K5_FMUL:g} tests ({ops['FMUL']} FMUL at {K5_FMUL} a test): "
        + " ".join(f"{k} {v}" for k, v in sorted(ops.items(), key=lambda kv: -kv[1]))
        + f"; a test {short:.2f} instructions when rejected before the division, {full:.2f} "
        f"when divided; the sampled rays reject {share:.4f} of their tests, so {per_test:.2f} a "
        f"test; issue floor {per_test:.2f} x {n5} x {nt} / ({sms} SMs x 128 lanes x {clock:.0f} "
        f"MHz) = {floor_ms:.3f} ms (every test divided: {floor_ms * full / per_test:.3f} ms), "
        f"against the {OPS['mt']}-operation bound's {k5_bound:.3f} ms; K5 at "
        f"{floor_ms / k5_ms:.1%} of the issue floor")

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

    def median_clock(self) -> float:
        """The median SM clock (MHz) of the samples inside the run."""
        return float(np.median(self._rows()[0]))

    def _rows(self) -> list:
        rows = []
        for line in self.lines[self._start:]:
            try:
                rows.append([float(x) for x in line.split(",")])
            except ValueError:
                continue
        if not rows:
            raise AssertionError("no clock sample fell inside the run")
        return [np.array(c) for c in zip(*rows)]

    def summary(self) -> str:
        clk, draw, limit = self._rows()
        return (f"SM clock {clk.min():.0f}/{np.median(clk):.0f}/{clk.max():.0f} MHz (min/median/"
                f"max), power draw median {np.median(draw):.1f} W max {draw.max():.1f} W, limit "
                f"{limit[0]:.2f} W ({len(clk)} samples)")


def sass_counts(name: str, loop: bool = False, key: str = "FFMA") -> dict:
    """{function name: {opcode: count}} of the built library's SASS, from
    `cuobjdump -sass` (opcodes without their modifiers). loop=True counts
    only the body of each function's loop that holds the most `key`
    instructions (from a backward branch's target to the branch), and
    leaves out functions without one."""
    counts = {}
    for fn, ins in sass_instructions(name, loop, key).items():
        c: dict = {}
        for _, op, _ in ins:
            c[op] = c.get(op, 0) + 1
        counts[fn] = c
    return counts


def sass_instructions(name: str, loop: bool = False, key: str = "FFMA") -> dict:
    """{function name: [(address, opcode, line)]}: sass_counts' instructions."""
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
    out = {}
    for fn, ins in funcs.items():
        if loop:
            best = (-1, 0, -1)
            for addr, op, line in ins:
                t = re.search(r"BRA\s+0x([0-9a-f]+)", line) if op == "BRA" else None
                if t and int(t.group(1), 16) < addr:
                    lo = int(t.group(1), 16)
                    n_key = sum(1 for a, o, _ in ins if lo <= a <= addr and o == key)
                    best = max(best, (n_key, lo, addr))
            if best[0] <= 0:
                continue  # no loop holds a `key` instruction
            ins = [x for x in ins if best[1] <= x[0] <= best[2]]
        out[fn] = ins
    return out


def k5_test_instructions() -> tuple[float, float, dict]:
    """(SASS instructions a test issues when its early reject holds, when it
    runs the division, the row loop's opcode counts): K5's row loop body
    over the tests it holds (its FMUL over K5_FMUL). The instructions a
    rejected test skips are those that a forward branch inside the body
    jumps over where the jumped-over span holds the division's MUFU
    (outermost spans only)."""
    ins = next(iter(sass_instructions("tri_scan", loop=True, key="FMUL").values()))
    ops = {}
    for _, op, _ in ins:
        ops[op] = ops.get(op, 0) + 1
    tests = ops["FMUL"] / K5_FMUL
    spans = []
    for addr, op, line in ins:
        t = re.search(r"BRA\s+0x([0-9a-f]+)", line) if op == "BRA" else None
        if t and addr < int(t.group(1), 16) <= ins[-1][0]:
            end = int(t.group(1), 16)
            if any(o == "MUFU" and addr < a < end for a, o, _ in ins):
                spans.append((addr, end))
    skipped = sum(1 for a, _, _ in ins if any(lo < a < hi for lo, hi in spans))
    return (len(ins) - skipped) / tests, len(ins) / tests, ops


def k5_reject_share(tri_table, o, d) -> float:
    """The share of (ray, row) tests that csrc/tri_scan.cu rejects before
    the division (|det| < 1e-4, or u or v surely negative), counted in its
    operation order on these rays against every row."""
    rejected = 0
    dx, dy, dz = (d[:, k:k + 1] for k in range(3))
    for c0 in range(0, tri_table.shape[0], 512):
        ax, ay, az, e1x, e1y, e1z, e2x, e2y, e2z = tri_table[c0:c0 + 512].T
        qx, qy, qz = dy * e2z - dz * e2y, dz * e2x - dx * e2z, dx * e2y - dy * e2x
        det = e1x * qx + e1y * qy + e1z * qz
        sx, sy, sz = o[:, 0:1] - ax, o[:, 1:2] - ay, o[:, 2:3] - az
        su = sx * qx + sy * qy + sz * qz
        sv = dx * (sy * e1z - sz * e1y) + dy * (sz * e1x - sx * e1z) + dz * (sx * e1y - sy * e1x)

        def surely_negative(x):
            return ((torch.signbit(x) != torch.signbit(det)) & (x.abs() >= 2.0**-20)
                    & (det.abs() < float("inf")))

        rejected += int((~(det.abs() >= 1e-4) | surely_negative(su) | surely_negative(sv)).sum())
    return rejected / (o.shape[0] * tri_table.shape[0])


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

def nee_phong_phases(dev, k1_mean: float, width: int, height: int, spp: int, depth: int) -> dict:
    """Phases 25-27 (see the module docstring): next-event estimation on the
    bench frame and on one chunk of the 32k bench scene, and the Phong frame
    of config 2. k1_mean: phase 6's mean HDR radiance of a sample. Returns
    the launches of K2 and K3 on these paths (reset just before each path
    runs and read just after)."""
    import dataclasses

    from cs397raytracingsp22_tpu_torch.ops import intersect as isect
    from cs397raytracingsp22_tpu_torch.ops.kernels import scene_intersect, tri_scan_big
    from cs397raytracingsp22_tpu_torch.render import driver, integrator
    from cs397raytracingsp22_tpu_torch.scenes import bench_scene, bench_teapot_32k, teapot
    from cs397raytracingsp22_tpu_torch.utils import threefry

    key = threefry.key_words(0)
    n_px = width * height
    shadow_depth = 2 * depth - 1  # K2 launches an NEE chunk: every bounce and every shadow bounce

    def with_nee(sc):
        return dataclasses.replace(sc, camera=dataclasses.replace(sc.camera, nee=True))

    def nee_sample_check(what, sd, cam, o, d, uids, rad_full):
        """The strided sample traced alone, bit for bit; then against the
        plain executor (intersect_scene_plain on the card)."""
        idx = torch.arange(0, o.shape[0], SAMPLE_STRIDE, device=dev)
        run = lambda o_, d_, u_: integrator.path_trace_shrink(  # noqa: E731
            sd, o_, d_, u_, key, cam.path_depth, cam.max_trace_dist, nee=True)
        sub, (rad_s, segs_s) = sample_alone(what, run, (rad_full,), (o, d, uids), idx)
        ref, ref_segs = integrator.path_trace_shrink(sd, *sub, key, cam.path_depth,
                                                     cam.max_trace_dist, nee=True,
                                                     intersect=isect.intersect_scene_plain)
        n_bad, err, seg_diff = compare(rad_s, segs_s, ref, ref_segs, shadow_depth)
        return (f"every {SAMPLE_STRIDE}th ray ({idx.numel()}) traced alone is bit-identical to "
                f"the run's rows; {idx.numel() - n_bad}/{idx.numel()} within rtol {RTOL} atol "
                f"{ATOL} of the plain NEE executor (intersect_scene_plain on the card), max |diff| "
                f"{err:.3g}, segments {int(segs_s)} vs {int(ref_segs)} (diff {seg_diff} <= "
                f"{shadow_depth}x{n_bad})")

    # ---- 25. the NEE frame: bench teapot_6k with Camera(nee=True) ----
    sc = with_nee(bench_scene.build(width, height, spp=spp, path_depth=depth))
    sd = sc.compile(device=dev)
    cam = sc.camera
    if not sd.nee_ok or sd.n_lt_tri != 2:
        raise AssertionError("the bench scene's two light triangles must make it NEE-able")
    nch, (o, d, uids) = chunk0(sd, cam, key)
    rad_full, _ = integrator.path_trace_shrink(sd, o, d, uids, key, depth, cam.max_trace_dist,
                                               nee=True)
    msg = nee_sample_check("NEE chunk", sd, cam, o, d, uids, rad_full)
    log("parity-nee", f"bench teapot_6k {width}²x{spp}spp depth {depth} with NEE, chunk 0 of "
        f"{nch}: one run of the NEE executor on {o.shape[0]} rays (K2 on every bounce and "
        f"shadow bounce); {msg}")
    # K2 on this chunk's bounce-0 rays and their shadow rays, as the fused
    # intersection passes them: timed and bounded
    calls = []

    def record(*a):
        if len(calls) < 2:
            calls.append(a)
        return isect.intersect_scene(*a)

    integrator.path_trace_shrink(sd, o, d, uids, key, depth, cam.max_trace_dist, nee=True,
                                 intersect=record)
    n = o.shape[0]
    idx = torch.arange(0, n, SAMPLE_STRIDE, device=dev)
    parts = []
    for what, (_, o_, d_, t0_, t1_, u_) in zip(("bounce 0", "its shadow rays"), calls):
        ins = (o_.contiguous(), d_.contiguous(),
               torch.broadcast_to(torch.as_tensor(t0_, dtype=torch.float32, device=dev), (n,))
               .contiguous(),
               torch.broadcast_to(torch.as_tensor(t1_, dtype=torch.float32, device=dev), (n,))
               .contiguous(),
               u_[:, :sd.vol_center.shape[0]].contiguous())
        ms = k2_ms(sd, ins)
        b_ms, b_by, w = k2_bound_of(sd, ins, idx)
        parts.append(f"{what} {ms:.4f} ms ({int((ins[3] > 0).sum())} rays with a window, "
                     f"{w['tris']:.2f} dense-mesh triangles a sampled ray; bound {b_ms:.4f} ms, "
                     f"{b_by}; K2 at {b_ms / ms:.1%} of it)")
    log("timing-k2-nee", f"bench teapot_6k with NEE, chunk 0 ({n} rays): K2 on " + "; on "
        .join(parts))
    del o, d, uids, rad_full, calls

    def render_nee(**kw):
        return driver.render_to_image(sc, device=dev, seed=0, verbose=False, scene_data=sd, **kw)

    # the warm render writes a checkpoint; a resume from it traces nothing
    ckpt = os.path.join(ROOT, "build", "chip_smoke", "nee_frame.npz")
    os.makedirs(os.path.dirname(ckpt), exist_ok=True)
    if os.path.exists(ckpt):
        os.remove(ckpt)
    img_w, st_w = render_nee(checkpoint_path=ckpt)
    img_r, st_r = render_nee(checkpoint_path=ckpt)
    if st_r.primary_rays != 0 or not np.array_equal(img_r, img_w):
        raise AssertionError("the NEE frame resumed from its checkpoint differs or traced rays")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    scene_intersect.LAUNCHES = tri_scan_big.LAUNCHES = 0  # the NEE frame's counts start here
    draws_reset()
    r1_reset()
    runs = [render_nee() for _ in range(2)]
    k2_nee, k3_nee = scene_intersect.LAUNCHES, tri_scan_big.LAUNCHES  # read just after
    draws_read()
    r1_read()
    peak = torch.cuda.max_memory_allocated()
    img, st = runs[0]
    if k2_nee != len(runs) * st.chunks * shadow_depth or k3_nee:
        raise AssertionError(f"the NEE frame launched K2 {k2_nee} and K3 {k3_nee} times, not "
                             f"{len(runs)} x {st.chunks} chunks x {shadow_depth} and 0")
    if img.max() == 0 or any(not np.array_equal(im, img) for im, _ in runs + [(img_w, 0)]):
        raise AssertionError("the NEE frames are all zero or differ from each other")
    ratio = st.mean_radiance / k1_mean
    if abs(ratio - 1.0) > 0.05:
        raise AssertionError(f"the NEE frame's mean radiance {st.mean_radiance:.5f} is not the "
                             f"K1 frame's {k1_mean:.5f} (the same expectation)")
    walls = [s.wall_seconds for _, s in runs]
    wall = sum(walls) / len(walls)
    log("nee-frame", f"bench teapot_6k {width}²x{spp}spp depth {depth} with NEE via "
        f"render_to_image: {st.chunks} chunks of {st.primary_rays // st.chunks} rays, "
        f"{st.path_segments} segments (shadow rays included); {wall:.4f} s per image (mean of "
        f"{len(walls)}: {', '.join(f'{w:.4f}' for w in walls)}) = "
        f"{st.path_segments / wall / 1e6:.2f} Mrays/s of segments; K2 launches per image "
        f"{k2_nee // len(runs)} = {st.chunks} x {shadow_depth}; peak device memory "
        f"{peak / 2**30:.2f} GiB; mean HDR radiance of a sample {st.mean_radiance:.5f}, the K1 "
        f"frame's (phase 6, no NEE, the same expectation) {k1_mean:.5f} (ratio {ratio:.4f}); "
        f"image u8 max {img.max()}, mean {img.mean():.2f}; a resume from the warm render's "
        f"checkpoint traced 0 rays and gave the same image")
    tr = device_trace("nee_frame", render_nee, {"K2": "scene_intersect_kernel"},
                      spans=("raygen", "bounce_rng", "nee_rng"))
    log("trace", "nee_frame: " + f"{tr['kernels']} kernels, device busy {tr['busy_ms']:.3f} ms in "
        f"a {tr['span_ms']:.3f} ms first-to-last span (idle share {tr['idle']:.2%}), "
        f"{tr['wall_ms']:.3f} ms wall under the profiler; " + ", ".join(
            f"{k} {v:.3f} ms ({tr['shares'][k]:.1%} of busy)" for k, v in tr["parts"].items()))
    del sc, sd

    # ---- 26. NEE on one chunk of the 32k bench scene: K2 and K3 on shadow rays ----
    sc32 = with_nee(bench_teapot_32k.build(width, height, spp=spp, path_depth=depth))
    sd32 = sc32.compile(device=dev)
    cam32 = sc32.camera
    nch32, (o, d, uids) = chunk0(sd32, cam32, key)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    scene_intersect.LAUNCHES = tri_scan_big.LAUNCHES = 0  # the 32k NEE chunk's counts start here
    r1_reset()
    t0 = time.perf_counter()
    rad_full, segs = integrator.path_trace_shrink(sd32, o, d, uids, key, depth,
                                                  cam32.max_trace_dist, nee=True)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    k2_32, k3_32 = scene_intersect.LAUNCHES, tri_scan_big.LAUNCHES  # read just after
    r1_read()
    peak = torch.cuda.max_memory_allocated()
    if k2_32 != shadow_depth or k3_32 != 2 * shadow_depth:  # K3: its screen and its walk a call
        raise AssertionError(f"the 32k NEE chunk launched K2 {k2_32} and K3 {k3_32} times, not "
                             f"{shadow_depth} and {2 * shadow_depth}")
    msg = nee_sample_check("NEE 32k chunk", sd32, cam32, o, d, uids, rad_full)
    log("nee-32k", f"teapot_32k {width}²x{spp}spp depth {depth} with NEE, chunk 0 of {nch32}: "
        f"{o.shape[0]} rays, {int(segs)} segments (shadow rays included) in {secs:.4f} s "
        f"(= {int(segs) / secs / 1e6:.2f} Mrays/s); K2 launches {k2_32}, K3 launches {k3_32} "
        f"({k3_32 // 2} calls: the screen and the walk); peak device memory "
        f"{peak / 2**30:.2f} GiB; {msg}")
    del o, d, uids, rad_full, sc32, sd32

    # ---- 27. the Phong frame: config 2, scenes/teapot.py ----
    scp = teapot.build(width, height, spp=spp)
    sdp = scp.compile(device=dev)
    camp = scp.camera
    nchp, (o, d, uids) = chunk0(sdp, camp, key)
    shade = lambda o_, d_, u_, **kw: (integrator.phong_trace(  # noqa: E731
        sdp, o_, d_, u_, key, camp.eyepoint, camp.max_trace_dist, **kw),)
    col_full = shade(o, d, uids)
    idx = torch.arange(0, o.shape[0], SAMPLE_STRIDE, device=dev)
    sub, (col_s,) = sample_alone("Phong chunk", shade, col_full, (o, d, uids), idx)
    (ref,) = shade(*sub, intersect=isect.intersect_scene_plain)
    n_s = idx.numel()
    n_bad, err, _ = compare(col_s, n_s, ref, n_s, 1)
    log("parity-phong", f"teapot (config 2, Phong) {width}²x{spp}spp, chunk 0 of {nchp}: one "
        f"phong_trace of {o.shape[0]} rays (K2 on the camera and the shadow rays); every "
        f"{SAMPLE_STRIDE}th ray ({n_s}) traced alone is bit-identical to the run's rows; "
        f"{n_s - n_bad}/{n_s} within rtol {RTOL} atol {ATOL} of the plain phong_trace "
        f"(intersect_scene_plain on the card), max |diff| {err:.3g}")
    del o, d, uids, col_full

    def render_phong():
        return driver.render_to_image(scp, device=dev, seed=0, verbose=False, scene_data=sdp)

    render_phong()  # warm
    torch.cuda.synchronize()
    scene_intersect.LAUNCHES = tri_scan_big.LAUNCHES = 0  # the Phong frame's counts start here
    r1_reset()
    runs = [render_phong() for _ in range(2)]
    k2_ph, k3_ph = scene_intersect.LAUNCHES, tri_scan_big.LAUNCHES  # read just after
    r1_read()
    img, st = runs[0]
    if k2_ph != len(runs) * 2 * st.chunks or k3_ph:
        raise AssertionError(f"the Phong frame launched K2 {k2_ph} and K3 {k3_ph} times, not "
                             f"{len(runs)} x 2 x {st.chunks} chunks and 0")
    if img.max() == 0 or any(not np.array_equal(im, img) for im, _ in runs):
        raise AssertionError("the Phong frames are all zero or differ from each other")
    walls = [s.wall_seconds for _, s in runs]
    wall = sum(walls) / len(walls)
    log("phong-frame", f"teapot (config 2, Phong) {width}²x{spp}spp via render_to_image: "
        f"{st.chunks} chunks of {st.primary_rays // st.chunks} camera rays; {wall:.4f} s per "
        f"image (mean of {len(walls)}: {', '.join(f'{w:.4f}' for w in walls)}) = "
        f"{st.primary_rays / wall / 1e6:.2f} Mrays/s of camera rays (each with its shadow ray); "
        f"K2 launches per image {k2_ph // len(runs)} = 2 x {st.chunks}; image u8 max {img.max()}, "
        f"mean {img.mean():.2f}, {float((img.max(axis=2) > 0).mean()):.1%} of pixels lit")
    tr = device_trace("phong_frame", render_phong, {"K2": "scene_intersect_kernel"},
                      spans=("raygen", "bounce_rng"))
    log("trace", "phong_frame: " + f"{tr['kernels']} kernels, device busy {tr['busy_ms']:.3f} ms "
        f"in a {tr['span_ms']:.3f} ms first-to-last span (idle share {tr['idle']:.2%}), "
        f"{tr['wall_ms']:.3f} ms wall under the profiler; " + ", ".join(
            f"{k} {v:.3f} ms ({tr['shares'][k]:.1%} of busy)" for k, v in tr["parts"].items()))
    return {"k2": k2_nee + k2_32 + k2_ph, "k3": k3_nee + k3_32 + k3_ph}


def texel_parity(what: str, sd, out, ref) -> str:
    """The texel that the merged resolve samples (slot 0, the albedo) for
    each mesh winner of a kernel's rows `out` against the plain version's
    `ref` on the same rays; each a tuple (code, idx, u, v). Fails unless at
    least HIT_MIN_SAME of the rays that a mesh wins in either get the same
    texel."""
    from cs397raytracingsp22_tpu_torch.ops import intersect as isect

    tk, tp = (isect.mesh_texels(sd, *rows) for rows in (out, ref))
    mesh = (tk >= 0) | (tp >= 0)
    n, n_same = int(mesh.sum()), int((mesh & (tk == tp)).sum())
    if n == 0 or n_same < HIT_MIN_SAME * n:
        raise AssertionError(f"{what}: {n - n_same} of {n} mesh hits sample another texel")
    return f"texels {n_same}/{n} of the mesh hits identical"


def chunk0(sd, cam, key):
    """(chunks, (o, d, uids)): chunk 0 of render_to_image's interleaved
    chunks of the scene, as the driver builds it."""
    from cs397raytracingsp22_tpu_torch.render import driver

    px = driver.chunk_pixels(sd, cam, cam.aa_sample_count)
    n_px = cam.screen_width * cam.screen_height
    nch = (n_px + px - 1) // px
    ids = torch.arange(px, dtype=torch.int32, device=sd.device) * nch
    return nch, driver._gen_chunk_rays(cam, ids, key, 0, cam.aa_sample_count, 1)


def staged_check(what, sd, cam, o, d, uids, key):
    """One staged run of the chunk; its strided sample alone, bit for bit,
    then against the plain path (integrator.path_trace)."""
    from cs397raytracingsp22_tpu_torch.render import integrator

    depth, max_dist = cam.path_depth, cam.max_trace_dist
    rad_full, segs = integrator.path_trace_shrink(sd, o, d, uids, key, depth, max_dist)
    idx = torch.arange(0, o.shape[0], SAMPLE_STRIDE, device=o.device)
    stage = lambda o_, d_, u_: integrator.path_trace_shrink(  # noqa: E731
        sd, o_, d_, u_, key, depth, max_dist)
    sub, (rad_s, segs_s) = sample_alone(what, stage, (rad_full,), (o, d, uids), idx)
    ref_rad, ref_segs = integrator.path_trace(sd, *sub, key, depth, max_dist)
    n_bad, err, _ = compare(rad_s, segs_s, ref_rad, ref_segs, depth)
    return (f"one staged run of {o.shape[0]} rays ({int(segs)} segments); every "
            f"{SAMPLE_STRIDE}th ray ({idx.numel()}) traced alone is bit-identical to the run's "
            f"rows; {idx.numel() - n_bad}/{idx.numel()} within rtol {RTOL} atol {ATOL} of the "
            f"plain path (integrator.path_trace on the card), max |diff| {err:.3g}, segments "
            f"{int(segs_s)} vs {int(ref_segs)}")


def staged_bounce_parity(phase: str, what: str, sd, cam, o, d, uids, key,
                         texel_stride: int = 16):
    """Phases 28 and 33: K2, and K3 on the scene's big mesh (one), against
    their plain versions on the bounce-0 and bounce-2 rays of a chunk (o,
    d, uids): every SAMPLE_STRIDE-th ray traced alone bit for bit, then the
    plain versions' winners and values (compare_hits), and the texels of
    the mesh winners on every texel_stride-th ray (texel_parity); the
    staged path's own bounce update between. Returns K2's and K3's
    bounce-0 inputs and the strided sample's indices."""
    from cs397raytracingsp22_tpu_torch.ops import intersect as isect
    from cs397raytracingsp22_tpu_torch.ops.kernels import scene_intersect, tri_scan_big
    from cs397raytracingsp22_tpu_torch.render import integrator
    from cs397raytracingsp22_tpu_torch.utils import rng as rnglib

    dev = o.device
    big = [i for i in range(len(sd.meshes)) if i not in sd.dense_mesh_ids]
    mesh_big = sd.meshes[big[0]]
    code_big = isect.CODE_MESH0 + len(sd.dense_mesh_ids)
    n = o.shape[0]
    idx = torch.arange(0, n, SAMPLE_STRIDE, device=dev)
    texel_rows = torch.arange(0, n, texel_stride, device=dev)
    k2f = lambda *a: scene_intersect.scene_intersect_cuda(sd, *a)  # noqa: E731
    k3f = lambda *a: tri_scan_big.tri_scan_big_cuda(mesh_big, *a)  # noqa: E731
    k2_err = k3_err = 0.0
    thr, rad = torch.ones_like(o), torch.zeros_like(o)
    alive = torch.ones((n,), dtype=torch.bool, device=dev)
    for b in range(3):
        site = rnglib.SITE_BOUNCE0 + b
        if b in (0, 2):
            u_vol = integrator._bounce_draws(sd, key, uids, site)[2]
            t_min = torch.full((n,), integrator.PATH_T_MIN, device=dev)
            t_max = torch.where(alive, torch.full_like(t_min, cam.max_trace_dist),
                                torch.zeros_like(t_min))
            ins = (o.contiguous(), d.contiguous(), t_min, t_max,
                   u_vol[:, :sd.vol_center.shape[0]].contiguous())
            full = k2f(*ins)
            sub, alone = sample_alone(f"K2 {what} bounce {b}", k2f, full, ins, idx)
            ref = scene_intersect.scene_intersect_plain(sd, *sub)
            m2, s2, e2, err = compare_hits(
                f"K2 {what} bounce {b}", alone[1:4], ref[1:4],
                *(dict(t=x[0], u=x[4], v=x[5], normal=x[6]) for x in (alone, ref)))
            k2_err = max(k2_err, err)
            ref_t = scene_intersect.scene_intersect_plain(sd, *[x[texel_rows] for x in ins])
            tx2 = texel_parity(f"K2 {what} bounce {b}", sd,
                               tuple(full[i][texel_rows] for i in (1, 2, 4, 5)),
                               tuple(ref_t[i] for i in (1, 2, 4, 5)))
            o_obj, d_obj = (x.contiguous() for x in isect.object_rays(mesh_big, o, d))
            ins3 = (o_obj, d_obj, t_min, torch.minimum(t_max, full[0]))
            full3 = k3f(*ins3)
            sub3, alone3 = sample_alone(f"K3 {what} bounce {b}", k3f, full3, ins3, idx)
            ref3 = tri_scan_big.tri_scan_big_plain(mesh_big, *sub3)
            m3, s3, e3, err = compare_hits(
                f"K3 {what} bounce {b}", (alone3[0], alone3[2]), (ref3[0], ref3[2]),
                *(dict(t=x[1], u=x[3], v=x[4]) for x in (alone3, ref3)))
            k3_err = max(k3_err, err)
            ref3_t = tri_scan_big.tri_scan_big_plain(mesh_big, *[x[texel_rows] for x in ins3])

            def big_rows(hit, tri, u, v):
                return (torch.where(hit, code_big, -1).to(torch.int32), tri, u, v)

            tx3 = texel_parity(f"K3 {what} bounce {b}", sd,
                               big_rows(*[full3[i][texel_rows] for i in (0, 2, 3, 4)]),
                               big_rows(*[ref3_t[i] for i in (0, 2, 3, 4)]))
            if b == 0:
                k2_in, k3_in = ins, ins3
            log(phase, f"{what} bounce {b} ({n} rays, "
                f"{int(alive.sum())} live): K2 and K3 ({mesh_big.tri_verts.shape[0]} triangles, "
                f"textured and normal-mapped) each one launch; every {SAMPLE_STRIDE}th ray alone "
                f"is bit-identical to the launch's rows; K2 {s2}/{m2} same (code, idx, mat) as "
                f"the plain version, {e2}/{m2} bit-identical, max |diff| {k2_err:.3g}; K3 "
                f"{s3}/{m3} same (hit, tri) as traverse, {e3}/{m3} bit-identical; on every "
                f"{texel_stride}th ray "
                f"({texel_rows.numel()}): K2 {tx2}, K3 {tx3}; sampled winners: "
                f"{int((alone[1] >= isect.CODE_MESH0).sum())} dense mesh, "
                f"{int(alone3[0].sum())} big mesh")
        if b < 2:
            o, d, thr, rad, alive, _, _ = integrator.bounce_update(
                sd, o, d, thr, rad, alive, uids, key, b, cam.max_trace_dist,
                intersect=isect.intersect_scene)
    return k2_in, k3_in, idx


def textured_phases(dev) -> dict:
    """Phases 28-30 (see the module docstring): the kitchen sink, the
    stand-in config 4 and general-boundary volumes on the staged path.
    Returns the launches of K2 and K3 on these paths (reset just before
    each path runs and read just after)."""
    import dataclasses

    from cs397raytracingsp22_tpu_torch import ConvexVolume, Isotropic, Lambertian, Plane, Scene
    from cs397raytracingsp22_tpu_torch import Sphere
    from cs397raytracingsp22_tpu_torch.models import materials
    from cs397raytracingsp22_tpu_torch.models import transform as tf
    from cs397raytracingsp22_tpu_torch.ops import intersect as isect
    from cs397raytracingsp22_tpu_torch.ops.kernels import scene_intersect, tri_scan_big
    from cs397raytracingsp22_tpu_torch.render import driver, integrator
    from cs397raytracingsp22_tpu_torch.scenes import kitchen_sink, textured_spheres
    from cs397raytracingsp22_tpu_torch.utils import rng as rnglib
    from cs397raytracingsp22_tpu_torch.utils import threefry
    from cs397raytracingsp22_tpu_torch.utils.texture import load_image

    key = threefry.key_words(0)

    # ---- 28. the kitchen sink: K2 and K3 on textured meshes, the staged path ----
    sck = kitchen_sink.build(256, 256, spp=16, path_depth=5)
    sdk = sck.compile(device=dev)
    camk = sck.camera
    nchk, (o, d, uids) = chunk0(sdk, camk, key)
    if nchk != 1:
        raise AssertionError(f"the kitchen sink at 256² x 16 spp takes {nchk} chunks, not 1")
    big = [i for i in range(len(sdk.meshes)) if i not in sdk.dense_mesh_ids]
    if len(big) != 1 or len(sdk.dense_mesh_ids) != 1 or sdk.n_gvols != 1:
        raise AssertionError("the kitchen sink must hold a dense mesh, a big mesh and a gvol")
    mesh_big = sdk.meshes[big[0]]
    n = o.shape[0]
    k2_in, k3_in, idx = staged_bounce_parity("textured-parity", "kitchen sink 256²x16spp depth 5",
                                             sdk, camk, o, d, uids, key)
    k3f = lambda *a: tri_scan_big.tri_scan_big_cuda(mesh_big, *a)  # noqa: E731
    ms2, k3_ms = k2_ms(sdk, k2_in), cuda_ms(lambda: k3f(*k3_in), 10)
    k2_b, k2_by, w2 = k2_bound_of(sdk, k2_in, idx)
    k3_b, k3_by, _ = k3_bound(mesh_big, k3_in, idx)
    log("timing-textured", f"kitchen sink bounce 0 ({n} rays): K2 {ms2:.4f} ms ({w2['tris']:.2f} "
        f"dense-mesh triangles a sampled ray; bound {k2_b:.4f} ms, {k2_by}; K2 at "
        f"{k2_b / ms2:.1%} of it); K3 on the {mesh_big.tri_verts.shape[0]}-triangle grid "
        f"{k3_ms:.4f} ms (bound {k3_b:.4f} ms, {k3_by}; {k3_b / k3_ms:.1%})")
    nchk, (o, d, uids) = chunk0(sdk, camk, key)
    log("textured-parity", f"kitchen sink chunk 0 of {nchk}: "
        + staged_check("kitchen sink chunk", sdk, camk, o, d, uids, key))
    del o, d, uids
    render_k = lambda: driver.render_to_image(sck, device=dev, seed=0, verbose=False,  # noqa: E731
                                              scene_data=sdk)
    render_k()  # warm
    scene_intersect.LAUNCHES = tri_scan_big.LAUNCHES = 0  # the kitchen sink's counts start here
    r1_reset()
    img_k, st_k = render_k()
    k2_k, k3_k = scene_intersect.LAUNCHES, tri_scan_big.LAUNCHES  # read just after
    r1_read()
    if k2_k < 1 or k3_k < 1 or img_k.max() == 0:
        raise AssertionError(f"the kitchen-sink render launched K2 {k2_k} and K3 {k3_k} times, "
                             f"image max {img_k.max()}")
    log("textured-parity", f"kitchen sink 256²x16spp depth 5 via render_to_image: "
        f"{st_k.wall_seconds:.4f} s, {st_k.path_segments} segments "
        f"({st_k.path_segments / st_k.wall_seconds / 1e6:.2f} Mrays/s); K2 launches {k2_k}, K3 "
        f"launches {k3_k}; mean HDR radiance {st_k.mean_radiance:.5f}, non-finite pixels "
        f"{st_k.nonfinite_pixels}, image u8 max {img_k.max()}, mean {img_k.mean():.2f}")
    del sck, sdk

    # ---- 29. config 4 on its stand-in assets at full size ----
    assets = textured_spheres.stand_in_dir()
    sc4 = textured_spheres.build(512, 512, spp=32, lens_radius=0.08, asset_dir=assets)
    sd4 = sc4.compile(device=dev)
    cam4 = sc4.camera
    maps = [("earthmap.jpg", "normal_test.png"), ("magenta.jpg", "normal_test.jpg")]
    bound = []
    for m, names in zip(sd4.meshes, maps):
        for slot, name in zip((0, 4), names):
            img = load_image(os.path.join(assets, "texture", name))
            tid = m.tex_ids[slot]
            if img is None or tid < 0 or int(sd4.tex_width[tid]) * int(sd4.tex_height[tid]) != \
                    img.shape[0] * img.shape[1]:
                raise AssertionError(f"config 4: texture slot {slot} ({name}) is not bound to its "
                                     "map's pixels")
            bound.append(f"{name} {img.shape[1]}x{img.shape[0]}")
    n_tan = sum(int((~torch.isfinite(m.tri_tangent)).any(dim=1).sum()) for m in sd4.meshes)
    nch4, (o, d, uids) = chunk0(sd4, cam4, key)
    log("config4-frame", f"stand-in config 4 chunk 0 of {nch4}: "
        + staged_check("config 4 chunk", sd4, cam4, o, d, uids, key))
    n = o.shape[0]
    u_vol = integrator._bounce_draws(sd4, key, uids, rnglib.SITE_BOUNCE0)[2]
    ins = (o, d, torch.full((n,), integrator.PATH_T_MIN, device=dev),
           torch.full((n,), cam4.max_trace_dist, device=dev),
           u_vol[:, :sd4.vol_center.shape[0]].contiguous())
    ms = k2_ms(sd4, ins)
    b_ms, b_by, w = k2_bound_of(sd4, ins, torch.arange(0, n, SAMPLE_STRIDE, device=dev))
    log("timing-textured", f"stand-in config 4 chunk 0 bounce 0 ({n} rays): K2 {ms:.4f} ms "
        f"({w['tris']:.2f} dense-mesh triangles a sampled ray over the two spheres' "
        f"{sum(m.tri_verts.shape[0] for m in sd4.meshes)}; bound {b_ms:.4f} ms, {b_by}; K2 at "
        f"{b_ms / ms:.1%} of it)")
    del o, d, uids, ins

    def render4(**kw):
        return driver.render_to_image(sc4, device=dev, seed=0, verbose=False, scene_data=sd4, **kw)

    render4()  # warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    scene_intersect.LAUNCHES = tri_scan_big.LAUNCHES = 0  # config 4's counts start here
    r1_reset()
    runs = [render4() for _ in range(2)]
    k2_4, k3_4 = scene_intersect.LAUNCHES, tri_scan_big.LAUNCHES  # read just after
    r1_read()
    peak = torch.cuda.max_memory_allocated()
    img4, st4 = runs[0]
    if k2_4 < 1 or k3_4:
        raise AssertionError(f"config 4 launched K2 {k2_4} and K3 {k3_4} times, not >= 1 and 0")
    if st4.mean_radiance <= 0.0 or any(not np.array_equal(im, img4) for im, _ in runs):
        raise AssertionError("the config-4 frames are unlit or differ from each other")
    walls = [s.wall_seconds for _, s in runs]
    wall = sum(walls) / len(walls)
    tr = device_trace("config4", render4, {"K2": "scene_intersect_kernel"},
                      spans=("bounce_rng", "raygen", "mesh_resolve"))
    log("config4-frame", f"stand-in config 4 512²x32spp depth 8 lens 0.08 via render_to_image: "
        f"{st4.chunks} chunks of {st4.primary_rays // st4.chunks} rays, {st4.path_segments} "
        f"segments; {wall:.4f} s per image (mean of {len(walls)}: "
        f"{', '.join(f'{w:.4f}' for w in walls)}) = {st4.path_segments / wall / 1e6:.2f} Mrays/s "
        f"of segments; K2 launches per image {k2_4 // len(runs)}, K3 {k3_4}; peak device memory "
        f"{peak / 2**30:.2f} GiB; {tr['kernels']} kernels an image, device busy "
        f"{tr['busy_ms']:.3f} ms in a {tr['span_ms']:.3f} ms span (idle share {tr['idle']:.2%}); "
        + ", ".join(f"{k} {v:.3f} ms ({tr['shares'][k]:.1%} of busy)"
                    for k, v in tr["parts"].items())
        + f"; slots bound: {', '.join(bound)} (atlas {sd4.tex_pixels.shape[0]} pixels); "
        f"non-finite tangents {n_tan} of {sum(m.tri_verts.shape[0] for m in sd4.meshes)}, "
        f"non-finite pixels {st4.nonfinite_pixels}; mean HDR radiance of a sample "
        f"{st4.mean_radiance:.5f}; image u8 max {img4.max()}, mean {img4.mean():.2f}")
    sc4n = dataclasses.replace(sc4, camera=dataclasses.replace(cam4, nee=True))
    if not sd4.nee_ok:
        raise AssertionError("config 4's two light triangles must make it NEE-able")
    _, (o, d, uids) = chunk0(sd4, sc4n.camera, key)
    shadow_depth = 2 * cam4.path_depth - 1
    torch.cuda.synchronize()
    scene_intersect.LAUNCHES = 0  # config 4's NEE chunk's count starts here
    r1_reset()
    t0 = time.perf_counter()
    rad_n, segs_n = integrator.path_trace_shrink(sd4, o, d, uids, key, cam4.path_depth,
                                                 cam4.max_trace_dist, nee=True)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    k2_n = scene_intersect.LAUNCHES  # read just after
    r1_read()
    if k2_n != shadow_depth:
        raise AssertionError(f"config 4's NEE chunk launched K2 {k2_n} times, not {shadow_depth}")
    idx = torch.arange(0, o.shape[0], SAMPLE_STRIDE, device=dev)
    run = lambda o_, d_, u_: integrator.path_trace_shrink(  # noqa: E731
        sd4, o_, d_, u_, key, cam4.path_depth, cam4.max_trace_dist, nee=True)
    sub, (rad_s, segs_s) = sample_alone("config 4 NEE chunk", run, (rad_n,), (o, d, uids), idx)
    ref, ref_segs = integrator.path_trace_shrink(sd4, *sub, key, cam4.path_depth,
                                                 cam4.max_trace_dist, nee=True,
                                                 intersect=isect.intersect_scene_plain)
    n_bad, err, _ = compare(rad_s, segs_s, ref, ref_segs, shadow_depth)
    log("config4-frame", f"stand-in config 4 with NEE, chunk 0 of {nch4}: {o.shape[0]} rays, "
        f"{int(segs_n)} segments (shadow rays included) in {secs:.4f} s "
        f"(= {int(segs_n) / secs / 1e6:.2f} Mrays/s); K2 launches {k2_n}; every "
        f"{SAMPLE_STRIDE}th ray ({idx.numel()}) alone is bit-identical to the run's rows; "
        f"{idx.numel() - n_bad}/{idx.numel()} within rtol {RTOL} atol {ATOL} of the plain NEE "
        f"executor, max |diff| {err:.3g}; mean HDR radiance {float(rad_n.mean()):.5f}")
    del o, d, uids, rad_n, sc4, sd4

    # ---- 30. general-boundary volumes: a cube and a small-scaled cube ----
    cube = np.array([[x, y, z] for x in (-1, 1) for y in (-1, 1) for z in (-1, 1)], np.float32)
    faces = np.array([[0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5], [0, 4, 5], [0, 5, 1],
                      [2, 3, 7], [2, 7, 6], [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3]], np.int32)

    def cube_volume(density, xf):
        mesh = kitchen_sink.mesh_from_arrays(cube, faces, np.zeros((8, 2), np.float32),
                                             (None,) * 5, Lambertian(), xf)
        return ConvexVolume(boundary=mesh, phase_function=Isotropic(albedo=(0.8, 0.8, 0.9)),
                            density=density)

    scg = Scene(camera=dataclasses.replace(kitchen_sink.build(256, 256, spp=16, path_depth=6)
                                           .camera, eyepoint=(0.0, 0.0, 3.0),
                                           view_dir=(0.0, 0.0, -1.0)),
                objects=[
                    cube_volume(1.2, tf.translate(0.2, 0.0, -0.5) @ tf.scale(0.9)),
                    cube_volume(1e6, tf.translate(0.0, 0.0, 2.5) @ tf.scale(0.002)),
                    Sphere(center=(0.0, 0.0, -3.0), radius=1.0,
                           material=Lambertian(albedo=(0.6, 0.3, 0.2))),
                    Plane(point=(0.0, -1.5, 0.0), normal=(0.0, 1.0, 0.0),
                          material=Lambertian(albedo=(0.5, 0.5, 0.5))),
                    Sphere(center=(0.0, 6.0, 0.0), radius=2.0,
                           material=Lambertian(albedo=(0, 0, 0), emission=(6.0, 6.0, 6.0))),
                ])
    sdg = scg.compile(device=dev)
    camg = scg.camera
    if sdg.n_gvols != 2 or sdg.gvol_tri[0].shape[0] != 12:
        raise AssertionError("the gvol scene must hold two 12-triangle boundaries")
    nchg, (o, d, uids) = chunk0(sdg, camg, key)
    n = o.shape[0]
    u_vol = integrator._bounce_draws(sdg, key, uids, rnglib.SITE_BOUNCE0)[2]
    before = scene_intersect.LAUNCHES
    fused = isect.intersect_scene_fused(sdg, o, d, integrator.PATH_T_MIN, camg.max_trace_dist,
                                        u_vol)
    if scene_intersect.LAUNCHES != before + 1:
        raise AssertionError("the fused path did not launch K2 once")
    plain = isect.intersect_scene_plain(sdg, o, d, integrator.PATH_T_MIN, camg.max_trace_dist,
                                        u_vol)
    iso = materials.ISOTROPIC
    ng, nv = int((fused.valid & (fused.mtype == iso)).sum()), int(fused.valid.sum())
    small = int(((fused.point - torch.tensor([0.0, 0.0, 2.5], device=dev)).abs().max(dim=1)
                 .values < 0.003).sum())
    mg, sg, eg, errg = compare_hits(
        "gvol chunk", *(((h.valid, torch.where(h.valid, h.mtype, -1)) for h in (fused, plain))),
        *(dict(t=torch.where(h.valid, h.t, 0.0), point=torch.where(h.valid[:, None], h.point, 0.0),
               normal=torch.where(h.valid[:, None], h.normal, 0.0)) for h in (fused, plain)))
    log("gvol", f"cube (12 triangles) and 0.002-scaled cube boundaries, 256²x16spp, chunk 0 of "
        f"{nchg} ({n} camera rays): intersect_scene_fused (K2, then the general volumes' merge) "
        f"against intersect_scene_plain on the card: {sg}/{mg} same (valid, material type), "
        f"{eg}/{mg} bit-identical, max |diff| {errg:.3g}; {nv} hits, {ng} volume scatter events, "
        f"{small} in the small cube (eps {sdg.gvol_eps[1]:.3g})")
    log("gvol", f"chunk 0 of {nchg}: " + staged_check("gvol chunk", sdg, camg, o, d, uids, key))
    return {"k2": k2_k + k2_4 + k2_n, "k3": k3_k}


# ---- phases 33-34: config 5 (the reference's demo scene) and the tools ----

# config 5 at its BASELINE width and depth; the spec's 1000 spp cut to 64
CONFIG5 = dict(width=1024, height=1024, spp=64, path_depth=10)
# the spp of the config-5 image held to the JAX package's 1000-spp render
GATE_SPP = 256
# the config-5 render whose checkpoint phase 34 previews: two spp chunks
PREVIEW_FRAME = dict(width=256, height=256, spp=8, path_depth=10)


def mesh_hits(mesh, o_obj, d_obj, eps: float) -> torch.Tensor:
    """Which object-space rays hit any triangle of the mesh in [PATH_T_MIN,
    100] under Möller–Trumbore with the |det| epsilon eps (every triangle
    tested, in blocks of 2,048)."""
    from cs397raytracingsp22_tpu_torch.ops import bvh as bvhlib
    from cs397raytracingsp22_tpu_torch.render import integrator

    hit = torch.zeros(o_obj.shape[0], dtype=torch.bool, device=o_obj.device)
    for c in range(0, mesh.tri_verts.shape[0], 2048):
        tv = mesh.tri_verts[None, c:c + 2048]
        valid, *_ = bvhlib.moller_trumbore(o_obj[:, None], d_obj[:, None], tv[..., 0, :],
                                           tv[..., 1, :], tv[..., 2, :], integrator.PATH_T_MIN,
                                           100.0, eps=eps)
        hit |= valid.any(dim=1)
    return hit


def config5_phases(dev) -> dict:
    """Phase 33 (see the module docstring): config 5 without its meshes on
    K1, then on its stand-in assets on the staged path (K2, K3). Returns
    the launches of K1, K2 and K3 of its renders (reset just before each
    render and read just after)."""
    from cs397raytracingsp22_tpu_torch.ops import bvh as bvhlib
    from cs397raytracingsp22_tpu_torch.ops import intersect as isect
    from cs397raytracingsp22_tpu_torch.ops.kernels import bounce, scene_intersect, tri_scan_big
    from cs397raytracingsp22_tpu_torch.render import driver, integrator
    from cs397raytracingsp22_tpu_torch.scenes import drone_demo
    from cs397raytracingsp22_tpu_torch.tools import compare_reference_render as crr
    from cs397raytracingsp22_tpu_torch.utils import threefry

    key = threefry.key_words(0)
    ref_img = crr.load_png(crr.DEFAULT_REFERENCE)
    spec = f"{CONFIG5['width']}²x{CONFIG5['spp']}spp depth {CONFIG5['path_depth']}"

    def regions(img, gate):
        res = crr.compare(img, ref_img, gate, verbose=False)
        line = ", ".join(f"{k} {d:.2f}{'' if g else ' (info)'}{'' if ok or not g else ' FAIL'}"
                         for k, (_, _, d, ok, g) in res.items())
        return res, line

    # ---- 33a. the analytic part on K1 ----
    sca = drone_demo.build(include_meshes=False, **CONFIG5)
    sda = sca.compile(device=dev)
    cama = sca.camera
    if not bounce.scene_is_simple(sda) or sda.meshes:
        raise AssertionError("config 5 without its meshes must be K1's scene")
    ncha, (o, d, uids) = chunk0(sda, cama, key)
    rad_full, _ = bounce.path_trace_cuda(sda, o, d, uids, key, cama.path_depth,
                                         cama.max_trace_dist)
    n_s, (n_bad, err_a, seg_diff) = check_full_launch(
        bounce, integrator, sda, o, d, uids, key, cama.path_depth, cama.max_trace_dist, rad_full)
    log("config5", f"analytic part (22 primitives, 2 sphere volumes) {spec}, chunk 0 of {ncha}: "
        f"one K1 launch of {o.shape[0]} rays; every {SAMPLE_STRIDE}th ray ({n_s}) traced alone is "
        f"bit-identical to the launch's rows; {n_s - n_bad}/{n_s} within rtol {RTOL} atol {ATOL} "
        f"of the plain version, max |diff| {err_a:.3g}, segment diff {seg_diff}")
    del o, d, uids, rad_full
    bounce.LAUNCHES = 0  # the analytic render's count starts here
    img_a, st_a = driver.render_to_image(sca, device=dev, seed=0, verbose=False, scene_data=sda)
    k1 = bounce.LAUNCHES  # read just after
    if k1 < 1 or img_a.max() == 0:
        raise AssertionError(f"config 5's analytic render launched K1 {k1} times, image max "
                             f"{img_a.max()}")
    _, line = regions(img_a, ())
    log("config5", f"analytic part {spec} via render_to_image: {st_a.wall_seconds:.4f} s, "
        f"{st_a.chunks} chunks, {st_a.path_segments} segments "
        f"({st_a.path_segments / st_a.wall_seconds / 1e6:.2f} Mrays/s); K1 launches {k1}; image "
        f"u8 mean {img_a.mean():.2f}; region |delta| against the JAX full-spec render (info: no "
        f"meshes): {line}")
    del sca, sda

    # ---- 33b. the stand-ins on the staged path ----
    sc = drone_demo.build(**CONFIG5)
    t0 = time.perf_counter()
    sd = sc.compile(device=dev)
    compile_s = time.perf_counter() - t0
    cam = sc.camera
    sizes = [m.tri_verts.shape[0] for m in sd.meshes]
    if sd.dense_mesh_ids != (0, 1) or sizes[2] != 32512:
        raise AssertionError(f"config 5's stand-ins: meshes {sizes}, dense {sd.dense_mesh_ids}")
    nch, (o, d, uids) = chunk0(sd, cam, key)
    n = o.shape[0]
    k2_in, k3_in, idx = staged_bounce_parity(
        "config5", f"stand-in config 5 {spec} chunk 0 of {nch}", sd, cam, o, d, uids, key,
        texel_stride=max(16, n // 65536))
    mesh = sd.meshes[2]
    ms2, ms3 = k2_ms(sd, k2_in), cuda_ms(lambda: tri_scan_big.tri_scan_big_cuda(mesh, *k3_in), 10)
    k2_b, k2_by, w2 = k2_bound_of(sd, k2_in, idx)
    k3_b, k3_by, _ = k3_bound(mesh, k3_in, idx)
    log("config5", f"stand-in config 5 chunk 0 bounce 0 ({n} rays): K2 {ms2:.4f} ms "
        f"({w2['tris']:.2f} dense-mesh triangles a sampled ray over the drone's and cube's "
        f"{sizes[0] + sizes[1]}; bound {k2_b:.4f} ms, {k2_by}; {k2_b / ms2:.1%}); K3 on the "
        f"{sizes[2]}-triangle sphere {ms3:.4f} ms (bound {k3_b:.4f} ms, {k3_by}; "
        f"{k3_b / ms3:.1%}); scene compile {compile_s:.2f} s")
    # ROADMAP C4: the reference's absolute |det| >= 1e-4 (kept by both
    # packages) on the sphere's thin triangles, counted on camera rays
    rows = torch.arange(0, n, 256, device=dev)
    o_obj, d_obj = isect.object_rays(mesh, k2_in[0][rows], k2_in[1][rows])
    reach, kept = (mesh_hits(mesh, o_obj, d_obj, eps) for eps in (0.0, bvhlib.MT_EPSILON))
    log("config5", f"MT epsilon (ROADMAP C4) on every 256th camera ray ({rows.numel()}): "
        f"{int(reach.sum())} reach the {sizes[2]}-triangle sphere with |det| >= 0, "
        f"{int((reach & ~kept).sum())} of them lose it to |det| >= {bvhlib.MT_EPSILON}")
    del k2_in, k3_in
    nch, (o, d, uids) = chunk0(sd, cam, key)
    log("config5", f"stand-in config 5 chunk 0 of {nch}: "
        + staged_check("config 5 chunk", sd, cam, o, d, uids, key))
    del o, d, uids
    render = lambda: driver.render_to_image(sc, device=dev, seed=0, verbose=False,  # noqa: E731
                                            scene_data=sd)
    render()  # warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    bounce.LAUNCHES = scene_intersect.LAUNCHES = tri_scan_big.LAUNCHES = 0  # counts start here
    r1_reset()
    img, st = render()
    k1_s, k2, k3 = bounce.LAUNCHES, scene_intersect.LAUNCHES, tri_scan_big.LAUNCHES  # read after
    r1_read()
    peak = torch.cuda.max_memory_allocated()
    if k1_s or k2 < 1 or k3 < 1 or st.mean_radiance <= 0.0:
        raise AssertionError(f"stand-in config 5 launched K1 {k1_s}, K2 {k2}, K3 {k3} times, "
                             f"mean radiance {st.mean_radiance}")
    tr = device_trace("config5", render, {"K2": "scene_intersect_kernel", "K3": "bvh_"},
                      spans=("bounce_rng", "raygen", "mesh_resolve"))
    _, line = regions(img, ())
    log("config5", f"stand-in config 5 {spec} via render_to_image: {st.chunks} chunks of "
        f"{st.primary_rays // st.chunks} rays, {st.path_segments} segments; {st.wall_seconds:.4f} "
        f"s per image = {st.path_segments / st.wall_seconds / 1e6:.2f} Mrays/s of segments "
        f"(steady window {st.segment_mrays_per_sec:.2f}); K2 launches {k2}, K3 {k3}, K1 {k1_s}; "
        f"peak device memory {peak / 2**30:.2f} GiB; non-finite pixels {st.nonfinite_pixels}; "
        f"mean HDR radiance of a sample {st.mean_radiance:.5f}; image u8 mean {img.mean():.2f}; "
        f"{tr['kernels']} kernels an image, device busy {tr['busy_ms']:.3f} ms in a "
        f"{tr['span_ms']:.3f} ms span (idle share {tr['idle']:.2%}); "
        + ", ".join(f"{k} {v:.3f} ms ({tr['shares'][k]:.1%} of busy)"
                    for k, v in tr["parts"].items())
        + f"; region |delta| (u8) against the JAX full-spec render (info at {CONFIG5['spp']} spp): "
        + line)
    # the gate: a mean tonemapped through gamma 2 reads dark at low spp (the
    # 64-spp image's glass_area 5.7-6.7 u8 under the 1000-spp render on
    # every seed, K1's analytic image too); GATE_SPP keeps that under 1.6
    scg = drone_demo.build(**dict(CONFIG5, spp=GATE_SPP))
    bounce.LAUNCHES = scene_intersect.LAUNCHES = tri_scan_big.LAUNCHES = 0  # counts start here
    r1_reset()
    img_g, st_g = driver.render_to_image(scg, device=dev, seed=0, verbose=False, scene_data=sd)
    k2 += scene_intersect.LAUNCHES
    k3 += tri_scan_big.LAUNCHES  # read just after
    r1_read()
    res, line = regions(img_g, crr.STAND_IN_GATE)
    log("config5", f"stand-in config 5 at {GATE_SPP} spp ({st_g.wall_seconds:.4f} s, "
        f"{st_g.path_segments} segments): region |delta| (u8) against "
        f"{os.path.relpath(crr.DEFAULT_REFERENCE, ROOT)}, gated at {crr.TOLERANCE['sphere_grid']} "
        f"on {', '.join(crr.STAND_IN_GATE)}: {line}")
    if not crr.passed(res):
        raise AssertionError("stand-in config 5 is beyond the JAX full-spec render's tolerance on "
                             "a gated region")
    return {"k1": k1, "k2": k2, "k3": k3}


def tools_phases(dev) -> dict:
    """Phase 34: make_artifacts' default recipes on the card, then
    preview_checkpoint on a two-chunk config-5 render's checkpoint.
    Returns the launches of K1, K2 and K3 of their renders."""
    from cs397raytracingsp22_tpu_torch.ops import tonemap as tonemap_ops
    from cs397raytracingsp22_tpu_torch.ops.kernels import bounce, scene_intersect, tri_scan_big
    from cs397raytracingsp22_tpu_torch.render import driver
    from cs397raytracingsp22_tpu_torch.scenes import drone_demo
    from cs397raytracingsp22_tpu_torch.tools import compare_reference_render as crr
    from cs397raytracingsp22_tpu_torch.tools import make_artifacts, preview_checkpoint

    out_dir = os.path.join(ROOT, "build", "chip_smoke", "artifacts")
    t0 = time.perf_counter()
    bounce.LAUNCHES = scene_intersect.LAUNCHES = tri_scan_big.LAUNCHES = 0  # counts start here
    r1_reset()
    rows = make_artifacts.run(out_dir=out_dir, device=dev, verbose=False)
    k = {"k1": bounce.LAUNCHES, "k2": scene_intersect.LAUNCHES,
         "k3": tri_scan_big.LAUNCHES}  # read just after
    r1_read()
    for name, row in rows.items():
        log("tools", f"make_artifacts {name}: {row['stats'].wall_seconds:.4f} s, "
            f"{row['stats'].chunks} chunks; {make_artifacts.describe(row)}")
    if min(k.values()) < 1:
        raise AssertionError(f"make_artifacts' default recipes launched K1, K2, K3 {k} times")
    log("tools", f"make_artifacts: {len(rows)} recipes into {os.path.relpath(out_dir, ROOT)} in "
        f"{time.perf_counter() - t0:.1f} s; K1 launches {k['k1']}, K2 {k['k2']}, K3 {k['k3']}")

    sc = drone_demo.build(**PREVIEW_FRAME)
    w, h, spp = (PREVIEW_FRAME[k] for k in ("width", "height", "spp"))
    ckpt = os.path.join(ROOT, "build", "chip_smoke", "config5_ckpt.npz")
    if os.path.exists(ckpt):
        os.remove(ckpt)
    k2, k3 = scene_intersect.LAUNCHES, tri_scan_big.LAUNCHES
    r1_reset()
    img, st = driver.render_to_image(sc, device=dev, seed=0, verbose=False, checkpoint_path=ckpt,
                                     spp_chunk=spp // 2)
    k["k2"] += scene_intersect.LAUNCHES - k2
    k["k3"] += tri_scan_big.LAUNCHES - k3
    r1_read()
    out = os.path.join(ROOT, "build", "chip_smoke", "config5_preview.png")
    rc = preview_checkpoint.main([ckpt, out, str(w), str(h), str(sc.camera.gamma)])
    with np.load(ckpt) as c:
        accum, spp_done = c["accum"], int(c["spp_done"])
    mean = torch.from_numpy((accum / spp_done).astype(np.float32).reshape(h, w, 3))
    want = tonemap_ops.tonemap(mean, sc.camera.gamma).numpy()
    prev = crr.load_png(out)
    diff = np.abs(prev.astype(int) - img.astype(int))
    if rc or spp_done != spp or not np.array_equal(prev, want) or diff.max() > 1:
        raise AssertionError(f"preview_checkpoint: rc {rc}, spp_done {spp_done}, preview equal "
                             f"to the accumulator's tonemap {np.array_equal(prev, want)}, max "
                             f"|diff| from the render's image {diff.max()}")
    log("tools", f"preview_checkpoint on a two-chunk config-5 render ({w}²x{spp}spp, spp_chunk "
        f"{spp // 2}, {st.wall_seconds:.3f} s): spp_done {spp_done}, the PNG equals the tonemap "
        f"of the kept accumulator; against the render's image {(diff == 0).mean():.4%} of subpixels equal, "
        f"max |diff| {diff.max()}")
    return k


# ---- phases 31-32: rendering over a mesh of ranks (parallel/) ----

# frame → (scene module, build function, its kwargs, NEE). Phase 31 renders the
# first two through a world of one on NCCL, both on K1 (NCCL_TRACE: the
# kernel each trace must show); phase 32 renders the bench frame, one
# 4,194,304-ray chunk of the 32k scene (K1), the NEE frame (K2) and the 32k
# scene's NEE frame (the staged path: K2 and K3) (MESH_FRAMES) over 4 gloo
# ranks sharing the card, and RESUME_FRAME over 2.
NCCL_FRAMES = {
    "bench": ("bench_scene", "build", dict(width=512, height=512, spp=64, path_depth=8), False),
    "32k": ("bench_teapot_32k", "build", dict(width=512, height=512, spp=64, path_depth=8), False),
}
NCCL_TRACE = {"bench": {"K1": "bounce_kernel"}, "32k": {"K1": "bounce_kernel_big"}}
MESH_FRAMES = {
    "bench": NCCL_FRAMES["bench"],
    "32k-chunk": ("bench_teapot_32k", "build", dict(width=256, height=256, spp=64, path_depth=8),
                  False),
    "nee": ("bench_scene", "build", dict(width=256, height=256, spp=16, path_depth=8), True),
    "nee-32k": ("bench_teapot_32k", "build", dict(width=256, height=256, spp=16, path_depth=8),
                True),
}
RESUME_FRAME = ("bench_scene", "build", dict(width=256, height=256, spp=16, path_depth=8), False)
RESUME_SPP_CHUNK = 8  # two spp chunks; the render is killed at the first chunk of the second
RANKS_TIMEOUT = 300  # seconds for a group of spawned ranks, start-up included


def frame_scene(frame):
    import dataclasses
    import importlib

    module, fn, kw, nee = frame
    scene = getattr(importlib.import_module("cs397raytracingsp22_tpu_torch.scenes." + module),
                    fn)(**kw)
    if nee:
        scene = dataclasses.replace(scene, camera=dataclasses.replace(scene.camera, nee=True))
    return scene


def mesh_rank(rank: int, world: int, port: int, backend: str, device: str, mesh_shape, jobs,
              out_dir: str) -> None:
    """One spawned rank of phase 32: joins the group, renders each job over
    the mesh through render_to_image and saves its image, its stats and the
    kernels it launched (counts set to 0 just before each render and read
    just after). A job with `kill_after` raises at that chunk call on every
    rank, before the chunk's collectives, and saves nothing."""
    sys.path.insert(0, ROOT)
    import torch.distributed as dist

    from cs397raytracingsp22_tpu_torch.ops.kernels import bounce, scene_intersect, tri_scan_big
    from cs397raytracingsp22_tpu_torch.parallel import multihost, sharding
    from cs397raytracingsp22_tpu_torch.render import driver

    multihost.initialize(f"127.0.0.1:{port}", world, rank, backend=backend, device=device)
    mesh = sharding.make_device_mesh(*mesh_shape)
    real, report = driver.render_chunk, {}
    for job in jobs:
        scene = frame_scene(job["frame"])
        data = scene.compile(device=device)
        kw = dict(job["render"])
        if "checkpoint_path" in kw:
            kw["checkpoint_path"] = kw["checkpoint_path"].format(rank=rank)
            os.makedirs(os.path.dirname(kw["checkpoint_path"]), exist_ok=True)
        calls = []

        def chunk(*a, _calls=calls, _kill=job.get("kill_after"), **k):
            _calls.append(1)
            if _kill is not None and len(_calls) > _kill:
                raise RuntimeError("killed")
            return real(*a, **k)

        driver.render_chunk = chunk
        bounce.LAUNCHES = scene_intersect.LAUNCHES = tri_scan_big.LAUNCHES = 0
        try:
            img, st = driver.render_to_image(scene, device=device, seed=0, verbose=False,
                                             scene_data=data, mesh=mesh, **kw)
        except RuntimeError as e:
            if "killed" not in str(e):
                raise
            continue
        finally:
            driver.render_chunk = real
        report[job["name"]] = dict(
            launches=[bounce.LAUNCHES, scene_intersect.LAUNCHES, tri_scan_big.LAUNCHES],
            seconds=st.wall_seconds, compile_seconds=st.compile_seconds,
            segments=st.path_segments, device_count=st.device_count, chunks=st.chunks)
        np.save(os.path.join(out_dir, f"{job['name']}_r{rank}.npy"), img)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(report, f)
    dist.destroy_process_group()


def spawn_ranks(world: int, backend: str, device: str, mesh_shape, jobs, out_dir: str):
    """Run mesh_rank in `world` spawned processes; fails when any rank
    fails or the group outlives RANKS_TIMEOUT (every rank is killed).
    Returns (each rank's report, seconds of the group)."""
    import torch.multiprocessing as mp

    from cs397raytracingsp22_tpu_torch.parallel import multihost

    os.makedirs(out_dir, exist_ok=True)
    t0 = time.perf_counter()
    ctx = mp.start_processes(mesh_rank, args=(world, multihost.free_port(), backend, device,
                                              mesh_shape, jobs, out_dir),
                             nprocs=world, join=False, start_method="spawn")
    try:
        while not ctx.join(timeout=5):
            if time.perf_counter() - t0 > RANKS_TIMEOUT:
                raise AssertionError(f"{world} ranks still running after {RANKS_TIMEOUT} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    reports = []
    for r in range(world):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            reports.append(json.load(f))
    return reports, time.perf_counter() - t0


def collective_host_time(name: str) -> tuple[int, float]:
    """The all_reduce calls in device_trace's trace `name` and the host
    milliseconds they took (the union of the c10d::allreduce_ spans)."""
    with open(trace_file(name)) as f:
        spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                       for e in json.load(f)["traceEvents"]
                       if e.get("ph") == "X" and e.get("name") == "c10d::allreduce_")
    total, end = 0.0, -1.0
    for a, b in spans:
        total += max(0.0, b - max(a, end))
        end = max(end, b)
    return len(spans), total / 1e3


def read_accum(path: str) -> np.ndarray:
    with np.load(path) as f:
        return f["accum"]


def mesh_phases(dev) -> list:
    """Phases 31-32 (see the module docstring): the sharded driver on a
    world of one on NCCL, and over 4 (and 2) gloo ranks sharing the card.
    Returns the launches of K1, K2 and K3 on these paths."""
    import shutil

    import torch.distributed as dist

    from cs397raytracingsp22_tpu_torch.ops.kernels import bounce, scene_intersect, tri_scan_big
    from cs397raytracingsp22_tpu_torch.parallel import multihost, sharding
    from cs397raytracingsp22_tpu_torch.render import driver

    out = os.path.join(ROOT, "build", "chip_smoke", "mesh")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    counts = [0, 0, 0]  # K1, K2, K3

    def zero():
        bounce.LAUNCHES = scene_intersect.LAUNCHES = tri_scan_big.LAUNCHES = 0
        r1_reset()

    def read():
        got = [bounce.LAUNCHES, scene_intersect.LAUNCHES, tri_scan_big.LAUNCHES]
        r1_read()
        for i, n in enumerate(got):
            counts[i] += n
        return got

    # ---- 31. mesh-nccl: the sharded path on a world of one ----
    multihost.initialize(f"127.0.0.1:{multihost.free_port()}", 1, 0, device=dev)
    try:
        mesh = sharding.make_device_mesh(1, 1)
        for name, frame in NCCL_FRAMES.items():
            scene = frame_scene(frame)
            data = scene.compile(device=dev)

            def run(m, **kw):
                return driver.render_to_image(scene, device=dev, seed=0, verbose=False,
                                              scene_data=data, mesh=m, **kw)

            run(None)
            run(mesh)  # warm
            secs, launched = {"one": [], "mesh": []}, [0, 0, 0]
            for m in (None, mesh, mesh, None):  # in turns
                if m is not None:
                    zero()  # the sharded render's counts start here
                _, st = run(m)
                if m is not None:
                    launched = [a + b for a, b in zip(launched, read())]  # read just after
                    device_count = st.device_count
                secs["one" if m is None else "mesh"].append(st.wall_seconds)
            ck_one, ck_mesh = (os.path.join(out, f"nccl_{name}_{k}.npz") for k in ("one", "mesh"))
            img_one, st_one = run(None, checkpoint_path=ck_one)
            zero()
            img_mesh, st_mesh = run(mesh, checkpoint_path=ck_mesh)
            launched = [a + b for a, b in zip(launched, read())]
            if not np.array_equal(img_one, img_mesh):
                raise AssertionError(f"mesh-nccl {name}: the sharded image differs from one device's")
            if not np.array_equal(read_accum(ck_one), read_accum(ck_mesh)):
                raise AssertionError(f"mesh-nccl {name}: the sharded accumulator differs")
            if st_one.path_segments != st_mesh.path_segments or img_mesh.max() == 0:
                raise AssertionError(f"mesh-nccl {name}: segments {st_mesh.path_segments} against "
                                     f"{st_one.path_segments}, u8 max {img_mesh.max()}")
            if launched[0] < 1 or launched[1] or launched[2]:
                raise AssertionError(f"mesh-nccl {name}: the sharded renders launched K1, K2, K3 "
                                     f"{launched} times; K1 alone renders the frame")
            one_s, mesh_s = (sum(secs[k]) / 2 for k in ("one", "mesh"))
            traces = {}
            for label, m in (("one", None), ("sharded", mesh)):
                tr = device_trace(f"mesh_nccl_{name}_{label}", lambda: run(m), NCCL_TRACE[name])
                calls, host_ms = collective_host_time(f"mesh_nccl_{name}_{label}")
                traces[label] = (f"{label}: {tr['kernels']} kernels, busy {tr['busy_ms']:.3f} ms, "
                                 f"idle {tr['idle']:.2%} of a {tr['span_ms']:.3f} ms span, wall "
                                 f"{tr['wall_ms']:.3f} ms, {calls} all_reduce calls taking "
                                 f"{host_ms:.3f} ms of host time")
            log("mesh-nccl", f"{name} {frame[2]['width']}²x{frame[2]['spp']}spp depth "
                f"{frame[2]['path_depth']}: a world of 1 on {dist.get_backend()}, mesh 1x1, "
                f"stats.device_count {device_count}: one device {one_s:.4f} s, sharded "
                f"{mesh_s:.4f} s an image ({mesh_s / one_s:.3f}x; mean of 2 after a warm render, "
                f"in turns: one {secs['one'][0]:.4f} / {secs['one'][1]:.4f}, sharded "
                f"{secs['mesh'][0]:.4f} / {secs['mesh'][1]:.4f}); {st_mesh.chunks} chunk(s), "
                f"{st_mesh.path_segments} segments; u8 image and HDR accumulator bit-identical to "
                f"one device's; launches of the 3 sharded renders K1 {launched[0]}, K2 "
                f"{launched[1]}, K3 {launched[2]}")
            log("mesh-nccl", f"{name}, one render of each traced (torch.profiler): "
                + "; ".join(traces[k] for k in ("one", "sharded")))
    finally:
        dist.destroy_process_group()

    # ---- 32. mesh-ranks: 4 gloo ranks sharing the card, then 2 ----
    rank_dev = "cuda:0" if dev.type == "cuda" else "cpu"

    def one_device(name, frame, spp_chunk, n_sp, n_dp):
        """The one-device reference at spp_chunk / n_sp, at the sharded
        render's pixel chunk."""
        scene = frame_scene(frame)
        data = scene.compile(device=dev)
        px = driver.chunk_pixels(data, scene.camera, spp_chunk)
        px = max(n_dp, px - px % n_dp)
        ck = os.path.join(out, f"{name}_one.npz")
        img, st = driver.render_to_image(scene, device=dev, seed=0, verbose=False,
                                         scene_data=data, spp_chunk=spp_chunk // n_sp,
                                         pixel_chunk=px, checkpoint_path=ck)
        return img, read_accum(ck), st, px

    def check_group(what, reports, seconds, names, refs, group_dir, world):
        for name in names:
            img_ref, acc_ref, st_ref, _ = refs[name]
            for r in range(world):
                if not np.array_equal(np.load(os.path.join(group_dir, f"{name}_r{r}.npy")), img_ref):
                    raise AssertionError(f"{what} {name}: rank {r}'s image differs from one device's")
                if os.path.exists(os.path.join(group_dir, name, f"r{r}", "c.npz")) != (r == 0):
                    raise AssertionError(f"{what} {name}: rank {r} wrote a checkpoint" if r else
                                         f"{what} {name}: rank 0 wrote no checkpoint")
            if not np.array_equal(read_accum(os.path.join(group_dir, name, "r0", "c.npz")), acc_ref):
                raise AssertionError(f"{what} {name}: the accumulator differs from one device's")
            rep = [rp[name] for rp in reports]
            if {x["segments"] for x in rep} != {st_ref.path_segments}:
                raise AssertionError(f"{what} {name}: segments {[x['segments'] for x in rep]} "
                                     f"against {st_ref.path_segments}")
            per_rank = [x["launches"] for x in rep]
            for i in range(3):
                counts[i] += sum(lr[i] for lr in per_rank)
            log(what, f"{name}: every rank's u8 image and rank 0's HDR accumulator bit-identical "
                f"to one device at spp_chunk / 2 ({st_ref.path_segments} segments); wall s per "
                f"rank {[round(x['seconds'], 4) for x in rep]} (compile window "
                f"{[round(x['compile_seconds'], 4) for x in rep]}), one device {st_ref.wall_seconds:.4f} s "
                f"at spp_chunk / 2; launches per rank (K1, K2, K3) {per_rank}")
        log(what, f"group of {world} ranks: {seconds:.1f} s, start-up and kernel loading included")

    refs = {}
    for name, frame in MESH_FRAMES.items():
        refs[name] = one_device(name, frame, frame[2]["spp"], 2, 2)
    groups = [("mesh-ranks", 4, "gloo", rank_dev, (2, 2))]
    n_cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    if n_cards > 1:  # one NCCL rank a card, as many as make a mesh with n_sp = 2
        groups.append(("mesh-nccl-cards", 4 if n_cards >= 4 else 2, "nccl", "cuda",
                       (2, 2) if n_cards >= 4 else (1, 2)))
    for what, world, backend, device, shape in groups:
        group_dir = os.path.join(out, what)
        jobs = [dict(name=name, frame=frame, render=dict(
            checkpoint_path=os.path.join(group_dir, name, "r{rank}", "c.npz")))
            for name, frame in MESH_FRAMES.items()]
        reports, seconds = spawn_ranks(world, backend, device, shape, jobs, group_dir)
        log(what, f"{world} {backend} ranks on {device if backend == 'gloo' else 'a card each'}, "
            f"mesh {shape[0]}x{shape[1]}")
        check_group(what, reports, seconds, list(MESH_FRAMES), refs, group_dir, world)

    # the 2-rank checkpoint resume: killed at the first chunk of its second
    # spp chunk, resumed from rank 0's file on both ranks
    img_ref, acc_ref, st_ref, px = one_device("resume", RESUME_FRAME, RESUME_SPP_CHUNK, 2, 1)
    n_px = RESUME_FRAME[2]["width"] * RESUME_FRAME[2]["height"]
    group_dir = os.path.join(out, "resume")
    ckpt = os.path.join(group_dir, "resume", "r{rank}", "c.npz")
    render = dict(spp_chunk=RESUME_SPP_CHUNK, checkpoint_path=ckpt)
    reports, seconds = spawn_ranks(2, "gloo", rank_dev, (1, 2), [
        dict(name="killed", frame=RESUME_FRAME, render=render, kill_after=-(-n_px // px)),
        dict(name="resume", frame=RESUME_FRAME, render=render)], group_dir)
    for r in range(2):
        if not np.array_equal(np.load(os.path.join(group_dir, f"resume_r{r}.npy")), img_ref):
            raise AssertionError(f"mesh-resume: rank {r}'s resumed image differs")
    if os.path.exists(os.path.join(group_dir, "resume", "r1", "c.npz")):
        raise AssertionError("mesh-resume: rank 1 wrote a checkpoint")
    if not np.array_equal(read_accum(os.path.join(group_dir, "resume", "r0", "c.npz")), acc_ref):
        raise AssertionError("mesh-resume: the resumed accumulator differs")
    left = [rp["resume"]["chunks"] for rp in reports]
    per_rank = [rp["resume"]["launches"] for rp in reports]
    for i in range(3):
        counts[i] += sum(lr[i] for lr in per_rank)
    log("mesh-resume", f"2 gloo ranks, mesh 1x2, {RESUME_FRAME[2]['width']}²x"
        f"{RESUME_FRAME[2]['spp']}spp at spp_chunk {RESUME_SPP_CHUNK}: killed at the first chunk of "
        f"the second spp chunk, checkpoint in rank 0's directory only, resumed on both ranks "
        f"({left[0]} chunk(s) left); image and accumulator bit-identical to the uninterrupted "
        f"one-device render at spp_chunk {RESUME_SPP_CHUNK // 2}; launches per rank {per_rank}; "
        f"{seconds:.1f} s for the group")
    if counts[0] < 1 or counts[1] < 1 or counts[2] < 1:
        raise AssertionError(f"the sharded paths launched K1, K2, K3 {counts} times")
    return counts


def main() -> int:
    t_script = time.perf_counter()
    # ---- 1. device ----
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    smi = nvidia_smi()
    dev = torch.device("cuda")
    log("device", f"{torch.cuda.get_device_name(0)} | nvidia-smi: {smi} | torch "
        f"{torch.__version__} CUDA {torch.version.cuda}")

    sys.path.insert(0, ROOT)
    from PIL import Image

    from cs397raytracingsp22_tpu_torch.ops.kernels import _build, bounce, draws, nee, resolve, shade
    from cs397raytracingsp22_tpu_torch.ops.kernels import scene_intersect, tri_scan, tri_scan_big
    from cs397raytracingsp22_tpu_torch.ops.kernels import wavefront
    from cs397raytracingsp22_tpu_torch.render import driver, integrator
    from cs397raytracingsp22_tpu_torch.scenes import bench_scene, cornell
    from cs397raytracingsp22_tpu_torch.utils import threefry

    # ---- 2. build ----
    t0 = time.perf_counter()
    _build.build_all(_build.KERNELS)
    build_s = time.perf_counter() - t0
    for kid, name, mod, kw in (("K1", "bounce", bounce, {}),
                               ("K1 no mesh", "bounce", bounce, {"dense": False}),
                               ("K1 sphere tree", "bounce", bounce, {"sph_tree": True}),
                               ("K4", "wavefront", wavefront, {}),
                               ("K4 last", "wavefront", wavefront, {"last": True}),
                               ("K4 no mesh", "wavefront", wavefront, {"dense": False}),
                               ("K4 no mesh last", "wavefront", wavefront,
                                {"dense": False, "last": True}),
                               ("K2", "scene_intersect", scene_intersect, {}),
                               ("K2 no mesh", "scene_intersect", scene_intersect,
                                {"dense": False}),
                               ("K2 sphere tree", "scene_intersect", scene_intersect,
                                {"sph_tree": True}),
                               ("K2 sphere tree no mesh", "scene_intersect", scene_intersect,
                                {"dense": False, "sph_tree": True}),
                               ("K3", "bvh_traverse", tri_scan_big, {}),
                               ("K5", "tri_scan", tri_scan, {}),
                               ("D1 camera rays", "draws", draws, {"entry": "camera_rays"}),
                               ("D1 bounce draws", "draws", draws, {"entry": "bounce_draws"}),
                               ("D1 counter uniforms", "draws", draws,
                                {"entry": "counter_uniforms"}),
                               ("R1", "resolve", resolve, {}),
                               ("R1 bare", "resolve", resolve, {"which": 0}),
                               ("S1", "shade", shade, {}),
                               ("S1 NEE", "shade", shade, {"nee": True}),
                               ("N1 sample", "nee", nee, {"entry": "nee_sample"}),
                               ("N1 contrib", "nee", nee, {"entry": "nee_contrib"})):
        regs, spill = mod.kernel_attrs(**kw)
        ptxas = [ln.strip() for ln in _build.BUILD_INFO[name]["log"].splitlines()
                 if "registers" in ln or "spill" in ln]
        log("build", f"{kid} csrc/{name}.cu ({_build.BUILD_INFO[name]['seconds']:.2f}s nvcc, all "
            f"{len(_build.KERNELS)} in {build_s:.2f}s): {regs} registers/thread, {spill} B local; "
            f"ptxas: {' | '.join(ptxas)}")
        if kid == "K1" and (regs > K1_MAX_REGS or spill):
            raise AssertionError(f"K1 has {regs} registers and {spill} B of spills; {K1_BLOCKS} "
                                 f"blocks an SM need at most {K1_MAX_REGS} and none")
        if (kid.startswith(("K4", "D1", "R1", "S1", "N1"))
                or kid in ("K1 no mesh", "K1 sphere tree", "K2 sphere tree",
                           "K2 sphere tree no mesh", "K3", "K5")
                ) and spill:
            raise AssertionError(f"{kid} spills {spill} B")
    for what, sc_ in (("the bench scene", bench_scene.build(64, 64, spp=4, path_depth=8)),
                      ("the Cornell box (no dense mesh)", cornell.build(64, 64, spp=4))):
        tables = sc_.compile(device=dev)
        blocks = bounce.resident_blocks(tables)
        staged = bounce.staged_bytes(tables)
        k4_blocks = [wavefront.resident_blocks(tables, last) for last in (False, True)]
        log("build", f"K1 with {what}'s tables staged ({tables.kscene.numel() * 4} B scene table, "
            f"{tables.ksl_tree.numel() * 4} B superleaf tree, {staged} B a block): {blocks} "
            f"resident blocks of 128 threads an SM ({blocks * 4} warps); K4 (the persistent "
            f"grid's blocks an SM) {k4_blocks[0]}, its last bounce {k4_blocks[1]}")
        if tables.dense_mesh_ids and blocks < K1_BLOCKS:
            raise AssertionError(f"K1 keeps {blocks} blocks an SM resident, not {K1_BLOCKS}")
    # ---- 19-20. the probes' registers and spills; the SASS check ----
    probe_build_and_sass(build_s)
    # ---- 35. the draws kernels against their plain versions ----
    draw_rows = draws_phase(dev)
    # ---- 36. K1's sphere tree on the final scene of The Next Week ----
    rtnw_phase(dev)
    # ---- 40. K2's sphere tree on the same scene under NEE ----
    tree_row = rtnw_nee_phase(dev)
    # ---- 37. the merged-resolve kernel against its plain version ----
    resolve_row = resolve_phase(dev)
    # ---- 38. the shading kernel against its plain version ----
    shade_row = shade_phase(dev)
    # ---- 39. NEE's light-sample kernel against its plain versions ----
    nee_row = nee_phase(dev)

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
    draws_reset()
    frame()  # warm
    torch.cuda.synchronize()
    reps = 3
    t0 = time.perf_counter()
    for _ in range(reps):
        sums, seg = frame()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / reps
    launches = bounce.LAUNCHES  # the main path's count, read just after
    draws_read()
    segments = int(seg)
    full = torch.cat(sums)
    k1_mean = full.mean().item() / spp  # mean HDR radiance of a sample, for phase 25
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
    draws_reset()
    runs = [driver.render_to_image(sc64, device=dev, seed=0, verbose=False, scene_data=d64)
            for _ in range(2)]
    launches += bounce.LAUNCHES
    draws_read()
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
    # ---- 25-27: NEE and Phong, whose rays K2 (and K3) intersect ----
    nee_phong = nee_phong_phases(dev, k1_mean, width, height, spp, depth)
    # ---- 28-30: textures, normal maps and general volumes on the staged path ----
    textured = textured_phases(dev)
    # ---- 31-32: the sharded driver over a mesh of ranks ----
    t_mesh = time.perf_counter()
    k1_mesh, k2_mesh, k3_mesh = mesh_phases(dev)
    log("mesh", f"phases 31-32 took {time.perf_counter() - t_mesh:.1f} s; the script so far "
        f"{time.perf_counter() - t_script:.1f} s")
    # ---- 33-34: config 5 on K1 and on the staged path; the tools ----
    t_c5 = time.perf_counter()
    c5 = config5_phases(dev)
    tools = tools_phases(dev)
    log("tools", f"phases 33-34 took {time.perf_counter() - t_c5:.1f} s; the script so far "
        f"{time.perf_counter() - t_script:.1f} s")
    staged[0]["launches"] += nee_phong["k2"] + textured["k2"] + k2_mesh + c5["k2"] + tools["k2"]
    staged[1]["launches"] += nee_phong["k3"] + textured["k3"] + k3_mesh + c5["k3"] + tools["k3"]
    print(json.dumps({"kernels": [{
        "name": "mega_bounce",
        "route": "cuda",
        "source": "cs397raytracingsp22_tpu_torch/csrc/bounce.cu",
        "replaces": "cs397raytracingsp22_tpu/ops/pallas/bounce.py:1480",
        "launches": launches + k1_mesh + c5["k1"] + tools["k1"],
        "max_abs_err": max_abs_err,
        "ms": k_ms,
        "plain_ms": p_ms,
        "bound_ms": k1_bound_ms,
        "bound_by": k1_by,
        "library_ms": None,
    }] + staged + k45 + probes + [dict(row, launches=D1_MAIN[row["name"][6:]])
                                  for row in draw_rows]
        + [dict(resolve_row, launches=R1_MAIN[0]), dict(shade_row, launches=S1_MAIN[0]),
           dict(nee_row, launches=N1_MAIN[0]), tree_row]}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
