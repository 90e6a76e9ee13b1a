"""Hold this checkout's scene-intersection kernel (K2) against the same
kernel built from other source trees, on the card: rows that differ,
registers, resident blocks and times in turns.

    python -m cs397raytracingsp22_tpu_torch.tools.compare_k2 CSRC[:threads=N] [...]

Each CSRC is a csrc/ directory: a parent commit's, unpacked with
`git archive <commit> cs397raytracingsp22_tpu_torch/csrc`, or an edited
copy of this checkout's (a design variant). `:threads=N` builds that
source with N threads a block (its `kThreads` replaced), and `.` names
this checkout's csrc/. Every build uses this checkout's nvcc flags
(ops/kernels/_build.py). A K2 whose source lacks
rt_scene_intersect_occupancy (the design of one thread a ray in blocks of
128, each staging the tables) is launched with that older argument list,
and built from a shim that includes its source and adds the occupancy
query, so its resident blocks print too.

Inputs, the five on which K2's dense-mesh gap was found (PERF.md):
- the NEE frame's chunk 0 (bench teapot_6k with NEE, 512² × 64 spp,
  depth 8: 1,048,576 rays), its bounce-0 rays and their shadow rays, as
  the NEE executor hands them to the fused intersection;
- config 4 on its stand-in assets (two textured spheres, 7,936 dense
  triangles), chunk 0's bounce-0 rays;
- the kitchen sink at 256² × 16 spp, chunk 0's bounce-0 rays;
- the 32k bench scene (no dense mesh), chunk 0's 4,194,304 bounce-0 rays.

Printed: the card's nvidia-smi name and power limit; each build's ptxas
registers and spills, its resident blocks an SM for each scene's staged
bytes, and this checkout's grid; for the dense-mesh inputs, the walk of
each warp's 32 neighbouring rays as the plain version counts it (tree
nodes a lane against the warp's busiest lane, superleaves a warp scans);
the rows that differ, bit for bit, from this checkout's build, the first
few with both outputs as float32 bits; and each build's milliseconds a
launch by CUDA events, in turns (this checkout, the others, then back,
twice), after a warm launch. With `--floors`, each build also runs each
input with the walk left out (n_mesh = 0, the floor without the walk) and
with neither the walk nor the trees staged (tree_len = 0): their
difference is what staging the trees costs a launch.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import os
import re
import statistics
import subprocess

import torch

from cs397raytracingsp22_tpu_torch.ops import intersect as isect
from cs397raytracingsp22_tpu_torch.ops.kernels import _build, scene_intersect
from cs397raytracingsp22_tpu_torch.ops.kernels.bounce import staged_bytes
from cs397raytracingsp22_tpu_torch.render import driver, integrator
from cs397raytracingsp22_tpu_torch.scenes import bench_scene, bench_teapot_32k, kitchen_sink
from cs397raytracingsp22_tpu_torch.scenes import textured_spheres
from cs397raytracingsp22_tpu_torch.utils import rng, threefry

WALK_RAYS = 65536  # rays (2,048 warps) of each input whose walk is counted


def _chunk0(sc, dev, key):
    """Chunk 0 of render_to_image(seed=0)'s camera rays of scene `sc`."""
    cam = sc.camera
    sd = sc.compile(device=dev)
    px = driver.chunk_pixels(sd, cam, cam.aa_sample_count)
    nch = (cam.screen_width * cam.screen_height + px - 1) // px
    ids = torch.arange(px, dtype=torch.int32, device=dev) * nch
    return sd, driver._gen_chunk_rays(cam, ids, key, 0, cam.aa_sample_count, 1)


def _bounce0(sd, cam, o, d, uids, key):
    n = o.shape[0]
    u_vol = integrator._bounce_draws(sd, key, uids, rng.SITE_BOUNCE0)[2]
    return (o.contiguous(), d.contiguous(),
            torch.full((n,), integrator.PATH_T_MIN, device=o.device),
            torch.full((n,), cam.max_trace_dist, device=o.device),
            u_vol[:, :sd.vol_center.shape[0]].contiguous())


def k2_inputs(dev) -> list:
    """[(name, SceneData, (o, d, t_min, t_max, u_vol))] of the five inputs."""
    key = threefry.key_words(0)
    out = []
    sc = bench_scene.build(512, 512, spp=64, path_depth=8)
    sc = dataclasses.replace(sc, camera=dataclasses.replace(sc.camera, nee=True))
    sd, (o, d, uids) = _chunk0(sc, dev, key)
    calls = []

    def record(*a):
        if len(calls) < 2:
            calls.append(a)
        return isect.intersect_scene(*a)

    integrator.path_trace_shrink(sd, o, d, uids, key, sc.camera.path_depth,
                                 sc.camera.max_trace_dist, nee=True, intersect=record)
    n = o.shape[0]
    for name, (_, o_, d_, t0, t1, u_) in zip(("NEE bounce 0", "NEE shadow rays"), calls):
        full = [torch.broadcast_to(torch.as_tensor(t, dtype=torch.float32, device=dev), (n,))
                .contiguous() for t in (t0, t1)]
        out.append((name, sd, (o_.contiguous(), d_.contiguous(), *full,
                               u_[:, :sd.vol_center.shape[0]].contiguous())))
    sc4 = textured_spheres.build(512, 512, spp=32, lens_radius=0.08,
                                 asset_dir=textured_spheres.stand_in_dir())
    sd4, rays = _chunk0(sc4, dev, key)
    out.append(("config 4 bounce 0", sd4, _bounce0(sd4, sc4.camera, *rays, key)))
    sck = kitchen_sink.build(256, 256, spp=16, path_depth=5)
    sdk, rays = _chunk0(sck, dev, key)
    out.append(("kitchen sink bounce 0", sdk, _bounce0(sdk, sck.camera, *rays, key)))
    sc32 = bench_teapot_32k.build(512, 512, spp=64, path_depth=8)
    sd32, rays = _chunk0(sc32, dev, key)
    out.append(("32k bounce 0", sd32, _bounce0(sd32, sc32.camera, *rays, key)))
    return out


def walk_of_warps(sd, ins) -> str:
    """The walk of WALK_RAYS / 32 warps spread evenly over the input (each
    32 neighbouring rays, a tile), as the plain version counts it against
    each ray's final hit: tree nodes a lane (mean) against the warp's
    busiest lane (mean over warps), and superleaves a warp scans together
    (mean, max)."""
    warps = ins[0].shape[0] // 32
    pick = torch.arange(0, warps, max(1, warps // (WALK_RAYS // 32)), device=ins[0].device)
    rows = (pick[:, None] * 32 + torch.arange(32, device=pick.device)).reshape(-1)
    st = {}
    scene_intersect.scene_intersect_plain(sd, *[x[rows] for x in ins], stats=st)
    nodes = st["nodes"].view(-1, 32).double()
    leaves = (st["tris"] // 16).view(-1, 32).double().sum(dim=1)
    busiest = nodes.max(dim=1).values
    return (f"nodes a lane {nodes.mean():.2f}, the warp's busiest lane {busiest.mean():.2f} "
            f"({busiest.mean() / nodes.mean():.2f}x); superleaves a warp scans {leaves.mean():.2f} "
            f"(max {int(leaves.max())}), {leaves.mean() / 32:.2f} a lane, over {nodes.shape[0]} "
            f"warps")


def _ptxas(log: str) -> str:
    lines = [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
    return " | ".join(lines) or "no ptxas output"


_P, _I = ctypes.c_void_p, ctypes.c_int
_OLD_ARGS = [_P, _P, _P, _P, _P, _I, _I, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _I] + [_P] * 9
_SHIM = """#include "{src}"
// The occupancy query of the earlier design (one thread a ray, kThreads a block).
extern "C" int rt_scene_intersect_occupancy(int scene_len, int tree_len, int n_mesh,
                                            int* blocks, int* threads) {{
  const size_t smem = staged_bytes(scene_len, tree_len);
  if (smem > 48 * 1024 &&
      cudaFuncSetAttribute(scene_intersect_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem) != cudaSuccess)
    return (int)cudaGetLastError();
  *threads = kThreads;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, scene_intersect_kernel,
                                                            kThreads, smem);
}}
"""


class Build:
    """K2 built from one csrc/ directory (with its threads a block replaced
    when asked)."""

    def __init__(self, spec: str, index: int):
        self.name = spec
        csrc, _, opt = spec.partition(":")
        csrc = _build.CSRC_DIR if csrc == "." else os.path.abspath(csrc)
        out_dir = os.path.join(_build.BUILD_DIR, "compare_k2", str(index))
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(csrc, "scene_intersect.cu")) as f:
            text = f.read()
        self.new = "rt_scene_intersect_occupancy" in text
        if opt:
            threads = int(opt.removeprefix("threads="))
            text, k = re.subn(r"constexpr int kThreads = \d+;",
                              f"constexpr int kThreads = {threads};", text)
            if k != 1:
                raise ValueError(f"{spec}: no kThreads to replace")
        for name in os.listdir(csrc):
            if name.endswith(".cuh"):
                with open(os.path.join(csrc, name)) as f, \
                        open(os.path.join(out_dir, name), "w") as g:
                    g.write(f.read())
        src = os.path.join(out_dir, "scene_intersect.cu")
        with open(src, "w") as f:
            f.write(text)
        if not self.new:
            src = os.path.join(out_dir, "shim.cu")
            with open(src, "w") as f:
                f.write(_SHIM.format(src="scene_intersect.cu"))
        self.path = os.path.join(out_dir, "libscene_intersect.so")
        self.proc = subprocess.Popen(
            [_build.nvcc_path(), *_build._flags("scene_intersect"), "-o", self.path, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    def wait(self) -> None:
        self.log = self.proc.communicate()[0]
        if self.proc.returncode != 0:
            raise RuntimeError(f"nvcc failed to build {self.name}:\n{self.log}")
        self.lib = ctypes.CDLL(self.path)
        self.lib.rt_scene_intersect_launch.argtypes = (scene_intersect._ARGTYPES if self.new
                                                       else _OLD_ARGS)
        self.lib.rt_scene_intersect_launch.restype = _I
        self.lib.rt_scene_intersect_occupancy.argtypes = [_I, _I, _I, ctypes.POINTER(_I),
                                                          ctypes.POINTER(_I)]
        self.lib.rt_scene_intersect_occupancy.restype = _I

    def occupancy(self, sd, walk: bool = True) -> tuple[int, int]:
        blocks, threads = _I(), _I()
        rc = self.lib.rt_scene_intersect_occupancy(
            int(sd.kscene.numel()), int(sd.ksl_tree.numel()),
            len(sd.dense_mesh_ids) if walk else 0, ctypes.byref(blocks), ctypes.byref(threads))
        if rc != 0:
            raise RuntimeError(f"{self.name}: the occupancy query failed with CUDA error {rc}")
        return blocks.value, threads.value

    def launch(self, sd, ins, out, walk: bool = True, trees: bool = True) -> None:
        """One launch into the outputs `out` (walk False: no dense mesh
        walked; trees False: no superleaf tree staged either)."""
        o, d, t_min, t_max, u_vol = ins
        n = o.shape[0]
        stream = torch.cuda.current_stream().cuda_stream
        head = [o.data_ptr(), d.data_ptr(), t_min.data_ptr(), t_max.data_ptr(), u_vol.data_ptr(),
                int(u_vol.shape[1]), n]
        if self.new:
            per_sm, threads = self.occupancy(sd, walk)
            sms = torch.cuda.get_device_properties(0).multi_processor_count
            grid = scene_intersect.grid_blocks(n, per_sm, sms, threads)
            n_static = scene_intersect.static_tiles(-(-n // 32), grid * threads // 32,
                                                    walk and bool(sd.dense_mesh_ids))
            head += [grid, n_static, scene_intersect.ticket(o.device, stream).data_ptr()]
        rc = self.lib.rt_scene_intersect_launch(
            *head, sd.kscene.data_ptr(), int(sd.kscene.numel()), sd.n_spheres, sd.n_planes,
            sd.n_tris, sd.n_volumes, int(sd.mat_type.shape[0]),
            len(sd.dense_mesh_ids) if walk else 0, sd.kmesh_tri4.data_ptr(),
            sd.ksl_tree.data_ptr(), int(sd.ksl_tree.numel()) if trees else 0,
            *(x.data_ptr() for x in out), stream)
        if rc != 0:
            raise RuntimeError(f"{self.name}: K2 failed to launch with CUDA error {rc}")


def _bits(x) -> torch.Tensor:
    """Each row of an output as comparable integers (float32 as its bits)."""
    x = x.view(torch.int32) if x.dtype == torch.float32 else x.to(torch.int32)
    return x.reshape(x.shape[0], -1)


def _row_bits(out, i) -> str:
    return " ".join("[" + " ".join(f"{int(b):#010x}" for b in _bits(x)[i].cpu()) + "]"
                    for x in out)


def _time(builds, sd, ins, outs, reps, **kw) -> dict:
    ms = {b.name: [] for b in builds}
    for b in builds + builds[::-1] + builds + builds[::-1]:
        b.launch(sd, ins, outs[b.name], **kw)
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            b.launch(sd, ins, outs[b.name], **kw)
        end.record()
        torch.cuda.synchronize()
        ms[b.name].append(start.elapsed_time(end) / reps)
    return ms


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("csrc", nargs="*", help="csrc/ directories to build K2 from (DIR[:threads=N])")
    ap.add_argument("--reps", type=int, default=10, help="launches a timed turn")
    ap.add_argument("--floors", action="store_true",
                    help="also time each input without the walk, and without the trees staged")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("compare_k2: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(f"device: {smi}", flush=True)
    builds = [Build(".", "this")] + [Build(s, i) for i, s in enumerate(args.csrc)]
    builds[0].name = "this checkout"
    for b in builds:
        b.wait()
    dev = torch.device("cuda")
    _build.build_all(("scene_intersect",))  # the package's own, for the walk's plain counts
    inputs = k2_inputs(dev)
    scenes = {}
    for _, sd, _ in inputs:
        scenes.setdefault(id(sd), sd)
    for b in builds:
        occ = "; ".join(f"{staged_bytes(sd)} B staged: {b.occupancy(sd)[0]} blocks of "
                        f"{b.occupancy(sd)[1]} threads an SM" for sd in scenes.values())
        print(f"{b.name}{'' if b.new else ' (one thread a ray, a block a 128-ray slice)'}: "
              f"{_ptxas(b.log)}; {occ}", flush=True)
    for name, sd, ins in inputs:
        n = ins[0].shape[0]
        line = (f"{name}: {n} rays, {int((ins[3] > ins[2]).sum())} with a window; "
                f"{len(sd.dense_mesh_ids)} dense meshes, {staged_bytes(sd)} B staged")
        if builds[0].new:
            cfg = scene_intersect.launch_config(sd, n)
            line += (f"; this checkout's grid {cfg['grid']} blocks of {cfg['threads']} threads "
                     f"({cfg['blocks_per_sm']} an SM x {cfg['sms']} SMs), {cfg['tiles']} tiles, "
                     f"{cfg['static_tiles']} of them by the fixed rule")
        if sd.dense_mesh_ids:
            line += f"; walk: {walk_of_warps(sd, ins)}"
        print(line, flush=True)
        outs = {b.name: scene_intersect.empty_outputs(n, dev) for b in builds}
        ref = outs["this checkout"]
        builds[0].launch(sd, ins, ref)
        for b in builds[1:]:
            b.launch(sd, ins, outs[b.name])
            diff = torch.zeros((n,), dtype=torch.bool, device=dev)
            for a, r in zip(outs[b.name], ref):
                diff |= (_bits(a) != _bits(r)).any(dim=1)
            rows = diff.nonzero()[:8, 0].tolist()
            print(f"  {b.name}: {int(diff.sum())} rows differ from this checkout's, bit for bit; "
                  f"first rows {rows}", flush=True)
            for i in rows[:4]:
                print(f"    row {i}: this checkout {_row_bits(ref, i)}; {b.name} "
                      f"{_row_bits(outs[b.name], i)}", flush=True)
        kinds = [("", {})]
        if args.floors:
            kinds += [(" without the walk", dict(walk=False)),
                      (" without the walk or the trees", dict(walk=False, trees=False))]
        for what, kw in kinds:
            ms = _time(builds, sd, ins, outs, args.reps, **kw)
            for bname, t in ms.items():
                print(f"  {name}{what} {bname}: {', '.join(f'{x:.4f}' for x in t)} ms a launch, "
                      f"median {statistics.median(t):.4f} ms", flush=True)
        del outs, ref
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
