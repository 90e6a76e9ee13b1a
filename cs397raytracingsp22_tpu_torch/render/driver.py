"""Render driver: chunked batch rendering, on-device accumulation, image I/O.

Mirrors `cs397raytracingsp22_tpu/render/driver.py`: one loop for one
device, a ("dp", "sp") mesh of ranks on one host and many hosts
(parallel/). Pixels go in chunks (each chunk generates pixel×spp rays,
traces them and sums per pixel); the per-chunk sums accumulate on the
device in float32 and only the tonemapped u8 image comes back to the host.
The RNG follows ray content, so chunk sizes never change the image. The
host waits for the card only at the end, and in a verbose render for its
progress lines (after the first chunk, then every SYNC_EVERY chunks); the
compile and steady windows of the stats are read from marks on the
device's timeline.

`render_chunk` routes as the JAX package's render_chunk_core does:
- Phong shading to integrator.phong_trace (two scene intersections a ray:
  the camera ray and the shadow ray);
- `Camera(nee=True)` to the staged executor integrator.path_trace_shrink
  with nee=True, the next-event estimator (render/nee.py), on any scene:
  the mega-bounce kernel computes the reference estimator only;
- a scene that passes `scene_is_simple` to the mega-bounce kernel
  (ops/kernels/bounce.py; its plain version for CPU tensors), among them
  a scene whose only mesh is past the dense budget, whose BVH it walks;
- any other scene (a normal map, a material synthesized from textures, a
  general-boundary volume, a big mesh beside another mesh or a sphere
  tree) to the staged executor.
Phong, NEE and the staged executor intersect through
ops/intersect.py::intersect_scene: the scene-intersection kernel K2 (and
the big-mesh kernel K3 per big mesh) for CUDA tensors, their plain
versions for CPU tensors. Nothing on the GPU path falls back to the CPU
or to a plain version.

`render_to_image(checkpoint_path=...)` persists the HDR accumulator after
every spp chunk and resumes from it: a `.npz` with `accum` (the per-pixel
sum in raster order, float64), `spp_done`, `seed` and `nee`, the layout
the JAX package writes and reads, so either package resumes the other's.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Optional

import numpy as np
import torch

from cs397raytracingsp22_tpu_torch.models.camera import Camera, ShadingMode
from cs397raytracingsp22_tpu_torch.models.scene import Scene, SceneData, resolve_device
from cs397raytracingsp22_tpu_torch.ops import tonemap as tonemap_ops
from cs397raytracingsp22_tpu_torch.ops.kernels import bounce as bounce_kernel
from cs397raytracingsp22_tpu_torch.render import integrator
from cs397raytracingsp22_tpu_torch.utils import profiling, threefry

# work budget of one chunk in ray·primitive·bounce units (driver.py:471);
# 32× that for big-mesh scenes, whose staged executor pays per-bounce host
# work (driver.py:474-484), so their chunks are larger
CHUNK_WORK_BUDGET = 1 << 36
BIG_MESH_BUDGET_SHIFT = 5
# chunks between the progress lines of a verbose render, at each of which
# the host waits for the card (the JAX driver's sync_every)
SYNC_EVERY = 8
# runs of a chunk again after the card ran out of memory
CHUNK_RETRIES = 2


@dataclasses.dataclass
class RenderStats:
    """Per-render metrics."""

    width: int = 0
    height: int = 0
    spp: int = 0
    path_depth: int = 0
    wall_seconds: float = 0.0
    # to the end of the first chunk on the device: the kernels' first load,
    # the allocator's warm-up
    compile_seconds: float = 0.0
    primary_rays: int = 0
    path_segments: int = 0
    # the chunks after the first, less the checkpoints' writes; zero for a
    # render of one chunk. The rates below come from this window when
    # there is one, else from the whole wall time
    steady_seconds: float = 0.0
    steady_segments: int = 0
    steady_primary: int = 0
    device_count: int = 1
    chunks: int = 0
    device: str = ""
    # mean HDR radiance of one sample over the image and channels (the
    # accumulator's mean over spp; a resumed render's includes the
    # checkpoint's samples)
    mean_radiance: float = 0.0
    # pixels whose HDR sum holds a NaN or inf (a mapped normal over a
    # triangle whose uv determinant is 0 gives the reference's NaN)
    nonfinite_pixels: int = 0

    @property
    def primary_mrays_per_sec(self) -> float:
        if self.steady_seconds > 0:
            return self.steady_primary / self.steady_seconds / 1e6
        return self.primary_rays / (self.wall_seconds or 1e-9) / 1e6

    @property
    def segment_mrays_per_sec(self) -> float:
        if self.steady_seconds > 0:
            return self.steady_segments / self.steady_seconds / 1e6
        return self.path_segments / (self.wall_seconds or 1e-9) / 1e6

    def summary(self) -> str:
        return (
            f"{self.width}x{self.height} @ {self.spp}spp depth {self.path_depth} | "
            f"{self.wall_seconds:.3f}s wall ({self.compile_seconds:.3f}s compile), "
            f"{self.chunks} chunk(s) | {self.primary_mrays_per_sec:.1f} Mrays/s primary, "
            f"{self.segment_mrays_per_sec:.1f} Mrays/s segments | {self.device}, "
            f"{self.device_count} device(s)"
        )


def _gen_chunk_rays(camera: Camera, pixel_ids, rng_key, sample_offset, spp: int, n_chains: int):
    """Camera rays and chain uids for one chunk: (N, 3), (N, 3), (N,) int32.
    Profiler traces show the work as the span "raygen"."""
    with profiling.span("raygen"):
        o, d = camera.generate_rays(rng_key, pixel_ids, spp=spp, sample_offset=sample_offset)
    o = o.reshape(-1, 3)
    d = d.reshape(-1, 3)
    sample_ids = sample_offset + torch.arange(spp, dtype=torch.int32, device=pixel_ids.device)
    uids = (pixel_ids.to(torch.int32)[:, None] * camera.aa_sample_count + sample_ids[None, :]).reshape(-1)
    if n_chains > 1:
        o = o.repeat_interleave(n_chains, dim=0)
        d = d.repeat_interleave(n_chains, dim=0)
        uids = (
            uids[:, None] * n_chains
            + torch.arange(n_chains, dtype=torch.int32, device=uids.device)
        ).reshape(-1)
    return o.contiguous(), d.contiguous(), uids.contiguous()


def render_chunk(
    scene: SceneData,
    camera: Camera,
    pixel_ids: torch.Tensor,
    rng_key,
    sample_offset: int,
    spp: int,
    n_chains: int = 1,
):
    """Render one pixel chunk at `spp` samples on pixel_ids' device.

    Returns (radiance_sum (n_px, 3) — per-pixel SUM over this chunk's
    samples — and the int64 count of traced segments: under Phong the
    camera rays, under NEE the path segments and the shadow rays shot).
    Every executor gives the image the others would on the same estimator:
    the RNG counters are shared."""
    n_px = pixel_ids.shape[0]
    o, d, uids = _gen_chunk_rays(camera, pixel_ids, rng_key, sample_offset, spp, n_chains)
    args = (scene, o, d, uids, rng_key, camera.path_depth, camera.max_trace_dist)
    if camera.shading_mode is ShadingMode.PHONG:
        radiance = integrator.phong_trace(scene, o, d, uids, rng_key, camera.eyepoint,
                                          camera.max_trace_dist)
        segments = torch.tensor(o.shape[0], dtype=torch.int64, device=o.device)
    elif camera.nee or not bounce_kernel.scene_is_simple(scene):
        radiance, segments = integrator.path_trace_shrink(*args, nee=camera.nee)
    else:
        # K1 for CUDA tensors, its plain version for CPU tensors
        with profiling.span("render.k1"):
            radiance, segments = bounce_kernel.path_trace_cuda(*args)
    radiance = radiance.reshape(n_px, spp * n_chains, 3)
    return radiance.sum(dim=1) / n_chains, segments


def _raster(pieces, n_px: int) -> torch.Tensor:
    """The interleaved chunks' sums in raster order: pieces[ci][j] holds
    pixel ci + nc·j, so de-interleaving is a transpose, and the padding of
    a ragged tail lands past n_px, where the slice drops it."""
    return torch.stack(pieces).transpose(0, 1).reshape(-1, 3)[:n_px]


def _finalize_image(pieces, n_px: int, spp: int, gamma: float) -> torch.Tensor:
    """Mean, channel bleed, gamma, u8, of the interleaved chunks' sums."""
    return tonemap_ops.tonemap(_raster(pieces, n_px) / float(max(spp, 1)), gamma)


def chunk_pixels(scene_data: SceneData, camera: Camera, spp_chunk: int) -> int:
    """Pixels per chunk from a work budget (ray segments × primitive
    tests, a general volume's boundary triangles among them; 32× larger
    for big-mesh scenes), rounded down to a power of two
    (driver.py:451-492)."""
    n_px_total = camera.screen_width * camera.screen_height
    per_px_rays = max(1, spp_chunk * max(1, camera.path_samples))
    prim_tests = (
        scene_data.n_spheres + scene_data.n_planes + scene_data.n_tris
        + scene_data.n_volumes + sum(int(g.shape[0]) for g in scene_data.gvol_tri)
        + sum(int(m.tri_verts.shape[0]) for m in scene_data.meshes)
    )
    work_per_px = per_px_rays * max(1, camera.path_depth) * max(16, prim_tests)
    budget = CHUNK_WORK_BUDGET
    if integrator.has_big_mesh(scene_data):
        budget <<= BIG_MESH_BUDGET_SHIFT
    pixel_chunk = max(1, min(n_px_total, budget // work_per_px))
    if pixel_chunk < n_px_total:
        pixel_chunk = 1 << (pixel_chunk.bit_length() - 1)
    return pixel_chunk


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _load_checkpoint(path: str, n_px: int, seed: int):
    """(accum (n_px, 3) float32 raster order, spp_done, nee flag or -1 when
    the file has none), or None when there is no file or it belongs to
    another image size or seed (driver.py:727-747 in the JAX package)."""
    if not os.path.exists(path):
        return None
    with np.load(path, allow_pickle=False) as ckpt:
        if ckpt["accum"].shape != (n_px, 3) or int(ckpt["seed"]) != seed:
            return None
        nee = int(ckpt["nee"]) if "nee" in ckpt.files else -1
        return ckpt["accum"].astype(np.float32), int(ckpt["spp_done"]), nee


def _dispatch_with_retry(dispatch, args):
    """dispatch(*args), run again (up to CHUNK_RETRIES times) after the
    card ran out of memory.

    Chunks are stateless, so a chunk that found too little free memory
    (other work on the card, a fragmented cache) is simply run again once
    the caching allocator has handed its free blocks back. Any other
    exception propagates at once: a CUDA launch error leaves the context
    unusable, so nothing can be re-run in it, and nothing falls back to the
    CPU. Under a mesh each rank retries its own shard before the chunk's
    collective, so the ranks stay in step.

    The JAX driver also replays, at its next sync, the chunks dispatched
    since its last good snapshot when an asynchronous device error surfaces
    there (`sync`, driver.py:827-843). The port has no counterpart: the
    allocator raises out-of-memory synchronously, inside the call wrapped
    here, and the errors a CUDA stream reports later are the sticky ones
    that leave the context unusable."""
    for attempt in range(CHUNK_RETRIES + 1):
        try:
            return dispatch(*args)
        except torch.cuda.OutOfMemoryError:
            if attempt == CHUNK_RETRIES:
                raise
            print(f"\n[render] out of device memory; retrying chunk "
                  f"({attempt + 1}/{CHUNK_RETRIES})")
            torch.cuda.empty_cache()


def _mark(device: torch.device):
    """A point on the device's timeline, taken without waiting for it: a
    recorded CUDA event on the card, the host clock on the CPU (whose work
    is done when its call returns)."""
    if device.type != "cuda":
        return time.perf_counter()
    event = torch.cuda.Event(enable_timing=True)
    event.record(torch.cuda.current_stream(device))
    return event


def _seconds(a, b) -> float:
    """Seconds from mark a to mark b, both reached."""
    return b - a if isinstance(a, float) else a.elapsed_time(b) / 1e3


class _Clock:
    """The render's windows and its progress.

    The compile window runs from the start to the end of the first chunk on
    the device (the kernels' first load, the allocator's warm-up); the
    steady window from there to the end of the last chunk, less each
    checkpoint's pull and write. Both are read from marks on the device's
    timeline once the render is done, so they add no wait to the render.
    Only a verbose render waits for the card: after the first chunk and
    then every SYNC_EVERY chunks, to print its progress with elapsed time
    and ETA."""

    def __init__(self, device: torch.device, total_chunks: int, verbose: bool):
        self.device, self.total, self.verbose = device, total_chunks, verbose
        self.t_start = time.perf_counter()
        self.start = _mark(device)
        self.first = None  # the end of the first chunk
        self.first_segments = None  # the segment count there
        self.pauses: list = []  # (mark, mark) around each checkpoint
        self.done = 0
        self.steady_primary = 0  # primary rays after the first chunk

    def chunk_done(self, seg_total: torch.Tensor, primary: int) -> None:
        self.done += 1
        if self.first is None:
            self.first, self.first_segments = _mark(self.device), seg_total
        else:
            self.steady_primary += primary
        if self.verbose and (self.done - 1) % SYNC_EVERY == 0:
            _sync(self.device)
            frac = min(1.0, self.done / self.total)
            elapsed = time.perf_counter() - self.t_start
            print(f"\r[render] chunk {self.done}/{self.total} ({100 * frac:.0f}%, elapsed "
                  f"{elapsed:.1f}s, eta {elapsed / frac - elapsed:.1f}s)", end="", flush=True)

    @contextlib.contextmanager
    def paused(self):
        """Leave the block (a checkpoint's pull and write) out of the steady
        window."""
        before = _mark(self.device)
        yield
        self.pauses.append((before, _mark(self.device)))

    def finish(self, stats: RenderStats) -> None:
        """Wait for the card and fill the windows' seconds into stats."""
        end = _mark(self.device)
        _sync(self.device)
        if self.first is not None:
            stats.compile_seconds = _seconds(self.start, self.first)
        if self.done > 1:
            stats.steady_seconds = _seconds(self.first, end) - sum(
                _seconds(a, b) for a, b in self.pauses)
            stats.steady_primary = self.steady_primary
        if self.verbose and self.done:
            print()


def render_to_image(
    scene: Scene,
    *,
    device="cuda",
    seed: int = 0,
    pixel_chunk: Optional[int] = None,
    spp_chunk: Optional[int] = None,
    checkpoint_path: Optional[str] = None,
    verbose: bool = True,
    scene_data: Optional[SceneData] = None,
    mesh=None,
) -> tuple[np.ndarray, RenderStats]:
    """Full render on `device` (the card unless the caller asks for the
    CPU): ((H, W, 3) uint8 image, RenderStats).

    The Scene::render_to_image of tracing.rs:221-263: AA rays per pixel,
    shade by the camera's mode, average, channel bleed + gamma + quantize.
    Pixel chunks are interleaved (chunk ci holds pixels ci, ci+nc, …), so
    every chunk is a statistical clone of the image.

    checkpoint_path: the HDR accumulator is written there (".npz" added
    when missing) after every spp chunk, and a render that finds the file
    (same image size and seed) resumes at its spp_done. A checkpoint that
    holds more samples than `spp`, or was rendered with the other `nee`
    setting, raises ValueError. Raises ValueError for NEE under Phong and
    for NEE on a scene whose emitters are not all sampled lights.

    mesh: a ("dp", "sp") DeviceMesh over every rank of the process group
    (parallel.sharding.make_device_mesh); every rank calls this with the
    same arguments. Each chunk's pixels split over dp, its samples over sp
    (parallel.sharding.make_sharded_render_chunk). pixel_chunk is rounded
    down to a multiple of n_dp and spp_chunk up to a multiple of n_sp; spp
    must divide by n_sp. Only rank 0 writes the checkpoint, and a resume
    reads rank 0's file on every rank (multihost.broadcast_checkpoint).
    Only rank 0 prints. Every rank returns the same image. The contract,
    bit for bit in the u8 image and in the HDR accumulator: with n_sp = 1
    the render equals the one-device render (each pixel's sum is made
    whole on one rank); with n_sp > 1 it equals the one-device render at
    spp_chunk / n_sp, since the sp partials of a chunk are added one at a
    time in sp order, the order in which one device adds its spp chunks.
    (A float sum regrouped over ranks could not promise more.)
    """
    with profiling.span("render.image"):
        return _render_to_image(scene, device, seed, pixel_chunk, spp_chunk, checkpoint_path,
                                verbose, scene_data, mesh)


def _render_to_image(scene, device, seed, pixel_chunk, spp_chunk, checkpoint_path, verbose,
                     scene_data, mesh):
    device = resolve_device(device)
    cam = scene.camera
    w, h = cam.screen_width, cam.screen_height
    n_px_total = w * h
    spp = cam.aa_sample_count
    n_chains = max(1, cam.path_samples)
    if n_px_total * spp * n_chains > 2**32:
        raise ValueError(
            f"{w}x{h} at {spp} spp x {n_chains} chains exceeds the 2^32 distinct "
            "32-bit RNG uids — rays would repeat each other's draws"
        )
    if scene_data is None:
        scene_data = scene.compile(device=device)
    elif scene_data.device != device:
        scene_data = scene_data.to(device)
    if cam.nee and cam.shading_mode is ShadingMode.PHONG:
        raise ValueError(
            "Camera(nee=True) has no effect under ShadingMode.PHONG: NEE is a path-tracer "
            "estimator and Phong shading ignores it. Drop --nee or shade by path tracing."
        )
    if cam.nee and not scene_data.nee_ok:
        raise ValueError(
            "Camera(nee=True) needs every emissive object to be a standalone Triangle or "
            "Sphere (the sampled lights, render/nee.py); this scene has emissive planes, "
            "meshes or media, or no light, so NEE's emission suppression would be wrong. "
            "Render without --nee."
        )
    spp_chunk = min(spp_chunk or spp, spp)
    n_dp = n_sp = 1
    rank = 0
    if mesh is not None:
        import torch.distributed as dist

        from cs397raytracingsp22_tpu_torch.parallel import multihost, sharding

        n_dp, n_sp, _, _ = sharding.mesh_axes(mesh)
        rank = dist.get_rank()
        verbose = verbose and rank == 0
        # chunk shapes must tile the mesh's axes
        if spp_chunk % n_sp:
            spp_chunk = min(spp, spp_chunk + n_sp - spp_chunk % n_sp)
        if spp % n_sp:
            raise ValueError(f"spp {spp} not divisible by the mesh's sp axis {n_sp}")
    if pixel_chunk is None:
        pixel_chunk = chunk_pixels(scene_data, cam, spp_chunk)
    pixel_chunk = max(n_dp, pixel_chunk - pixel_chunk % n_dp)
    n_chunks = (n_px_total + pixel_chunk - 1) // pixel_chunk
    rng_key = threefry.key_words(seed)

    if checkpoint_path and not checkpoint_path.endswith(".npz"):
        checkpoint_path += ".npz"
    pieces: list = [None] * n_chunks
    spp_done = 0
    resume = None
    if checkpoint_path and mesh is not None:
        # every rank must see rank 0's file: a local read could disagree
        # on spp_done, and the ranks' chunk counts with it
        accum, spp_done, ckpt_nee = multihost.broadcast_checkpoint(checkpoint_path, n_px_total,
                                                                   seed)
        resume = None if accum is None else (accum, spp_done, ckpt_nee)
    elif checkpoint_path:
        resume = _load_checkpoint(checkpoint_path, n_px_total, seed)
    if resume is not None:
        # every refusal below comes after the broadcast, so it is raised on
        # every rank and none is left waiting in a collective
        accum, spp_done, ckpt_nee = resume
        # an accumulator of more samples than asked for cannot be finished
        # (the mean would divide by too few), and two estimators must not
        # share one
        if spp_done > spp:
            raise ValueError(
                f"checkpoint holds {spp_done} spp but this render asks for {spp}: raise "
                "--spp (a resume can only extend a render) or delete the checkpoint"
            )
        if ckpt_nee >= 0 and bool(ckpt_nee) != bool(cam.nee):
            raise ValueError(
                f"checkpoint was rendered with nee={bool(ckpt_nee)} but this render has "
                f"nee={bool(cam.nee)}: the accumulator would blend two estimators; match "
                "--nee or delete the checkpoint"
            )
        if spp_done % n_sp:
            # every sharded chunk splits its samples over sp, so what is
            # left must come in multiples of n_sp
            raise ValueError(
                f"checkpoint at spp_done={spp_done} is not divisible by this mesh's sp axis "
                f"({n_sp}); resume on the original device configuration or finish the "
                "render without an sp axis"
            )
        # raster order re-split into this render's interleaved chunks
        padded = np.zeros((n_chunks * pixel_chunk, 3), np.float32)
        padded[:n_px_total] = accum
        parts = torch.from_numpy(padded).to(device).reshape(pixel_chunk, n_chunks, 3)
        pieces = [parts[:, ci].contiguous() for ci in range(n_chunks)]
        if verbose:
            print(f"[render] resuming from {checkpoint_path} at {spp_done} spp")

    if mesh is None:
        def dispatch(ids, s0, s_count):
            # one device: a single "sp partial"; render_chunk is looked up
            # at call time, so a test can patch it
            rad, segs = _dispatch_with_retry(render_chunk, (scene_data, cam, ids, rng_key, s0,
                                                            s_count, n_chains))
            return rad[None], segs
    else:
        sharded_fns: dict = {}

        def dispatch(ids, s0, s_count):
            if s_count not in sharded_fns:
                sharded_fns[s_count] = sharding.make_sharded_render_chunk(mesh, cam, s_count,
                                                                          n_chains)
            return sharded_fns[s_count](scene_data, ids, rng_key, s0)

    stats = RenderStats(width=w, height=h, spp=spp, path_depth=cam.path_depth,
                        device=str(device), device_count=n_dp * n_sp)
    _sync(device)
    seg_total = torch.zeros((), dtype=torch.int64, device=device)
    lane = torch.arange(pixel_chunk, dtype=torch.int32, device=device) * n_chunks
    n_spp_chunks = max(1, -(-(spp - spp_done) // spp_chunk))
    clock = _Clock(device, n_spp_chunks * n_chunks, verbose)
    for s0 in range(spp_done, spp, spp_chunk):
        s_count = min(spp_chunk, spp - s0)
        for ci in range(n_chunks):
            with profiling.span("render.chunk"):
                parts, segs = dispatch(lane + ci, s0, s_count)
                # the sp partials one at a time, in sp order: the order in which
                # one device adds its spp chunks
                for part in parts:
                    pieces[ci] = part if pieces[ci] is None else pieces[ci] + part
                seg_total = seg_total + segs
                stats.chunks += 1
                # ids past n_px (a ragged tail's padding) are traced, not counted
                n_valid = -(-(n_px_total - ci) // n_chunks)
                clock.chunk_done(seg_total, n_valid * s_count * n_chains)
        if checkpoint_path and rank == 0:
            with clock.paused(), profiling.span("render.checkpoint"):
                np.savez(
                    checkpoint_path,
                    accum=_raster(pieces, n_px_total).cpu().numpy().astype(np.float64),
                    spp_done=np.int64(s0 + s_count),
                    seed=np.int64(seed),
                    # the estimator: a resume with the other --nee would blend two
                    nee=np.int64(int(bool(cam.nee))),
                )
    with profiling.span("render.finish"):
        clock.finish(stats)
        # the segments after the first chunk and in all; under a mesh each rank
        # counted its own shards, summed over the ranks here, once a render
        seg_counts = torch.stack(
            [seg_total if clock.first_segments is None else clock.first_segments, seg_total])
        if mesh is not None:
            with profiling.span("render.allreduce"):
                sharding.sum_over_ranks(seg_counts)
        first_segs, stats.path_segments = seg_counts.tolist()
        if clock.done > 1:
            stats.steady_segments = stats.path_segments - first_segs
        accum = _raster(pieces, n_px_total)
        stats.mean_radiance = float(accum.mean()) / max(spp, 1)
        stats.nonfinite_pixels = int((~torch.isfinite(accum)).any(dim=1).sum())
        img = _finalize_image(pieces, n_px_total, spp, cam.gamma).cpu().numpy().reshape(h, w, 3)
    stats.wall_seconds = time.perf_counter() - clock.t_start
    stats.primary_rays = n_px_total * (spp - spp_done) * n_chains
    if verbose:
        print("[render] " + stats.summary())
    return img, stats


def save_png(img: np.ndarray, path: str) -> None:
    """Write an (H, W, 3) uint8 image as PNG (reference tracing.rs:546)."""
    from PIL import Image

    Image.fromarray(img, mode="RGB").save(path, format="PNG")

