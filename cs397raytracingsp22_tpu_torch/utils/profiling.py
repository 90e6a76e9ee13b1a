"""Layer spans and device traces (the JAX package's utils/profiling.py
holds its own phase timer and trace).

- `span(name)` marks a layer of the render on the profiler's timeline.
  While a torch profiler records, it is `record_function(name)`: the span
  lands on one timeline and one clock with the host's calls and the
  card's kernels, and a span entered inside another nests under it. With
  no profiler recording it returns one shared no-op context, at the cost
  of one flag read, so the untraced render pays nothing for its spans.
- `device_trace(log_dir)` runs the block under `torch.profiler` and writes
  a Chrome trace (viewable in Perfetto or chrome://tracing) into log_dir:
  the host's calls, the spans, and on a card the kernels. Without a
  directory it starts no profiler and costs nothing. The directory is an
  argument (the CLI's `--profile-dir`): the port reads no environment
  variable.

The spans of the render path, outermost first:

| span | where | encloses |
|---|---|---|
| `render.image` | render/driver.py::render_to_image | one image |
| `render.chunk` | the driver's chunk loop | one chunk's dispatch (its retries) and accumulation |
| `render.k1` | render/driver.py::render_chunk | the mega-bounce kernel's call |
| `render.bounce` | integrator.path_trace_shrink | one bounce, its compaction included |
| `render.intersect` | ops/intersect.py::intersect_scene | K2, K3, the general volumes, the merged resolve |
| `render.shade` | integrator.bounce_update | after the intersection: NEE's sample, then the miss and emission terms, the BSDF and the path's update (the shading kernel S1's launch on the card) |
| `render.nee` | render/nee.py::direct_light | NEE's draws, its sample (N1a on the card), the shadow rays, the contribution (N1b) |
| `render.live_count` | integrator._compact | the host's read of the live count (it waits for the card) |
| `render.finish` | the driver, after the last chunk | the image's end-of-render reads, tonemap and pull |
| `render.checkpoint` | the driver | the checkpoint's pull and write |
| `render.allreduce` | parallel/sharding.py, the driver | a chunk's and the segment counts' exchange |

and inside them the draws and the resolve: `raygen`
(models/camera.py through the driver), `bounce_rng`, `nee_rng`,
`mesh_resolve` and `wavefront_partition` (ops/kernels/wavefront.py).
Outside a render, `scene.sphere_tree` marks the scene compile's build of
the sphere tree (models/scene.py::pack_kernel_tables). No span reads the
card or launches a kernel.
"""

from __future__ import annotations

import contextlib
import os

import torch
from torch.profiler import record_function

_OFF = contextlib.nullcontext()
_recording = torch._C._autograd._profiler_enabled


def span(name: str):
    """A context that marks `name` on the profiler's timeline while a
    profiler records, and the shared no-op context otherwise."""
    if _recording():
        return record_function(name)
    return _OFF


def trace_path(log_dir: str) -> str:
    """The file device_trace writes into log_dir."""
    return os.path.join(log_dir, f"trace_{os.getpid()}.json")


@contextlib.contextmanager
def device_trace(log_dir: str | None = None):
    """Profile the block and write its Chrome trace to trace_path(log_dir)
    when a directory is given; a no-op otherwise. Yields the profiler (or
    None). The card's activity is traced when CUDA is available; the host
    waits for the card before the trace is written, so the block's
    kernels are in it."""
    if not log_dir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(trace_path(log_dir))
