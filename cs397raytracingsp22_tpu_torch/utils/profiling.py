"""Phase timing and device traces (mirrors the JAX package's
utils/profiling.py).

- `PhaseTimer` collects named wall-clock phases (load, compile, render,
  tonemap) for a render's summary; a phase entered again adds to its sum.
- `device_trace(log_dir)` runs the block under `torch.profiler` and writes
  a Chrome trace (viewable in Perfetto or chrome://tracing) into log_dir:
  the host's calls and the package's record_function spans ("raygen",
  "bounce_rng", "nee_rng", "mesh_resolve"), and on a card the kernels.
  Without a directory it starts no profiler and costs nothing. The
  directory is an argument (the CLI's `--profile-dir`): the port reads no
  environment variable.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import OrderedDict

import torch


class PhaseTimer:
    def __init__(self):
        self.phases: "OrderedDict[str, float]" = OrderedDict()

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.phases[name] = self.phases.get(name, 0.0) + (time.perf_counter() - t0)

    def summary(self) -> str:
        return " | ".join(f"{k}: {v:.2f}s" for k, v in self.phases.items())


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
