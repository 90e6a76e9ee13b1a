"""Timing and device helpers shared by the port's probe tools.

On the card a time is the mean of `reps` launches between two CUDA events
after one warm launch. The card first sleeps (~0.1 ms a launch, at most
~1 s) while the host enqueues the launches, so a kernel shorter than the
host's time to launch it (P4 at the JAX tool's shape) is timed on the
device, not at the host's launch rate.
On the CPU (the plain versions, for a tiny rehearsal) a time is the host
clock's, and the tools say so beside it.
"""

from __future__ import annotations

import subprocess
import time

import torch


def seconds(fn, reps: int, device: torch.device) -> float:
    """Mean seconds of fn() over reps calls, after one warm call: CUDA
    events on the card, the host clock on the CPU."""
    fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) / reps
    torch.cuda.synchronize(device)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(min(reps * 1e-4, 1.0) * 2e9))  # cycles, ~2 GHz
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / 1e3 / reps


def clock_label(device: torch.device) -> str:
    """What a time was taken with, for the tools' printed lines."""
    return "CUDA events" if device.type == "cuda" else "host clock, plain version on the CPU"


def nvidia_smi(query: str = "name,power.limit") -> str:
    """The first card's `nvidia-smi --query-gpu=<query>` line."""
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def resident_threads(device: torch.device) -> int | None:
    """SMs × resident threads an SM of a card (None on the CPU)."""
    if device.type != "cuda":
        return None
    p = torch.cuda.get_device_properties(device)
    return p.multi_processor_count * p.max_threads_per_multi_processor
