"""The traced sub-window: torch.profiler over a few whole images, read in
the process into a small summary (no trace file is written).

`Trace` holds what the metric readers need: the device activities (kernels,
copies, sets) with their start, end and the span they were launched in,
the host window (first image's start to last image's end), and the host
ops for labelling idle gaps. A kernel belongs to a span when its launch
call (matched by the trace's correlation id) started inside one of the
span's ranges on the launching thread. The spans read are the renderer's
own (`raygen`, `bounce_rng`, `nee_rng`, `mesh_resolve`) and the
benchmark's `bench.image` around each image.
"""

from __future__ import annotations

import bisect
import dataclasses
from collections import defaultdict

SPANS = ("raygen", "bounce_rng", "nee_rng", "mesh_resolve", "bench.image")
NAME_CHARS = 160  # a kernel's name in the breakdown, cut: C++ signatures run long


@dataclasses.dataclass
class Activity:
    name: str
    kind: str  # "kernel", "gpu_memcpy" or "gpu_memset"
    start: int  # ns, on the host's clock
    end: int
    span: str | None  # innermost of SPANS it was launched in


@dataclasses.dataclass
class Trace:
    activities: list  # Activity, by start
    window: tuple  # (start ns, end ns) of the traced images on the host
    images: int
    host_ops: list  # (start, end, name) on the main thread, by start

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    @property
    def kernels(self) -> list:
        return [a for a in self.activities if a.kind == "kernel"]

    def busy_intervals(self) -> list:
        """Merged (start, end) of every device activity inside the window."""
        lo, hi = self.window
        out = []
        for a in self.activities:
            s, e = max(a.start, lo), min(a.end, hi)
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e9

    def union_s(self, keep) -> float:
        """Seconds covered by the activities for which keep(a) holds."""
        total, cur = 0, None
        for a in self.activities:
            if not keep(a):
                continue
            if cur is None or a.start > cur[1]:
                total += 0 if cur is None else cur[1] - cur[0]
                cur = [a.start, a.end]
            else:
                cur[1] = max(cur[1], a.end)
        return (total + (0 if cur is None else cur[1] - cur[0])) / 1e9

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the idle gaps
        summed by the innermost host op running at each gap's middle."""
        by_name = defaultdict(int)
        for a in self.activities:
            by_name[a.name] += a.end - a.start
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps = defaultdict(int)
        lo, hi = self.window
        prev, found = lo, []
        for s, e in self.busy_intervals() + [[hi, hi]]:
            if s > prev:
                found.append(((prev + s) // 2, s - prev))
            prev = max(prev, e)
        for (_, length), name in zip(found, self._host_at([t for t, _ in found])):
            gaps[name] += length
        idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n[:NAME_CHARS], v / 1e9] for n, v in ops],
                "idle_gaps": [[n, v / 1e9] for n, v in idle]}

    def _host_at(self, times: list) -> list:
        """The innermost host op open at each of the increasing times."""
        out, stack, i, ops = [], [], 0, self.host_ops
        for t in times:
            while i < len(ops) and ops[i][0] <= t:
                while stack and stack[-1][1] < ops[i][0]:
                    stack.pop()
                stack.append(ops[i])
                i += 1
            while stack and stack[-1][1] < t:
                stack.pop()
            out.append(stack[-1][2] if stack else "host (no op)")
        return out


def read(prof, images: int) -> Trace:
    """A Trace from a stopped torch.profiler.profile over `images` images,
    each inside a `bench.image` span; the window runs from the first
    one's start to the last one's end."""
    from torch.autograd import DeviceType

    events = prof.profiler.kineto_results.events()
    launch_at, spans, cpu_ops, device = {}, defaultdict(list), [], []
    main_tid = None
    for e in events:
        name = e.name()
        if e.device_type() == DeviceType.CPU:
            start, end, tid = e.start_ns(), e.end_ns(), e.start_thread_id()
            if name.startswith("cu"):  # a CUDA runtime or driver call
                launch_at[e.correlation_id()] = (start, tid)
            if name in SPANS:
                spans[name].append((start, end, tid))
                if name == "bench.image":
                    main_tid = tid
            cpu_ops.append((start, end, name, tid))
        elif e.device_type() == DeviceType.CUDA and name not in SPANS:
            if hasattr(e, "is_user_annotation") and e.is_user_annotation():
                continue
            kind = ("gpu_memcpy" if name.startswith("Memcpy") else
                    "gpu_memset" if name.startswith("Memset") else "kernel")
            device.append((e, kind))
    span_list = sorted((s, e, n, tid) for n, rs in spans.items() if n != "bench.image"
                       for s, e, tid in rs)
    span_starts = [s[0] for s in span_list]
    acts = []
    for e, kind in device:
        at = launch_at.get(e.correlation_id())
        label = None
        if at is not None:
            label = _innermost(span_list, span_starts, at[0], at[1])
        acts.append(Activity(e.name(), kind, e.start_ns(), e.end_ns(), label))
    acts.sort(key=lambda a: a.start)
    host_ops = sorted((s, e, n) for s, e, n, tid in cpu_ops if tid == main_tid)
    marks = spans["bench.image"]
    window = (min(m[0] for m in marks), max(m[1] for m in marks))
    return Trace(activities=acts, window=window, images=images, host_ops=host_ops)


def _innermost(spans: list, starts: list, t: int, tid) -> str | None:
    """The span (the renderer's spans do not nest) open at time t on
    thread tid."""
    i = bisect.bisect_right(starts, t) - 1
    while i >= 0:  # the latest span started on thread tid by time t
        s, e, name, stid = spans[i]
        if stid == tid:
            return name if t <= e else None
        i -= 1
    return None
