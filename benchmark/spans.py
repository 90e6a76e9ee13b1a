"""The port's layer spans in a traced run: where the card's idle time goes.

The port marks its layers with spans (`utils/profiling.span`) that the
profiler records on the host's main thread, on the clock of the device's
activities. The window's idle time (the complement of the device's busy
intervals) is split here by the innermost program span open on the host at
each instant, by exact overlap; the idle under no program span is
UNCOVERED. The shares of all spans and UNCOVERED add up to idle_share.
The benchmark's own `bench.image` is no program span.
"""

from __future__ import annotations

import bisect
from collections import defaultdict

PROGRAM = (
    "render.image", "render.chunk", "render.k1", "render.bounce", "render.intersect",
    "render.shade", "render.nee", "render.live_count", "render.finish", "render.checkpoint",
    "render.allreduce", "raygen", "bounce_rng", "nee_rng", "mesh_resolve", "wavefront_partition",
)
UNCOVERED = "(no span)"
LAUNCHES = ("cudaLaunch", "cuLaunch")  # the host's kernel-launch calls


def spans_of(tr, names) -> list:
    """(start, end, name) of the host's spans named in `names`, by start."""
    names = set(names)
    return [op for op in tr.host_ops if op[2] in names]


def innermost(spans: list) -> list:
    """Disjoint (start, end, name) pieces, by start, each naming the
    innermost of the nested spans open there; none where no span is open."""
    out, stack, at = [], [], None  # stack: (end, name), the innermost last
    for s, e, name in sorted(spans, key=lambda sp: (sp[0], -sp[1])):
        while stack and stack[-1][0] <= s:
            end, top = stack.pop()
            if end > at:
                out.append((at, end, top))
            at = max(at, end)
        if stack:
            if s > at:
                out.append((at, s, stack[-1][1]))
            e = min(e, stack[-1][0])
        stack.append((e, name))
        at = s
    while stack:
        end, top = stack.pop()
        if end > at:
            out.append((at, end, top))
        at = max(at, end)
    return out


def idle_intervals(tr) -> list:
    """(start, end) of the window's times with nothing on the device."""
    lo, hi = tr.window
    out, prev = [], lo
    for s, e in tr.busy_intervals():
        if s > prev:
            out.append((prev, s))
        prev = max(prev, e)
    if hi > prev:
        out.append((prev, hi))
    return out


def idle_shares(run):
    """{span: % of the window idle under it as the innermost program
    span} for every program span in the trace, and UNCOVERED; None
    without a trace. Computed once a run, kept in its notes."""
    tr = run.get("trace")
    if tr is None or tr.window_s == 0.0:
        return None
    notes = run.setdefault("notes", {})
    if "idle_by_span" not in notes:
        spans = spans_of(tr, PROGRAM)
        pieces = innermost(spans)
        by, total, i = defaultdict(int), 0, 0
        for a, b in idle_intervals(tr):
            total += b - a
            while i < len(pieces) and pieces[i][1] <= a:
                i += 1
            j = i
            while j < len(pieces) and pieces[j][0] < b:
                by[pieces[j][2]] += min(b, pieces[j][1]) - max(a, pieces[j][0])
                j += 1
        window = tr.window[1] - tr.window[0]
        shares = {name: 100.0 * by[name] / window for name in sorted({sp[2] for sp in spans})}
        shares[UNCOVERED] = 100.0 * (total - sum(by.values())) / window
        notes["idle_by_span"] = shares
    return notes["idle_by_span"]


def idle_under(run, names):
    """% of the window idle under the spans `names` (innermost), or None
    where none of them is in the trace."""
    shares = idle_shares(run)
    if shares is None or not any(n in shares for n in names):
        return None
    return sum(shares.get(n, 0.0) for n in names)


def launches_in(tr, name: str):
    """(kernel-launch calls that start inside a span `name`, the spans), on
    the host's main thread."""
    spans = spans_of(tr, (name,))
    starts = [s for s, _, _ in spans]
    n = 0
    for s, _, op in tr.host_ops:
        if op.startswith(LAUNCHES):
            k = bisect.bisect_right(starts, s) - 1
            if k >= 0 and s <= spans[k][1]:
                n += 1
    return n, len(spans)


def host_seconds_in(tr, name: str) -> float:
    """Seconds of the window inside the spans `name` (they do not nest in
    one another)."""
    lo, hi = tr.window
    return sum(max(0, min(e, hi) - max(s, lo)) for s, e, _ in spans_of(tr, (name,))) / 1e9
