"""The benchmark's readers of the port's layer spans (benchmark/spans.py
and the metrics that use it) on a synthetic trace: the window's idle time
split by the innermost program span, by exact overlap, adds up with the
uncovered idle to idle_share; launches count only inside render.bounce;
the host's wait in render.live_count; nothing where the spans are absent."""

import pytest

from benchmark import cells, spans
from benchmark.trace import Activity, Trace

MS = 1_000_000  # ns

# one image: a chunk with raygen and two bounces (the first with an
# intersect holding the resolve, the shading and the live-count read), a
# host op under the image alone, the finish
HOST = [
    (0, 100, "bench.image"), (1, 99, "render.image"), (2, 40, "render.chunk"),
    (3, 10, "raygen"), (4, 5, "cudaLaunchKernel"),
    (10, 30, "render.bounce"), (11, 20, "render.intersect"), (12, 13, "cudaLaunchKernel"),
    (14, 18, "mesh_resolve"), (15, 16, "cudaLaunchKernel"),
    (20, 25, "render.shade"), (21, 22, "cuLaunchKernel"),
    (25, 28, "render.live_count"), (26, 27, "cudaMemcpyAsync"),
    (30, 38, "render.bounce"), (31, 32, "cudaLaunchKernel"),
    (40, 45, "aten::add"), (50, 60, "render.finish"),
]
BUSY = [(5, 12, "kernel"), (16, 21, "kernel"), (27, 35, "gpu_memcpy"), (45, 52, "kernel"),
        (70, 80, "kernel")]
# idle ms under each innermost span (idle: 0-5, 12-16, 21-27, 35-45, 52-70, 80-100)
IDLE = {spans.UNCOVERED: 2, "render.image": 35, "render.chunk": 3, "raygen": 2,
        "render.intersect": 2, "mesh_resolve": 2, "render.shade": 4, "render.live_count": 2,
        "render.bounce": 3, "render.finish": 8}


def _trace(host=HOST, busy=BUSY):
    acts = [Activity(f"k{i}", kind, s * MS, e * MS, None) for i, (s, e, kind) in enumerate(busy)]
    return Trace(activities=sorted(acts, key=lambda a: a.start), window=(0, 100 * MS),
                 images=1, host_ops=sorted((s * MS, e * MS, n) for s, e, n in host))


def _read(name, run):
    return cells.metric_reader(name).read(run)


def test_idle_by_innermost_span_adds_up_to_idle_share():
    run = {"trace": _trace()}
    shares = spans.idle_shares(run)
    assert shares == pytest.approx(IDLE)
    assert sum(shares.values()) == pytest.approx(_read("idle_share", run)) == pytest.approx(63.0)
    assert run["notes"]["idle_by_span"] is shares  # computed once, kept in the run's notes


def test_layer_metrics_read_their_spans():
    run = {"trace": _trace()}
    assert _read("rng_idle_share", run) == pytest.approx(2.0)
    assert _read("intersect_idle_share", run) == pytest.approx(4.0)
    assert _read("driver_idle_share", run) == pytest.approx(35 + 3 + 8)
    assert _read("sync_wait_share", run) == pytest.approx(3.0)  # 25-28 ms of 100


def test_nested_spans_give_their_idle_to_the_innermost():
    """The resolve nested in the intersect, nested in the bounce: each idle
    instant counts once, under the innermost; a span that starts where its
    parent does, or outlives it, is held inside the parent."""
    host = [(0, 100, "render.image"), (0, 50, "render.bounce"), (0, 40, "render.intersect"),
            (20, 30, "mesh_resolve"), (45, 60, "render.shade")]
    run = {"trace": _trace(host, busy=[(40, 100, "kernel")])}
    assert spans.idle_shares(run) == pytest.approx(
        {"render.image": 0, "render.bounce": 0, "render.intersect": 30, "mesh_resolve": 10,
         "render.shade": 0, spans.UNCOVERED: 0})
    assert spans.innermost([(s * MS, e * MS, n) for s, e, n in host]) == [
        (0, 20 * MS, "render.intersect"), (20 * MS, 30 * MS, "mesh_resolve"),
        (30 * MS, 40 * MS, "render.intersect"), (40 * MS, 45 * MS, "render.bounce"),
        (45 * MS, 50 * MS, "render.shade"), (50 * MS, 100 * MS, "render.image")]


def test_launches_per_bounce_counts_inside_bounces_only():
    tr = _trace()
    # 12, 15 (in the resolve), 21 (a driver-API launch), 31; raygen's at 4 is outside
    assert spans.launches_in(tr, "render.bounce") == (4, 2)
    assert _read("launches_per_bounce", {"trace": tr}) == pytest.approx(2.0)


@pytest.mark.parametrize("name,drop", [
    ("rng_idle_share", {"raygen"}),
    ("intersect_idle_share", {"render.intersect", "mesh_resolve"}),
    ("driver_idle_share", {"render.image", "render.chunk", "render.finish"}),
    ("launches_per_bounce", {"render.bounce"}),
    ("sync_wait_share", {"render.live_count"}),
])
def test_readers_leave_out_what_they_cannot_read(name, drop):
    host = [op for op in HOST if op[2] not in drop]
    assert _read(name, {"trace": _trace(host)}) is None
    assert _read(name, {"trace": None}) is None
    assert _read(name, {"trace": _trace()}) is not None
