"""The metric arithmetic on synthetic records and events: the window's
image time, the p95, busy and idle, span and kernel shares, launches, the
all-reduce share, the K1 bound's scaling to the traced images, and the
idle gaps labelled by the host op."""

import math

import numpy as np
import pytest

from benchmark import cells
from benchmark.trace import Activity, Trace

MS = 1_000_000  # ns


def _trace():
    acts = [
        Activity("raygen_k", "kernel", 0 * MS, 10 * MS, "raygen"),
        Activity("void bounce_kernel<true>(Params)", "kernel", 5 * MS, 30 * MS, None),
        Activity("rng_k", "kernel", 40 * MS, 50 * MS, "bounce_rng"),
        Activity("resolve_k", "kernel", 60 * MS, 65 * MS, "mesh_resolve"),
        Activity("Memcpy DtoH", "gpu_memcpy", 70 * MS, 72 * MS, None),
        Activity("ncclDevKernel_AllReduce_Sum_f32", "kernel", 80 * MS, 84 * MS, None),
    ]
    host = [(0, 100 * MS, "bench.image"), (30 * MS, 40 * MS, "aten::argsort"),
            (50 * MS, 60 * MS, "cudaStreamSynchronize")]
    return Trace(activities=acts, window=(0, 100 * MS), images=2, host_ops=host)


def _read(name, run):
    return cells.metric_reader(name).read(run)


def test_busy_idle_and_shares():
    tr = _trace()
    run = {"trace": tr}
    busy = (30 + 10 + 5 + 2 + 4) / 1000
    assert tr.busy_s == pytest.approx(busy)
    assert tr.window_s == pytest.approx(0.1)
    assert _read("idle_share", run) == pytest.approx(100 * (1 - busy / 0.1))
    assert _read("rng_share", run) == pytest.approx(100 * 0.020 / busy)
    assert _read("resolve_share", run) == pytest.approx(100 * 0.005 / busy)
    assert _read("allreduce_share", run) == pytest.approx(100 * 0.004 / 0.1)
    assert _read("launches_per_image", run) == pytest.approx(5 / 2)


def test_readers_leave_out_what_they_cannot_read():
    tr = _trace()
    tr.activities = [a for a in tr.activities if a.span is None and "nccl" not in a.name]
    run = {"trace": tr}
    for name in ("rng_share", "resolve_share", "allreduce_share"):
        assert _read(name, run) is None
    for name in ("idle_share", "launches_per_image", "k1_roofline", "rng_share"):
        assert _read(name, {"trace": None}) is None


def test_window_metrics():
    times = [0.1, 0.12, 0.11, 0.3] + [0.1] * 96
    run = {"window_s": 12.5, "images": 100, "image_times": times, "peak_bytes": 3 * 2**30,
           "setup_s": 7.5}
    assert _read("image_s", run) == pytest.approx(0.125)
    assert _read("image_s_p95", run) == pytest.approx(float(np.percentile(times, 95)))
    assert _read("peak_mem_gib", run) == pytest.approx(3.0)
    assert _read("setup_s", run) == 7.5


def test_idle_gaps_name_the_host_op():
    bd = _trace().breakdown()
    gaps = dict(bd["idle_gaps"])
    assert gaps["aten::argsort"] == pytest.approx(0.010)  # 30-40 ms
    assert gaps["cudaStreamSynchronize"] == pytest.approx(0.010)  # 50-60 ms
    assert sum(gaps.values()) == pytest.approx(0.1 - _trace().busy_s)
    assert bd["device_ops"][0] == ["void bounce_kernel<true>(Params)", pytest.approx(0.025)]


def test_k1_roofline_scales_the_image_bound_to_the_traced_images(monkeypatch):
    from benchmark import check
    from benchmark.reference import walk

    monkeypatch.setattr(check, "reference_scene", lambda cell, device: None)
    monkeypatch.setattr(walk, "k1_image_bound", lambda scene, seed: {"seconds": 0.001})
    tr = _trace()
    run = {"trace": tr, "cell": None, "device": None, "seed": 5, "notes": {}}
    # two images, one K1 kernel of 25 ms in all: 2 ms of least time over 25 ms
    assert _read("k1_roofline", run) == pytest.approx(100 * 0.002 / 0.025)


def test_k1_count_matches_the_walk_of_a_known_ray():
    import torch

    from benchmark.reference import walk

    verts = np.zeros((32, 3, 3), np.float32)
    for i in range(32):  # 32 small triangles along x, two superleaves
        verts[i] = [[i, 0, 0], [i + 0.5, 0, 0], [i, 0.5, 0]]
    tree, s = walk.superleaf_tree(verts)
    assert s == 2 and tree.shape == (3, 6)
    o = torch.tensor([[0.2, 0.1, 1.0], [100.0, 100.0, 1.0]])
    d = torch.tensor([[0.0, 0.0, -1.0], [0.0, 0.0, -1.0]])
    nodes, leaves = walk.tree_counts(torch.as_tensor(tree), s, o, d, 0.001,
                                     torch.tensor([math.inf, math.inf]))
    assert nodes.tolist() == [3, 1]
    assert leaves.tolist() == [1, 0]


class _Event:
    def __init__(self, name, dev, start, end, corr, tid=1, annotation=False):
        self._v = (name, dev, start, end, corr, tid, annotation)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def end_ns(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def start_thread_id(self):
        return self._v[5]

    def is_user_annotation(self):
        return self._v[6]


def test_read_matches_kernels_to_the_spans_of_their_launches():
    from types import SimpleNamespace

    from torch.autograd import DeviceType

    from benchmark import trace

    cpu, gpu = DeviceType.CPU, DeviceType.CUDA
    events = [
        _Event("bench.image", cpu, 0, 100 * MS, 1),
        _Event("raygen", cpu, 1 * MS, 10 * MS, 2),
        _Event("cudaLaunchKernel", cpu, 2 * MS, 3 * MS, 50),
        _Event("mesh_resolve", cpu, 20 * MS, 30 * MS, 3),
        _Event("cudaLaunchKernel", cpu, 21 * MS, 22 * MS, 51),
        _Event("cuLaunchKernel", cpu, 40 * MS, 41 * MS, 52),
        _Event("cudaLaunchKernel", cpu, 25 * MS, 26 * MS, 53, tid=2),
        _Event("k_raygen", gpu, 4 * MS, 8 * MS, 50),
        _Event("k_resolve", gpu, 23 * MS, 28 * MS, 51),
        _Event("bounce_kernel", gpu, 42 * MS, 60 * MS, 52),
        _Event("k_other_thread", gpu, 61 * MS, 62 * MS, 53),
        _Event("Memcpy DtoH (Device -> Pinned)", gpu, 90 * MS, 91 * MS, 99),
        _Event("raygen", gpu, 4 * MS, 8 * MS, 2, annotation=True),
    ]
    prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))
    tr = trace.read(prof, 1)
    spans = {a.name: (a.kind, a.span) for a in tr.activities}
    assert spans == {"k_raygen": ("kernel", "raygen"), "k_resolve": ("kernel", "mesh_resolve"),
                     "bounce_kernel": ("kernel", None), "k_other_thread": ("kernel", None),
                     "Memcpy DtoH (Device -> Pinned)": ("gpu_memcpy", None)}
    assert tr.window == (0, 100 * MS)
    assert len(tr.kernels) == 4
