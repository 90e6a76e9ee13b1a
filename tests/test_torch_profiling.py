"""utils/profiling.py of the port (span, device_trace) and the CLI's
--profile-dir, on the CPU: a span enters nothing while no profiler
records; under a profiler each render path gives its layer spans, nested
as the render runs them and on the clock of time.time_ns(); a trace is
written only where a directory is given, it holds the package's spans,
and RT_PROFILE_DIR, which the JAX package reads, changes nothing."""

import json
import os
import sys
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from benchmark import spans as bspans
from benchmark import trace as btrace
from cs397raytracingsp22_tpu_torch import cli
from cs397raytracingsp22_tpu_torch.ops.kernels import bounce as tbounce
from cs397raytracingsp22_tpu_torch.render import driver as tdriver
from cs397raytracingsp22_tpu_torch.scenes import cornell as tcornell
from cs397raytracingsp22_tpu_torch.utils import profiling

torch.set_num_threads(1)

SPANS = set(bspans.PROGRAM)


def spans(path):
    with open(path) as f:
        return {e.get("name") for e in json.load(f)["traceEvents"]
                if e.get("cat") == "user_annotation"}


def recorded(prof):
    """(start ns, end ns, name) of the program's spans in a stopped
    profiler, by start."""
    return sorted((e.start_ns(), e.end_ns(), e.name())
                  for e in prof.profiler.kineto_results.events() if e.name() in SPANS)


def parent_of(found, span):
    """The name of the innermost other span that encloses `span`, or None."""
    s, e, _ = span
    outer = [sp for sp in found if sp is not span and sp[0] <= s and e <= sp[1]
             and (sp[0], -sp[1]) < (s, -e)]
    return max(outer, key=lambda sp: (sp[0], -sp[1]))[2] if outer else None


def test_span_without_a_profiler_is_the_shared_no_op(monkeypatch):
    """No profiler: every span is one shared no-op context, and no
    record_function is entered (it would raise here)."""
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered with no profiler")

    monkeypatch.setattr(profiling, "record_function", refuse)
    a, b = profiling.span("render.chunk"), profiling.span("raygen")
    assert a is b
    with a, profiling.span("render.bounce"):
        pass
    scene = tcornell.build(width=4, height=4, spp=1, path_depth=2)
    tdriver.render_to_image(scene, device="cpu", seed=0, verbose=False)


def test_span_under_a_profiler_records_nested_ranges():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("render.chunk"):
            with profiling.span("raygen"):
                pass
    found = recorded(prof)
    assert [n for _, _, n in found] == ["render.chunk", "raygen"]
    assert parent_of(found, found[1]) == "render.chunk"
    assert profiling.span("render.chunk") is profiling.span("raygen")


SIDE, DEPTH = 8, 3


def _simple(monkeypatch, tmp_path):
    return tcornell.build(width=SIDE, height=SIDE, spp=2, path_depth=DEPTH), {}


def _staged(monkeypatch, tmp_path):
    # the staged executor on the CPU: the scene is routed past K1
    monkeypatch.setattr(tbounce, "scene_is_simple", lambda scene: False)
    return tcornell.build(width=SIDE, height=SIDE, spp=2, path_depth=DEPTH), {}


def _nee(monkeypatch, tmp_path):
    import dataclasses

    scene = tcornell.build_config3(width=SIDE, height=SIDE, spp=2, path_depth=DEPTH)
    return dataclasses.replace(scene, camera=dataclasses.replace(scene.camera, nee=True)), {}


def _checkpointed(monkeypatch, tmp_path):
    return (tcornell.build(width=SIDE, height=SIDE, spp=4, path_depth=DEPTH),
            dict(spp_chunk=2, checkpoint_path=str(tmp_path / "c.npz")))


# path → (scene and render arguments, the spans it must give, those it
# must not)
PATHS = {
    "simple": (_simple, {"render.k1", "raygen"},
               {"render.bounce", "render.intersect", "render.checkpoint"}),
    "staged": (_staged, {"render.bounce", "render.intersect", "render.shade", "render.live_count",
                         "bounce_rng", "raygen"}, {"render.k1", "render.nee"}),
    "nee": (_nee, {"render.bounce", "render.intersect", "render.shade", "render.nee",
                   "render.live_count", "nee_rng", "bounce_rng"}, {"render.k1"}),
    "checkpointed": (_checkpointed, {"render.checkpoint", "render.k1"}, {"render.bounce"}),
}
# each span's enclosing span (the innermost), where it has one fixed parent
PARENT = {"render.chunk": "render.image", "render.finish": "render.image",
          "render.checkpoint": "render.image", "render.k1": "render.chunk",
          "raygen": "render.chunk", "render.bounce": "render.chunk",
          "render.live_count": "render.bounce", "render.nee": "render.shade",
          "nee_rng": "render.nee"}


@pytest.mark.parametrize("path", sorted(PATHS))
def test_render_paths_give_their_layer_spans(path, monkeypatch, tmp_path):
    make, present, absent = PATHS[path]
    scene, kw = make(monkeypatch, tmp_path)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _, stats = tdriver.render_to_image(scene, device="cpu", seed=3, verbose=False,
                                           pixel_chunk=SIDE * SIDE // 2, **kw)
    found = recorded(prof)
    names = [n for _, _, n in found]
    assert names.count("render.image") == 1 and names.count("render.finish") == 1
    assert present <= set(names) and not absent & set(names), sorted(set(names))
    assert names.count("render.chunk") == stats.chunks == (4 if kw else 2)
    assert names.count("render.checkpoint") == (2 if kw else 0)
    image = found[names.index("render.image")]
    for span in found:
        if span is not image:
            assert parent_of(found, span) is not None, span  # all inside the image
        if span[2] in PARENT:
            assert parent_of(found, span) == PARENT[span[2]], span
    assert max(sp[0] for sp in found if sp[2] == "render.chunk") < \
        found[names.index("render.finish")][0]
    staged = "render.bounce" in present
    for c in (sp for sp in found if sp[2] == "render.chunk"):
        inside = [sp for sp in found if sp[2] == "render.bounce" and c[0] <= sp[0] <= c[1]]
        assert 0 < len(inside) <= DEPTH if staged else not inside, c
    # the bounce's pieces: in the executors' bounce (the shadow rays' in
    # render.nee), in the plain K1 path's render.k1
    inner = ({"render.intersect": {"render.bounce", "render.nee"},
              "render.shade": {"render.bounce"}, "bounce_rng": {"render.bounce"}} if staged
             else {"render.shade": {"render.k1"}, "bounce_rng": {"render.k1"}})
    for sp in found:
        if sp[2] in inner:
            assert parent_of(found, sp) in inner[sp[2]], sp


# One of two gloo ranks: renders the Cornell box over a 2 x 1 mesh, rank 0
# under the profiler, and writes rank 0's spans.
WORKER = r"""
import contextlib, json, os, sys
import torch
torch.set_num_threads(1)
from torch.profiler import ProfilerActivity, profile
from cs397raytracingsp22_tpu_torch.parallel import multihost
from cs397raytracingsp22_tpu_torch.scenes import cornell
rank, port, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
multihost.initialize(f"127.0.0.1:{port}", 2, rank, device="cpu")
scene = cornell.build(width=8, height=8, spp=2, path_depth=2)
prof = profile(activities=[ProfilerActivity.CPU]) if rank == 0 else contextlib.nullcontext()
with prof:
    multihost.render_to_image_multihost(scene, device="cpu", seed=1, verbose=False,
                                        pixel_chunk=32)
if rank == 0:
    names = {"render.image", "render.chunk", "render.finish", "render.allreduce"}
    found = sorted((e.start_ns(), e.end_ns(), e.name())
                   for e in prof.profiler.kineto_results.events() if e.name() in names)
    with open(os.path.join(out, "spans.json"), "w") as f:
        json.dump(found, f)
torch.distributed.destroy_process_group()
"""


def test_sharded_render_gives_the_exchange_span(tmp_path):
    """Two gloo ranks: each chunk's all_reduce and the segment counts'
    exchange at the end are render.allreduce spans."""
    from cs397raytracingsp22_tpu_torch.parallel import multihost
    from tests.test_torch_sharding import ROOT, assert_ranks_ok, run_bounded

    port = multihost.free_port()
    assert_ranks_ok(run_bounded([[sys.executable, "-c", WORKER, str(r), str(port), str(tmp_path)]
                                 for r in range(2)], ROOT, str(tmp_path)))
    with open(tmp_path / "spans.json") as f:
        found = [tuple(sp) for sp in json.load(f)]
    names = [n for _, _, n in found]
    assert names.count("render.chunk") == 2 and names.count("render.allreduce") == 3
    parents = [parent_of(found, sp) for sp in found if sp[2] == "render.allreduce"]
    assert parents == ["render.chunk", "render.chunk", "render.finish"]


def test_traced_render_reads_on_the_host_clock(monkeypatch):
    """A CPU traced render through the benchmark's reader: the program's
    spans lie inside the bench.image window, which lies between two
    time.time_ns() reads; with nothing on a device the whole window is
    idle, and the layers' idle shares and the uncovered one add up to it."""
    monkeypatch.setattr(tbounce, "scene_is_simple", lambda scene: False)
    scene = tcornell.build(width=SIDE, height=SIDE, spp=2, path_depth=DEPTH)
    before = time.time_ns()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("bench.image"):
            tdriver.render_to_image(scene, device="cpu", seed=3, verbose=False,
                                    pixel_chunk=SIDE * SIDE // 2)
    after = time.time_ns()
    tr = btrace.read(prof, 1)
    assert before <= tr.window[0] < tr.window[1] <= after
    program = [op for op in tr.host_ops if op[2] in SPANS]
    assert {"render.image", "render.chunk", "render.bounce", "render.live_count"} <= \
        {n for _, _, n in program}
    assert all(tr.window[0] <= s <= e <= tr.window[1] for s, e, _ in program)
    run = {"trace": tr}
    shares = bspans.idle_shares(run)
    assert sum(shares.values()) == pytest.approx(100.0)
    assert shares["render.live_count"] > 0.0 and shares["render.image"] > 0.0
    assert bspans.launches_in(tr, "render.bounce") == (0, 2 * DEPTH)


def test_device_trace_without_a_directory_starts_no_profiler(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("RT_PROFILE_DIR", str(tmp_path / "env"))
    with profiling.device_trace(None) as prof:
        assert prof is None
        assert torch.autograd.profiler._is_profiler_enabled is False
    with profiling.device_trace("") as prof:
        assert prof is None
    assert os.listdir(tmp_path) == []


def test_device_trace_of_a_render_holds_raygen(tmp_path):
    scene = tcornell.build(width=4, height=4, spp=1, path_depth=2)
    with profiling.device_trace(str(tmp_path / "trace")) as prof:
        assert prof is not None
        tdriver.render_to_image(scene, device="cpu", seed=0, verbose=False)
    path = profiling.trace_path(str(tmp_path / "trace"))
    assert os.listdir(tmp_path / "trace") == [os.path.basename(path)]
    assert "raygen" in spans(path)


def test_cli_profile_dir_writes_a_trace(tmp_path, monkeypatch):
    monkeypatch.setenv("RT_PROFILE_DIR", str(tmp_path / "env"))
    base = [tcornell.__file__, "--width", "4", "--height", "4", "--spp", "1", "--depth", "2",
            "--device", "cpu", "-q"]
    assert cli.main(base + ["-o", str(tmp_path / "a.png")]) == 0
    assert not os.path.exists(tmp_path / "env")  # the port reads no RT_PROFILE_DIR
    assert cli.main(base + ["-o", str(tmp_path / "b.png"), "--profile-dir",
                            str(tmp_path / "prof")]) == 0
    assert "raygen" in spans(profiling.trace_path(str(tmp_path / "prof")))
    assert (tmp_path / "a.png").read_bytes() == (tmp_path / "b.png").read_bytes()
    assert not os.path.exists(tmp_path / "env")
