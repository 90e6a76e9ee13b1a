"""utils/profiling.py of the port (PhaseTimer, device_trace) and the CLI's
--profile-dir, on the CPU: a trace is written only where a directory is
given, it holds the package's "raygen" span, and RT_PROFILE_DIR, which
the JAX package reads, changes nothing."""

import json
import os
import time

import torch

from cs397raytracingsp22_tpu_torch import cli
from cs397raytracingsp22_tpu_torch.render import driver as tdriver
from cs397raytracingsp22_tpu_torch.scenes import cornell as tcornell
from cs397raytracingsp22_tpu_torch.utils import profiling

torch.set_num_threads(1)


def spans(path):
    with open(path) as f:
        return {e.get("name") for e in json.load(f)["traceEvents"]
                if e.get("cat") == "user_annotation"}


def test_phase_timer_sums_repeated_phases():
    t = profiling.PhaseTimer()
    for _ in range(2):
        with t.phase("render"):
            time.sleep(0.01)
    with t.phase("tonemap"):
        pass
    assert list(t.phases) == ["render", "tonemap"]
    assert t.phases["render"] >= 0.02
    assert t.summary().startswith("render: 0.0")


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
