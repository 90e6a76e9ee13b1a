import json
import os
import shutil

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
# the cells at a size a CPU test run holds: every other number as committed
TINY = {"bench_teapot_6k": dict(screen_width=16, screen_height=16, aa_sample_count=4,
                                path_depth=3),
        "demo_scene": dict(screen_width=12, screen_height=12, aa_sample_count=2, path_depth=3)}


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    """A copy of the checkout's benchmark with the configurations shrunk
    (TINY) and 48 sampled pixels an image."""
    root = tmp_path_factory.mktemp("tiny")
    shutil.copytree(os.path.join(ROOT, "benchmark"), root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root / "BENCHMARK.json")
    for name, cam in TINY.items():
        p = root / "benchmark" / "configs" / f"{name}.json"
        c = json.loads(p.read_text())
        c["scene"]["camera"].update(cam)
        p.write_text(json.dumps(c))
    for p in (root / "benchmark" / "workloads").glob("*.json"):
        w = json.loads(p.read_text())
        w["check"]["pixels"] = 48
        w["trace_images"] = 1
        p.write_text(json.dumps(w))
    return root
