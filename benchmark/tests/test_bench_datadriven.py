"""A configuration, a cell (with its traffic) and a per-layer metric are
added as new files; the harness finds each by name, and no file that was
there changes."""

import hashlib
import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _digest(base: str) -> dict:
    out = {}
    for dirpath, _, files in os.walk(base):
        for f in files:
            if "__pycache__" in dirpath:
                continue
            p = os.path.join(dirpath, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, base)] = hashlib.sha256(fh.read()).hexdigest()
    return out


def test_new_files_are_found_by_name(tmp_path):
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path / "BENCHMARK.json")
    before = _digest(str(tmp_path / "benchmark"))
    b = tmp_path / "benchmark"
    config = json.loads((b / "configs" / "bench_teapot_6k.json").read_text())
    config["name"] = "cornell_only"
    config["scene"]["objects"] = config["scene"]["objects"][:9]
    (b / "configs" / "cornell_only.json").write_text(json.dumps(config))
    (b / "traffic" / "frames.path2.json").write_text(json.dumps(
        {"name": "frames.path2", "why": "test", "estimator": "path", "mesh": None}))
    (b / "workloads" / "cornell.k1.json").write_text(json.dumps(
        {"name": "cornell.k1", "config": "cornell_only", "traffic": "frames.path2", "chips": 1,
         "trace_images": 3, "check": {"images": 1, "pixels": 8,
                                      "limits": {"mean_abs_u8": 1.0, "share_off_u8": 1.0}}}))
    (b / "metrics" / "kernels_total.py").write_text(
        "def read(run):\n    tr = run.get('trace')\n    return None if tr is None else float(len(tr.kernels))\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["per_layer"].append({"name": "kernels_total", "unit": "kernels", "better": "lower",
                               "source": "device_trace", "layer": "device", "moves": "image_s",
                               "workloads": ["cornell.k1"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = ("from benchmark import cells\n"
            "c = cells.load_cell('cornell.k1')\n"
            "e2e, pl = cells.cell_metrics('cornell.k1')\n"
            "r = cells.metric_reader('kernels_total')\n"
            "print(c.config['name'], c.traffic['name'], [m['name'] for m in pl], r.read({}))\n"
            "print(sorted(cells.files_of(c.config)))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, timeout=120, check=True).stdout.splitlines()
    assert out[0] == "cornell_only frames.path2 ['kernels_total'] None"
    assert out[1] == "['teapot_6k.obj']"
    after = _digest(str(b))
    assert {k: v for k, v in after.items() if k in before} == before
    assert sorted(set(after) - set(before)) == sorted([
        "configs/cornell_only.json", "traffic/frames.path2.json", "workloads/cornell.k1.json",
        "metrics/kernels_total.py"])
