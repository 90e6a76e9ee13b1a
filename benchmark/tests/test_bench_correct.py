"""`correct` against its control and its faults, at a size a CPU run holds.

Sound runs read 0 here (the renderer's plain versions and the reference
agree pixel for pixel). The control (the reference in bfloat16) reads
over a committed limit on each configuration; and a run with the timed
path broken underneath comes out not correct, once for each fault the
cell can have: a chunk that leaves the accumulator unchanged, half of
the samples left out with the mean taken over the rest, an answer altered
where it is produced, and (the sharded cell) the exchange between ranks
left out. Every limit is the committed cell's."""

import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SEED = 2**31 + 977


def _run(tiny_root, cell: str, fault: str = "", seconds: float = 0.5) -> dict:
    from benchmark.tests import faults

    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [faults.sitecustomize_dir(str(tiny_root / "site")), ROOT]))
    if fault:
        env["BENCHMARK_TEST_FAULT"] = fault
    out = subprocess.run([sys.executable, "-m", "benchmark.tests.run_tiny", cell, str(SEED),
                          str(seconds)], cwd=tiny_root, env=env, capture_output=True, text=True,
                         timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("cell", ["bench.k1", "demo.staged", "bench.nee", "demo.x4"])
def test_sound_run_is_correct(tiny_root, cell):
    res = _run(tiny_root, cell)
    assert res["correct"], res
    assert res["left"] == []
    assert all(v["value"] == 0.0 for v in res["compared"].values()), res


@pytest.mark.parametrize("cell,fault", [(c, f) for c in ("bench.k1", "demo.staged", "bench.nee")
                                        for f in ("state_unchanged", "half_batch",
                                                  "answer_altered")]
                         + [("demo.x4", f) for f in ("state_unchanged", "half_batch",
                                                     "answer_altered", "exchange_left_out")])
def test_fault_is_not_correct(tiny_root, cell, fault):
    res = _run(tiny_root, cell, fault)
    assert not res["correct"], res
    assert res["left"] == []


@pytest.mark.parametrize("cell", ["bench.k1", "demo.staged", "bench.nee"])
def test_control_fails_a_limit(tiny_root, cell):
    code = ("import json, torch\n"
            "from benchmark import cells, control\n"
            f"cell = cells.load_cell({cell!r})\n"
            "lim = cell.spec['check']['limits']\n"
            f"vals = [control.control(cell, s, torch.device('cpu')) for s in (11, 12, 13)]\n"
            "print(json.dumps([vals, lim]))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=tiny_root,
                         env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True, text=True,
                         timeout=900, check=True)
    vals, lim = json.loads(out.stdout.strip().splitlines()[-1])
    for v in vals:
        assert any(v[k] > lim[k] for k in lim), (v, lim)
