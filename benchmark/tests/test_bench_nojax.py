"""Nothing the benchmark runs imports JAX or the JAX package, and the plain
reference imports nothing of the renderer: checked in fresh interpreters
by the top-level name of every loaded module, compared whole (the port's
name begins with the JAX package's)."""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
HARNESS = ["benchmark.run", "benchmark.rank", "benchmark.session", "benchmark.check",
           "benchmark.trace", "benchmark.procs", "benchmark.control", "benchmark.cells",
           "benchmark.port_scene", "benchmark.assets"]
REFERENCE = ["benchmark.reference.rng", "benchmark.reference.scene", "benchmark.reference.tracer",
             "benchmark.reference.walk"]


def _loaded(modules: list, extra: str = "") -> set:
    code = ("import importlib, json, sys\n"
            f"for m in {modules!r}: importlib.import_module(m)\n" + extra +
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_and_readers_load_no_jax():
    readers = ("from benchmark import cells\n"
               "import os\n"
               "for f in os.listdir('benchmark/metrics'):\n"
               "    cells.metric_reader(f[:-3])\n"
               "import cs397raytracingsp22_tpu_torch.render.driver\n")
    top = _loaded(HARNESS + REFERENCE, readers)
    assert not top & {"jax", "jaxlib", "flax", "cs397raytracingsp22_tpu"}
    assert "cs397raytracingsp22_tpu_torch" in top


def test_reference_loads_nothing_of_the_renderer():
    top = _loaded(REFERENCE)
    assert not top & {"jax", "jaxlib", "flax", "cs397raytracingsp22_tpu",
                      "cs397raytracingsp22_tpu_torch"}


def test_forbidden_modules_compares_whole_names(monkeypatch):
    from benchmark import run

    monkeypatch.setitem(sys.modules, "cs397raytracingsp22_tpu_torch_x", sys)
    assert run.forbidden_modules() == [] or "cs397raytracingsp22_tpu" in sys.modules
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert "jax" in run.forbidden_modules()
