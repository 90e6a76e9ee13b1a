"""Cells, configurations, traffic mixes and metrics, found by name.

Everything that belongs to one cell, configuration, traffic mix or metric
is a file of its own, so a later change adds files and edits none:
- `workloads/<cell>.json`: the cell's configuration and traffic, its
  chips, the images its traced run profiles, the pixel sample its check
  compares and the limits of the compared numbers;
- `configs/<config>.json`: the scene as data (materials, objects, camera),
  the files it reads, its stand-in recipe, `source`, `reduced`, `assumed`;
- `traffic/<traffic>.json`: the mix of renders (estimator, device mesh);
- `metrics/<metric>.py`: a reader with `read(run) -> float | None`;
- BENCHMARK.json at the checkout's root says which metrics a cell reports.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _load(kind: str, name: str) -> dict:
    path = os.path.join(HERE, kind, f"{name}.json")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path})")
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    spec: dict  # workloads/<cell>.json
    config: dict  # configs/<config>.json
    traffic: dict  # traffic/<traffic>.json

    @property
    def chips(self) -> int:
        return int(self.spec["chips"])

    @property
    def camera(self) -> dict:
        """The configuration's camera with the traffic's estimator."""
        return dict(self.config["scene"]["camera"], nee=self.traffic.get("estimator") == "nee")

    @property
    def mesh(self):
        return self.traffic.get("mesh")


def load_cell(name: str) -> Cell:
    spec = _load("workloads", name)
    return Cell(name=name, spec=spec, config=_load("configs", spec["config"]),
                traffic=_load("traffic", spec["traffic"]))


def metric_reader(name: str):
    """The module metrics/<name>.py (loaded from its file: a name may hold
    dots)."""
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name.replace('.', '_')}",
                                                  path)
    if spec is None or not os.path.exists(path):
        raise FileNotFoundError(f"no metric reader {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(cell: str, root: str = ROOT) -> tuple[list, list]:
    """(end-to-end metric entries, per-layer metric entries) of BENCHMARK.json
    that this cell reports: those whose `workloads` list it, or that have
    none."""
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    pick = lambda ms: [m for m in ms if cell in m.get("workloads", [cell])]  # noqa: E731
    return pick(bench["end_to_end"]), pick(bench["per_layer"])


def files_of(config: dict) -> dict:
    """The configuration's file names → paths: a path under "stand_ins/"
    lies in its written stand-in directory, any other is relative to the
    checkout's root."""
    from benchmark import assets

    out, stand = {}, None
    for name, rel in config.get("files", {}).items():
        if rel.startswith("stand_ins/"):
            stand = stand or assets.stand_in_dir(config["stand_ins"])
            out[name] = os.path.join(stand, rel[len("stand_ins/"):])
        else:
            out[name] = os.path.join(ROOT, rel)
    return out
