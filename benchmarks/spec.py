"""What a run is: its cell in BENCHMARK.json, the cell's configuration file
(`configs/<config>.json`, the file `BENCHMARK.json` names), its traffic
file (`traffic/<traffic>.json`), its entry (`entries/<entry>.py`, the
traffic file's `entry`) and the readers of its per-layer metrics
(`metrics/<name>.py`). Everything is found by name; nothing in the code
names a cell."""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import os
from typing import Callable, Dict, List

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "dpig_tpu")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: Dict          # the configuration file
    traffic: Dict         # the traffic file
    end_to_end: List[Dict]
    per_layer: List[Dict]


def _applies(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: str = ROOT) -> Cell:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; there are "
                       f"{sorted(cells)}")
    w = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    with open(os.path.join(root, conf["file"])) as f:
        config = json.load(f)
    with open(os.path.join(HERE, "traffic", f"{w['traffic']}.json")) as f:
        traffic = json.load(f)
    return Cell(name, w["chips"], config, traffic,
                [m for m in bench["end_to_end"] if _applies(m, name)],
                [m for m in bench["per_layer"] if _applies(m, name)])


def entry(cell: Cell):
    """The module that drives the cell's entry point."""
    return importlib.import_module(
        f"benchmarks.entries.{cell.traffic['entry']}")


def reader(metric_name: str) -> Callable:
    """`read(ctx)` of `metrics/<metric_name>.py`."""
    path = os.path.join(HERE, "metrics", f"{metric_name}.py")
    spec = importlib.util.spec_from_file_location(
        f"benchmarks_metric_{metric_name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_loaded(modules) -> List[str]:
    """Top-level names (before the first dot, compared whole) of loaded
    modules that a run must not hold: JAX and the JAX package."""
    return sorted({m.split(".")[0] for m in modules}
                  & set(FORBIDDEN_MODULES))
