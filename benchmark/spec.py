"""Finds what a cell is made of, by the names in ``BENCHMARK.json``.

* a configuration: the JSON file its entry names (``configs/<name>.json``),
  whose ``family`` names the module under ``families/`` that makes its
  inputs, reaches the program and gives its reference;
* a traffic mix: ``traffic/<name>.json``;
* a metric: ``metrics/<name>.py``, whose ``read(run)`` returns the value
  or None when it finds nothing to read;
* the limits of the comparison that decides ``correct``:
  ``limits/<workload>.json``.

A new cell, mix or metric is new files and entries: nothing here changes.
"""

import importlib
import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    mix: dict
    limits: dict
    family: object
    end_to_end: list      # the BENCHMARK.json entries this cell reports
    per_layer: list
    root: Path            # the directory that holds BENCHMARK.json


def _reports(metric, workload, moved):
    if "workloads" in metric:
        return workload in metric["workloads"]
    return moved is None or metric["moves"] in moved


def load(workload, root=None):
    """The cell named ``workload``, from ``root``/BENCHMARK.json (the
    directory above this package by default)."""
    root = Path(root) if root else HERE.parent
    spec = json.loads((root / "BENCHMARK.json").read_text())
    here = Path(spec["paths"][0])
    entry = next((w for w in spec["workloads"] if w["name"] == workload),
                 None)
    if entry is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cfg = next(c for c in spec["configs"] if c["name"] == entry["config"])
    config = json.loads((root / cfg["file"]).read_text())
    mix = json.loads((root / here / "traffic" / f"{entry['traffic']}.json")
                     .read_text())
    limits = json.loads((root / here / "limits" / f"{workload}.json")
                        .read_text())
    e2e = [m for m in spec["end_to_end"] if _reports(m, workload, None)]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"]
                 if _reports(m, workload, moved)]
    family = importlib.import_module(
        f"{here.as_posix().replace('/', '.')}.families.{config['family']}")
    return Cell(name=workload, chips=entry["chips"], config=config, mix=mix,
                limits=limits, family=family, end_to_end=e2e,
                per_layer=per_layer, root=root)


def reader(name, root):
    """The ``read`` function of ``metrics/<name>.py`` under the benchmark's
    directory in ``root``."""
    spec = json.loads((Path(root) / "BENCHMARK.json").read_text())
    path = Path(root) / spec["paths"][0] / "metrics" / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(module)
    return module.read
