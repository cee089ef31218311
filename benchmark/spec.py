"""Finds what a cell is made of, by the names in ``BENCHMARK.json``.

* a configuration: the JSON file its entry names (``configs/<name>.json``),
  whose ``family`` names the module under ``families/`` that makes its
  inputs, reaches the program, gives its reference and judges its outputs
  (``harness.run_cell`` lists what a family provides);
* a traffic mix: ``traffic/<name>.json``;
* a metric: ``metrics/<name>.py``, whose ``read(run)`` returns the value
  or None when it finds nothing to read;
* the limits of the comparison that decides ``correct``:
  ``limits/<workload>.json``.

A new cell, mix or metric is new files and entries: nothing here changes.
"""

import importlib.util
import json
import sys
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
    return Cell(name=workload, chips=entry["chips"], config=config, mix=mix,
                limits=limits, family=family(root, here, config["family"]),
                end_to_end=e2e, per_layer=per_layer, root=root)


def family(root, here, name):
    """The module ``families/<name>.py`` of the benchmark at ``root``/
    ``here``, loaded from that file, so that a copy of the benchmark finds
    its own families whatever ``sys.path`` holds.  It is registered under
    its package's name (``benchmark.families.<name>``), replacing a module
    of that name loaded from another file, and its relative imports resolve
    through that package."""
    path = (Path(root) / here / "families" / f"{name}.py").resolve()
    modname = f"{here.as_posix().replace('/', '.')}.families.{name}"
    module = sys.modules.get(modname)
    if module is not None and Path(module.__file__).resolve() == path:
        return module
    mod_spec = importlib.util.spec_from_file_location(modname, path)
    module = importlib.util.module_from_spec(mod_spec)
    sys.modules[modname] = module
    mod_spec.loader.exec_module(module)
    return module


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
