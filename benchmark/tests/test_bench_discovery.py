"""The harness finds configurations, mixes, limits and metrics by the names
in BENCHMARK.json, and a new mix and metric are new files only."""

import io
import json
import shutil
from pathlib import Path
from types import SimpleNamespace

from _small import cpu_run, small_cell

from benchmark import spec, trace

ROOT = Path(__file__).resolve().parents[2]
CELLS = ("kl_n100_b10k.certified", "kl_n10000_b100.certified",
         "kl_n100_b10k.primal")


def test_every_cell_is_found_by_name():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert tuple(w["name"] for w in bench["workloads"]) == CELLS
    for name in CELLS:
        cell = spec.load(name)
        assert cell.chips == 1
        assert cell.config["family"] == "kl_bounds"
        assert cell.mix["call"] in ("solve_certified_batch",
                                    "solve_jittable_batch")
        assert set(cell.limits) == {"x_err", "obj_err", "gap_err",
                                    "dual_err", "res_err", "stall_diff"}
        assert [m["name"] for m in cell.end_to_end] == [
            "instances_per_s", "call_ms_p95", "setup_s"]
        for m in cell.per_layer:
            assert callable(spec.reader(m["name"], ROOT))
    every = {"device.idle_pct", "entry.device_ops_per_call",
             "entry.host_ms_per_call", "kernel.wrapper_us_per_launch",
             "device.idle_in_program_pct", "setup.kernel_load_s"}
    primal = {m["name"] for m in spec.load(CELLS[2]).per_layer}
    assert primal == every | {"cert.device_ms_per_call", "kernel.k3_roofline",
                              "cert.host_ms_per_call",
                              "cert.span_device_ms_per_call"}
    for name in CELLS[:2]:
        certified = {m["name"] for m in spec.load(name).per_layer}
        assert certified == every | {"kernel.k2_roofline"}


def test_each_metric_has_its_reader_file():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert (ROOT / "benchmark" / "metrics" / f"{m['name']}.py").is_file()


def test_a_new_mix_and_metric_are_new_files_only(tmp_path):
    """Copy the benchmark, add a mix and a per-layer metric as new files and
    entries, and run the new cell: the harness reads both."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    here = tmp_path / "benchmark"
    mix = json.loads((here / "traffic" / "certified.json").read_text())
    mix["pool"] = 3
    (here / "traffic" / "dummy_mix.json").write_text(json.dumps(mix))
    (here / "metrics" / "dummy.calls_traced.py").write_text(
        "def read(run):\n    return float(run.window.calls)\n")
    name = "kl_n100_b10k.dummy_mix"
    (here / "limits" / f"{name}.json").write_text(
        (here / "limits" / "kl_n100_b10k.certified.json").read_text())
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": name, "config": "kl_n100_b10k",
                               "traffic": "dummy_mix", "chips": 1,
                               "why": "a test's cell"})
    bench["per_layer"].append({"name": "dummy.calls_traced", "unit": "calls",
                               "better": "higher", "source": "host_clock",
                               "layer": "entry", "moves": "instances_per_s",
                               "workloads": [name]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = small_cell(name, tmp_path)
    assert cell.mix["call"] == "solve_certified_batch"
    assert "dummy.calls_traced" in [m["name"] for m in cell.per_layer]
    cell.mix["pool"] = 3
    r = cpu_run(cell, traced=True)
    assert r.metrics["dummy.calls_traced"]["unit"] == "calls"
    assert r.metrics["dummy.calls_traced"]["value"] >= 1
    # a CPU run reads no device metric
    assert not any(k.startswith(("device.", "kernel.")) for k in r.metrics)
    assert r.correct


def _traced(counters, ops):
    fam = spec.load("kl_n100_b10k.certified").family
    return SimpleNamespace(
        cell=SimpleNamespace(family=fam), log=io.StringIO(),
        trace=trace.Slice(calls=2, window_s=1e-3, ops=ops,
                          counters=counters))


def test_device_ops_cross_check_gives_no_value_on_a_mismatch():
    read = spec.reader("entry.device_ops_per_call", ROOT)
    ops = [("kl_dual_cert_kernel", 0, 5), ("abs", 6, 7),
           ("kl_dual_cert_kernel", 8, 12), ("abs", 13, 14)]
    zero = {"kl_dual_fused": 0, "kl_barrier_fused": 0}
    assert read(_traced({"kl_dual_fused_cert": 2, **zero}, ops)) == 2.0
    # the trace lost a kernel, or the counter counted one it never saw
    assert read(_traced({"kl_dual_fused_cert": 3, **zero}, ops)) is None
    assert read(_traced({"kl_dual_fused_cert": 2, **zero}, ops[1:])) is None
