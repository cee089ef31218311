"""``bench_scaling_torch.py``, the port's scaling ladder, on the CPU at
its tiny size: every row group runs once (one call after the warm-up) and
each JSON record carries its keys and holds its checks: the certified
rows max |gap| <= 1e-8 and residuals <= tol_feas, K1 / primal rows their
host f64 certificates on every lane, every K1 / K2 row the kernel against
its plain version, the phase-I rows exact flags, the factorizations their
residuals.  On the CPU the wrappers run the kernels' plain versions, so
every launch count is 0.  The agreement rules themselves
(``cvx_tpu_torch._bench``) must fail on a lane that parts from the plain
version.  The ladder at the card's shapes
runs on the H100 (``python3 bench_scaling_torch.py``)."""

import json
import math
import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import bench_scaling_torch as bst  # noqa: E402
from cvx_tpu_torch._bench import (K1_DZ, K1_TOL, bench_family,  # noqa: E402
                                  k1_agreement, k2_agreement)
from cvx_tpu_torch.ops import (kl_dual_fused_cert_plain,  # noqa: E402
                               kl_dual_fused_plain)

# six test processes share the CPU's cores (see test_torch_qp.py)
torch.set_num_threads(1)

BASE_KEYS = {"group", "metric", "device", "dtype", "checks"}
KERNEL_KEYS = {"name", "kernel_ms", "bound_ms", "bound_by"}


def _zero(launches):
    return launches == {k: 0 for k in bst.KERNELS}


@pytest.mark.parametrize("group", [g.__name__ for g in bst.GROUPS])
def test_row_group(group, capsys):
    L = bst.Ladder("cpu", reps=1, tries=1)
    getattr(bst, group)(L)
    printed = [json.loads(line) for line in
               capsys.readouterr().out.splitlines() if line.startswith("{")]
    assert L.records and printed == json.loads(json.dumps(L.records))
    for rec in L.records:
        assert BASE_KEYS <= set(rec), rec
        assert rec["group"] == group and rec["device"] == "cpu"
        assert rec["dtype"] == "float64"
        assert "failed" not in rec and all(rec["checks"].values()), rec
        assert math.isfinite(rec.get("ms", rec.get("value")))
        if "ms" in rec:
            assert rec["ms"] > 0 and "unit" in rec
            assert "launches" in rec
        launches = rec.get("launches", {})
        if "barrier" in launches:
            assert _zero(launches["barrier"]) and _zero(launches["certify"])
        elif launches:
            assert _zero(launches)
        if "kernel" in rec:
            k = rec["kernel"]
            assert KERNEL_KEYS <= set(k) and k["name"] in bst.KERNELS
            assert k["kernel_ms"] > 0 and k["bound_ms"] > 0
            assert k["bound_by"] in ("bytes", "operations")
            if k["name"] in ("kl_dual_fused", "kl_dual_fused_cert"):
                assert "kernel_vs_plain" in rec["checks"], rec
        if "gap_cert_max" in rec and "route_gap_maxabs" in rec:
            # a K1 route row: the certificate holds on every lane, whatever
            # the route flags
            assert "cert" in rec["checks"], rec
    assert not L.failed


def test_every_reference_group_has_a_row_function():
    """The groups follow ``bench_scaling.py``'s main, in its order."""
    src = (Path(__file__).resolve().parents[1] / "bench_scaling.py") \
        .read_text().split("def main():")[1]
    ref = [name for name in (g.__name__ for g in bst.GROUPS)
           if name + "(" in src]
    assert ref == [g.__name__ for g in bst.GROUPS]
    assert sorted(src.index(n + "(") for n in ref) == [
        src.index(n + "(") for n in ref]


def test_main_writes_its_rows(tmp_path, capsys):
    out = tmp_path / "ladder.jsonl"
    rc = bst.main(["--device", "cpu", "--rows", "kl_certified,big_cholesky",
                   "--reps", "1", "--tries", "1", "--out", str(out)])
    assert rc == 0
    lines = [json.loads(v) for v in out.read_text().splitlines()]
    assert [r["group"] for r in lines] == ["kl_certified"] * 2 + [
        "big_cholesky"]
    summary = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert summary["rows"] == 3 and summary["failed"] == []


def test_main_refuses_what_it_cannot_run(capsys):
    with pytest.raises(SystemExit):
        bst.main(["--device", "cpu", "--rows", "no_such_row"])
    if not torch.cuda.is_available():
        assert bst.main(["--device", "cuda"]) == 1
        assert "no CUDA device" in capsys.readouterr().err


def _bench_batch(B=6, n=40):
    H, U = bench_family(B, n, seed=0)
    Hb = torch.tensor(H)[None].expand(B, -1, -1)
    return Hb, torch.tensor(U)


def test_k1_agreement_fails_on_a_lane_off_the_plain_version():
    """The rule the ladder and chip_smoke.py hold K1 to: one lane whose z
    and gap part from the plain version's (as a stalled lane does) fails
    it, stall flag or not."""
    Hb, U = _bench_batch()
    x, gap, z = kl_dual_fused_plain(Hb, U)
    assert k1_agreement((x, gap, z), (x, gap, z), K1_TOL, K1_DZ)["close"]
    z_off, gap_off = z.clone(), gap.clone()
    z_off[2, 0] += 1.3e-3
    gap_off[2] = 1.4e-3
    a = k1_agreement((x, gap_off, z_off), (x, gap, z), K1_TOL, K1_DZ)
    assert a["dead_same"] and not a["close"] and a["gap"] == 1.4e-3


def test_k2_agreement_fails_on_a_lane_off_the_plain_version():
    Hb, U = _bench_batch()
    out = kl_dual_fused_cert_plain(Hb.float(), U.float())
    assert k2_agreement(out, out)["close"]
    x, z, gap, ineq, eq = (t.clone() for t in out[:5])
    x[1, 0] += 1e-9
    assert not k2_agreement((x, z, gap, ineq, eq), out)["close"]
