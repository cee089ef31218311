"""``benchmark/spans.py``'s attribution on made-up events: the spans'
sums, the device time of the ops launched inside each span, the idle time
split by innermost span on the device's timeline put back on the host's
clock, and the metrics that read it, each with no value where it cannot
account for what it counts."""

import io
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from benchmark import spans, spec, trace

ROOT = Path(__file__).resolve().parents[2]
WRAPPER = "cvx.kernel.kl_dual_fused_cert"
CERT = "cvx.cert.kl_dual_gap"


def _call(t0, corr):
    """One call at t0 (ns): entry [5, 90] around a wrapper [10, 40] with its
    launch [20, 30] and the certificate [50, 80]; three device ops, queued
    at 25 (in the launch), 60 (in the certificate) and 96 (in no span), the
    last starting as it is queued."""
    host = [(trace.CALL_SPAN, t0, t0 + 100),
            ("cvx.entry.solve_certified_batch", t0 + 5, t0 + 90),
            (WRAPPER, t0 + 10, t0 + 40),
            (spans.LAUNCH_SPAN, t0 + 20, t0 + 30),
            (CERT, t0 + 50, t0 + 80)]
    device = [("k2", t0 + 30, t0 + 45, corr),
              ("abs", t0 + 62, t0 + 70, corr + 1),
              ("and", t0 + 96, t0 + 99, corr + 2)]
    launches = {corr: t0 + 25, corr + 1: t0 + 60, corr + 2: t0 + 96}
    return host, device, launches


def _slice(*calls):
    host, device, launches = [], [], {}
    for h, d, ln in calls:
        host += h
        device += d
        launches.update(ln)
    return host, device, launches


def _read(name, got):
    run = SimpleNamespace(spans=got, log=io.StringIO())
    return spec.reader(name, ROOT)(run)


def test_sums_device_time_and_idle_split():
    got = spans.attribute(*_slice(_call(0, 1), _call(200, 11)))
    assert got.calls == 2 and got.call_ns == [100, 100]
    assert got.span_ns == {"cvx.entry.solve_certified_batch": 170,
                           WRAPPER: 60, spans.LAUNCH_SPAN: 20, CERT: 60}
    assert got.summed("cvx.kernel.") == (80, 4)
    # the ops by the spans covering their launch, nested spans all counted
    assert got.device_ns == {"cvx.entry.solve_certified_batch": 46,
                             WRAPPER: 30, spans.LAUNCH_SPAN: 30, CERT: 16}
    assert (got.ops, got.unlinked, got.early) == (6, 0, 0)
    # a call's gaps: [0, 30], [45, 62], [70, 96], [99, 100]
    assert got.idle_ns == 2 * 74
    assert got.idle_by_span == {spans.NONE: 24,
                                "cvx.entry.solve_certified_batch": 40,
                                WRAPPER: 20, spans.LAUNCH_SPAN: 20,
                                CERT: 44}
    assert got.idle_in_program_ns == 2 * 62


def test_metrics_read_the_attribution():
    got = spans.attribute(*_slice(_call(0, 1), _call(200, 11)))
    assert _read("entry.host_ms_per_call", got) == pytest.approx(85e-6)
    assert _read("kernel.wrapper_us_per_launch", got) == pytest.approx(0.03)
    assert _read("cert.host_ms_per_call", got) == pytest.approx(30e-6)
    assert _read("cert.span_device_ms_per_call", got) == pytest.approx(8e-6)
    assert _read("device.idle_in_program_pct", got) == pytest.approx(
        100.0 * 62 / 74)
    spans._report(got, io.StringIO())


def test_no_value_where_the_slice_cannot_be_accounted_for():
    host, device, launches = _slice(_call(0, 1), _call(200, 11))
    # an op whose launch the trace lost: no certificate device time
    lost = spans.attribute(host, device + [("x", 150, 160, 99)], launches)
    assert lost.unlinked == 1
    assert _read("cert.span_device_ms_per_call", lost) is None
    assert _read("cert.host_ms_per_call", lost) == pytest.approx(30e-6)
    assert _read("device.idle_in_program_pct", lost) is None
    # a call without its entry span, a wrapper that did not launch
    partial = spans.attribute(
        [row for row in host if not (row[0].startswith("cvx.entry")
                                     and row[1] > 100)
         and not (row[0] == spans.LAUNCH_SPAN and row[1] > 100)],
        device, launches)
    assert _read("entry.host_ms_per_call", partial) is None
    assert _read("kernel.wrapper_us_per_launch", partial) is None


def _skewed(call, off):
    host, device, launches = call
    return host, [(n, a + off, b + off, c) for n, a, b, c in device], \
        launches


def test_a_device_clock_off_the_hosts_is_put_back_through_the_links():
    """Device stamps 600 ns early in one call and 300 ns late in another,
    more than a stretch later: the split is the one on a shared clock."""
    t1 = 5 * spans.WINDOW_NS
    true = spans.attribute(*_slice(_call(0, 1), _call(t1, 11)))
    skew = spans.attribute(*_slice(_skewed(_call(0, 1), -600),
                                   _skewed(_call(t1, 11), 300)))
    assert skew.early == 3 and true.early == 0
    assert sorted(skew.offsets_ns) == [-600, 300]
    assert (skew.idle_ns, skew.idle_in_program_ns, skew.idle_by_span) == (
        true.idle_ns, true.idle_in_program_ns, true.idle_by_span)
    assert skew.device_ns == true.device_ns


def test_a_program_without_spans_gives_no_values():
    host, device, launches = _slice(_call(0, 1))
    bare = spans.attribute([row for row in host
                            if row[0] == trace.CALL_SPAN], device, launches)
    assert bare.span_ns == {} and bare.idle_by_span == {spans.NONE: 74}
    for name in ("entry.host_ms_per_call", "kernel.wrapper_us_per_launch",
                 "cert.host_ms_per_call", "cert.span_device_ms_per_call",
                 "device.idle_in_program_pct"):
        assert _read(name, bare) is None, name


def test_nothing_is_traced_off_the_card():
    run = SimpleNamespace(device=torch.device("cpu"), log=io.StringIO())
    assert spans.read(run) is None and run.spans is None
    assert _read("setup.kernel_load_s", None) == 0.0
