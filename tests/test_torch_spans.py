"""The program's spans and counters: ``diagnostics.span`` (recorded by
``torch.profiler`` while one records, a flag check otherwise) at the entry,
route, certificate, kernel-wrapper and build layers, and
``diagnostics.counters()``.  The certified route and the fused primal route
run their kernels' plain versions here; the test marked ``cuda`` holds the
launch span and the link from a kernel to its launch on the card."""

import json
import os

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from cvx_tpu_torch import DistKL, SolverParams, _spans, diagnostics
from cvx_tpu_torch.ops import _build
from cvx_tpu_torch.ops.kl_barrier import kl_barrier_fused

# one torch thread a test process (see test_torch_api_utilities.py)
torch.set_num_threads(1)

N = 12
U = torch.tensor([[-0.3, 0.7], [-0.25, 0.65], [-0.4, 0.75]])


def _model(device="cpu"):
    H = torch.zeros((2, N))
    H[0, :3] = -1.0
    H[1, N // 2:] = 1.0
    return DistKL.create(N, H=H.to(device), u=torch.tensor([-0.3, 0.7]),
                         device=device)


def _x0(u):
    """Strictly feasible starts: weight -u_A + 0.05 on A, the rest spread."""
    w = -u[:, :1] + 0.05
    inside = torch.zeros(N, device=u.device)
    inside[:3] = 1.0
    return (w / 3) * inside + ((1 - w) / (N - 3)) * (1 - inside)


ROUTES = {
    "certified": (lambda m: m.solve_certified_batch(U),
                  ["cvx.entry.solve_certified_batch",
                   "cvx.kernel.kl_dual_fused_cert",
                   "cvx.route.cert_solution"]),
    "primal": (lambda m: m.solve_jittable_batch(
        U, _x0(U), method="fused",
        pars=SolverParams(max_iter=3, mu=55.0, tol=1e-8)),
               ["cvx.entry.solve_jittable_batch",
                "cvx.kernel.kl_barrier_fused",
                "cvx.route.fused_solution", "cvx.cert.kl_dual_gap",
                "cvx.kernel.kl_gap_fused", "cvx.cert.polish_dual"]),
}
# (inner, outer): each inner span lies inside its outer one
NESTED = [("cvx.cert.kl_dual_gap", "cvx.route.fused_solution"),
          ("cvx.kernel.kl_gap_fused", "cvx.cert.kl_dual_gap"),
          ("cvx.cert.polish_dual", "cvx.kernel.kl_gap_fused")]


def _spans_of(prof):
    return {e.name: (e.time_range.start, e.time_range.end)
            for e in prof.events() if e.name.startswith("cvx.")}


@pytest.mark.parametrize("route", list(ROUTES))
def test_spans_are_recorded_and_nested(route):
    call, expected = ROUTES[route]
    model = _model()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        call(model)
    names = [e.name for e in prof.events() if e.name.startswith("cvx.")]
    assert sorted(names) == sorted(expected)       # one of each
    got = _spans_of(prof)
    entry = got[expected[0]]
    for name in expected[1:]:
        assert entry[0] <= got[name][0] <= got[name][1] <= entry[1], name
    for inner, outer in NESTED:
        if inner in got:
            assert got[outer][0] <= got[inner][0] <= got[inner][1] \
                <= got[outer][1]


@pytest.mark.parametrize("route", list(ROUTES))
def test_outputs_are_bit_identical_under_a_profiler(route):
    call, _ = ROUTES[route]
    model = _model()
    plain = call(model)
    with profile(activities=[ProfilerActivity.CPU]):
        traced = call(model)
    for field in ("x", "lam", "nu", "duality_gap", "eq_gap", "ineq_res",
                  "stalled", "iters"):
        torch.testing.assert_close(getattr(traced, field),
                                   getattr(plain, field), rtol=0, atol=0,
                                   equal_nan=True)


def test_no_range_is_entered_without_a_profiler(monkeypatch):
    entered = []

    class Spy:
        def __init__(self, name):
            self.name = name

        def __enter__(self):
            entered.append(self.name)

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(_spans, "_Range", Spy)
    model = _model()
    for call, _ in ROUTES.values():
        call(model)
    assert entered == []
    with profile(activities=[ProfilerActivity.CPU]):
        ROUTES["certified"][0](model)
    assert sorted(entered) == sorted(ROUTES["certified"][1])


def test_trace_shows_the_spans(tmp_path):
    model = _model()
    with diagnostics.trace(str(tmp_path)) as d:
        model.solve_certified_batch(U)
    with open(os.path.join(d, "trace.json")) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "cvx.entry.solve_certified_batch" in names


def test_counters_and_a_cpu_solve_moves_none():
    """No launch or build counter moves on the CPU; the certified call's
    Solution, whose leaves K2's plain version made by the torch rule,
    counts under ``cert_leaves_torch``, and the fused primal call's K3,
    whose plain version built its schedule as tensors, under
    ``kl_barrier_schedule_torch``."""
    before = diagnostics.counters()
    assert set(before) == {"kl_dual_fused", "kl_dual_fused_cert",
                           "kl_barrier_fused", "kl_gap_fused",
                           "cholesky_batched_cuda", "kl_dual_gap_chain_calls",
                           "kl_barrier_schedule_torch",
                           "cert_leaves_fused", "cert_leaves_torch",
                           "nvcc_runs", "kernel_loads", "kernel_load_s"}
    model = _model()
    for call, _ in ROUTES.values():
        call(model)
    assert diagnostics.counters() == dict(
        before, cert_leaves_torch=before["cert_leaves_torch"] + 1,
        kl_barrier_schedule_torch=before["kl_barrier_schedule_torch"] + 1)


LAUNCHES = ("kl_dual_fused", "kl_dual_fused_cert", "kl_barrier_fused",
            "kl_gap_fused", "cholesky_batched_cuda")


@pytest.mark.parametrize("call", [
    lambda m: kl_barrier_fused(
        m.H[None].expand(3, -1, -1), U, torch.ones((3, 1, N)),
        torch.ones((3, 1)), _x0(U), mu=55.0, n_inner=3),
    ROUTES["primal"][0]], ids=["kl_barrier_fused", "solve_jittable_batch"])
def test_a_cpu_k3_call_counts_one_torch_schedule(call):
    """K3 on CPU tensors runs the plain version, which builds its schedule
    as tensors: one ``kl_barrier_schedule_torch`` a call, for the wrapper
    and for the fused primal route, and no launch."""
    model = _model()
    before = diagnostics.counters()
    call(model)
    got = diagnostics.counters()
    assert got["kl_barrier_schedule_torch"] == \
        before["kl_barrier_schedule_torch"] + 1
    assert {c: got[c] for c in LAUNCHES} == {c: before[c] for c in LAUNCHES}


@pytest.mark.parametrize("route", [
    lambda m: m.solve_certified_batch(U, fused_cert=False),
    lambda m: DistKL.create(N, H=m.H.double(), u=m.u.double(),
                            device="cpu").solve_certified_batch(U.double()),
    lambda m: m.solve_certified(),
    lambda m: m.solve_certified_batch(U)],
    ids=["fused_cert_false", "f64_model", "solve_certified", "cpu_k2"])
def test_certified_routes_off_the_card_count_torch_leaves(route):
    """The f64 route (K1 + ``kl_certify``: asked for, or an f64 model's
    default), ``solve_certified`` and the CPU count one
    ``cert_leaves_torch`` a call and never ``cert_leaves_fused``."""
    model = _model()
    before = diagnostics.counters()
    route(model)
    route(model)
    got = diagnostics.counters()
    assert got["cert_leaves_torch"] == before["cert_leaves_torch"] + 2
    assert got["cert_leaves_fused"] == before["cert_leaves_fused"]


def test_build_counters_count_builds_and_loads(monkeypatch, tmp_path):
    """With nvcc and the loader faked: the K1/K2 libraries build together
    at the first load (three nvcc runs, one load), a second entry of them
    loads without a build, and a load is one ``cvx.build.load`` span."""

    class Done:
        returncode = 0

        def communicate(self):
            return "", ""

        def poll(self):
            return 0

    def start(src, flags, out):
        tmp = tmp_path / f".{out.name}.tmp"
        tmp.write_bytes(b"")
        return Done(), tmp

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_start", start)
    monkeypatch.setattr(_build, "bind", lambda path, sig, err: object())
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "nvcc_runs", {})
    monkeypatch.setattr(_build, "kernel_loads", 0)
    monkeypatch.setattr(_build, "kernel_load_s", 0.0)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _build.load("kl_dual_cert")
    _build.load("kl_dual_cert")
    got = diagnostics.counters()
    assert got["nvcc_runs"] == {"kl_dual_cert": 1, "kl_dual_f64": 1,
                                "kl_dual_f32": 1}
    assert got["kernel_loads"] == 1 and got["kernel_load_s"] > 0
    assert [e.name for e in prof.events()
            if e.name.startswith("cvx.")] == ["cvx.build.load"]
    _build.load("kl_dual_f32")
    got = diagnostics.counters()
    assert got["kernel_loads"] == 2
    assert sum(got["nvcc_runs"].values()) == 3


@pytest.mark.cuda
def test_launch_span_links_the_kernel_on_the_card():
    """On the card: the launch span lies inside the wrapper's, no span is
    mirrored among the device's events, and K2 is linked by correlation id
    to a runtime launch inside ``cvx.kernel.launch`` (the host's clock; the
    profiler's device timestamps may run off it)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    model = _model("cuda")
    u = U.cuda()
    model.solve_certified_batch(u)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        model.solve_certified_batch(u)
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    events = prof.profiler.kineto_results.events()
    spans = {e.name(): (e.start_ns(), e.start_ns() + e.duration_ns())
             for e in events
             if e.device_type() != cuda and e.name().startswith("cvx.")}
    wrapper = spans["cvx.kernel.kl_dual_fused_cert"]
    launch = spans["cvx.kernel.launch"]
    assert wrapper[0] <= launch[0] <= launch[1] <= wrapper[1]
    assert not any(e.name().startswith("cvx.") for e in events
                   if e.device_type() == cuda)
    k2 = [e for e in events if e.device_type() == cuda
          and "kl_dual_cert" in e.name()]
    assert len(k2) == 1
    runtime = [e for e in events if e.device_type() != cuda
               and e.name().startswith("cu")       # CUDA API calls
               and e.correlation_id() == k2[0].correlation_id()]
    assert len(runtime) == 1
    assert launch[0] <= runtime[0].start_ns() <= launch[1]
