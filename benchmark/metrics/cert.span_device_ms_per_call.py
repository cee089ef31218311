"""Device ms per call of the ops whose launch lies inside the certificate's
span (``cvx.cert.kl_dual_gap``), each op linked to its launch by
correlation id, in the traced slice of ``benchmark/spans.py``.  No value
if any device op of the slice has no launch in the trace."""

from benchmark import spans

SPAN = "cvx.cert.kl_dual_gap"


def read(run):
    got = spans.read(run)
    if (got is None or not got.ops or got.unlinked
            or SPAN not in got.span_ns):
        return None
    return got.device_ns.get(SPAN, 0) / 1e6 / got.calls
