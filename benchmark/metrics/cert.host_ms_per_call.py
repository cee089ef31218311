"""Host ms per call inside the certificate's span
(``cvx.cert.kl_dual_gap``) in the traced slice of ``benchmark/spans.py``."""

from benchmark import spans


def read(run):
    got = spans.read(run)
    if got is None:
        return None
    ns, count = got.summed("cvx.cert.kl_dual_gap")
    return ns / 1e6 / got.calls if count else None
