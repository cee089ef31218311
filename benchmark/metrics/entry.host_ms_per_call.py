"""Host ms per call inside the program's entry span
(``cvx.entry.solve_certified_batch`` or ``cvx.entry.solve_jittable_batch``)
in the traced slice of ``benchmark/spans.py``: the host's time to queue a
call.  No value unless each call holds one entry span."""

from benchmark import spans


def read(run):
    got = spans.read(run)
    if got is None:
        return None
    ns, count = got.summed("cvx.entry.")
    return ns / 1e6 / count if count == got.calls > 0 else None
