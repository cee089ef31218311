"""Of the device's idle time inside the calls of the traced slice of
``benchmark/spans.py``, the share in % during which the host was inside
some ``cvx.*`` span; the rest is the loop, the sync and the return.  The
device's timeline is put on the host's clock through each op's link to its
launch, so no value without spans or where an op has no launch in the
trace."""

from benchmark import spans


def read(run):
    got = spans.read(run)
    if (got is None or not got.ops or not got.span_ns or got.unlinked
            or not got.idle_ns):
        return None
    return 100.0 * got.idle_in_program_ns / got.idle_ns
