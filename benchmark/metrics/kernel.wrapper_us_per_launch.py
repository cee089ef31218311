"""Host us per launch inside the kernel wrappers' spans
(``cvx.kernel.<wrapper>``: the argument checks, the allocations and
``cvx.kernel.launch``) in the traced slice of ``benchmark/spans.py``.  No
value unless each wrapper span launched once."""

from benchmark import spans


def read(run):
    got = spans.read(run)
    if got is None:
        return None
    ns, count = got.summed("cvx.kernel.")
    launch_ns, launches = got.summed(spans.LAUNCH_SPAN)
    wrappers = count - launches
    if not wrappers or wrappers != launches:
        return None
    return (ns - launch_ns) / wrappers / 1e3
