"""Host seconds the program spent building or loading its kernel libraries
at first use, by its own counter (``diagnostics.counters()``'s
``kernel_load_s``), read after the run: part of ``setup_s``, nearly all of
it where the kernels were built."""


def read(run):
    from cvx_tpu_torch import diagnostics

    counters = getattr(diagnostics, "counters", None)
    return float(counters()["kernel_load_s"]) if counters else None
