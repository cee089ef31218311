"""The program's spans: host ranges recorded through ``torch.profiler``.

``span(name)`` marks a stretch of host code as a context manager or as a
decorator.  While no profiler records, it costs one check of the flag the
profiler sets as it starts and clears as it stops.  While one records, the
range is recorded by the profiler itself, so it lies on the clock that the
profiler's device activity is stamped on, and a range's parent is the range
that encloses it.  There is no other store of spans.

Names are ``cvx.<layer>.<what>``: ``entry`` (the batched solve entry
points), ``route`` (the Solution a route assembles), ``cert`` (the measured
certificates), ``kernel`` (each kernel wrapper, and ``cvx.kernel.launch``
around the launch itself) and ``build`` (``cvx.build.load``, a kernel
library's first use).  No span sits inside a loop over steps.

This module imports nothing of the package, so every module can use it.
"""

from __future__ import annotations

import functools

from torch.autograd import profiler as _profiler

try:     # a range that skips record_function's Python layers
    from torch._C._profiler import _RecordFunctionFast as _Range
except ImportError:    # pragma: no cover - older torch
    _Range = _profiler.record_function


class span:
    """A host range named ``name``, recorded while a ``torch.profiler``
    records and otherwise nothing; ``with span(name):`` or ``@span(name)``.
    """

    __slots__ = ("name", "_range")

    def __init__(self, name: str):
        self.name = name
        self._range = None

    def __enter__(self):
        if _profiler._is_profiler_enabled:
            self._range = _Range(self.name)
            self._range.__enter__()
        return self

    def __exit__(self, *exc):
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
        return False

    def __call__(self, fn):
        name = self.name

        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            if not _profiler._is_profiler_enabled:
                return fn(*args, **kwargs)
            with _Range(name):
                return fn(*args, **kwargs)

        return spanned
