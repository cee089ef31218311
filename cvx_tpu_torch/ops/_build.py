"""Builds the CUDA sources under ``csrc/`` with nvcc and binds them with
ctypes.

A library is compiled at first use, never at import, into
``cvx_tpu_torch/ops/_build/`` (listed in ``.gitignore``), named by a hash of
its source and flags so that an edited source rebuilds and an unchanged one
loads the cached file.  The sources have a plain C interface (pointers,
strides, sizes, the stream), so the build needs neither PyTorch's headers
nor a compiler for them.  A failed build raises with nvcc's output.
``build_all`` starts one nvcc per unit at once and waits for all of them.
A unit is a source with the flags that select its part: ``kl_dual.cu``'s
three entry points (60-odd template instances, which nvcc compiles one
after another) are three units, so that they build on three cores, and
the units of one source are built together at the first ``load`` of any.
``UNITS`` lists each unit's source, flags, entry points with their ctypes
argument types, and error-string function; ``load(unit)`` builds and
binds it.

Counters, read through ``diagnostics.counters()``: ``nvcc_runs`` (unit ->
the nvcc runs started for it in this process), ``kernel_loads`` and
``kernel_load_s`` (the libraries built or bound at first use, and the host
seconds that took, builds included).

Flags: ``sm_90a`` (Hopper), no fast math (the kernels test isfinite and
inf, and need IEEE exp/log/div/sqrt), and ``--fmad=false`` so that each
multiply and add rounds as in the plain PyTorch version.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import NamedTuple

from .._spans import span

_CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "--fmad=false")
_P, _I64, _I32, _F64 = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                        ctypes.c_double)


class _Unit(NamedTuple):
    source: str          # under csrc/
    flags: tuple         # further nvcc flags
    entries: dict        # entry point -> ctypes argument types
    error_fn: str        # the library's error-string function


_ROWS = [_P] * 5 + [_I64] * 8             # Hs, u, A, r, log_prior; strides
_K1 = _ROWS + [_P] * 3 + [_I32] * 5 + [_F64, _I32, _P]
_K2 = _ROWS + [_P] * 9 + [_I32] * 5 + [_F64, _I32, _I32, _F64, _F64, _P]
_K3 = [_P] * 5 + [_I64] * 7 + [_P] * 2 + [_I32] * 6 + [_F64] * 5 + [_P]
_K3_SCHEDULE = [_P] + [_I32] * 3 + [_F64] * 3 + [_P]
_GAP = ([_P, _I64, _P, _I64, _I64, _P, _I64, _P, _I64, _I64, _P, _I64]
        + [_P] * 2 + [_F64] * 2 + [_P] * 2 + [_I32] * 5 + [_F64, _P])
_K4 = [_P, _I64, _I64, _P, _I32, _I32, _P]
UNITS = {
    "kl_dual_cert": _Unit("kl_dual.cu", ("-DKL_DUAL_ENTRY=3",),
                          {"kl_dual_fused_cert_f32": _K2},
                          "kl_dual_error_string"),
    "kl_dual_f64": _Unit("kl_dual.cu", ("-DKL_DUAL_ENTRY=2",),
                         {"kl_dual_fused_f64": _K1}, "kl_dual_error_string"),
    "kl_dual_f32": _Unit("kl_dual.cu", ("-DKL_DUAL_ENTRY=1",),
                         {"kl_dual_fused_f32": _K1}, "kl_dual_error_string"),
    "kl_barrier": _Unit("kl_barrier.cu", (),
                        {"kl_barrier_fused_f32": _K3,
                         "kl_barrier_fused_f64": _K3,
                         "kl_barrier_schedule_f32": _K3_SCHEDULE,
                         "kl_barrier_schedule_f64": _K3_SCHEDULE},
                        "kl_barrier_error_string"),
    "chol": _Unit("chol.cu", (), {"chol_batched_f32": _K4,
                                  "chol_batched_f64": _K4},
                  "chol_error_string"),
    "kl_gap": _Unit("kl_gap.cu", (), {"kl_gap_fused_f32": _GAP,
                                      "kl_gap_fused_f64": _GAP},
                    "kl_gap_error_string")}

_libs: dict[str, ctypes.CDLL] = {}
nvcc_runs: dict[str, int] = {}
kernel_loads = 0
kernel_load_s = 0.0


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): the "
                       "CUDA kernels are built from source at first use")


def _target(unit: str) -> tuple[Path, tuple, Path]:
    row = UNITS[unit]
    src = _CSRC / row.source
    digest = hashlib.sha256(src.read_bytes() + " ".join(
        NVCC_FLAGS + row.flags).encode()).hexdigest()[:16]
    return src, row.flags, BUILD_DIR / f"{unit}_{digest}.so"


def _start(src: Path, flags: tuple, out: Path):
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f".{out.name}.{os.getpid()}.tmp"
    proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, *flags, "-o", str(tmp),
                             str(src)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    return proc, tmp


def _finish(src: Path, out: Path, proc, tmp: Path) -> None:
    stdout, stderr = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on {src} (exit {proc.returncode}):"
                           f"\n{stdout}\n{stderr}")
    os.replace(tmp, out)     # atomic: concurrent builders race harmlessly


def build_all(units=tuple(UNITS)) -> list[Path]:
    """Compile every unit not built yet, one nvcc each, all started
    together; returns the libraries' paths in the order given."""
    targets = [_target(u) for u in units]
    running = []
    for unit, (src, flags, out) in zip(units, targets):
        if not out.exists():
            running.append((src, out, *_start(src, flags, out)))
            nvcc_runs[unit] = nvcc_runs.get(unit, 0) + 1
    try:
        for src, out, proc, tmp in running:
            _finish(src, out, proc, tmp)
    finally:
        for _, _, proc, _ in running:   # a failed build stops the others
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return [out for _, _, out in targets]


def bind(path, signatures: dict, error_fn: str) -> ctypes.CDLL:
    """Load the shared library at ``path`` and declare its entries
    (``signatures``: name -> argument types, each returning a CUDA error
    code) and its error-string function."""
    lib = ctypes.CDLL(str(path))
    for fn, argtypes in signatures.items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = _I32
    err = getattr(lib, error_fn)
    err.argtypes = [_I32]
    err.restype = ctypes.c_char_p
    lib.error_string = err
    return lib


def load(unit: str) -> ctypes.CDLL:
    """The library of ``unit``, built (with the other units of its source
    beside it) and bound at first use."""
    global kernel_loads, kernel_load_s
    lib = _libs.get(unit)
    if lib is None:
        with span("cvx.build.load"):
            t0 = time.perf_counter()
            row = UNITS[unit]
            units = tuple(u for u, r in UNITS.items()
                          if r.source == row.source)
            path = build_all(units)[units.index(unit)]
            lib = _libs[unit] = bind(path, row.entries, row.error_fn)
            kernel_loads += 1
            kernel_load_s += time.perf_counter() - t0
    return lib


def launch(lib: ctypes.CDLL, fn: str, name: str, device, *args) -> None:
    """Call ``lib.fn(*args, stream)`` on ``device``'s current stream and
    raise with CUDA's message if the launch is refused."""
    import torch

    with span("cvx.kernel.launch"), torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, fn)(*args, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} "
                           f"({lib.error_string(err).decode()})")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())
