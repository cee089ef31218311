"""Builds the CUDA sources under ``csrc/`` with nvcc and binds them with
ctypes.

A library is compiled at first use, never at import, into
``cvx_tpu_torch/ops/_build/`` (listed in ``.gitignore``), named by a hash of
its source and flags so that an edited source rebuilds and an unchanged one
loads the cached file.  The sources have a plain C interface (pointers,
strides, sizes, the stream), so the build needs neither PyTorch's headers
nor a compiler for them.  A failed build raises with nvcc's output.
``build_all`` starts one nvcc per source at once and waits for all of them.

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
from pathlib import Path

_CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "--fmad=false")
SOURCES = ("kl_dual.cu", "kl_barrier.cu", "chol.cu")

_libs: dict[str, ctypes.CDLL] = {}
_P, _I64, _I32, _F64 = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                        ctypes.c_double)


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): the "
                       "CUDA kernels are built from source at first use")


def _target(source: str) -> tuple[Path, Path]:
    src = _CSRC / source
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return src, BUILD_DIR / f"{src.stem}_{digest}.so"


def _start(src: Path, out: Path):
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f".{out.name}.{os.getpid()}.tmp"
    proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
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


def build_all(sources=SOURCES) -> list[Path]:
    """Compile every source not built yet, one nvcc each, all started
    together; returns the libraries' paths in the order given."""
    targets = [_target(s) for s in sources]
    running = [(src, out, *_start(src, out)) for src, out in targets
               if not out.exists()]
    try:
        for src, out, proc, tmp in running:
            _finish(src, out, proc, tmp)
    finally:
        for _, _, proc, _ in running:   # a failed build stops the others
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return [out for _, out in targets]


def build(source: str) -> Path:
    """Compile ``csrc/<source>`` into a shared library; returns its path."""
    return build_all((source,))[0]


def _load(source: str, signatures: dict, error_fn: str) -> ctypes.CDLL:
    lib = _libs.get(source)
    if lib is not None:
        return lib
    lib = ctypes.CDLL(str(build(source)))
    for fn, argtypes in signatures.items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = _I32
    err = getattr(lib, error_fn)
    err.argtypes = [_I32]
    err.restype = ctypes.c_char_p
    lib.error_string = err
    _libs[source] = lib
    return lib


def load_kl_dual() -> ctypes.CDLL:
    """The K1/K2 library (``csrc/kl_dual.cu``), built on first call."""
    rows = [_P] * 5 + [_I64] * 8          # Hs, u, A, r, log_prior; strides
    k1 = rows + [_P] * 3 + [_I32] * 5 + [_F64, _I32, _P]
    k2 = rows + [_P] * 5 + [_I32] * 5 + [_F64, _I32, _I32, _P]
    return _load("kl_dual.cu", {"kl_dual_fused_f32": k1,
                                "kl_dual_fused_f64": k1,
                                "kl_dual_fused_cert_f32": k2},
                 "kl_dual_error_string")


def load_kl_barrier() -> ctypes.CDLL:
    """The K3 library (``csrc/kl_barrier.cu``), built on first call."""
    sig = ([_P] * 5 + [_I64] * 7 + [_P] * 4 + [_I32] * 6 + [_P]
           + [_F64] * 2 + [_P])
    return _load("kl_barrier.cu", {"kl_barrier_fused_f32": sig,
                                   "kl_barrier_fused_f64": sig},
                 "kl_barrier_error_string")


def load_chol() -> ctypes.CDLL:
    """The K4 library (``csrc/chol.cu``), built on first call."""
    sig = [_P, _I64, _I64, _P, _I32, _I32, _P]
    return _load("chol.cu", {"chol_batched_f32": sig,
                             "chol_batched_f64": sig},
                 "chol_error_string")


def launch(lib: ctypes.CDLL, fn: str, name: str, device, *args) -> None:
    """Call ``lib.fn(*args, stream)`` on ``device``'s current stream and
    raise with CUDA's message if the launch is refused."""
    import torch

    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, fn)(*args, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} "
                           f"({lib.error_string(err).decode()})")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())
