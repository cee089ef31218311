"""Builds the CUDA sources under ``csrc/`` with nvcc and binds them with
ctypes.

A library is compiled at first use, never at import, into
``cvx_tpu_torch/ops/_build/`` (listed in ``.gitignore``), named by a hash of
its source and flags so that an edited source rebuilds and an unchanged one
loads the cached file.  The sources have a plain C interface (pointers,
strides, sizes, the stream), so the build needs neither PyTorch's headers
nor a compiler for them.  A failed build raises with nvcc's output.

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

_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): the "
                       "CUDA kernels are built from source at first use")


def build(source: str) -> Path:
    """Compile ``csrc/<source>`` into a shared library; returns its path."""
    src = _CSRC / source
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"{src.stem}_{digest}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f".{out.name}.{os.getpid()}.tmp"
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on {src} (exit {proc.returncode}):"
                           f"\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)     # atomic: concurrent builders race harmlessly
    return out


def load_kl_dual() -> ctypes.CDLL:
    """The K1/K2 library (``csrc/kl_dual.cu``), built on first call."""
    lib = _libs.get("kl_dual")
    if lib is not None:
        return lib
    lib = ctypes.CDLL(str(build("kl_dual.cu")))
    p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    rows = [p] * 5 + [i64] * 8          # Hs, u, A, r, log_prior; strides
    for fn in ("kl_dual_fused_f32", "kl_dual_fused_f64"):
        f = getattr(lib, fn)
        f.argtypes = rows + [p] * 3 + [i32] * 5 + [ctypes.c_double, i32, p]
        f.restype = i32
    f = lib.kl_dual_fused_cert_f32
    f.argtypes = rows + [p] * 5 + [i32] * 5 + [ctypes.c_double, i32, i32, p]
    f.restype = i32
    lib.kl_dual_error_string.argtypes = [i32]
    lib.kl_dual_error_string.restype = ctypes.c_char_p
    _libs["kl_dual"] = lib
    return lib
