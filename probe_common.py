"""What the kernel probes (``probe_k12.py``, ``probe_k3.py``,
``probe_k4.py``) share: the log, the card's line, the ``-Xptxas -v``
build of variant sources, the generic reading of ptxas's report, the SASS
loop finder and the bit-for-bit comparison.

A probe builds each variant of one source with ``_build.NVCC_FLAGS`` plus
``-Xptxas -v`` into ``_probe/build`` (gitignored) and binds it with the
entry points and error function that ``_build.UNITS`` lists for that
source; it launches the kernels itself, so that its CUDA events time the
kernel alone.
"""

from __future__ import annotations

import json
import re
import subprocess
import time
from pathlib import Path

import torch

from cvx_tpu_torch.ops import _build

BUILD = Path(__file__).resolve().parent / "_probe" / "build"
_LOG = []


def say(*parts):
    """print, and keep the line for ``DIR/log.txt``."""
    line = " ".join(str(p) for p in parts)
    print(line, flush=True)
    _LOG.append(line)


def write_log(out):
    """Every line said so far, to ``out/log.txt``."""
    (out / "log.txt").write_text("\n".join(_LOG) + "\n")


def card():
    """The card's name and power limit (``nvidia-smi``), said with torch's
    and CUDA's versions."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    say(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    return smi


def parse_ptxas(report, names, fields=("regs", "spill")):
    """{label: {"regs": r, "spill": "stores/loads", "stack": bytes,
    "smem": bytes}} from nvcc's ``-Xptxas -v`` report, each record cut to
    ``fields``: one record for each function whose mangled name one of
    ``names`` ((regex, label(match)); the first that matches) matches on
    its "Compiling entry" or "Function properties" line, read from the
    lines that follow."""
    res, cur = {}, None
    for line in report.splitlines():
        if "Compiling entry" in line or "Function properties for" in line:
            cur = None
            for pat, label in names:
                m = re.search(pat, line)
                if m:
                    cur = res.setdefault(label(m), {})
                    break
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            cur["stack"], cur["spill"] = int(m[1]), f"{m[2]}/{m[3]}"
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["regs"] = int(m[1])
            m = re.search(r"(\d+) bytes smem", line)
            cur["smem"] = int(m[1]) if m else 0
    return {label: {f: rec[f] for f in fields if f in rec}
            for label, rec in res.items()}


def build(srcs, out, source, table):
    """Compile each of ``srcs`` ({variant: CUDA source text}), one nvcc
    each, all started together; write nvcc's report to
    ``out/ptxas_<variant>.txt``, say ``table(variant, report)`` and bind
    the library with those of ``source``'s entry points from
    ``_build.UNITS`` that its text defines (an older source may lack
    some).  A variant nvcc refuses is said and left out.  Returns
    {variant: library}."""
    BUILD.mkdir(parents=True, exist_ok=True)
    out.mkdir(parents=True, exist_ok=True)
    rows = [r for r in _build.UNITS.values() if r.source == source]
    entries = {fn: args for r in rows for fn, args in r.entries.items()}
    procs = {}
    for name, src in srcs.items():
        cu = BUILD / f"{name}.cu"
        cu.write_text(src)
        procs[name] = (time.perf_counter(), subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
             str(BUILD / f"{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (t0, proc) in procs.items():
        report, _ = proc.communicate()
        (out / f"ptxas_{name}.txt").write_text(report)
        if proc.returncode:
            say(f"nvcc FAILED on {name}:\n{report[-3000:]}")
            continue
        say(f"ptxas {name} (done {time.perf_counter() - t0:.0f} s after the "
            "start)", json.dumps(table(name, report), sort_keys=True))
        libs[name] = _build.bind(BUILD / f"{name}.so",
                                 {fn: a for fn, a in entries.items()
                                  if fn in srcs[name]}, rows[0].error_fn)
    return libs


def sass_loops(so, kernel, dump=None):
    """Every loop (a backward branch and the span back to its target) in
    the SASS (``cuobjdump -sass``) of each function whose mangled name
    holds ``kernel``: [(static instructions, {opcode: count}), ...] in
    address order.  With ``dump``, the function's SASS is written to that
    file and its instruction count said."""
    sass = subprocess.run(
        [str(Path(_build._nvcc()).parent / "cuobjdump"), "-sass", str(so)],
        capture_output=True, text=True, check=True).stdout
    loops = []
    for fn in re.split(r"\n\s*Function : ", sass)[1:]:
        if kernel not in fn.split("\n", 1)[0]:
            continue
        ins = [(int(m[1], 16), m[2], m[3]) for m in re.finditer(
            r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_]+)[.\w]*"
            r"(.*?);", fn)]
        if dump:
            dump.write_text(fn)
            say(f"sass {kernel}: {len(ins)} instructions in all")
        for addr, op, rest in ins:
            t = re.search(r"0x([0-9a-f]+)", rest)
            if op == "BRA" and t and int(t[1], 16) < addr:
                body = [o for a, o, _ in ins if int(t[1], 16) <= a <= addr]
                loops.append((len(body), {o: body.count(o)
                                          for o in sorted(set(body))}))
    return loops


def same_bits(got, ref):
    """Two tensors, or two sequences of them pairwise, equal with NaN in
    the same places (inf compares equal to itself)."""
    if isinstance(got, torch.Tensor):
        got, ref = (got,), (ref,)
    for a, b in zip(got, ref):
        na, nb = torch.isnan(a), torch.isnan(b)
        if not (torch.equal(na, nb) and torch.equal(a[~na], b[~nb])):
            return False
    return True
