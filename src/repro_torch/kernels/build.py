"""Build and load the port's hand-written CUDA kernels.

Each kernel is one ``csrc/<name>.cu`` with a plain ``extern "C"`` launcher.
It is compiled at first use with ``nvcc`` for Hopper (``sm_90a``) into a
shared library under ``<repo>/build/kernels/`` and loaded with ``ctypes``
(no PyTorch headers, so a build takes seconds, not minutes). Shared Hopper
helpers live in ``csrc/hopper.cuh``. The library's file name carries a
digest of its source, of the headers and of the flags, so an edited
source or header never loads a stale build. A missing ``nvcc`` or a failed compile raises: there is no
fallback. Several processes may build at once (the sweep's process and
host workers on a fresh checkout): an exclusive ``flock`` on
``BUILD_DIR/.build.lock`` lets one of them compile while the others wait,
then load what it built.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin); "
                           "the CUDA kernels cannot be built")
    return path


def library_path(name: str) -> Path:
    """The library of kernel ``name``: its file name carries a digest of
    ``<name>.cu``, of every header under ``csrc/`` and of the compiler
    flags, so an edited source or header, or other flags, never load a
    stale build."""
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.name.encode())
        digest.update(header.read_bytes())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:12]}.so"


def build(names: Sequence[str]) -> Dict[str, Path]:
    """Compile every named kernel whose library is missing, one ``nvcc``
    per source, all started together, under the build directory's
    exclusive lock (another process building the same sources makes this
    one wait, then find the libraries built). Returns {name: library
    path}; the compiler's ``-Xptxas -v`` report lands beside each library
    as ``.log``. Raises :class:`RuntimeError` naming the failed
    sources."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = {n: library_path(n) for n in names}
    with open(BUILD_DIR / ".build.lock", "a") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)     # released when it closes
        procs = {}
        for n, lib in out.items():
            if lib.exists():
                continue
            tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
            procs[n] = (subprocess.Popen(
                [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
                 str(CSRC / f"{n}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), tmp)
        failed = []
        for n, (proc, tmp) in procs.items():
            log, _ = proc.communicate()
            # temp-and-rename: a reader of the report never sees it half
            # written
            log_path = out[n].with_suffix(".log")
            tmp_log = log_path.with_name(f"{log_path.name}.{os.getpid()}.tmp")
            tmp_log.write_text(log)
            os.replace(tmp_log, log_path)
            if proc.returncode != 0:
                failed.append(f"{n}.cu (nvcc exit {proc.returncode}):\n{log}")
                continue
            os.replace(tmp, out[n])
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = _LIBS[name] = ctypes.CDLL(str(build([name])[name]))
        return lib


def kernel_label(symbol: str) -> str:
    """A readable name for a mangled kernel symbol of this repo:
    ``flash_attention_wgmma_kernel<128>``, ``flash_attention_kernel<bf16,
    32,64>``, ``loo_trials_kernel<32,1>`` (a bool argument reads 0 or 1);
    any other symbol is returned as it is."""
    m = re.search(r"\d+([A-Za-z_]*kernel)"
                  r"(I(?:Li\d+E|Lb[01]E|f|13__nv_bfloat16)+E)?", symbol)
    if m is None:
        return symbol
    args = ["f32" if t == "f" else "bf16" if t.startswith("13") else t[2:-1]
            for t in re.findall(r"Li\d+E|Lb[01]E|13__nv_bfloat16|f",
                                (m.group(2) or "")[1:-1])]
    return f"{m.group(1)}<{','.join(args)}>" if args else m.group(1)


def ptxas_report(log: str) -> Dict[str, Dict[str, int]]:
    """Registers and spill bytes per kernel function from a build's
    ``-Xptxas -v`` report: {label: {"registers", "spill_stores",
    "spill_loads"}}, labelled by :func:`kernel_label`."""
    out: Dict[str, Dict[str, int]] = {}
    fn = None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            fn = kernel_label(m.group(1))
            out.setdefault(fn, {})
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and fn:
            out[fn]["spill_stores"] = int(m.group(1))
            out[fn]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            out[fn]["registers"] = int(m.group(1))
    return out
