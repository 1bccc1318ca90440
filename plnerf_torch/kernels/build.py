"""Build the port's CUDA kernels at first use and load them with ctypes.

Each ``csrc/*.cu`` source compiles with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface under ``build/plnerf_torch/``
at the repository root (``.gitignore`` lists ``build/``).  The file name
carries a hash of the source and of the headers beside it
(``csrc/*.cuh``), so an edited source or header rebuilds and a stale
library is never loaded.  ``ptxas -v`` output (registers, shared memory,
spills per kernel) is kept beside the library and read by
``ptxas_info``.  Nothing here runs at import time: this module is
imported on machines without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
from typing import Dict, Optional

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BUILD_DIR = os.path.join(REPO_ROOT, "build", "plnerf_torch")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                       "CUDA toolkit at first use")


def library_path(name: str, csrc: str = CSRC) -> str:
    """The library of ``<csrc>/<name>.cu``: its name carries a hash of the
    source and of every header in ``csrc``, so an edit to either rebuilds."""
    h = hashlib.sha256()
    headers = sorted(f for f in os.listdir(csrc) if f.endswith(".cuh"))
    for f in [name + ".cu"] + headers:
        with open(os.path.join(csrc, f), "rb") as fh:
            h.update(f.encode() + b"\0" + fh.read() + b"\0")
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:12]}.so")


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless its library exists; returns the
    library path.  Writes to a temporary file and renames it, so a build
    running in parallel never loads a half-written library."""
    out = library_path(name)
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [nvcc_path()] + NVCC_FLAGS
            + ["-o", tmp, os.path.join(CSRC, name + ".cu")],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stderr}")
        with open(out[:-3] + ".log", "w") as f:
            f.write(proc.stderr)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; cached per process."""
    with _lock:
        if name not in _loaded:
            _loaded[name] = ctypes.CDLL(build(name))
        return _loaded[name]


def _demangle(names):
    try:
        proc = subprocess.run(["c++filt"], input="\n".join(names),
                              capture_output=True, text=True, timeout=60)
        out = proc.stdout.splitlines()
        if proc.returncode == 0 and len(out) == len(names):
            return out
    except OSError:
        pass
    return list(names)


def ptxas_info(name: str) -> Optional[Dict[str, dict]]:
    """{function: {"registers", "smem", "stack", "spill_stores",
    "spill_loads"}} from the ``ptxas -v`` log of the built
    ``csrc/<name>.cu`` (None before the build): every kernel, and every
    device function compiled as a call (stack and spills only).  ``smem``
    is static shared memory in bytes; dynamic shared memory is set at
    launch."""
    log = library_path(name)[:-3] + ".log"
    if not os.path.exists(log):
        return None
    info: Dict[str, dict] = {}
    cur = None
    with open(log) as f:
        for line in f:
            m = re.search(r"Compiling entry function '([^']+)'|Function "
                          r"properties for (\S+)", line)
            if m:
                cur = info.setdefault(m.group(1) or m.group(2), {})
                continue
            if cur is None:
                continue
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads", line)
            if m:
                (cur["stack"], cur["spill_stores"],
                 cur["spill_loads"]) = map(int, m.groups())
            m = re.search(r"Used (\d+) registers", line)
            if m:
                cur["registers"] = int(m.group(1))
                m = re.search(r"(\d+) bytes smem", line)
                cur["smem"] = int(m.group(1)) if m else 0
    keys = list(info)
    return dict(zip(_demangle(keys), (info[k] for k in keys)))
