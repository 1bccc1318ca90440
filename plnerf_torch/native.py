"""Build the port's host C++ sources with g++ at first use.

``mesh/_marching_cubes.cpp`` and ``data/_jpeg_entropy.cpp`` compile into
shared libraries with a plain C interface, loaded with ctypes, under
``build/plnerf_torch/`` at the repository root (beside the CUDA kernels of
``kernels/build.py``; ``.gitignore`` lists ``build/``).  The file name
carries a hash of the source, so an edited source rebuilds and a stale
library is never loaded.  A build writes a temporary file and renames it,
so a build running in parallel never loads a half-written library.  There
is no fallback: a build that fails raises with the compiler's output.
``-march=native`` tunes a library to the machine that builds it, so a
build directory is not copied between machines.
"""
from __future__ import annotations

import hashlib
import os
import subprocess
import tempfile
from typing import Sequence

from .kernels.build import BUILD_DIR

CXX = "g++"
CXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-std=c++17"]


def library_path(src: str, name: str, build_dir: str = BUILD_DIR) -> str:
    """``<build_dir>/lib<name>-<hash of src>.so``."""
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:12]
    return os.path.join(build_dir, f"lib{name}-{digest}.so")


def build(src: str, name: str, cxx: str = CXX,
          flags: Sequence[str] = CXX_FLAGS, build_dir: str = BUILD_DIR
          ) -> str:
    """Compile ``src`` unless its library exists; returns the library path.
    Raises ``RuntimeError`` with the compiler's output when the build fails
    or the compiler is missing."""
    out = library_path(src, name, build_dir)
    if os.path.exists(out):
        return out
    os.makedirs(build_dir, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=build_dir)
    os.close(fd)
    try:
        try:
            proc = subprocess.run([cxx] + list(flags) + [src, "-o", tmp],
                                  capture_output=True, text=True)
        except OSError as e:
            raise RuntimeError(f"{name}: cannot run {cxx!r} to build "
                               f"{src}: {e}") from e
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: {cxx} failed for {src}:\n"
                               f"{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out
