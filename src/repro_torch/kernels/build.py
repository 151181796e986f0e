"""Build the port's CUDA sources at first use and load them with ctypes.

Each source in ``kernels/csrc`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface (no PyTorch headers, so a build takes
seconds). Libraries go to ``build/kernels/`` at the repository root, which
``.gitignore`` lists, under a name that carries a hash of the source and of
the shared headers (``csrc/*.cuh``), so an edited source or header is
rebuilt and a stale library is never loaded. Nothing is
compiled when the module is imported: the CPU tests import every module.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, NamedTuple, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

_LOADED: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def find_nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                       "source on the machine with the card")


def library_path(source: str) -> Path:
    """The library's path, named by a hash of the source, the headers it
    may include (every ``csrc/*.cuh``) and the flags."""
    h = hashlib.sha1((CSRC / source).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{Path(source).stem}-{h.hexdigest()[:12]}.so"


class Build(NamedTuple):
    proc: subprocess.Popen  # the running nvcc
    tmp: str  # the library's temporary name until the build succeeds


def start_build(source: str) -> Optional[Build]:
    """Start compiling ``source`` unless its library exists (None then).
    The library is written under a temporary name and renamed into place by
    `finish_build`, so a concurrent build never loads a partial file."""
    out = library_path(source)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    proc = subprocess.Popen(
        [find_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / source)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return Build(proc, tmp)


def finish_build(source: str, build: Optional[Build]) -> str:
    """Wait for `start_build`'s nvcc; returns its output (the ptxas report of
    registers and shared memory). Raises with that output on failure."""
    if build is None:
        return ""
    log, _ = build.proc.communicate()
    if build.proc.returncode != 0:
        os.unlink(build.tmp)
        raise RuntimeError(f"nvcc failed on {source}:\n{log}")
    os.replace(build.tmp, library_path(source))
    return log


def build_all() -> Dict[str, str]:
    """Compile every CUDA source anew, one nvcc each, all started together,
    so that the compiler's report of each is there to read; returns
    {source: compiler output}. Call it before any library is loaded."""
    names = sorted(p.name for p in CSRC.glob("*.cu"))
    for s in names:
        library_path(s).unlink(missing_ok=True)
    builds = {s: start_build(s) for s in names}
    return {s: finish_build(s, b) for s, b in builds.items()}


def load(source: str) -> ctypes.CDLL:
    """The loaded library of ``source``, built first if needed."""
    with _LOCK:
        lib = _LOADED.get(source)
        if lib is None:
            finish_build(source, start_build(source))
            lib = ctypes.CDLL(str(library_path(source)))
            _LOADED[source] = lib
        return lib
