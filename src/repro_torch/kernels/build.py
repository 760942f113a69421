"""Builds the port's CUDA sources with ``nvcc`` and loads them with ctypes.

Each ``csrc/**/<name>.cu`` compiles on first use into its own shared
library with a plain C interface, under the repository's ``build/kernels``
directory (listed in ``.gitignore``), keyed by a hash of the sources and
the flags: a changed source builds anew, an unchanged one loads at once.
Every build error raises. ``build_all`` starts one ``nvcc`` per source, all
at once, so the build of several kernels takes as long as the slowest.

Nothing here runs at import: the CPU tests import every module, and this
machine's CPU-only installation has no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess

PKG = pathlib.Path(__file__).resolve().parents[1]
CSRC = PKG / "csrc"
BUILD_DIR = PKG.parents[1] / "build" / "kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


class KernelBuildError(RuntimeError):
    pass


class KernelLaunchError(RuntimeError):
    """A kernel launch that the CUDA runtime refused."""


def sources() -> list[pathlib.Path]:
    return sorted(CSRC.rglob("*.cu"))


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise KernelBuildError("nvcc not found on PATH or in /usr/local/cuda/bin")
    return nvcc


def _target(src: pathlib.Path) -> pathlib.Path:
    h = hashlib.sha256()
    for f in [src, *sorted(CSRC.rglob("*.cuh"))]:
        h.update(f.read_bytes())
    h.update(" ".join(ARCH_FLAGS + FLAGS).encode())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:16]}.so"


def _start(src: pathlib.Path):
    """Start the nvcc of one source; None if its library is built already."""
    out = _target(src)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *ARCH_FLAGS, *FLAGS, "-o", str(tmp), str(src)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(src: pathlib.Path, job) -> str:
    """Wait for one nvcc; rename its output into place. Returns its log."""
    if job is None:
        return ""
    proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise KernelBuildError(f"nvcc failed on {src.relative_to(PKG)} "
                               f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)          # atomic: a concurrent build never sees half a file
    return log


def build_all() -> dict[str, str]:
    """Build every source in parallel; returns {source name: nvcc log}
    (the ``-Xptxas -v`` register and shared-memory report)."""
    jobs = [(src, _start(src)) for src in sources()]
    logs = {}
    try:
        for src, job in jobs:
            logs[src.name] = _finish(src, job)
    finally:
        for _, job in jobs:       # a failed build stops no sibling half-way
            if job is not None and job[0].poll() is None:
                job[0].kill()
                job[0].wait()
    return logs


@functools.lru_cache(maxsize=None)
def load(rel: str) -> ctypes.CDLL:
    """The library built from ``csrc/<rel>``, building it first if needed."""
    src = CSRC / rel
    if not src.exists():
        raise KernelBuildError(f"no kernel source {src}")
    _finish(src, _start(src))
    return ctypes.CDLL(str(_target(src)))
