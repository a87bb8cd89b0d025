"""Build and load the CUDA kernels of ``desmo_tpu_torch/csrc``.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into a shared library with a
plain C interface, loaded through ``ctypes``. The library lands in
``build/kernels/`` at the root of the checkout, named by a hash of the source,
the headers beside it and the flags, so a changed source or header rebuilds
and an unchanged one loads directly. Nothing builds when the package is imported; the first launch on a
CUDA tensor builds. A failed build raises with the compiler's output.
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

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else under ``$CUDA_HOME`` (default
    ``/usr/local/cuda``)."""
    found = shutil.which("nvcc")
    if found:
        return found
    toolkit = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if os.path.exists(toolkit):
        return toolkit
    raise RuntimeError(f"nvcc not found on PATH or at {toolkit}")


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` lands: named by a hash of the
    source, the headers of ``csrc/`` (any of them may be included) and the
    flags."""
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.name.encode() + b"\0" + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library is already built; returns
    the library's path. The compiler's report (``-Xptxas -v``: registers and
    shared memory per kernel) is kept beside it as ``<lib>.log``. Safe to call
    for different names from several threads at once."""
    src = CSRC / f"{name}.cu"
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(src)]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
        except OSError as exc:
            raise RuntimeError(f"cannot run {cmd[0]} to build {name}: {exc}") from exc
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}) building {name}:\n"
                f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
            )
        Path(f"{out}.log").write_text(proc.stdout + proc.stderr)
        os.replace(tmp, out)  # atomic: a concurrent process sees a whole file or none
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            _loaded[name] = lib
        return lib


def build_log(name: str) -> str:
    """The compiler's report for the built ``csrc/<name>.cu`` ("" if none kept)."""
    log = Path(f"{library_path(name)}.log")
    return log.read_text() if log.exists() else ""
