"""ctypes binding + lazy build of the native snapshot-series loader.

The port's own copy of ``desmo_tpu/io/native``: the same C++ source
(``snapshot_loader.cpp``) and the same functions. The shared library is
compiled with g++ on first use into ``build/native/`` at the root of the
checkout (gitignored), named by a hash of the source, so an edit rebuilds.
Each process compiles to a temporary file of its own and moves it into place
with one atomic ``os.replace``, so parallel processes (test workers) never
load or overwrite a half-written library. ``available()`` is False when no
compiler is present or the build fails, and callers fall back to the
pure-Python readers in ``desmo_tpu_torch.io.vtk``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_SRC = Path(__file__).resolve().parent / "snapshot_loader.cpp"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "native"
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_error: Optional[str] = None


def library_path() -> Path:
    tag = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"snapshot_loader_{tag}.so"


def _build() -> ctypes.CDLL:
    so_path = library_path()
    if not so_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", str(_SRC), "-o", tmp, "-lz", "-lpthread"]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"native build failed:\n{proc.stderr}")
            os.replace(tmp, so_path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    lib = ctypes.CDLL(str(so_path))
    lib.load_snapshot_series.restype = ctypes.c_int
    lib.load_snapshot_series.argtypes = [
        ctypes.POINTER(ctypes.c_char_p),
        ctypes.c_int64,
        ctypes.c_char_p,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int,
    ]
    lib.probe_array_size.restype = ctypes.c_int64
    lib.probe_array_size.argtypes = [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_int]
    lib.snapshot_loader_last_error.restype = ctypes.c_char_p
    return lib


def _get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _build_error
    with _lock:
        if _lib is None and _build_error is None:
            try:
                _lib = _build()
            except Exception as exc:  # compiler missing, link failure, ...
                _build_error = str(exc)
        return _lib


def available() -> bool:
    return _get_lib() is not None


def build_error() -> Optional[str]:
    _get_lib()
    return _build_error


def load_series(
    paths: list[str],
    array: str = "velocity",
    location: str = "point",
    legacy: bool = False,
    num_threads: int = 0,
) -> np.ndarray:
    """Parallel-load a snapshot series into X (values_per_file, num_files).

    Raises RuntimeError (with the failing file's message) on unsupported
    formats; callers catch it and fall back to the Python reader.
    """
    lib = _get_lib()
    if lib is None:
        raise RuntimeError(f"native loader unavailable: {_build_error}")
    if not paths:
        raise ValueError("empty path list")
    is_cell = 1 if location == "cell" else 0
    is_legacy = 1 if legacy else 0
    nvals = lib.probe_array_size(paths[0].encode(), array.encode(), is_cell, is_legacy)
    if nvals < 0:
        raise RuntimeError(lib.snapshot_loader_last_error().decode())
    out = np.empty((int(nvals), len(paths)), dtype=np.float32)
    c_paths = (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])
    rc = lib.load_snapshot_series(
        c_paths, len(paths), array.encode(), is_cell, is_legacy, int(nvals),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), num_threads,
    )
    if rc != 0:
        raise RuntimeError(lib.snapshot_loader_last_error().decode())
    return out


def read_snapshot_series_native(
    input_dir: str,
    filename: str,
    t_start: int,
    t_end: int,
    extension: str = ".vtu",
    array: str = "velocity",
    location: str = "point",
) -> np.ndarray:
    """Accelerated equivalent of ``vtk.read_snapshot_series`` (matrix only;
    read one file with the Python reader if the mesh is needed)."""
    sep = "" if input_dir.endswith("/") or not input_dir else "/"
    paths = [f"{input_dir}{sep}{filename}{i}{extension}" for i in range(t_start, t_end)]
    return load_series(
        paths, array=array, location=location, legacy=extension not in (".vtu", ".vtr", ".vti")
    )
