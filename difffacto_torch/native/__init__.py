"""The ShapeNet text parser (C++), built with the system g++ at first use.

The port's own copy of ``difffacto_tpu/native``: ``fast_loadtxt`` is a drop-in
for ``np.loadtxt`` on numeric whitespace files, used once per split by the
ShapeNet packing step. The library is built from ``txtparse.cpp`` into
``build/native/libtxtparse-<hash>.so`` at the root of the checkout (a
directory ``.gitignore`` lists), never beside its source; the hash covers the
source and the flags, so an edited source is rebuilt. Where no compiler is
found, or the build fails, ``fast_loadtxt`` reads with ``np.loadtxt``.
This is a host parser, not a device kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

SRC = Path(__file__).resolve().parent / "txtparse.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "native"
FLAGS = ("-O3", "-shared", "-fPIC")

_lib: Optional[ctypes.CDLL] = None
_build_failed = False


def library_path() -> Path:
    h = hashlib.sha256(SRC.read_bytes() + " ".join(FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"libtxtparse-{h}.so"


def _build() -> Optional[ctypes.CDLL]:
    global _build_failed
    if _build_failed:
        return None
    lib_path = library_path()
    if not lib_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
        try:
            subprocess.run(["g++", *FLAGS, "-o", str(tmp), str(SRC)], check=True,
                           capture_output=True)
        except (subprocess.CalledProcessError, FileNotFoundError):
            _build_failed = True
            return None
        os.replace(tmp, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    lib.parse_floats.restype = ctypes.c_long
    lib.parse_floats.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_long]
    return lib


def get_lib() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is None:
        _lib = _build()
    return _lib


def fast_loadtxt(path: str, ncols: Optional[int] = None) -> np.ndarray:
    """Parse a whitespace-delimited numeric file -> (rows, ncols) float32.

    ``ncols`` is read from the first line when not given. Reads with
    ``np.loadtxt`` where the native library is unavailable.
    """
    lib = get_lib()
    if lib is None:
        return np.loadtxt(path).astype(np.float32)
    if ncols is None:
        with open(path, "r") as f:
            ncols = len(f.readline().split())
    # a float takes at least 2 bytes of text: the file size bounds the count
    max_vals = max(os.path.getsize(path), 64)
    out = np.empty(max_vals, np.float32)
    n = lib.parse_floats(path.encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                         max_vals)
    if n < 0:
        return np.loadtxt(path).astype(np.float32)
    if n % ncols != 0:
        raise ValueError(f"{path}: {n} values do not fill rows of {ncols} columns")
    return out[:n].reshape(-1, ncols).copy()
