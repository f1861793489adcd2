"""Build the port's CUDA sources with nvcc at first use and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and compiles alone into
``build/kernels/lib<name>-<hash>.so`` at the root of the checkout (a directory
``.gitignore`` lists); the hash covers the source, every ``csrc/*.cuh`` header
and the flags, so an edited source or header is rebuilt. ``build`` starts one nvcc per missing library, all at once,
and keeps what ``-Xptxas -v`` reports (registers, shared memory, spills) in a
``.log`` beside each library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "kernels"
FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_libs: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is")


def library_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names: Iterable[str]) -> Dict[str, str]:
    """Compile every missing library of ``names`` in parallel; returns each
    library's build log (nvcc's ``-Xptxas -v`` report)."""
    names = list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        lib = library_path(name)
        if not lib.exists():
            tmp = lib.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc(), *FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True), tmp, lib)
    failed = []
    for name, (proc, tmp, lib) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}.cu:\n{out}")
            continue
        lib.with_suffix(".log").write_text(out)
        os.replace(tmp, lib)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    logs = {}
    for name in names:
        log = library_path(name).with_suffix(".log")
        logs[name] = log.read_text() if log.exists() else ""
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if missing."""
    lib = _libs.get(name)
    if lib is None:
        build([name])
        lib = _libs[name] = ctypes.CDLL(str(library_path(name)))
    return lib


def check_operands(kernel: str, specs, tensors) -> None:
    """Raise unless each tensor lies on the card of the first, with the
    (name, shape, dtype) of its spec, contiguous and 16-byte aligned: what a
    kernel takes through a raw pointer."""
    device = tensors[0].device
    for (name, shape, dtype), t in zip(specs, tensors):
        if t.device.type != "cuda":
            raise ValueError(f"{kernel}: {name} is on {t.device}, not on the card")
        if t.device != device:
            raise ValueError(f"{kernel}: operands must share one device")
        if t.dtype != dtype:
            raise TypeError(f"{kernel}: {name} is {t.dtype}, the kernel takes {dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{kernel}: {name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{kernel}: {name} must be contiguous and 16-byte aligned")


def check_launch(lib: ctypes.CDLL, kernel: str, rc: int) -> None:
    """Raise if the C entry point returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(
            f"{kernel} kernel launch failed: {lib.difffacto_cuda_error_string(rc).decode()}"
        )
