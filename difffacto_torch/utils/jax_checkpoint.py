"""The JAX package's checkpoint format: flax's msgpack, read and written in Python.

``difffacto_tpu/utils/checkpoint.py`` writes ``checkpoints/ckpt_<epoch>.msgpack``
with ``flax.serialization.to_bytes(state)`` beside a ``ckpt_<epoch>.meta.json``.
That is a msgpack map of maps (tuples become maps keyed "0", "1", ...; an
empty optax state an empty map) whose leaves are

* ext type 1, an ndarray: the msgpack array (shape, dtype name, C-order
  bytes); ``bfloat16`` is named so, and decodes through ``torch.frombuffer``
  because numpy has no such dtype of its own;
* ext type 3, a numpy scalar: the same triple with shape ();
* or plain msgpack: nil, bool, int, float, str and bin.

``unpack`` returns nested dicts with numpy arrays, numpy scalars and, for
bfloat16, torch tensors as leaves; ``pack`` is the counterpart of
``flax.serialization.msgpack_serialize`` with the same encodings (the
smallest integer, float64 for a Python float, str8 and bin types), so it
gives flax's bytes for the trees a JAX train state holds. Ext type 2
(complex) and flax's chunked leaves (arrays over 1 GiB) raise, as does any
other type. This module imports neither ``msgpack`` nor ``flax``.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3


class _Reader:
    def __init__(self, data: bytes):
        self.data, self.pos = memoryview(data), 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError(f"msgpack: truncated at byte {self.pos} (wanted {n} more)")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self):
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.value() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return str(self.take(b & 0x1F), "utf-8")
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        sized = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}  # bin
        if b in sized:
            return bytes(self.take(self.unpack(sized[b])))
        ext = {0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}
        if b in ext:
            n = self.unpack(ext[b])
            return self.ext(self.unpack(">b"), n)
        if 0xD4 <= b <= 0xD8:  # fixext 1, 2, 4, 8, 16
            return self.ext(self.unpack(">b"), 1 << (b - 0xD4))
        numbers = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                   0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in numbers:
            return self.unpack(numbers[b])
        strs = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}
        if b in strs:
            return str(self.take(self.unpack(strs[b])), "utf-8")
        if b in (0xDC, 0xDD):
            return [self.value() for _ in range(self.unpack(">H" if b == 0xDC else ">I"))]
        if b in (0xDE, 0xDF):
            return self.map(self.unpack(">H" if b == 0xDE else ">I"))
        raise ValueError(f"msgpack: byte 0x{b:02x} at {self.pos - 1} starts no value")

    def map(self, n: int) -> Dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        if "__msgpack_chunked_array__" in out:
            raise ValueError("msgpack: flax's chunked array leaves (over 1 GiB) are not read")
        return out

    def ext(self, code: int, n: int):
        data = bytes(self.take(n))
        if code not in (EXT_NDARRAY, EXT_NPSCALAR):
            raise ValueError(f"msgpack: ext type {code} is not read (only ndarrays and scalars)")
        shape, name, buf = _Reader(data).value()
        name = name.decode() if isinstance(name, bytes) else name
        if name == "bfloat16":
            arr = (torch.frombuffer(bytearray(buf), dtype=torch.bfloat16) if buf
                   else torch.empty(0, dtype=torch.bfloat16)).reshape(shape)
            return arr.reshape(()) if code == EXT_NPSCALAR else arr
        arr = np.frombuffer(buf, dtype=np.dtype(name)).reshape(shape).copy()
        return arr[()] if code == EXT_NPSCALAR else arr


def unpack(data: bytes) -> Any:
    """msgpack bytes (flax's encoding) -> the tree."""
    r = _Reader(data)
    out = r.value()
    if r.pos != len(r.data):
        raise ValueError(f"msgpack: {len(r.data) - r.pos} bytes after the value")
    return out


def _int(v: int) -> bytes:
    if 0 <= v <= 0x7F:
        return bytes([v])
    if -32 <= v < 0:
        return struct.pack(">b", v)
    if v > 0:
        for code, fmt, top in ((0xCC, ">B", 0xFF), (0xCD, ">H", 0xFFFF), (0xCE, ">I", 2**32 - 1),
                               (0xCF, ">Q", 2**64 - 1)):
            if v <= top:
                return bytes([code]) + struct.pack(fmt, v)
    else:
        for code, fmt, low in ((0xD0, ">b", -2**7), (0xD1, ">h", -2**15), (0xD2, ">i", -2**31),
                               (0xD3, ">q", -2**63)):
            if v >= low:
                return bytes([code]) + struct.pack(fmt, v)
    raise OverflowError(f"msgpack: integer {v} does not fit 64 bits")


def _sized(n: int, codes, fix=None) -> bytes:
    """The header of a str, bin, array, map or ext of ``n`` items or bytes:
    ``fix`` = (base, limit) for the fix form, ``codes`` the 8/16/32-bit forms
    (None where the kind has no such form)."""
    if fix is not None and n <= fix[1]:
        return bytes([fix[0] | n])
    for code, fmt, top in zip(codes, (">B", ">H", ">I"), (0xFF, 0xFFFF, 2**32 - 1)):
        if code is not None and n <= top:
            return bytes([code]) + struct.pack(fmt, n)
    raise OverflowError(f"msgpack: length {n} does not fit 32 bits")


def _ext(code: int, data: bytes) -> bytes:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if len(data) in fixed:
        return bytes([fixed[len(data)]]) + struct.pack(">b", code) + data
    return _sized(len(data), (0xC7, 0xC8, 0xC9)) + struct.pack(">b", code) + data


def _array_triple(shape, name: str, buf: bytes) -> bytes:
    return (bytes([0x93]) + _sized(len(shape), (None, 0xDC, 0xDD), (0x90, 15))
            + b"".join(_int(int(d)) for d in shape) + _str(name) + _bin(buf))


def _str(s: str) -> bytes:
    b = s.encode("utf-8")
    return _sized(len(b), (0xD9, 0xDA, 0xDB), (0xA0, 31)) + b


def _bin(b: bytes) -> bytes:
    return _sized(len(b), (0xC4, 0xC5, 0xC6)) + b


def _pack(v, out: list):
    if isinstance(v, np.generic):  # before float: np.float64 is a float
        a = np.asarray(v)
        out.append(_ext(EXT_NPSCALAR, _array_triple(a.shape, a.dtype.name, a.tobytes("C"))))
    elif v is None:
        out.append(b"\xc0")
    elif isinstance(v, bool):
        out.append(b"\xc3" if v else b"\xc2")
    elif isinstance(v, int):
        out.append(_int(v))
    elif isinstance(v, float):
        out.append(b"\xcb" + struct.pack(">d", v))
    elif isinstance(v, str):
        out.append(_str(v))
    elif isinstance(v, (bytes, bytearray)):
        out.append(_bin(bytes(v)))
    elif isinstance(v, dict):
        out.append(_sized(len(v), (None, 0xDE, 0xDF), (0x80, 15)))
        for k, x in v.items():
            if not isinstance(k, str):
                raise TypeError(f"msgpack: a checkpoint's keys are str, got {k!r}")
            out.append(_str(k))
            _pack(x, out)
    elif isinstance(v, (list, tuple)):
        out.append(_sized(len(v), (None, 0xDC, 0xDD), (0x90, 15)))
        for x in v:
            _pack(x, out)
    elif isinstance(v, torch.Tensor):
        t = v.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            buf = t.view(torch.int16).numpy().tobytes()
            out.append(_ext(EXT_NDARRAY, _array_triple(tuple(t.shape), "bfloat16", buf)))
        else:
            _pack(t.numpy(), out)
    elif isinstance(v, np.ndarray):
        if v.dtype.hasobject or v.dtype.fields is not None:
            raise TypeError(f"msgpack: arrays of dtype {v.dtype} are not written")
        out.append(_ext(EXT_NDARRAY, _array_triple(v.shape, v.dtype.name, v.tobytes("C"))))
    else:
        raise TypeError(f"msgpack: {type(v).__name__} is not written")


def pack(tree: Any) -> bytes:
    """The tree -> msgpack bytes as ``flax.serialization.msgpack_serialize``
    encodes it. Leaves: numpy arrays and scalars, torch tensors (bfloat16
    written as flax names it), None, bool, int, float, str, bytes."""
    out: list = []
    _pack(tree, out)
    return b"".join(out)


def meta_path(path: str) -> str:
    return path[: -len(".msgpack")] + ".meta.json"


def read_jax_checkpoint(path: str) -> Tuple[Dict, Dict]:
    """(tree, meta) of a checkpoint the JAX package wrote; meta is the
    ``.meta.json`` beside it ({} where there is none)."""
    with open(path, "rb") as f:
        tree = unpack(f.read())
    meta = {}
    if os.path.exists(meta_path(path)):
        with open(meta_path(path)) as f:
            meta = json.load(f)
    return tree, meta


def write_jax_checkpoint(work_dir: str, epoch: int, tree: Dict,
                         meta: Optional[Dict] = None) -> str:
    """Write ``work_dir/checkpoints/ckpt_<epoch>.msgpack`` and its
    ``.meta.json`` as ``difffacto_tpu/utils/checkpoint.py:save_checkpoint``
    does; returns the path."""
    ckpt_dir = os.path.join(work_dir, "checkpoints")
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"ckpt_{epoch}.msgpack")
    with open(path, "wb") as f:
        f.write(pack(tree))
    with open(meta_path(path), "w") as f:
        json.dump({"epoch": epoch, **(meta or {})}, f)
    return path
