"""The msgpack files of the JAX package, read and written without ``msgpack``,
``flax`` or ``ml_dtypes``.

:func:`packb` gives the bytes of ``flax.serialization.to_bytes`` for the trees the
JAX package writes, and :func:`unpackb` reads them as
``flax.serialization.msgpack_restore`` does:

- a tree is dicts (keys as ``str(key)``, in insertion order), lists and tuples
  (written as dicts keyed ``"0"``, ``"1"``, ... as flax writes them), None, bool,
  int, float (float64), str, bytes and array leaves;
- an array (numpy, or a torch tensor, taken to the host) is msgpack ext type 1
  holding the packed ``(shape, dtype name, C-order bytes)``; a numpy scalar is
  ext type 3 (read back as a numpy scalar), a Python complex ext type 2;
- an array of more than :data:`MAX_CHUNK_SIZE` bytes is written as flax's chunked
  dict (``__msgpack_chunked_array__``) and joined again on reading;
- every integer in its smallest encoding, str8/16/32 and bin8/16/32, fixmap and
  map16/32, as ``msgpack.packb(..., strict_types=True)`` writes them.

numpy has no bfloat16: a ``bfloat16`` leaf is read as a ``torch.bfloat16`` tensor
of its bytes, and a ``torch.bfloat16`` tensor is written as a ``bfloat16`` leaf,
so such a leaf goes through a read and a write unchanged. Arrays are read as
writable copies.
"""

from __future__ import annotations

import struct
from typing import Any, NamedTuple

import numpy as np
import torch

# flax's limit on the bytes of one array leaf before it is chunked
MAX_CHUNK_SIZE = 2 ** 30
CHUNKED = "__msgpack_chunked_array__"
EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3


class ExtType(NamedTuple):
    """An ext value of a type code this codec does not read."""

    code: int
    data: bytes


# ---------------------------------------------------------------------------
# writing
# ---------------------------------------------------------------------------

def _header(out: bytearray, n: int, fix: int, fix_max: int, codes, what: str) -> None:
    if fix is not None and n <= fix_max:
        out.append(fix + n)
    elif codes[0] is not None and n <= 0xFF:
        out += struct.pack(">BB", codes[0], n)
    elif n <= 0xFFFF:
        out += struct.pack(">BH", codes[1], n)
    elif n <= 0xFFFFFFFF:
        out += struct.pack(">BI", codes[2], n)
    else:
        raise ValueError(f"{what} is too large")


def _pack_int(out: bytearray, v: int) -> None:
    if 0 <= v < 0x80:
        out += struct.pack("B", v)
    elif -0x20 <= v < 0:
        out += struct.pack("b", v)
    elif 0x80 <= v <= 0xFF:
        out += struct.pack("BB", 0xCC, v)
    elif -0x80 <= v < 0:
        out += struct.pack(">Bb", 0xD0, v)
    elif 0xFF < v <= 0xFFFF:
        out += struct.pack(">BH", 0xCD, v)
    elif -0x8000 <= v < -0x80:
        out += struct.pack(">Bh", 0xD1, v)
    elif 0xFFFF < v <= 0xFFFFFFFF:
        out += struct.pack(">BI", 0xCE, v)
    elif -0x80000000 <= v < -0x8000:
        out += struct.pack(">Bi", 0xD2, v)
    elif 0xFFFFFFFF < v <= 0xFFFFFFFFFFFFFFFF:
        out += struct.pack(">BQ", 0xCF, v)
    elif -0x8000000000000000 <= v < -0x80000000:
        out += struct.pack(">Bq", 0xD3, v)
    else:
        raise OverflowError("Integer value out of range")


def _pack_str(out: bytearray, s: str) -> None:
    b = s.encode("utf-8")
    _header(out, len(b), 0xA0, 0x1F, (0xD9, 0xDA, 0xDB), "String")
    out += b


def _pack_bin(out: bytearray, b) -> None:
    _header(out, len(b), None, -1, (0xC4, 0xC5, 0xC6), "Bin")
    out += b


def _pack_ext(out: bytearray, code: int, data: bytes) -> None:
    n = len(data)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        out.append(fixed[n])
    elif n <= 0xFF:
        out += struct.pack(">BB", 0xC7, n)
    elif n <= 0xFFFF:
        out += struct.pack(">BH", 0xC8, n)
    else:
        out += struct.pack(">BI", 0xC9, n)
    out += struct.pack("b", code)
    out += data


def _array_fields(a):
    """(shape, dtype name, C-order bytes) of a numpy array or a host tensor."""
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            a = a.detach().cpu().contiguous()
            return tuple(a.shape), "bfloat16", a.view(torch.int16).numpy().tobytes()
        a = a.detach().cpu().numpy()
    if a.dtype.hasobject or a.dtype.isalignedstruct:
        raise ValueError("Object and structured dtypes not supported for serialization of "
                         "ndarrays.")
    return a.shape, a.dtype.name, a.tobytes("C")


def _ndarray_bytes(a) -> bytes:
    """flax's ``_ndarray_to_bytes``: ``packb((shape, dtype name, bytes))``."""
    shape, name, data = _array_fields(a)
    out = bytearray()
    out.append(0x93)
    _header(out, len(shape), 0x90, 0x0F, (None, 0xDC, 0xDD), "Array")
    for d in shape:
        _pack_int(out, int(d))
    _pack_str(out, name)
    _pack_bin(out, data)
    return bytes(out)


def _pack(out: bytearray, obj: Any) -> None:
    if obj is None:
        out.append(0xC0)
    elif type(obj) is bool:
        out.append(0xC3 if obj else 0xC2)
    elif type(obj) is int:
        _pack_int(out, obj)
    elif type(obj) is float:
        out += struct.pack(">Bd", 0xCB, obj)
    elif type(obj) is str:
        _pack_str(out, obj)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        _pack_bin(out, bytes(obj))
    elif isinstance(obj, dict):
        _header(out, len(obj), 0x80, 0x0F, (None, 0xDE, 0xDF), "Dict")
        for k, v in obj.items():
            _pack(out, k)
            _pack(out, v)
    elif isinstance(obj, (np.ndarray, torch.Tensor)):
        _pack_ext(out, EXT_NDARRAY, _ndarray_bytes(obj))
    elif isinstance(obj, np.generic):
        _pack_ext(out, EXT_NPSCALAR, _ndarray_bytes(np.asarray(obj)))
    elif type(obj) is complex:
        body = bytearray(b"\x92")
        body += struct.pack(">Bd", 0xCB, obj.real) + struct.pack(">Bd", 0xCB, obj.imag)
        _pack_ext(out, EXT_COMPLEX, bytes(body))
    elif isinstance(obj, ExtType):
        _pack_ext(out, obj.code, obj.data)
    else:
        raise TypeError(f"Cannot serialize {obj!r}")


def _nbytes(a) -> int:
    return a.numel() * a.element_size() if isinstance(a, torch.Tensor) else a.size * a.itemsize


def _chunk(a) -> dict:
    """flax's ``_chunk``: the array as a dict of flat chunks."""
    itemsize = a.element_size() if isinstance(a, torch.Tensor) else a.dtype.itemsize
    size = max(1, int(MAX_CHUNK_SIZE / itemsize))
    flat = a.reshape(-1)
    n = flat.shape[0]
    return {CHUNKED: True, "shape": {str(i): int(d) for i, d in enumerate(a.shape)},
            "chunks": {str(j): flat[s:s + size] for j, s in enumerate(range(0, n, size))}}


def _state_dict(tree: Any) -> Any:
    """flax's ``to_state_dict`` of a tree of dicts, lists and tuples, with its
    oversized array leaves chunked (``msgpack_serialize``)."""
    if isinstance(tree, dict):
        keys = [str(k) for k in tree]
        if len(set(keys)) != len(keys):
            raise ValueError(f"Dict keys do not have a unique string representation: {keys}")
        return {str(k): _state_dict(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return {str(i): _state_dict(v) for i, v in enumerate(tree)}
    if isinstance(tree, (np.ndarray, torch.Tensor)) and _nbytes(tree) > MAX_CHUNK_SIZE:
        return _chunk(tree)
    return tree


def packb(tree: Any) -> bytes:
    """The bytes ``flax.serialization.to_bytes(tree)`` gives."""
    out = bytearray()
    _pack(out, _state_dict(tree))
    return bytes(out)


# ---------------------------------------------------------------------------
# reading
# ---------------------------------------------------------------------------

class _Reader:
    def __init__(self, data, raw: bool):
        self.data = memoryview(data)
        self.pos = 0
        self.raw = raw

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        b = self.data[self.pos:self.pos + n]
        self.pos += n
        return b

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def str_(self, n: int):
        b = bytes(self.take(n))
        return b if self.raw else b.decode("utf-8")

    def ext(self, n: int):
        code = self.unpack("b")
        return _ext_value(code, bytes(self.take(n)))

    def value(self) -> Any:
        t = self.unpack("B")
        if t <= 0x7F:
            return t
        if t >= 0xE0:
            return t - 0x100
        if 0x80 <= t <= 0x8F:
            return self.map_(t - 0x80)
        if 0x90 <= t <= 0x9F:
            return [self.value() for _ in range(t - 0x90)]
        if 0xA0 <= t <= 0xBF:
            return self.str_(t - 0xA0)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if t in simple:
            return simple[t]
        sized = {0xC4: ("B", "bin"), 0xC5: (">H", "bin"), 0xC6: (">I", "bin"),
                 0xC7: ("B", "ext"), 0xC8: (">H", "ext"), 0xC9: (">I", "ext"),
                 0xD9: ("B", "str"), 0xDA: (">H", "str"), 0xDB: (">I", "str"),
                 0xDC: (">H", "array"), 0xDD: (">I", "array"),
                 0xDE: (">H", "map"), 0xDF: (">I", "map")}
        if t in sized:
            fmt, kind = sized[t]
            n = self.unpack(fmt)
            if kind == "bin":
                return bytes(self.take(n))
            if kind == "ext":
                return self.ext(n)
            if kind == "str":
                return self.str_(n)
            if kind == "array":
                return [self.value() for _ in range(n)]
            return self.map_(n)
        numbers = {0xCA: ">f", 0xCB: ">d", 0xCC: "B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                   0xD0: "b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if t in numbers:
            return self.unpack(numbers[t])
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if t in fixext:
            return self.ext(fixext[t])
        raise ValueError(f"msgpack: unknown type byte 0x{t:02x}")

    def map_(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out


def _unpack_one(data, raw: bool = False) -> Any:
    r = _Reader(data, raw)
    v = r.value()
    if r.pos != len(r.data):
        raise ValueError("msgpack: extra data after the value")
    return v


def _ndarray_from_bytes(data: bytes):
    """flax's ``_ndarray_from_bytes``, a ``bfloat16`` leaf as a torch tensor."""
    shape, name, buf = _unpack_one(data, raw=True)
    shape = tuple(shape)
    if name == b"bfloat16":
        bits = np.frombuffer(buf, dtype=np.uint16).copy()
        return torch.from_numpy(bits).view(torch.bfloat16).reshape(shape)
    return np.frombuffer(buf, dtype=np.dtype(name.decode())).reshape(shape).copy()


def _ext_value(code: int, data: bytes):
    if code == EXT_NDARRAY:
        return _ndarray_from_bytes(data)
    if code == EXT_COMPLEX:
        re, im = _unpack_one(data)
        return complex(re, im)
    if code == EXT_NPSCALAR:
        a = _ndarray_from_bytes(data)
        return a if isinstance(a, torch.Tensor) else a[()]
    return ExtType(code, data)


def _unchunk(d: dict):
    shape = tuple(d["shape"][str(i)] for i in range(len(d["shape"])))
    chunks = [d["chunks"][str(i)] for i in range(len(d["chunks"]))]
    if chunks and isinstance(chunks[0], torch.Tensor):
        return torch.cat(chunks).reshape(shape)
    return np.concatenate(chunks).reshape(shape)


def _unchunk_leaves(d):
    """flax's ``_unchunk_array_leaves_in_place``."""
    if isinstance(d, dict):
        if CHUNKED in d:
            return _unchunk(d)
        for k, v in d.items():
            if isinstance(v, dict) and CHUNKED in v:
                d[k] = _unchunk(v)
            elif isinstance(v, dict):
                _unchunk_leaves(v)
    return d


def unpackb(data) -> Any:
    """The tree ``flax.serialization.msgpack_restore(data)`` gives (a
    ``bfloat16`` leaf as a torch tensor)."""
    return _unchunk_leaves(_unpack_one(data))
