"""Read and write the msgpack layout of flax's ``serialization`` module with
the standard library and numpy alone (the machine with the card has neither
flax nor the ``msgpack`` module).

The layout: maps with str keys, lists and the usual scalars; every array
is msgpack ext type 1, whose payload is itself a msgpack array ``(shape,
dtype name, raw C-order bytes)`` (flax ``_ndarray_to_bytes``); ext type 3
is a numpy scalar in the same payload, of shape ``()``.

``msgpack_restore`` gives numpy arrays over the bytes it was handed (no
copy; writable when those bytes are a ``bytearray``). A ``bfloat16`` leaf
has no numpy dtype without JAX: it is read as ``uint16`` and returned as a
``torch.bfloat16`` tensor. Anything else it does not know raises: another
ext type, a dtype name numpy does not know, and flax's chunked-array marker
(written only for leaves over 2**30 bytes).

``msgpack_serialize`` writes the bytes ``flax.serialization.
msgpack_serialize`` writes for a tree of dicts (keys sorted, as flax's tree
copy leaves them), lists, Python scalars, numpy arrays and scalars; a torch
tensor is written as the numpy array of its values (a bfloat16 one under
the name ``bfloat16``).
"""

from __future__ import annotations

import struct

import numpy as np
import torch

EXT_NDARRAY, EXT_NPSCALAR = 1, 3
CHUNKED = "__msgpack_chunked_array__"
MAX_LEAF_BYTES = 2 ** 30          # flax chunks leaves above this; neither side here does


# ---------------------------------------------------------------------------
# reading
# ---------------------------------------------------------------------------

_FIXED = {0xca: ">f", 0xcb: ">d", 0xcc: ">B", 0xcd: ">H", 0xce: ">I", 0xcf: ">Q",
          0xd0: ">b", 0xd1: ">h", 0xd2: ">i", 0xd3: ">q"}
_LEN = {0xc4: ">B", 0xc5: ">H", 0xc6: ">I", 0xd9: ">B", 0xda: ">H", 0xdb: ">I",
        0xdc: ">H", 0xdd: ">I", 0xde: ">H", 0xdf: ">I", 0xc7: ">B", 0xc8: ">H", 0xc9: ">I"}
_FIXEXT = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}


class _Reader:
    def __init__(self, buf, bin_view: bool = False):
        self.buf = memoryview(buf).cast("B")
        self.pos = 0
        self.bin_view = bin_view    # bin objects as views into buf, not copies

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("msgpack data ends inside an object")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def read(self):
        b = self.take(1)[0]
        if b <= 0x7f:
            return b
        if b >= 0xe0:
            return b - 0x100
        if b <= 0x8f:
            return self.read_map(b & 0x0f)
        if b <= 0x9f:
            return [self.read() for _ in range(b & 0x0f)]
        if b <= 0xbf:
            return str(self.take(b & 0x1f), "utf-8")
        if b == 0xc0:
            return None
        if b in (0xc2, 0xc3):
            return b == 0xc3
        if b in _FIXED:
            return self.unpack(_FIXED[b])
        if b in _FIXEXT or b in (0xc7, 0xc8, 0xc9):
            n = _FIXEXT[b] if b in _FIXEXT else self.unpack(_LEN[b])
            code = self.unpack(">b")
            return _ext(code, self.take(n))
        if b in _LEN:
            n = self.unpack(_LEN[b])
            if b <= 0xc6:
                return self.take(n) if self.bin_view else bytes(self.take(n))
            if b <= 0xdb:
                return str(self.take(n), "utf-8")
            if b <= 0xdd:
                return [self.read() for _ in range(n)]
            return self.read_map(n)
        raise ValueError(f"byte 0x{b:02x} does not start a msgpack object")

    def read_map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        if CHUNKED in out:
            raise ValueError(
                "a chunked array (flax splits leaves over 2**30 bytes): not supported")
        return out


def _ext(code: int, payload: memoryview):
    if code not in (EXT_NDARRAY, EXT_NPSCALAR):
        raise ValueError(f"msgpack ext type {code}: not part of flax's array layout")
    r = _Reader(payload, bin_view=True)
    shape, name, data = r.read()
    if r.pos != len(payload):
        raise ValueError("trailing bytes after an array payload")
    name = str(name, "utf-8") if isinstance(name, (bytes, memoryview)) else name
    if name == "bfloat16":
        a = np.frombuffer(data, np.uint16).reshape(shape)
        t = torch.from_numpy(a.copy()).view(torch.bfloat16)
        return t if code == EXT_NDARRAY else t.reshape(())
    try:
        dtype = np.dtype(name)
    except TypeError as e:
        raise ValueError(f"array dtype {name!r} is not known to numpy") from e
    a = np.frombuffer(data, dtype).reshape(shape)
    return a if code == EXT_NDARRAY else a[()]


def msgpack_restore(data) -> object:
    """The tree in ``data`` (bytes, bytearray or memoryview)."""
    r = _Reader(data)
    out = r.read()
    if r.pos != len(r.buf):
        raise ValueError("trailing bytes after the msgpack object")
    return out


# ---------------------------------------------------------------------------
# writing: msgpack-python's encodings (use_bin_type, doubles, strict types)
# ---------------------------------------------------------------------------


def _head(out: bytearray, n: int, fix: int, fix_max: int, codes) -> None:
    """A length header: the fixed form below ``fix_max``, else the shortest
    of 8 / 16 / 32-bit lengths in ``codes`` (None: no such form)."""
    if fix is not None and n < fix_max:
        out.append(fix | n)
    elif codes[0] is not None and n < 2 ** 8:
        out += struct.pack(">BB", codes[0], n)
    elif n < 2 ** 16:
        out += struct.pack(">BH", codes[1], n)
    elif n < 2 ** 32:
        out += struct.pack(">BI", codes[2], n)
    else:
        raise ValueError(f"a msgpack object of length {n}")


def _int(out: bytearray, v: int) -> None:
    if v > 0:
        if v < 2 ** 7:
            out.append(v)
        else:
            for code, fmt, top in ((0xcc, ">B", 8), (0xcd, ">H", 16), (0xce, ">I", 32), (0xcf, ">Q", 64)):
                if v < 2 ** top:
                    out.append(code)
                    out += struct.pack(fmt, v)
                    return
            raise OverflowError(f"int {v} does not fit 64 bits")
    elif v >= -32:
        out.append(v & 0xff)
    else:
        for code, fmt, top in ((0xd0, ">b", 7), (0xd1, ">h", 15), (0xd2, ">i", 31), (0xd3, ">q", 63)):
            if v >= -(2 ** top):
                out.append(code)
                out += struct.pack(fmt, v)
                return
        raise OverflowError(f"int {v} does not fit 64 bits")


def _array_payload(a: np.ndarray, name: str) -> bytes:
    if a.dtype.hasobject or a.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes cannot be written")
    if a.nbytes > MAX_LEAF_BYTES:
        raise ValueError(f"a leaf of {a.nbytes} bytes: flax would chunk it, this writer does not")
    out = bytearray()
    _pack(out, [list(a.shape), name, a.tobytes("C")])
    return bytes(out)


def _ext_out(out: bytearray, code: int, payload: bytes) -> None:
    n = len(payload)
    fixed = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}
    if n in fixed:
        out.append(fixed[n])
    else:
        _head(out, n, None, 0, (0xc7, 0xc8, 0xc9))
    out += struct.pack(">b", code)
    out += payload


def _pack(out: bytearray, x) -> None:
    t = type(x)
    if x is None:
        out.append(0xc0)
    elif t is bool:
        out.append(0xc3 if x else 0xc2)
    elif t is int:
        _int(out, x)
    elif t is float:
        out += struct.pack(">Bd", 0xcb, x)
    elif t is str:
        b = x.encode("utf-8")
        _head(out, len(b), 0xa0, 32, (0xd9, 0xda, 0xdb))
        out += b
    elif t in (bytes, bytearray, memoryview):
        b = bytes(x)
        _head(out, len(b), None, 0, (0xc4, 0xc5, 0xc6))
        out += b
    elif t is list:
        _head(out, len(x), 0x90, 16, (None, 0xdc, 0xdd))
        for v in x:
            _pack(out, v)
    elif t is dict:
        # flax copies the tree with jax.tree_util first, which sorts dict keys
        _head(out, len(x), 0x80, 16, (None, 0xde, 0xdf))
        for k in sorted(x):
            _pack(out, k)
            _pack(out, x[k])
    elif isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            _ext_out(out, EXT_NDARRAY, _array_payload(x.view(torch.int16).numpy(), "bfloat16"))
        else:
            _pack(out, x.numpy())
    elif isinstance(x, np.ndarray):
        _ext_out(out, EXT_NDARRAY, _array_payload(x, x.dtype.name))
    elif isinstance(x, np.generic):
        a = np.asarray(x)
        _ext_out(out, EXT_NPSCALAR, _array_payload(a, a.dtype.name))
    else:
        raise TypeError(f"cannot write a {t.__name__} in flax's msgpack layout")


def msgpack_serialize(tree) -> bytes:
    """``tree`` as flax's ``msgpack_serialize`` writes it."""
    out = bytearray()
    _pack(out, tree)
    return bytes(out)
