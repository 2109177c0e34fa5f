"""The msgpack subset that ``flax.serialization`` writes, on tensors, with
no msgpack package (the JAX package's checkpoints are
``flax.serialization.msgpack_serialize`` output).

Types: maps (str keys), str, bin, int, float, bool, nil, arrays, and
two extension types:

- ext 1, an array: the packed tuple (shape, dtype name, C-order bytes);
- ext 3, a numpy scalar: an ext 1 payload of shape ().

An array of more than ``MAX_CHUNK_SIZE`` bytes (2**30, flax's) is written
as flax writes it: a map ``{"__msgpack_chunked_array__": True, "shape":
{"0": ...}, "chunks": {"0": <flat slice>, ...}}`` of flat slices of
``MAX_CHUNK_SIZE // itemsize`` elements; the reader joins such a map back
into one tensor.

``dump`` writes a tree to a binary file as it goes: every tensor is
copied to the host one at a time and its bytes go to the file without
another copy, so a checkpoint of several GB needs no buffer of its size.
The encoding is msgpack-python's (``packb(..., use_bin_type=True)``, the
smallest form of every int and length, float64 for floats) with map keys
in sorted order, as flax writes them (its copy of the tree sorts them),
so a tree gives the bytes flax would give it. ``loads`` reads arrays back as
tensors: a ``bfloat16`` array through torch's bfloat16 from the raw
bytes; ext 3 comes back as a 0-d tensor.
"""

from __future__ import annotations

import io
import struct
from typing import Any, BinaryIO

import numpy as np
import torch

MAX_CHUNK_SIZE = 2**30
CHUNKED_KEY = "__msgpack_chunked_array__"
EXT_NDARRAY, EXT_NPSCALAR = 1, 3

DTYPES = {
    "float32": torch.float32, "float64": torch.float64, "float16": torch.float16,
    "bfloat16": torch.bfloat16, "int8": torch.int8, "int16": torch.int16,
    "int32": torch.int32, "int64": torch.int64, "uint8": torch.uint8, "bool": torch.bool,
}
DTYPE_NAMES = {v: k for k, v in DTYPES.items()}


# ------------------------------------------------------------- encoding


def _int(x: int) -> bytes:
    if 0 <= x < 128:
        return struct.pack("B", x)
    if -32 <= x < 0:
        return struct.pack("b", x)
    if x >= 0:
        for code, fmt, top in ((0xCC, ">B", 0xFF), (0xCD, ">H", 0xFFFF),
                               (0xCE, ">I", 0xFFFFFFFF), (0xCF, ">Q", 2**64 - 1)):
            if x <= top:
                return bytes([code]) + struct.pack(fmt, x)
    else:
        for code, fmt, low in ((0xD0, ">b", -2**7), (0xD1, ">h", -2**15),
                               (0xD2, ">i", -2**31), (0xD3, ">q", -2**63)):
            if x >= low:
                return bytes([code]) + struct.pack(fmt, x)
    raise OverflowError(f"int {x} does not fit msgpack")


def _length(n: int, fix, fix_top: int, codes) -> bytes:
    """A length header: the fix form below ``fix_top``, else the first of
    ``codes`` ((code, struct format, largest length)) that holds n."""
    if fix is not None and n < fix_top:
        return bytes([fix | n])
    for code, fmt, top in codes:
        if n <= top:
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"msgpack object of length {n} is too long")


def _str(s: str) -> bytes:
    raw = s.encode("utf-8")
    return _length(len(raw), 0xA0, 32, ((0xD9, ">B", 0xFF), (0xDA, ">H", 0xFFFF),
                                        (0xDB, ">I", 0xFFFFFFFF))) + raw


def _bin_header(n: int) -> bytes:
    return _length(n, None, 0, ((0xC4, ">B", 0xFF), (0xC5, ">H", 0xFFFF),
                                (0xC6, ">I", 0xFFFFFFFF)))


def _array_header(n: int) -> bytes:
    return _length(n, 0x90, 16, ((0xDC, ">H", 0xFFFF), (0xDD, ">I", 0xFFFFFFFF)))


def _map_header(n: int) -> bytes:
    return _length(n, 0x80, 16, ((0xDE, ">H", 0xFFFF), (0xDF, ">I", 0xFFFFFFFF)))


def _ext_header(code: int, n: int) -> bytes:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        return bytes([fixed[n], code])
    return _length(n, None, 0, ((0xC7, ">B", 0xFF), (0xC8, ">H", 0xFFFF),
                                (0xC9, ">I", 0xFFFFFFFF))) + bytes([code])


def _host_bytes(x) -> tuple:
    """(shape, dtype name, a uint8 view of the C-order bytes) of a tensor
    or numpy array, copied to the host if it is not there."""
    if isinstance(x, torch.Tensor):
        t = x.detach().to("cpu").contiguous()
        if t.dtype not in DTYPE_NAMES:
            raise TypeError(f"no msgpack dtype for {t.dtype}")
        return tuple(t.shape), DTYPE_NAMES[t.dtype], t.reshape(-1).view(torch.uint8).numpy()
    a = np.asarray(x)
    if not a.flags.c_contiguous:  # (np.ascontiguousarray would make a 0-d array 1-d)
        a = a.copy(order="C")
    if a.dtype.hasobject or a.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes are not serialized")
    return a.shape, a.dtype.name, a.reshape(-1).view(np.uint8)


def _write_array(out: BinaryIO, code: int, shape, dtype: str, data) -> None:
    head = _array_header(3) + _array_header(len(shape)) + b"".join(map(_int, shape))
    head += _str(dtype) + _bin_header(len(data))
    out.write(_ext_header(code, len(head) + len(data)) + head)
    out.write(memoryview(data))


def _write(out: BinaryIO, x) -> None:
    if x is None:
        out.write(b"\xc0")
    elif x is True or x is False:
        out.write(b"\xc3" if x else b"\xc2")
    elif type(x) is int:
        out.write(_int(x))
    elif type(x) is float:
        out.write(b"\xcb" + struct.pack(">d", x))
    elif type(x) is str:
        out.write(_str(x))
    elif type(x) in (bytes, bytearray):
        out.write(_bin_header(len(x)) + bytes(x))
    elif type(x) is dict:
        if any(type(k) is not str for k in x):
            raise TypeError("map keys must be str")
        out.write(_map_header(len(x)))
        for k in sorted(x):  # flax's tree_map copy sorts them
            out.write(_str(k))
            _write(out, x[k])
    elif type(x) is list:
        out.write(_array_header(len(x)))
        for v in x:
            _write(out, v)
    elif isinstance(x, np.generic):
        _write_array(out, EXT_NPSCALAR, *_host_bytes(np.asarray(x)))
    elif isinstance(x, (torch.Tensor, np.ndarray)):
        shape, dtype, data = _host_bytes(x)
        if len(data) <= MAX_CHUNK_SIZE:
            _write_array(out, EXT_NDARRAY, shape, dtype, data)
            return
        itemsize = len(data) // max(1, int(np.prod(shape)))
        step = max(1, int(MAX_CHUNK_SIZE / itemsize)) * itemsize
        chunks = [data[s:s + step] for s in range(0, len(data), step)]
        # flax chunks after its sorting copy: these maps keep their order
        out.write(_map_header(3) + _str(CHUNKED_KEY) + b"\xc3" + _str("shape"))
        out.write(_map_header(len(shape)))
        for i, d in enumerate(shape):
            out.write(_str(str(i)) + _int(d))
        out.write(_str("chunks") + _map_header(len(chunks)))
        for i, chunk in enumerate(chunks):
            out.write(_str(str(i)))
            _write_array(out, EXT_NDARRAY, (len(chunk) // itemsize,), dtype, chunk)
    else:
        raise TypeError(f"cannot msgpack {type(x).__name__}")


def dump(tree: Any, out: BinaryIO) -> None:
    """Write ``tree`` to the binary file ``out``."""
    _write(out, tree)


def dumps(tree: Any) -> bytes:
    buf = io.BytesIO()
    _write(buf, tree)
    return buf.getvalue()


# ------------------------------------------------------------- decoding


class _Reader:
    def __init__(self, buf):
        self.buf = memoryview(buf)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("msgpack data ends early")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def read(self):
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.read() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return str(self.take(b & 0x1F), "utf-8")
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        sized = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I", 0xD9: ">B", 0xDA: ">H", 0xDB: ">I",
                 0xDC: ">H", 0xDD: ">I", 0xDE: ">H", 0xDF: ">I",
                 0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}
        if b in sized:
            n = self.unpack(sized[b])
            if b <= 0xC6:
                return bytes(self.take(n))
            if b <= 0xDB and b >= 0xD9:
                return str(self.take(n), "utf-8")
            if b in (0xDC, 0xDD):
                return [self.read() for _ in range(n)]
            if b in (0xDE, 0xDF):
                return self.map(n)
            return self.ext(self.unpack("b"), n)
        numbers = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                   0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in numbers:
            return self.unpack(numbers[b])
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            return self.ext(self.unpack("b"), fixext[b])
        raise ValueError(f"msgpack: unknown type byte 0x{b:02x}")

    def map(self, n: int):
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        if CHUNKED_KEY in out:
            shape = tuple(out["shape"][str(i)] for i in range(len(out["shape"])))
            chunks = [out["chunks"][str(i)] for i in range(len(out["chunks"]))]
            return torch.cat([c.reshape(-1) for c in chunks]).reshape(shape)
        return out

    def ext(self, code: int, n: int):
        end = self.pos + n
        if code in (EXT_NDARRAY, EXT_NPSCALAR):
            if self.take(1)[0] != 0x93:
                raise ValueError("msgpack: an array extension is not a 3-tuple")
            shape = tuple(self.read())
            dtype = DTYPES[self.read()]
            size = self.read_bin_size()
            t = torch.empty(shape, dtype=dtype)
            if size:
                t.reshape(-1).view(torch.uint8).copy_(
                    torch.frombuffer(self.buf, dtype=torch.uint8, count=size, offset=self.pos))
            self.pos += size
        else:
            raise ValueError(f"msgpack: unknown extension type {code}")
        if self.pos != end:
            raise ValueError("msgpack: extension length does not match its payload")
        return t

    def read_bin_size(self) -> int:
        b = self.take(1)[0]
        fmt = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}.get(b)
        if fmt is None:
            raise ValueError("msgpack: an array's data is not bin")
        n = self.unpack(fmt)
        if self.pos + n > len(self.buf):
            raise ValueError("msgpack data ends early")
        return n


def loads(data) -> Any:
    """The tree of msgpack ``data`` (bytes, or a writable buffer, which the
    reader reads without a copy); trailing bytes raise ``ValueError``."""
    reader = _Reader(bytearray(data) if isinstance(data, bytes) else data)
    out = reader.read()
    if reader.pos != len(reader.buf):
        raise ValueError("msgpack: trailing bytes after the object")
    return out
