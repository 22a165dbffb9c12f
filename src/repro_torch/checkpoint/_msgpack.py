"""The msgpack subset a checkpoint shard is made of, without ``msgpack``.

A shard is one map of str keys to leaf maps
``{"dtype": str, "shape": [int, ...], "data": bin}``. The writer gives the
bytes ``msgpack.packb(..., use_bin_type=True)`` gives for the same dict:
the smallest header for every str, bin, array, map and int, keys in
insertion order. So a shard's crc32, and each leaf's, agree with what the
JAX package's checkpointer writes for the same tree. The writer yields its
bytes in pieces (headers, and each leaf's data buffer as it is), so a
caller can stream them to a file without joining a copy of the payload.

The reader accepts any valid encoding of the subset (maps, arrays, str,
bin and ints of every width) and returns bin values as zero-copy
``memoryview`` slices of its input. A truncated or malformed payload
raises ``ValueError``.
"""
from __future__ import annotations

import struct
from typing import Iterable, Iterator

_MAX32 = 0xFFFFFFFF


def _sized(n: int, fix_base: int, fix_max: int, tags) -> bytes:
    """Header of a str / bin / array / map of length ``n``: the fix form
    below ``fix_max`` (when the type has one), else the smallest of the
    8/16/32-bit forms listed in ``tags`` ((limit, tag, struct code), ...)."""
    if fix_base is not None and n <= fix_max:
        return bytes((fix_base | n,))
    for limit, tag, code in tags:
        if n <= limit:
            return bytes((tag,)) + struct.pack(">" + code, n)
    raise ValueError(f"msgpack: length {n} exceeds 2**32 - 1")


def str_header(n: int) -> bytes:
    return _sized(n, 0xA0, 31, ((0xFF, 0xD9, "B"), (0xFFFF, 0xDA, "H"),
                                (_MAX32, 0xDB, "I")))


def bin_header(n: int) -> bytes:
    return _sized(n, None, -1, ((0xFF, 0xC4, "B"), (0xFFFF, 0xC5, "H"),
                                (_MAX32, 0xC6, "I")))


def array_header(n: int) -> bytes:
    return _sized(n, 0x90, 15, ((0xFFFF, 0xDC, "H"), (_MAX32, 0xDD, "I")))


def map_header(n: int) -> bytes:
    return _sized(n, 0x80, 15, ((0xFFFF, 0xDE, "H"), (_MAX32, 0xDF, "I")))


def pack_str(s: str) -> bytes:
    b = s.encode("utf-8")
    return str_header(len(b)) + b


def pack_int(v: int) -> bytes:
    """A non-negative int (the writer's only ints are shapes)."""
    if v < 0:
        raise ValueError(f"msgpack: the writer packs no negative int ({v})")
    if v < 0x80:
        return bytes((v,))
    for limit, tag, code in ((0xFF, 0xCC, "B"), (0xFFFF, 0xCD, "H"),
                             (_MAX32, 0xCE, "I"),
                             (0xFFFFFFFFFFFFFFFF, 0xCF, "Q")):
        if v <= limit:
            return bytes((tag,)) + struct.pack(">" + code, v)
    raise ValueError(f"msgpack: int {v} out of range")


def shard_chunks(leaves: Iterable) -> Iterator:
    """The pieces of a shard: ``leaves`` is a list of
    ``(key, dtype, shape, data)`` in the order the map is to hold them;
    each leaf is the map ``{"dtype", "shape", "data"}``, its ``data`` any
    contiguous buffer, yielded as it is (not copied)."""
    leaves = list(leaves)
    yield map_header(len(leaves))
    for key, dtype, shape, data in leaves:
        nbytes = memoryview(data).nbytes
        yield b"".join([pack_str(key), map_header(3), pack_str("dtype"),
                        pack_str(dtype), pack_str("shape"),
                        array_header(len(shape)),
                        *(pack_int(int(d)) for d in shape),
                        pack_str("data"), bin_header(nbytes)])
        if nbytes:
            yield data


# ----------------------------------------------------------------- reader

_FIXED = {  # tag -> (struct code, kind)
    0xCC: ("B", "int"), 0xCD: ("H", "int"), 0xCE: ("I", "int"),
    0xCF: ("Q", "int"), 0xD0: ("b", "int"), 0xD1: ("h", "int"),
    0xD2: ("i", "int"), 0xD3: ("q", "int"),
    0xD9: ("B", "str"), 0xDA: ("H", "str"), 0xDB: ("I", "str"),
    0xC4: ("B", "bin"), 0xC5: ("H", "bin"), 0xC6: ("I", "bin"),
    0xDC: ("H", "array"), 0xDD: ("I", "array"),
    0xDE: ("H", "map"), 0xDF: ("I", "map"),
}


class _Reader:
    def __init__(self, buf):
        self.buf = memoryview(buf).cast("B")
        self.pos = 0

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.buf):
            raise ValueError(f"msgpack: truncated at byte {self.pos} "
                             f"(needs {n} more of {len(self.buf)})")
        out = self.buf[self.pos:end]
        self.pos = end
        return out

    def value(self):
        tag = self.take(1)[0]
        if tag <= 0x7F:
            return tag
        if tag >= 0xE0:
            return tag - 0x100
        if 0x80 <= tag <= 0x8F:
            return self.map(tag & 0x0F)
        if 0x90 <= tag <= 0x9F:
            return [self.value() for _ in range(tag & 0x0F)]
        if 0xA0 <= tag <= 0xBF:
            return str(self.take(tag & 0x1F), "utf-8")
        if tag not in _FIXED:
            raise ValueError(f"msgpack: type byte {tag:#04x} at "
                             f"{self.pos - 1} is outside the checkpoint "
                             "subset")
        code, kind = _FIXED[tag]
        n = struct.unpack(">" + code, self.take(struct.calcsize(code)))[0]
        if kind == "int":
            return n
        if kind == "str":
            return str(self.take(n), "utf-8")
        if kind == "bin":
            return self.take(n)
        if kind == "array":
            return [self.value() for _ in range(n)]
        return self.map(n)

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out


def unpackb(buf) -> object:
    """Decode one value of the subset; bin values are memoryview slices of
    ``buf``. Trailing bytes are an error, as in ``msgpack.unpackb``."""
    r = _Reader(buf)
    out = r.value()
    if r.pos != len(r.buf):
        raise ValueError(f"msgpack: {len(r.buf) - r.pos} trailing bytes")
    return out
