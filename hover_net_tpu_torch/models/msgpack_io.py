"""The msgpack format of the JAX package's checkpoints, without flax.

The JAX package writes its checkpoints with flax's
`serialization.msgpack_serialize` (flax/serialization.py, flax 0.12.3).
This module reads and writes that format on `struct`, numpy and torch
alone, so that the port loads those files where flax, jax and the
`msgpack` package are not installed:

- a tree is nested dicts and lists of None, bool, int, float, str,
  bytes, complex, numpy scalars and arrays;
- an array is msgpack ExtType 1 holding the packed
  `(shape, dtype name, C-order bytes)`, a numpy scalar ExtType 3 in the
  same layout, a Python complex ExtType 2 holding `(real, imag)`;
- an array of more than `MAX_CHUNK_SIZE` bytes under a dict is written
  as a `__msgpack_chunked_array__` dict of flat chunks.

`msgpack_serialize` packs as flax packs: the smallest encoding of each
value, str as UTF-8 str, bytes as bin, doubles for floats, and dict keys
in sorted order (flax copies the tree with `jax.tree_util.tree_map`,
which sorts them). For the trees a checkpoint holds its bytes are
flax's own.
"""

from __future__ import annotations

import struct
from typing import Any, List

import numpy as np
import torch

# flax's limit on the bytes of one array leaf before it is chunked
MAX_CHUNK_SIZE = 2 ** 30
CHUNKED = "__msgpack_chunked_array__"

_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3


# ------------------------------------------------------------------ decode

class _Reader:
    """A cursor over the encoded bytes; every read names its offset when
    the buffer ends early."""

    def __init__(self, data):
        self.buf = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.buf):
            raise ValueError(
                f"msgpack: truncated at byte {self.pos}: {n} bytes wanted, "
                f"{len(self.buf) - self.pos} left")
        out = self.buf[self.pos:end]
        self.pos = end
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]


# fixed-width values after their type byte: struct format
_FIXED = {0xca: ">f", 0xcb: ">d", 0xcc: ">B", 0xcd: ">H", 0xce: ">I",
          0xcf: ">Q", 0xd0: ">b", 0xd1: ">h", 0xd2: ">i", 0xd3: ">q"}
# length-prefixed values: type byte -> (kind, struct format of the length)
_SIZED = {0xc4: ("bin", ">B"), 0xc5: ("bin", ">H"), 0xc6: ("bin", ">I"),
          0xc7: ("ext", ">B"), 0xc8: ("ext", ">H"), 0xc9: ("ext", ">I"),
          0xd9: ("str", ">B"), 0xda: ("str", ">H"), 0xdb: ("str", ">I"),
          0xdc: ("array", ">H"), 0xdd: ("array", ">I"),
          0xde: ("map", ">H"), 0xdf: ("map", ">I")}
_FIXEXT = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}


def _decode(r: _Reader, ext: bool):
    """The next value. `ext`: decode ExtTypes as flax does (off inside an
    array's own header, which flax unpacks as plain msgpack)."""
    at = r.pos
    b = r.take(1)[0]
    if b <= 0x7f:
        return b
    if b >= 0xe0:
        return b - 0x100
    if 0x80 <= b <= 0x8f:
        return _map(r, b & 0x0f, ext)
    if 0x90 <= b <= 0x9f:
        return [_decode(r, ext) for _ in range(b & 0x0f)]
    if 0xa0 <= b <= 0xbf:
        return _str(r, b & 0x1f, at)
    if b == 0xc0:
        return None
    if b in (0xc2, 0xc3):
        return b == 0xc3
    if b in _FIXED:
        return r.unpack(_FIXED[b])
    if b in _FIXEXT:
        return _ext(r, _FIXEXT[b], at, ext)
    if b in _SIZED:
        kind, fmt = _SIZED[b]
        n = r.unpack(fmt)
        if kind == "bin":
            return bytes(r.take(n))
        if kind == "str":
            return _str(r, n, at)
        if kind == "array":
            return [_decode(r, ext) for _ in range(n)]
        if kind == "map":
            return _map(r, n, ext)
        return _ext(r, n, at, ext)
    raise ValueError(f"msgpack: byte {at}: type byte 0x{b:02x} is never "
                     "used by msgpack")


def _str(r: _Reader, n: int, at: int) -> str:
    try:
        return str(r.take(n), "utf-8")
    except UnicodeDecodeError as e:
        raise ValueError(f"msgpack: byte {at}: a str that is not UTF-8: "
                         f"{e}") from None


def _map(r: _Reader, n: int, ext: bool) -> dict:
    out = {}
    for _ in range(n):
        at = r.pos
        key = _decode(r, ext)
        # msgpack's strict_map_key, as flax's msgpack_restore unpacks
        if type(key) not in (str, bytes):
            raise ValueError(f"msgpack: byte {at}: a map key of type "
                             f"{type(key).__name__} (only str and bytes)")
        out[key] = _decode(r, ext)
    return out


def _ext(r: _Reader, n: int, at: int, ext: bool):
    code = struct.unpack(">b", r.take(1))[0]
    data = r.take(n)
    if not ext:
        raise ValueError(f"msgpack: byte {at}: an ExtType inside an array's "
                         "header")
    if code == _EXT_COMPLEX:
        real, imag = _restore_plain(data, at)
        return complex(real, imag)
    if code in (_EXT_NDARRAY, _EXT_NPSCALAR):
        arr = _array(data, at)
        return arr if code == _EXT_NDARRAY else arr[()]
    raise ValueError(f"msgpack: byte {at}: unknown ExtType code {code} "
                     "(flax writes 1, 2 and 3)")


def _restore_plain(data, at: int):
    r = _Reader(data)
    try:
        out = _decode(r, ext=False)
    except ValueError as e:
        raise ValueError(f"msgpack: in the ExtType at byte {at}: {e}") \
            from None
    if r.pos != len(r.buf):
        raise ValueError(f"msgpack: the ExtType at byte {at} has "
                         f"{len(r.buf) - r.pos} trailing bytes")
    return out


def _array(data, at: int):
    """flax's `_ndarray_from_bytes`: a writable numpy array, or for
    bfloat16 (which numpy lacks) a torch.bfloat16 tensor."""
    header = _restore_plain(data, at)
    if not (isinstance(header, list) and len(header) == 3):
        raise ValueError(f"msgpack: byte {at}: an array header that is not "
                         "[shape, dtype, bytes]")
    shape, name, buf = header
    if isinstance(name, bytes):
        name = name.decode("ascii", "replace")
    if not (isinstance(shape, list) and isinstance(buf, bytes)
            and all(type(d) is int and d >= 0 for d in shape)):
        raise ValueError(f"msgpack: byte {at}: an array header with shape "
                         f"{shape!r} and a {type(buf).__name__} buffer")
    bf16 = name == "bfloat16"
    try:
        dtype = np.dtype(np.int16 if bf16 else name)
    except TypeError:
        raise ValueError(f"msgpack: byte {at}: unknown array dtype "
                         f"{name!r}") from None
    if dtype.hasobject:
        raise ValueError(f"msgpack: byte {at}: an array of object dtype")
    count = int(np.prod(shape, dtype=np.int64))
    if len(buf) != count * dtype.itemsize:
        raise ValueError(f"msgpack: byte {at}: {len(buf)} bytes for a "
                         f"{name} array of shape {tuple(shape)}")
    arr = np.frombuffer(bytearray(buf), dtype).reshape(shape)
    return torch.from_numpy(arr).view(torch.bfloat16) if bf16 else arr


def _unchunk(d: dict):
    shape = tuple(d["shape"][str(i)] for i in range(len(d["shape"])))
    chunks = [d["chunks"][str(i)] for i in range(len(d["chunks"]))]
    if chunks and isinstance(chunks[0], torch.Tensor):
        return torch.cat(chunks).reshape(shape)
    return np.concatenate(chunks).reshape(shape)


def _unchunk_leaves(d):
    """flax's `_unchunk_array_leaves_in_place`."""
    if isinstance(d, dict):
        if CHUNKED in d:
            return _unchunk(d)
        for k, v in d.items():
            if isinstance(v, dict):
                d[k] = _unchunk(v) if CHUNKED in v else _unchunk_leaves(v)
    return d


def msgpack_restore(data: bytes) -> Any:
    """The tree encoded in `data`, as flax's `msgpack_restore` gives it:
    nested dicts and lists with None, bool, int, float, str, bytes and
    complex values, numpy arrays (writable copies) and numpy scalars,
    chunked arrays reassembled. A bfloat16 array, which numpy lacks,
    comes back as a torch.bfloat16 tensor built from its uint16 bits, and
    a bfloat16 scalar as a 0-d one.

    Raises ValueError, naming the byte offset, on a truncated buffer, an
    unknown ExtType code, an unknown or object dtype, a map key that is
    not str or bytes, or bytes after the value."""
    r = _Reader(data)
    out = _decode(r, ext=True)
    if r.pos != len(r.buf):
        raise ValueError(f"msgpack: {len(r.buf) - r.pos} trailing bytes "
                         f"after the value, from byte {r.pos}")
    return _unchunk_leaves(out)


# ------------------------------------------------------------------ encode

def _copy(tree):
    """flax's tree copy (`jax.tree_util.tree_map(lambda x: x, ...)`): new
    dicts with sorted keys and new lists, the leaves as they are."""
    if type(tree) is dict:
        return {k: _copy(tree[k]) for k in sorted(tree)}
    if type(tree) is list:
        return [_copy(v) for v in tree]
    return tree


def _is_array(x) -> bool:
    """A numpy array or a bfloat16 tensor (the arrays `_pack` writes)."""
    return isinstance(x, np.ndarray) or _is_bf16(x)


def _is_bf16(x) -> bool:
    return isinstance(x, torch.Tensor) and x.dtype == torch.bfloat16


def _sizes(x):
    """(element count, bytes per element) of an array leaf."""
    if isinstance(x, torch.Tensor):
        return x.numel(), x.element_size()
    return x.size, x.dtype.itemsize


def _chunk(arr) -> dict:
    """flax's `_chunk`: flat chunks of at most MAX_CHUNK_SIZE bytes."""
    n, itemsize = _sizes(arr)
    size = max(1, int(MAX_CHUNK_SIZE / itemsize))
    flat = arr.reshape(-1)
    return {CHUNKED: True,
            "shape": {str(i): d for i, d in enumerate(arr.shape)},
            "chunks": {str(j): flat[i:i + size]
                       for j, i in enumerate(range(0, n, size))}}


def _too_big(x) -> bool:
    n, itemsize = _sizes(x)
    return n * itemsize > MAX_CHUNK_SIZE


def _chunk_leaves(d):
    """flax's `_chunk_array_leaves_in_place`: arrays under dicts, and the
    tree itself (not arrays inside lists)."""
    if isinstance(d, dict):
        for k, v in d.items():
            if _is_array(v):
                if _too_big(v):
                    d[k] = _chunk(v)
            elif isinstance(v, dict):
                _chunk_leaves(v)
    elif _is_array(d) and _too_big(d):
        return _chunk(d)
    return d


def _head(out: List[bytes], n: int, fix: int, fix_max: int,
          codes) -> None:
    """The header of a str/bin/array/map of `n` items: a fix form up to
    `fix_max`, then 8-, 16- and 32-bit lengths (`codes`, None where the
    type has no such form)."""
    if fix is not None and n <= fix_max:
        out.append(bytes((fix | n,)))
    elif codes[0] is not None and n <= 0xff:
        out.append(struct.pack(">BB", codes[0], n))
    elif n <= 0xffff:
        out.append(struct.pack(">BH", codes[1], n))
    elif n <= 0xffffffff:
        out.append(struct.pack(">BI", codes[2], n))
    else:
        raise ValueError(f"msgpack: {n} items or bytes is too large")


def _int(out: List[bytes], v: int) -> None:
    if 0 <= v < 0x80:
        out.append(struct.pack("B", v))
    elif -0x20 <= v < 0:
        out.append(struct.pack("b", v))
    elif 0x80 <= v <= 0xff:
        out.append(struct.pack(">BB", 0xcc, v))
    elif -0x80 <= v < 0:
        out.append(struct.pack(">Bb", 0xd0, v))
    elif 0xff < v <= 0xffff:
        out.append(struct.pack(">BH", 0xcd, v))
    elif -0x8000 <= v < -0x80:
        out.append(struct.pack(">Bh", 0xd1, v))
    elif 0xffff < v <= 0xffffffff:
        out.append(struct.pack(">BI", 0xce, v))
    elif -0x80000000 <= v < -0x8000:
        out.append(struct.pack(">Bi", 0xd2, v))
    elif 0xffffffff < v <= 0xffffffffffffffff:
        out.append(struct.pack(">BQ", 0xcf, v))
    elif -0x8000000000000000 <= v < -0x80000000:
        out.append(struct.pack(">Bq", 0xd3, v))
    else:
        raise OverflowError("Integer value out of range")


def _ext_bytes(out: List[bytes], code: int, data: bytes) -> None:
    n = len(data)
    fix = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}.get(n)
    if fix is not None:
        out.append(bytes((fix,)))
    elif n <= 0xff:
        out.append(struct.pack(">BB", 0xc7, n))
    elif n <= 0xffff:
        out.append(struct.pack(">BH", 0xc8, n))
    else:
        out.append(struct.pack(">BI", 0xc9, n))
    out.append(struct.pack("b", code))
    out.append(data)


def _array_bytes(x) -> bytes:
    """flax's `_ndarray_to_bytes`: the packed (shape, dtype name, bytes)."""
    if _is_bf16(x):  # which numpy lacks
        shape, name = tuple(x.shape), "bfloat16"
        buf = x.detach().cpu().contiguous().view(torch.int16).numpy() \
            .tobytes()
    else:
        if x.dtype.hasobject or x.dtype.isalignedstruct:
            raise ValueError("Object and structured dtypes not supported "
                             "for serialization of ndarrays.")
        shape, name, buf = x.shape, x.dtype.name, x.tobytes("C")
    out: List[bytes] = [b"\x93"]
    _head(out, len(shape), 0x90, 0x0f, (None, 0xdc, 0xdd))
    for d in shape:
        _int(out, int(d))
    _pack(out, name)
    _pack(out, buf)
    return b"".join(out)


def _pack(out: List[bytes], x) -> None:
    """msgpack's `packb(x, use_bin_type=True, strict_types=True)` with
    flax's `_msgpack_ext_pack` as the default."""
    t = type(x)
    if x is None:
        out.append(b"\xc0")
    elif t is bool:
        out.append(b"\xc3" if x else b"\xc2")
    elif t is int:
        _int(out, x)
    elif t in (bytes, bytearray, memoryview):
        data = bytes(x)
        _head(out, len(data), None, 0, (0xc4, 0xc5, 0xc6))
        out.append(data)
    elif t is str:
        data = x.encode("utf-8")
        _head(out, len(data), 0xa0, 0x1f, (0xd9, 0xda, 0xdb))
        out.append(data)
    elif t is float:
        out.append(struct.pack(">Bd", 0xcb, x))
    elif t is list:
        _head(out, len(x), 0x90, 0x0f, (None, 0xdc, 0xdd))
        for v in x:
            _pack(out, v)
    elif t is dict:
        _head(out, len(x), 0x80, 0x0f, (None, 0xde, 0xdf))
        for k, v in x.items():
            _pack(out, k)
            _pack(out, v)
    elif _is_array(x):
        _ext_bytes(out, _EXT_NDARRAY, _array_bytes(x))
    elif isinstance(x, np.generic):
        _ext_bytes(out, _EXT_NPSCALAR, _array_bytes(np.asarray(x)))
    elif t is complex:
        parts: List[bytes] = [b"\x92"]
        _pack(parts, x.real)
        _pack(parts, x.imag)
        _ext_bytes(out, _EXT_COMPLEX, b"".join(parts))
    else:
        raise TypeError(f"can not serialize {t.__name__!r} object")


def msgpack_serialize(tree) -> bytes:
    """`tree` in flax's msgpack format, the bytes of flax's
    `msgpack_serialize(tree)`: nested dicts and lists of None, bool, int,
    float, str, bytes, complex, numpy scalars and arrays, and bfloat16
    torch tensors (written as flax writes a bfloat16 array, as
    `msgpack_restore` gives them back). Tuples and other containers
    raise TypeError, as flax's strict packing does; so does any other
    leaf."""
    out: List[bytes] = []
    _pack(out, _chunk_leaves(_copy(tree)))
    return b"".join(out)
