"""The JAX package's checkpoint format: flax msgpack, read and written
without ``flax`` or the ``msgpack`` package.

Every file the JAX package writes (``flax.serialization.to_bytes``) is
one msgpack object: nested maps with str keys whose leaves are nil,
bool, int, float, str, bin or an extension:

  * ext 1, an array: the packed ``(shape, dtype name, C-order bytes)``;
  * ext 3, a numpy scalar: packed as ext 1 of its 0-d array.

(flax's ext 2, a Python complex, is in no checkpoint of the JAX package;
it raises, as any other extension does.)

An array of more than ``MAX_CHUNK_SIZE`` bytes is written as the map
``{"__msgpack_chunked_array__": True, "shape": {"0": d0, ...},
"chunks": {"0": flat chunk, ...}}`` (chunks of MAX_CHUNK_SIZE bytes).

flax's state-dict conventions, which the callers build their trees by: a
list or tuple is the map ``{"0": ..., "1": ...}``, a namedtuple (an optax
state) the map of its fields, ``optax.EmptyState`` and
``optax.MaskedNode`` the empty map.

``restore`` gives nested dicts of numpy arrays (read-only views into the
bytes: no per-element Python work); a ``bfloat16`` array, which numpy
has no type for, comes back as a ``torch.bfloat16`` tensor.  A dtype
name numpy does not know raises.  ``serialize`` writes what
``msgpack.packb`` writes for the same tree, byte for byte: numpy arrays,
numpy scalars and torch tensors become extensions, lists and tuples index
maps.
"""
from __future__ import annotations

import os
import struct
from typing import Any, List

import numpy as np
import torch

MAX_CHUNK_SIZE = 2 ** 30
EXT_NDARRAY, EXT_NPSCALAR = 1, 3
CHUNKED = "__msgpack_chunked_array__"


# ------------------------------------------------------------------ reading
class _Reader:
    def __init__(self, data):
        self.buf = memoryview(data).cast("B")
        self.pos = 0

    def take(self, n: int) -> memoryview:
        start, self.pos = self.pos, self.pos + n
        if self.pos > len(self.buf):
            raise ValueError("flax msgpack: truncated data")
        return self.buf[start:self.pos]

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
        numbers = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H",
                   0xCE: ">I", 0xCF: ">Q", 0xD0: ">b", 0xD1: ">h",
                   0xD2: ">i", 0xD3: ">q"}
        if b in numbers:
            return self.unpack(numbers[b])
        sizes = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I", 0xD9: ">B", 0xDA: ">H",
                 0xDB: ">I", 0xDC: ">H", 0xDD: ">I", 0xDE: ">H", 0xDF: ">I",
                 0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}
        if 0xD4 <= b <= 0xD8:                                 # fixext
            n = 1 << (b - 0xD4)
            return self.ext(self.unpack(">b"), self.take(n))
        if b not in sizes:
            raise ValueError(f"flax msgpack: unknown format byte {b:#x}")
        n = self.unpack(sizes[b])
        if b in (0xC4, 0xC5, 0xC6):
            return bytes(self.take(n))
        if b in (0xD9, 0xDA, 0xDB):
            return str(self.take(n), "utf-8")
        if b in (0xDC, 0xDD):
            return [self.read() for _ in range(n)]
        if b in (0xDE, 0xDF):
            return self.map(n)
        return self.ext(self.unpack(">b"), self.take(n))     # ext 8/16/32

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.read()
            out[key] = self.read()
        return out

    def ext(self, code: int, data: memoryview):
        if code == EXT_NDARRAY:
            return _array(data)
        if code == EXT_NPSCALAR:
            a = _array(data)
            return a.reshape(()) if isinstance(a, torch.Tensor) else a[()]
        raise ValueError(f"flax msgpack: unknown extension type {code}")


def _array(data: memoryview):
    """An ext-1 payload -> a numpy array over ``data`` (bfloat16: a torch
    tensor)."""
    r = _Reader(data)
    if r.take(1)[0] != 0x93:
        raise ValueError("flax msgpack: an array is not (shape, dtype, "
                         "bytes)")
    shape = tuple(r.read())
    name = r.read()
    if isinstance(name, bytes):
        name = name.decode()
    raw = r.read()
    if name == "bfloat16":
        flat = torch.from_numpy(np.frombuffer(raw, np.int16).copy())
        return flat.view(torch.bfloat16).reshape(shape)
    try:
        dtype = np.dtype(name)
    except TypeError:
        dtype = None
    if dtype is None or dtype.hasobject or dtype.name != name:
        raise ValueError(f"flax msgpack: unknown array dtype {name!r}")
    return np.frombuffer(raw, dtype).reshape(shape)


def _unchunk(tree):
    if not isinstance(tree, dict):
        return tree
    if CHUNKED in tree:
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def restore(data) -> Any:
    """flax msgpack bytes (or any buffer) -> the tree, chunked arrays
    joined."""
    reader = _Reader(data)
    tree = reader.read()
    if reader.pos != len(reader.buf):
        raise ValueError("flax msgpack: trailing bytes after the object")
    return _unchunk(tree)


def read(path: str) -> Any:
    """The tree of a file; its arrays are writable views into one buffer
    of the file's size."""
    buf = bytearray(os.path.getsize(path))
    with open(path, "rb") as f:
        if f.readinto(buf) != len(buf):
            raise ValueError(f"flax msgpack: {path} changed while read")
    return restore(buf)


def is_flax_msgpack(path: str) -> bool:
    """Whether ``path`` holds flax msgpack rather than a ``torch.save``
    file (a zip archive, or a pickle for the legacy format): the JAX
    package's files are one map."""
    with open(path, "rb") as f:
        head = f.read(4)
    if head[:2] == b"PK" or (head[:1] == b"\x80" and len(head) > 1):
        return False
    return bool(head) and (0x80 <= head[0] <= 0x8F or head[0] in (0xDE, 0xDF))


# ------------------------------------------------------------------ writing
def _int(v: int) -> bytes:
    if 0 <= v < 0x80:
        return bytes([v])
    if -32 <= v < 0:
        return struct.pack(">b", v)
    if v >= 0:
        for code, fmt, top in ((0xCC, ">B", 0xFF), (0xCD, ">H", 0xFFFF),
                               (0xCE, ">I", 0xFFFFFFFF),
                               (0xCF, ">Q", 0xFFFFFFFFFFFFFFFF)):
            if v <= top:
                return bytes([code]) + struct.pack(fmt, v)
    else:
        for code, fmt, bottom in ((0xD0, ">b", -0x80), (0xD1, ">h", -0x8000),
                                  (0xD2, ">i", -0x80000000),
                                  (0xD3, ">q", -0x8000000000000000)):
            if v >= bottom:
                return bytes([code]) + struct.pack(fmt, v)
    raise OverflowError(f"flax msgpack: integer {v} out of range")


def _header(n: int, fix: int, fix_max: int, codes) -> bytes:
    """The header of a str/bin/array/map of length ``n``: a fix form below
    ``fix_max`` (when there is one), then 8/16/32-bit lengths."""
    if fix is not None and n < fix_max:
        return bytes([fix | n])
    for code, fmt, top in zip(codes, (">B", ">H", ">I"),
                              (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if code is not None and n <= top:
            return bytes([code]) + struct.pack(fmt, n)
    raise OverflowError(f"flax msgpack: length {n} out of range")


def _str(s: str) -> bytes:
    b = s.encode("utf-8")
    return _header(len(b), 0xA0, 32, (0xD9, 0xDA, 0xDB)) + b


def _ext(code: int, payload: List) -> List:
    n = sum(len(p) for p in payload)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        head = bytes([fixed[n]])
    else:
        head = _header(n, None, 0, (0xC7, 0xC8, 0xC9))
    return [head, struct.pack(">b", code), *payload]


def _numpy(x) -> tuple:
    """A numpy array or torch tensor -> (shape, dtype name, C bytes)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().contiguous()
        if x.dtype == torch.bfloat16:
            return tuple(x.shape), "bfloat16", _bytes(
                x.view(torch.int16).numpy())
        x = x.numpy()
    if x.dtype.hasobject or x.dtype.isalignedstruct:
        raise ValueError(f"flax msgpack: cannot write dtype {x.dtype}")
    return x.shape, x.dtype.name, _bytes(x)


def _bytes(x: np.ndarray) -> memoryview:
    """The C-order bytes of ``x``, without a copy where it is contiguous."""
    return memoryview(np.ascontiguousarray(x).reshape(-1).view(np.uint8))


def _array_payload(x) -> List:
    shape, name, raw = _numpy(x)
    return [b"\x93", _header(len(shape), 0x90, 16, (None, 0xDC, 0xDD)),
            *(_int(int(d)) for d in shape), _str(name),
            _header(len(raw), None, 0, (0xC4, 0xC5, 0xC6)), raw]


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    return x.size * x.dtype.itemsize


def _chunked(x) -> dict:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    flat = x.reshape(-1)
    n = max(1, int(MAX_CHUNK_SIZE / x.dtype.itemsize))
    return {CHUNKED: True,
            "shape": {str(i): int(d) for i, d in enumerate(x.shape)},
            "chunks": {str(j): flat[i:i + n] for j, i in
                       enumerate(range(0, flat.size, n))}}


def _pack(x, out: List, top: bool = True) -> None:
    if isinstance(x, (list, tuple)):
        x = {str(i): v for i, v in enumerate(x)}
    if isinstance(x, dict):
        out.append(_header(len(x), 0x80, 16, (None, 0xDE, 0xDF)))
        for k, v in x.items():
            _pack(k, out, False)
            if (isinstance(v, (np.ndarray, torch.Tensor))
                    and _nbytes(v) > MAX_CHUNK_SIZE):
                v = _chunked(v)
            _pack(v, out, False)
    elif isinstance(x, np.generic):       # before float: np.float64 is one
        out += _ext(EXT_NPSCALAR, _array_payload(np.asarray(x)))
    elif x is None:
        out.append(b"\xc0")
    elif isinstance(x, bool):
        out.append(b"\xc3" if x else b"\xc2")
    elif isinstance(x, int):
        out.append(_int(x))
    elif isinstance(x, float):
        out.append(b"\xcb" + struct.pack(">d", x))
    elif isinstance(x, str):
        out.append(_str(x))
    elif isinstance(x, bytes):
        out += [_header(len(x), None, 0, (0xC4, 0xC5, 0xC6)), x]
    elif isinstance(x, (np.ndarray, torch.Tensor)):
        if top and _nbytes(x) > MAX_CHUNK_SIZE:
            _pack(_chunked(x), out, False)
        else:
            out += _ext(EXT_NDARRAY, _array_payload(x))
    else:
        raise TypeError(f"flax msgpack: cannot write {type(x).__name__}")


def _pieces(tree) -> List:
    out: List = []
    _pack(tree, out)
    return out


def serialize(tree) -> bytes:
    """The tree -> flax msgpack bytes, as ``flax.serialization.
    msgpack_serialize`` writes them."""
    return b"".join(_pieces(tree))


def write(path: str, tree) -> int:
    """Write the tree to ``path`` through a temporary name and a rename, so
    a reader never sees a partial file -> the bytes written."""
    tmp = f"{path}.{os.getpid()}.tmp"
    n = 0
    with open(tmp, "wb") as f:
        for piece in _pieces(tree):
            n += f.write(piece)
    os.replace(tmp, path)
    return n


def check_like(tree, want, where: str, path: str = "") -> None:
    """Raise unless ``tree`` has the maps, keys and array shapes of
    ``want``, with floating arrays where ``want`` has them: a checkpoint of
    another configuration or layout is refused, not partly read."""
    if isinstance(want, dict):
        if not isinstance(tree, dict):
            raise ValueError(f"{where}: {path or 'the root'} is "
                             f"{type(tree).__name__}, expected a map")
        if set(tree) != set(want):
            extra, missing = sorted(set(tree) - set(want)), sorted(
                set(want) - set(tree))
            raise ValueError(f"{where}: at {path or 'the root'}, keys "
                             f"{extra[:5]} are not expected and {missing[:5]} "
                             "are missing")
        for k, v in want.items():
            check_like(tree[k], v, where, f"{path}/{k}")
        return
    if isinstance(want, (np.ndarray, np.generic, torch.Tensor)):
        shape = tuple(getattr(tree, "shape", (None,)))
        floating = (tree.is_floating_point() if isinstance(tree, torch.Tensor)
                    else np.issubdtype(getattr(tree, "dtype", np.object_),
                                       np.floating))
        want_floating = (want.is_floating_point()
                         if isinstance(want, torch.Tensor)
                         else np.issubdtype(want.dtype, np.floating))
        if shape != tuple(want.shape) or floating != want_floating:
            raise ValueError(f"{where}: {path} has shape {shape} and dtype "
                             f"{getattr(tree, 'dtype', type(tree).__name__)}"
                             f", expected {tuple(want.shape)} {want.dtype}")
