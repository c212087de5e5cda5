"""Checkpoints of the port in the JAX package's format: flax's msgpack
state dicts (``flax.serialization.to_bytes``), read and written with the
port's own msgpack code (the card's machine has no ``msgpack`` or
``flax``, and the port imports neither).

One format serves both packages: a model trained by either loads in the
other (``models/convert.py`` maps the tree to a ``state_dict``). The trees
are the JAX package's payloads: ``{"params", "batch_stats", "step"}`` for
the SSL model (``train/ssl_train.py``), ``{"params", "batch_stats",
"opt_state", "epoch"}`` for UNet++ (``train/seg_train.py``).

The msgpack subset: maps, arrays, str, bin, int, float, nil and bool, and
flax's ext type 1, an ndarray packed as ``(shape, dtype name, raw C
bytes)``. These payloads hold nothing else: flax's ext types 2 (complex)
and 3 (numpy scalar), any other ext code, and the
``__msgpack_chunked_array__`` maps flax writes for arrays above 1 GiB (the
largest array of either model is far smaller) raise
``CheckpointFormatError`` on reading, and the writer refuses them. A
``bfloat16`` array is read as float32 (widening it is exact).

The orbax functions of the JAX module are not ported (``ROADMAP.md``).
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Any

import numpy as np

EXT_NDARRAY = 1
MAX_CHUNK_SIZE = 2 ** 30            # flax's largest unchunked array, bytes
CHUNKED = "__msgpack_chunked_array__"


class CheckpointFormatError(ValueError):
    """Bytes that are not a checkpoint the port reads."""


# --- reading ------------------------------------------------------------------

class _Reader:
    def __init__(self, data: bytes, ext_hook):
        self.buf = memoryview(data)
        self.pos = 0
        self.ext_hook = ext_hook

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise CheckpointFormatError("msgpack data ends inside an object")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def obj(self) -> Any:
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.str(b & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        sized = {0xC4: (">B", "bin"), 0xC5: (">H", "bin"), 0xC6: (">I", "bin"),
                 0xD9: (">B", "str"), 0xDA: (">H", "str"), 0xDB: (">I", "str"),
                 0xDC: (">H", "array"), 0xDD: (">I", "array"),
                 0xDE: (">H", "map"), 0xDF: (">I", "map")}
        if b in sized:
            fmt, kind = sized[b]
            n = self.unpack(fmt)
            if kind == "bin":
                return bytes(self.take(n))
            return getattr(self, kind)(n)
        numbers = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
                   0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in numbers:
            return self.unpack(numbers[b])
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            return self.ext(fixext[b])
        if b in (0xC7, 0xC8, 0xC9):
            return self.ext(self.unpack({0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}[b]))
        raise CheckpointFormatError(f"msgpack type byte 0x{b:02x} is not used "
                                    "by flax checkpoints")

    def str(self, n: int) -> str:
        return bytes(self.take(n)).decode("utf-8")

    def array(self, n: int) -> list:
        return [self.obj() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.obj()
            if key == CHUNKED:
                raise CheckpointFormatError(
                    "a chunked array (flax splits arrays above 1 GiB): no "
                    "checkpoint of the port's models holds one")
            out[key] = self.obj()
        return out

    def ext(self, n: int) -> Any:
        code = self.unpack(">b")
        return self.ext_hook(code, bytes(self.take(n)))


def unpackb(data: bytes, ext_hook=None) -> Any:
    """One msgpack object from ``data`` (all of it)."""
    def refuse(code, _):
        raise CheckpointFormatError(f"unexpected msgpack ext type {code}")
    r = _Reader(data, ext_hook or refuse)
    out = r.obj()
    if r.pos != len(data):
        raise CheckpointFormatError(
            f"{len(data) - r.pos} bytes after the msgpack object")
    return out


def _ndarray_from_bytes(data: bytes) -> np.ndarray:
    shape, name, raw = unpackb(data)
    name = name.decode() if isinstance(name, bytes) else name
    if name == "bfloat16":
        bits = np.frombuffer(raw, dtype="<u2").astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    try:
        dtype = np.dtype(name)
    except TypeError as e:
        raise CheckpointFormatError(f"unknown array dtype {name!r}") from e
    if dtype.hasobject:
        raise CheckpointFormatError(f"object dtype {name!r} in a checkpoint")
    return np.frombuffer(raw, dtype=dtype).reshape(shape).copy()


def _ext_hook(code: int, data: bytes) -> Any:
    if code == EXT_NDARRAY:
        return _ndarray_from_bytes(data)
    raise CheckpointFormatError(
        f"msgpack ext type {code} is not an ndarray (flax's type 1), the "
        "only ext type the models' checkpoints hold")


def msgpack_restore(data: bytes) -> Any:
    """The state dict ``flax.serialization.msgpack_restore`` gives: nested
    dicts with numpy leaves."""
    return unpackb(data, _ext_hook)


# --- writing ------------------------------------------------------------------

def _head(n: int, fix: int | None, fix_max: int, codes: tuple) -> bytes:
    """The header of a sized object: a fix form, then 8/16/32-bit sizes
    (``codes`` for those three; None where the type has no such form)."""
    if fix is not None and n <= fix_max:
        return bytes([fix | n])
    for code, fmt, top in zip(codes, (">B", ">H", ">I"),
                              (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if code is not None and n <= top:
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"object of {n} entries is too large for msgpack")


def _pack_int(v: int) -> bytes:
    if 0 <= v <= 0x7F:
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
        for code, fmt, low in ((0xD0, ">b", -0x80), (0xD1, ">h", -0x8000),
                               (0xD2, ">i", -0x80000000),
                               (0xD3, ">q", -0x8000000000000000)):
            if v >= low:
                return bytes([code]) + struct.pack(fmt, v)
    raise ValueError(f"integer {v} does not fit msgpack's 64 bits")


def _pack_ext(code: int, data: bytes) -> bytes:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    head = (bytes([fixed[len(data)]]) if len(data) in fixed
            else _head(len(data), None, 0, (0xC7, 0xC8, 0xC9)))
    return head + struct.pack(">b", code) + data


def _ndarray_to_bytes(arr: np.ndarray) -> bytes:
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes are not serializable")
    return packb([list(arr.shape), arr.dtype.name,
                  np.ascontiguousarray(arr).tobytes()])


def _pack(obj: Any, out: list) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True or obj is False:
        out.append(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, np.ndarray):
        if obj.nbytes > MAX_CHUNK_SIZE:
            raise ValueError("arrays above 1 GiB are not written")
        out.append(_pack_ext(EXT_NDARRAY, _ndarray_to_bytes(obj)))
    elif isinstance(obj, np.generic):
        raise TypeError("numpy scalars (flax's ext type 3) are not written: "
                        "pass a Python number or a 0-d array")
    elif isinstance(obj, int):
        out.append(_pack_int(obj))
    elif isinstance(obj, float):
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        out.append(_head(len(raw), 0xA0, 31, (0xD9, 0xDA, 0xDB)) + raw)
    elif isinstance(obj, (bytes, bytearray)):
        out.append(_head(len(obj), None, 0, (0xC4, 0xC5, 0xC6)) + bytes(obj))
    elif isinstance(obj, (list, tuple)):
        out.append(_head(len(obj), 0x90, 15, (None, 0xDC, 0xDD)))
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, dict):
        out.append(_head(len(obj), 0x80, 15, (None, 0xDE, 0xDF)))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"cannot pack {type(obj).__name__} into a checkpoint")


def packb(obj: Any) -> bytes:
    """msgpack bytes of ``obj`` as flax writes them (``strict_types``,
    ``use_bin_type``)."""
    out: list = []
    _pack(obj, out)
    return b"".join(out)


def _state_dict(tree: Any) -> Any:
    """flax's ``to_state_dict`` for plain trees: tuples and lists become
    maps keyed ``"0"``, ``"1"``, ..., keys become str."""
    if isinstance(tree, dict):
        return {str(k): _state_dict(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return {str(i): _state_dict(v) for i, v in enumerate(tree)}
    return tree


def to_bytes(tree: Any) -> bytes:
    """The bytes ``flax.serialization.to_bytes`` writes for a tree of dicts,
    lists, tuples, numpy arrays and Python scalars."""
    return packb(_state_dict(tree))


# --- files (the JAX module's functions) -------------------------------------

def save_msgpack(path: str | Path, tree: Any) -> Path:
    """Write ``tree`` as flax's msgpack bytes, atomically (a temporary
    file, then a rename)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(path.suffix + ".tmp")
    tmp.write_bytes(to_bytes(tree))
    tmp.replace(path)
    return path


def load_msgpack(path: str | Path) -> Any:
    """The tree a flax msgpack file holds (nested dicts with numpy leaves).
    The JAX function restores into a template; here
    ``models.load_jax_variables`` holds the tree to the model's keys and
    shapes."""
    return msgpack_restore(Path(path).read_bytes())
