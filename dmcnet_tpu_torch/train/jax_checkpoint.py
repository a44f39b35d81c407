"""Read the JAX package's checkpoint files with neither jax, flax nor the
`msgpack` package.

`dmcnet_tpu/train/checkpoints.py:23-63` writes a pickle of

    {"meta": {epoch, arch, best_prec1} or {epoch, top1},
     "state": flax msgpack bytes of the whole TrainState}

where the state holds params, batch_stats, opt_cls, opt_gf, opt_d, grad_acc
and step (`dmcnet_tpu/train/engine.py:39-54`).  `read_jax_checkpoint`
returns (meta, state) with the state as nested dicts of numpy arrays.

The pickle is read by `_RestrictedUnpickler`, which admits builtins' plain
containers and numpy's array and scalar reconstructors only; any other
class becomes an inert `_Foreign` placeholder that is never called, and a
placeholder in the meta raises naming its key.  The msgpack bytes are
decoded by `unpack_msgpack`, a stdlib (`struct`) reader of the msgpack
format with flax's extension types (`flax/serialization.py:249-311`):
1 = ndarray, a nested msgpack of (shape, dtype name, C-order bytes);
2 = complex, a nested (real, imag); 3 = numpy scalar, an ndarray of shape
(); and flax's `__msgpack_chunked_array__` leaves (`:324-390`), which
`unpack_msgpack` joins back into arrays.  bfloat16 arrays, which numpy has
no dtype for, come back as float32 (exact).
"""

from __future__ import annotations

import pickle
import pickletools
import struct
import zipfile

import numpy as np

# builtins a checkpoint's meta may hold: plain values and containers
_BUILTINS = frozenset({
    "bool", "bytearray", "bytes", "complex", "dict", "float", "frozenset",
    "int", "list", "range", "set", "slice", "str", "tuple"})
# numpy's reconstructors of arrays, scalars and dtypes (both module paths:
# numpy 1.x pickles `numpy.core`, 2.x `numpy._core`)
_NUMPY = frozenset(
    (mod, name) for mod in ("numpy.core.multiarray", "numpy._core.multiarray")
    for name in ("_reconstruct", "scalar")) | {
    ("numpy", "ndarray"), ("numpy", "dtype")}


class _Foreign:
    """Stands for a class the unpickler does not admit: built from any
    arguments, it runs nothing and keeps nothing."""

    module = name = ""

    def __new__(cls, *args, **kwargs):
        return object.__new__(cls)

    def __init__(self, *args, **kwargs):
        pass

    def __setstate__(self, state):
        pass


class _RestrictedUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module == "builtins" and name in _BUILTINS:
            return super().find_class(module, name)
        if (module, name) in _NUMPY or (
                module == "numpy.dtypes" and name.endswith("DType")):
            return super().find_class(module, name)
        return type("_Foreign", (_Foreign,), {"module": module, "name": name})


def _foreign_in(obj):
    """The first `_Foreign` inside `obj` (containers walked), or None."""
    if isinstance(obj, _Foreign):
        return obj
    if isinstance(obj, dict):
        items = list(obj.keys()) + list(obj.values())
    elif isinstance(obj, (list, tuple, set, frozenset)):
        items = list(obj)
    else:
        return None
    for item in items:
        found = _foreign_in(item)
        if found is not None:
            return found
    return None


def is_jax_checkpoint(path):
    """Whether the file `path` is the JAX package's checkpoint: a pickle of
    {meta, state (msgpack bytes)}, read by its opcodes without
    unpickling."""
    if zipfile.is_zipfile(path):
        return False
    with open(path, "rb") as f:
        try:
            names = {arg for _, arg, _ in pickletools.genops(f)
                     if isinstance(arg, str)}
        except ValueError:  # not a pickle
            return False
    return {"meta", "state"} <= names


def read_jax_checkpoint(path):
    """(meta, state) of a checkpoint of `dmcnet_tpu/train/checkpoints.
    save_checkpoint`: the meta dict and the TrainState as nested dicts of
    numpy arrays (None where a field is None)."""
    with open(path, "rb") as f:
        payload = _RestrictedUnpickler(f).load()
    if not isinstance(payload, dict) or not {"meta", "state"} <= set(
            payload):
        raise ValueError(f"{path} is not a JAX checkpoint ({{meta, state}})")
    meta = payload["meta"]
    if not isinstance(meta, dict):
        raise ValueError(f"{path}: meta is a {type(meta).__name__}, not a "
                         "dict")
    for key, value in meta.items():
        bad = _foreign_in(value)
        if bad is not None:
            raise ValueError(f"{path}: meta[{key!r}] holds a "
                             f"{bad.module}.{bad.name}, which the reader "
                             "does not load")
    if not isinstance(payload["state"], (bytes, bytearray)):
        raise ValueError(f"{path}: state is not msgpack bytes")
    return dict(meta), unpack_msgpack(bytes(payload["state"]))


# --- msgpack ---------------------------------------------------------------

_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3


class _Reader:
    """Big-endian msgpack decoder over one buffer (the format's spec:
    github.com/msgpack/msgpack/blob/master/spec.md)."""

    def __init__(self, data):
        self.buf = memoryview(data)
        self.pos = 0

    def take(self, n):
        if self.pos + n > len(self.buf):
            raise ValueError("msgpack data ends early")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def num(self, fmt):
        return struct.unpack(">" + fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self):
        b = self.num("B")
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
        op = _OPS.get(b)
        if op is None:
            raise ValueError(f"msgpack byte 0x{b:02x} is not a type")
        return op(self)

    def map(self, n):
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out

    def array(self, n):
        return [self.value() for _ in range(n)]

    def str(self, n):
        return bytes(self.take(n)).decode("utf-8")

    def ext(self, n):
        code = self.num("b")
        return _ext(code, bytes(self.take(n)))


_OPS = {
    0xC0: lambda r: None,
    0xC2: lambda r: False,
    0xC3: lambda r: True,
    0xC4: lambda r: bytes(r.take(r.num("B"))),
    0xC5: lambda r: bytes(r.take(r.num("H"))),
    0xC6: lambda r: bytes(r.take(r.num("I"))),
    0xC7: lambda r: r.ext(r.num("B")),
    0xC8: lambda r: r.ext(r.num("H")),
    0xC9: lambda r: r.ext(r.num("I")),
    0xCA: lambda r: r.num("f"),
    0xCB: lambda r: r.num("d"),
    0xCC: lambda r: r.num("B"),
    0xCD: lambda r: r.num("H"),
    0xCE: lambda r: r.num("I"),
    0xCF: lambda r: r.num("Q"),
    0xD0: lambda r: r.num("b"),
    0xD1: lambda r: r.num("h"),
    0xD2: lambda r: r.num("i"),
    0xD3: lambda r: r.num("q"),
    0xD4: lambda r: r.ext(1),
    0xD5: lambda r: r.ext(2),
    0xD6: lambda r: r.ext(4),
    0xD7: lambda r: r.ext(8),
    0xD8: lambda r: r.ext(16),
    0xD9: lambda r: r.str(r.num("B")),
    0xDA: lambda r: r.str(r.num("H")),
    0xDB: lambda r: r.str(r.num("I")),
    0xDC: lambda r: r.array(r.num("H")),
    0xDD: lambda r: r.array(r.num("I")),
    0xDE: lambda r: r.map(r.num("H")),
    0xDF: lambda r: r.map(r.num("I")),
}


def _unpack_one(data):
    r = _Reader(data)
    out = r.value()
    if r.pos != len(r.buf):
        raise ValueError(f"{len(r.buf) - r.pos} bytes after the msgpack "
                         "value")
    return out


def _ndarray(data):
    """flax's ndarray payload: msgpack (shape, dtype name, C bytes)."""
    shape, name, raw = _unpack_one(data)
    if isinstance(name, bytes):
        name = name.decode()
    if name == "bfloat16":  # the upper 16 bits of a float32
        bits = np.frombuffer(raw, dtype="<u2").astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(raw, dtype=np.dtype(name)).reshape(shape).copy()


def _ext(code, data):
    if code == _EXT_NDARRAY:
        return _ndarray(data)
    if code == _EXT_COMPLEX:
        real, imag = _unpack_one(data)
        return complex(real, imag)
    if code == _EXT_NPSCALAR:
        return _ndarray(data)[()]
    raise ValueError(f"msgpack extension type {code} is not flax's")


def _unchunk(tree):
    """flax's chunked leaves ({"__msgpack_chunked_array__": True, "shape":
    {"0": d0, ...}, "chunks": {"0": flat0, ...}}) joined back, in place."""
    if isinstance(tree, dict):
        if "__msgpack_chunked_array__" in tree:
            shape = tuple(tree["shape"][str(i)]
                          for i in range(len(tree["shape"])))
            chunks = [tree["chunks"][str(i)]
                      for i in range(len(tree["chunks"]))]
            return np.concatenate(chunks).reshape(shape)
        for k, v in tree.items():
            tree[k] = _unchunk(v)
    return tree


def unpack_msgpack(data):
    """The value of flax `msgpack_serialize` bytes (`msgpack_restore`'s
    result): dicts, lists, str, bytes, None, bool, int, float, complex and
    numpy arrays and scalars."""
    return _unchunk(_unpack_one(data))
