"""Versioned checkpoints in the JAX package's layout, byte for byte.

Counterpart of ``analytics_zoo_tpu/learn/checkpoint.py`` (ref BigDL-style
snapshots, Topology.scala:1245-1252, and Orca ``find_latest_checkpoint``
/ ``load_orca_checkpoint``). A checkpoint is ``<dir>/ckpt-<iteration>/``
holding ``state.msgpack`` and ``meta.json`` (``{"iteration", "epoch",
"time"}``); it is written to ``ckpt-<n>.tmp`` and renamed into place, and
the oldest versions beyond ``OrcaContext.checkpoint_max_to_keep`` are
removed.

``state.msgpack`` is flax's msgpack encoding of the state tree
(``flax.serialization.to_bytes``), which the port writes and reads itself
(the card's machine has neither ``msgpack`` nor flax): maps with str keys,
str, bin, ints, floats, nil, bools and arrays, and flax's two numpy ext
types, 1 (an array: ``(shape, dtype name, C-order bytes)``) and 3 (a numpy
scalar, the same payload). An array over ``MAX_CHUNK_SIZE`` bytes is
split into flax's ``__msgpack_chunked_array__`` map. A ``bfloat16`` leaf
(numpy has none without ml_dtypes) is read and written as a
``torch.bfloat16`` tensor. Maps are written in the order of the tree's
keys: the estimators build their trees with sorted keys, as
``jax.tree_util`` rebuilds the JAX state.
"""

from __future__ import annotations

import glob
import json
import logging
import os
import re
import shutil
import struct
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

logger = logging.getLogger(__name__)

#: flax's limit for one array leaf; larger arrays are chunked
MAX_CHUNK_SIZE = 2 ** 30

_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3

_TORCH_DTYPE_NAMES = {torch.float32: "float32", torch.float64: "float64",
                      torch.float16: "float16", torch.bfloat16: "bfloat16",
                      torch.int64: "int64", torch.int32: "int32",
                      torch.int16: "int16", torch.int8: "int8",
                      torch.uint8: "uint8", torch.bool: "bool"}


# ---------------------------------------------------------------- encoding

def _int(x: int) -> bytes:
    if x < -(1 << 5):
        if x < -(1 << 15):
            return (b"\xd3" + struct.pack(">q", x)) if x < -(1 << 31) \
                else b"\xd2" + struct.pack(">i", x)
        return (b"\xd1" + struct.pack(">h", x)) if x < -(1 << 7) \
            else b"\xd0" + struct.pack(">b", x)
    if x < (1 << 7):
        return struct.pack(">b", x)
    if x < (1 << 8):
        return b"\xcc" + struct.pack(">B", x)
    if x < (1 << 16):
        return b"\xcd" + struct.pack(">H", x)
    if x < (1 << 32):
        return b"\xce" + struct.pack(">I", x)
    return b"\xcf" + struct.pack(">Q", x)


def _sized(n: int, fix: Optional[Tuple[int, int]], codes: Tuple[int, ...]
           ) -> bytes:
    """A length header: the fix form below its limit, else the 8-, 16- or
    32-bit form (``codes`` without an 8-bit form has two entries)."""
    if fix is not None and n < fix[1]:
        return bytes([fix[0] | n])
    forms = ((1 << 8, ">B"), (1 << 16, ">H"), (1 << 32, ">I"))
    if len(codes) == 2:
        forms = forms[1:]
    for code, (limit, fmt) in zip(codes, forms):
        if n < limit:
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"object of length {n} is too large for msgpack")


def _str(s: str) -> bytes:
    raw = s.encode("utf-8")
    return _sized(len(raw), (0xa0, 32), (0xd9, 0xda, 0xdb)) + raw


def _bin_header(n: int) -> bytes:
    return _sized(n, None, (0xc4, 0xc5, 0xc6))


def _ext_header(code: int, n: int) -> bytes:
    fixed = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}
    head = bytes([fixed[n]]) if n in fixed else \
        _sized(n, None, (0xc7, 0xc8, 0xc9))
    return head + struct.pack(">b", code)


def _array_parts(leaf) -> Tuple[Tuple[int, ...], str, memoryview]:
    """(shape, dtype name, C-order bytes) of an ndarray or a CPU tensor."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        name = _TORCH_DTYPE_NAMES[t.dtype]
        arr = (t.view(torch.int16) if t.dtype == torch.bfloat16 else t
               ).numpy()
        return tuple(t.shape), name, memoryview(arr.reshape(-1)).cast("B")
    arr = np.asarray(leaf)
    if not arr.flags.c_contiguous:     # (ascontiguousarray makes 0-d 1-d)
        arr = arr.copy(order="C")
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes are not supported")
    return (tuple(arr.shape), arr.dtype.name,
            memoryview(arr.reshape(-1)).cast("B"))


def _pack_array(code: int, leaf, out: List) -> None:
    """flax's ``_ndarray_to_bytes`` inside an ext of type ``code``."""
    shape, name, data = _array_parts(leaf)
    head = (_sized(3, (0x90, 16), (0xdc, 0xdd))
            + _sized(len(shape), (0x90, 16), (0xdc, 0xdd))
            + b"".join(_int(int(d)) for d in shape)
            + _str(name) + _bin_header(len(data)))
    out.append(_ext_header(code, len(head) + len(data)))
    out.append(head)
    out.append(data)


def _nbytes(leaf) -> int:
    if isinstance(leaf, torch.Tensor):
        return leaf.numel() * leaf.element_size()
    return int(leaf.size) * leaf.dtype.itemsize


def _chunked(leaf) -> dict:
    """flax's ``_chunk``: a flat array split into ``MAX_CHUNK_SIZE`` byte
    pieces, with its shape."""
    flat = leaf.reshape(-1)
    size = int(flat.shape[0])
    item = _nbytes(leaf) // max(size, 1)
    step = max(1, int(MAX_CHUNK_SIZE / item))
    chunks = [flat[i:i + step] for i in range(0, size, step)]
    return {"__msgpack_chunked_array__": True,
            "shape": {str(i): int(d) for i, d in enumerate(leaf.shape)},
            "chunks": {str(i): c for i, c in enumerate(chunks)}}


def _pack(obj, out: List) -> None:
    if isinstance(obj, dict):
        out.append(_sized(len(obj), (0x80, 16), (0xde, 0xdf)))
        for k, v in obj.items():
            if not isinstance(k, str):
                raise TypeError(f"map keys must be str, got {type(k)}")
            out.append(_str(k))
            if isinstance(v, (np.ndarray, torch.Tensor)) and \
                    _nbytes(v) > MAX_CHUNK_SIZE:
                v = _chunked(v)
            _pack(v, out)
    elif obj is None:
        out.append(b"\xc0")
    elif obj is True:
        out.append(b"\xc3")
    elif obj is False:
        out.append(b"\xc2")
    elif type(obj) is int:
        out.append(_int(obj))
    elif type(obj) is float:
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif type(obj) is str:
        out.append(_str(obj))
    elif type(obj) is bytes:
        out.append(_bin_header(len(obj)))
        out.append(obj)
    elif type(obj) is list:
        out.append(_sized(len(obj), (0x90, 16), (0xdc, 0xdd)))
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, (np.ndarray, torch.Tensor)):
        _pack_array(_EXT_NDARRAY, obj, out)
    elif isinstance(obj, np.generic):
        _pack_array(_EXT_NPSCALAR, np.asarray(obj), out)
    else:
        raise TypeError(f"cannot serialise {type(obj).__name__}")


def _encode(tree) -> List:
    out: List = []
    if isinstance(tree, (np.ndarray, torch.Tensor)) and \
            _nbytes(tree) > MAX_CHUNK_SIZE:
        tree = _chunked(tree)
    _pack(tree, out)
    return out


def to_bytes(tree) -> bytes:
    """``flax.serialization.to_bytes`` of a state tree of dicts with numpy
    (or CPU torch) leaves."""
    return b"".join(_encode(tree))


# ---------------------------------------------------------------- decoding

class _Reader:
    def __init__(self, data):
        self.buf = memoryview(data).cast("B")
        self.pos = 0

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.buf):
            raise ValueError("msgpack data is truncated")
        out = self.buf[self.pos:end]
        self.pos = end
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def obj(self):
        b = self.take(1)[0]
        if b <= 0x7f:
            return b
        if b >= 0xe0:
            return b - 0x100
        if 0x80 <= b <= 0x8f:
            return self._map(b & 0x0f)
        if 0x90 <= b <= 0x9f:
            return [self.obj() for _ in range(b & 0x0f)]
        if 0xa0 <= b <= 0xbf:
            return str(self.take(b & 0x1f), "utf-8")
        simple = {0xc0: None, 0xc2: False, 0xc3: True}
        if b in simple:
            return simple[b]
        sizes = {0xc4: ">B", 0xc5: ">H", 0xc6: ">I"}
        if b in sizes:
            return bytes(self.take(self.unpack(sizes[b])))
        ext = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}
        if b in ext:
            return self._ext(ext[b])
        sizes = {0xc7: ">B", 0xc8: ">H", 0xc9: ">I"}
        if b in sizes:
            return self._ext(self.unpack(sizes[b]))
        nums = {0xca: ">f", 0xcb: ">d", 0xcc: ">B", 0xcd: ">H", 0xce: ">I",
                0xcf: ">Q", 0xd0: ">b", 0xd1: ">h", 0xd2: ">i", 0xd3: ">q"}
        if b in nums:
            return self.unpack(nums[b])
        sizes = {0xd9: ">B", 0xda: ">H", 0xdb: ">I"}
        if b in sizes:
            return str(self.take(self.unpack(sizes[b])), "utf-8")
        if b in (0xdc, 0xdd):
            n = self.unpack(">H" if b == 0xdc else ">I")
            return [self.obj() for _ in range(n)]
        if b in (0xde, 0xdf):
            return self._map(self.unpack(">H" if b == 0xde else ">I"))
        raise ValueError(f"unsupported msgpack byte 0x{b:02x}")

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.obj()
            if not isinstance(k, str):
                raise ValueError(f"map key {k!r} is not a str")
            out[k] = self.obj()
        return out

    def _ext(self, n: int):
        code = self.unpack(">b")
        body = self.take(n)
        if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
            raise ValueError(f"unsupported msgpack ext type {code}")
        inner = _Reader(body)
        if inner.take(1)[0] != 0x93:
            raise ValueError("malformed ndarray ext")
        shape = tuple(inner.obj())
        name = inner.obj()
        data = inner.obj_view()
        if name == "bfloat16":
            # torch wants a writable buffer: copy a read-only one
            buf = bytearray(data) if data.readonly else data
            arr = torch.frombuffer(buf, dtype=torch.bfloat16) if len(buf) \
                else torch.empty(0, dtype=torch.bfloat16)
            arr = arr.reshape(shape)
            return arr if code == _EXT_NDARRAY else arr.reshape(())
        arr = np.frombuffer(data, dtype=np.dtype(name)).reshape(shape)
        return arr if code == _EXT_NDARRAY else arr[()]

    def obj_view(self) -> memoryview:
        """A bin object as a view into the buffer (no copy)."""
        b = self.take(1)[0]
        sizes = {0xc4: ">B", 0xc5: ">H", 0xc6: ">I"}
        if b not in sizes:
            raise ValueError("malformed ndarray ext: no bin payload")
        return self.take(self.unpack(sizes[b]))


def _unchunk(tree):
    if isinstance(tree, dict):
        if "__msgpack_chunked_array__" in tree:
            shape = tuple(tree["shape"][str(i)]
                          for i in range(len(tree["shape"])))
            parts = [tree["chunks"][str(i)]
                     for i in range(len(tree["chunks"]))]
            flat = (torch.cat(parts) if isinstance(parts[0], torch.Tensor)
                    else np.concatenate(parts))
            return flat.reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def msgpack_restore(data) -> Any:
    """Decode flax's msgpack bytes into dicts with numpy (or, for
    bfloat16, torch) leaves, chunked arrays joined. Arrays view ``data``:
    pass a ``bytearray`` for writable arrays."""
    reader = _Reader(data)
    tree = reader.obj()
    if reader.pos != len(reader.buf):
        raise ValueError("trailing bytes after the msgpack object")
    return _unchunk(tree)


def _restore(target, state, path: str):
    if isinstance(target, dict):
        if not isinstance(state, dict):
            raise ValueError(f"checkpoint has a leaf at {path or '/'} where "
                             "the target has a map")
        if set(target) != set(state):
            raise ValueError(
                f"checkpoint keys at {path or '/'} do not match: "
                f"{sorted(state)} != {sorted(target)}")
        return {k: _restore(v, state[k], f"{path}/{k}")
                for k, v in target.items()}
    return state


def from_bytes(target, data) -> Any:
    """``flax.serialization.from_bytes``: restore ``data`` into the
    structure of ``target`` (maps must have the target's keys)."""
    return _restore(target, msgpack_restore(data), "")


# ------------------------------------------------------------ checkpoints

def save_checkpoint(ckpt_dir: str, state: Any, iteration: int, epoch: int,
                    max_to_keep: Optional[int] = None) -> str:
    """Write ``state`` as ``ckpt_dir/ckpt-<iteration>`` (through a
    ``.tmp`` directory and an atomic rename), then keep the newest
    ``max_to_keep`` versions (default ``OrcaContext.checkpoint_max_to_keep``)."""
    if max_to_keep is None:
        from analytics_zoo_tpu_torch.common.context import OrcaContext
        max_to_keep = OrcaContext.checkpoint_max_to_keep
    path = os.path.join(ckpt_dir, f"ckpt-{iteration}")
    tmp = path + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    with open(os.path.join(tmp, "state.msgpack"), "wb") as fh:
        for part in _encode(state):
            fh.write(part)
    with open(os.path.join(tmp, "meta.json"), "w") as fh:
        json.dump({"iteration": iteration, "epoch": epoch,
                   "time": time.time()}, fh)  # zoolint: disable=wallclock-hotpath (metadata)
    if os.path.exists(path):
        shutil.rmtree(path)
    os.replace(tmp, path)
    for v in sorted(_list_versions(ckpt_dir))[:-max_to_keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"ckpt-{v}"), ignore_errors=True)
    return path


def _list_versions(ckpt_dir: str) -> List[int]:
    out = []
    for p in glob.glob(os.path.join(ckpt_dir, "ckpt-*")):
        m = re.match(r".*ckpt-(\d+)$", p)
        if m and os.path.isdir(p):
            out.append(int(m.group(1)))
    return out


def find_latest_checkpoint(ckpt_dir: str) -> Optional[Tuple[str, int]]:
    """(ref orca/learn/utils.py find_latest_checkpoint) ``(path,
    version)`` of the newest version, or None."""
    versions = _list_versions(ckpt_dir)
    if not versions:
        return None
    v = max(versions)
    return os.path.join(ckpt_dir, f"ckpt-{v}"), v


def _flatten(tree, path: str = "") -> Dict[str, Any]:
    if isinstance(tree, dict):
        out: Dict[str, Any] = {}
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{path}/{k}"))
        if not tree:
            out[path + "/"] = {}
        return out
    return {path: tree}


def _dtype_name(leaf) -> Optional[str]:
    if isinstance(leaf, torch.Tensor):
        return _TORCH_DTYPE_NAMES.get(leaf.dtype)
    dt = getattr(leaf, "dtype", None)
    return None if dt is None else np.dtype(dt).name


def validate_state(state: Any, target: Any) -> None:
    """Check a restored ``state`` against ``target``: the same tree, and
    every leaf with the target's shape and dtype (leaves may be arrays,
    tensors, meta tensors included). Raises ``ValueError`` on a mismatch,
    which the auto-resume path treats as a torn file."""
    s, t = _flatten(state), _flatten(target)
    if list(s) != list(t):
        raise ValueError(f"checkpoint tree structure mismatch: {list(s)} "
                         f"!= {list(t)}")
    for path, leaf in s.items():
        want = t[path]
        if isinstance(leaf, dict) or isinstance(want, dict):
            continue
        ss, ts = tuple(np.shape(leaf)), tuple(want.shape)
        if ss != ts:
            raise ValueError(
                f"checkpoint leaf {path} shape mismatch: {ss} != {ts}")
        sd, td = _dtype_name(leaf), _dtype_name(want)
        if sd is not None and td is not None and sd != td:
            raise ValueError(
                f"checkpoint leaf {path} dtype mismatch: {sd} != {td}")


def read_checkpoint(path: str) -> Tuple[Any, dict]:
    """The whole state tree of ``path/state.msgpack``, restored against
    no target, and ``meta.json``: for a reader that takes only part of a
    snapshot (``InferenceModel.load_checkpoint`` keeps the parameters
    and the model state, whatever optimizer wrote the rest)."""
    file = os.path.join(path, "state.msgpack")
    data = bytearray(os.path.getsize(file))
    with open(file, "rb") as fh:
        if fh.readinto(data) != len(data):
            raise ValueError(f"{file} changed while it was read")
    with open(os.path.join(path, "meta.json")) as fh:
        meta = json.load(fh)
    return msgpack_restore(data), meta


def load_checkpoint(path: str, target: Any, validate: bool = True
                    ) -> Tuple[Any, dict]:
    """Restore ``path/state.msgpack`` into the structure of ``target``
    and read ``meta.json``. With ``validate`` the result is checked
    against ``target``'s shapes and dtypes: a complete file holding
    another model must not restore silently."""
    tree, meta = read_checkpoint(path)
    state = _restore(target, tree, "")
    if validate:
        validate_state(state, target)
    return state, meta


def load_latest_checkpoint(ckpt_dir: str, target: Any
                           ) -> Optional[Tuple[Any, dict, str]]:
    """The newest version that loads and validates against ``target``,
    walking newest to oldest past torn or mismatched ones: ``(state,
    meta, path)``, or None when none survives."""
    for v in sorted(_list_versions(ckpt_dir), reverse=True):
        path = os.path.join(ckpt_dir, f"ckpt-{v}")
        try:
            state, meta = load_checkpoint(path, target)
            return state, meta, path
        except Exception as e:
            logger.warning("checkpoint %s unusable (%s); trying the "
                           "previous version", path, e)
    return None
