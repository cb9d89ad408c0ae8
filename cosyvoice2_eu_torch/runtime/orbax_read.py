"""A reader of the JAX package's orbax checkpoint directories, in plain Python.

``cosyvoice2_eu_tpu.runtime.checkpoint.save_pytree`` writes a parameter tree
with orbax's ``StandardCheckpointer`` (orbax-checkpoint 0.11, tensorstore
underneath).  This module reads such a directory back as a tree of CPU
tensors without JAX, orbax or tensorstore.  The format, as verified on the
files those libraries write:

``_METADATA`` (JSON)
    ``tree_metadata`` has one entry per leaf: ``key_metadata`` is the key
    path (``key_type`` 2 a dict key, 1 a sequence index; sequences come back
    as lists, as orbax restores them), ``value_metadata.value_type`` is
    ``jax.Array``, ``np.ndarray`` or ``scalar`` for an array, ``None``,
    ``Dict`` or ``List`` for an empty node.  ``use_ocdbt`` and ``use_zarr3``
    say how the arrays are stored (true and false; other layouts raise).  A leaf's array
    lives under the keys ``<param name>/...``, the param name being its keys
    joined with ``.`` (so it is never split back: ``{"x.y": a}`` and
    ``{"x": {"y": a}}`` give the same name).

The key-value store (OCDBT)
    ``manifest.ocdbt`` at the root, ``d/<hex>`` data files, and each writing
    process's own database under ``ocdbt.process_<i>/`` whose files the
    root's nodes may name.  Every manifest and B+tree node is a container:
    the magic (u32 big-endian: ``0x0cdb3a2a`` manifest, ``0x0cdb20de``
    node), the container's length (u64 LE), a version (varint, 0), a
    compression (varint: 0 none, 1 zstd), the body, and a CRC-32C (4 bytes,
    not checked here).  Integers below are LEB128 varints unless noted, and
    the per-entry fields are stored column by column.

    * A data file table: the count, then for files 1.. the length of the
      path prefix shared with the previous file, every file's suffix
      length, every file's base-path length, then the suffixes.  A path is
      relative to the database's directory.
    * A manifest body: the config (a 16-byte uuid, the manifest kind (0: a
      single file; numbered manifests are not read), the largest inline
      value, the largest decoded node, the version tree's arity log2 (one
      byte), the compression (1: zstd, followed by its level as i32 LE)),
      a data file table, then the versions: the count, each version's
      generation number, root height (one byte), root node's file id,
      offset and length, the statistics (keys, tree bytes, indirect value
      bytes) and commit time (u64 LE).  The newest version is the last; a
      root of length 0 is an empty tree.
    * A node body: the height (one byte), a data file table, the entry
      count, each entry's key prefix length shared with the previous key
      (from the second entry on), each key suffix length, then for an
      interior node each subtree's common-prefix length; the key suffixes;
      then for a leaf each value length, each value kind (0 inline,
      1 in a data file), the file id and offset of each value held in a
      file, and the inline values end to end; for an interior node each
      child's file id, offset and length and its statistics.  A child's
      keys omit the parent entry's subtree common prefix.

Arrays (zarr v2)
    ``<name>/.zarray`` is JSON (``shape``, ``chunks``, ``dtype`` as
    ``"<f4"``, ``"<i4"``, ... or ``"bfloat16"``, ``compressor`` null or
    ``{"id": "zstd"}``, ``fill_value``, ``order`` "C",
    ``dimension_separator`` "."); a chunk's key is its grid index joined by
    the separator (``"0"`` for a 0-d array).  Each chunk holds the whole
    chunk shape in C order, the edges padded; a leaf JAX sharded over 8
    devices writes 8 chunks.  A chunk the store lacks is ``fill_value``.
    bfloat16 is read as ``<u2`` and viewed as ``torch.bfloat16``.

zstd comes from the system's ``libzstd.so.1`` through ``ctypes`` (Python
3.12 has no zstd module); without it reading raises ``OSError`` naming the
library.
"""

from __future__ import annotations

import ctypes
import json
import math
import os
import struct

import numpy as np
import torch

ZSTD_LIBRARY = "libzstd.so.1"
_MANIFEST_MAGIC = 0x0CDB3A2A
_NODE_MAGIC = 0x0CDB20DE
_ZSTD_CONTENTSIZE_UNKNOWN = (1 << 64) - 1
_ZSTD_CONTENTSIZE_ERROR = (1 << 64) - 2

_zstd_lib = None


class _InBuffer(ctypes.Structure):
    _fields_ = [("src", ctypes.c_void_p), ("size", ctypes.c_size_t), ("pos", ctypes.c_size_t)]


class _OutBuffer(ctypes.Structure):
    _fields_ = [("dst", ctypes.c_void_p), ("size", ctypes.c_size_t), ("pos", ctypes.c_size_t)]


def _zstd():
    """The bound ``libzstd`` (loaded once, by ``ZSTD_LIBRARY``'s name)."""
    global _zstd_lib
    if _zstd_lib is not None and _zstd_lib[0] == ZSTD_LIBRARY:
        return _zstd_lib[1]
    try:
        lib = ctypes.CDLL(ZSTD_LIBRARY)
    except OSError as e:
        raise OSError(f"reading an orbax checkpoint needs the zstd library {ZSTD_LIBRARY} "
                      f"(the system's libzstd), which did not load: {e}") from e
    size_t, vp = ctypes.c_size_t, ctypes.c_void_p
    lib.ZSTD_getFrameContentSize.restype = ctypes.c_ulonglong
    lib.ZSTD_getFrameContentSize.argtypes = [vp, size_t]
    lib.ZSTD_findFrameCompressedSize.restype = size_t
    lib.ZSTD_findFrameCompressedSize.argtypes = [vp, size_t]
    lib.ZSTD_decompress.restype = size_t
    lib.ZSTD_decompress.argtypes = [vp, size_t, vp, size_t]
    lib.ZSTD_isError.restype = ctypes.c_uint
    lib.ZSTD_isError.argtypes = [size_t]
    lib.ZSTD_getErrorName.restype = ctypes.c_char_p
    lib.ZSTD_getErrorName.argtypes = [size_t]
    lib.ZSTD_createDStream.restype = vp
    lib.ZSTD_freeDStream.argtypes = [vp]
    lib.ZSTD_initDStream.restype = size_t
    lib.ZSTD_initDStream.argtypes = [vp]
    lib.ZSTD_decompressStream.restype = size_t
    lib.ZSTD_decompressStream.argtypes = [vp, ctypes.POINTER(_OutBuffer),
                                          ctypes.POINTER(_InBuffer)]
    _zstd_lib = (ZSTD_LIBRARY, lib)
    return lib


def _check(lib, code: int) -> int:
    if lib.ZSTD_isError(code):
        raise ValueError(f"zstd: {lib.ZSTD_getErrorName(code).decode()}")
    return code


def zstd_decompress(data: bytes) -> bytes:
    """The decompressed zstd frame(s) in ``data``: one call when a single
    frame states its size, the streaming decoder otherwise."""
    lib = _zstd()
    src = ctypes.c_char_p(data)
    size = lib.ZSTD_getFrameContentSize(src, len(data))
    if size == _ZSTD_CONTENTSIZE_ERROR:
        raise ValueError("zstd: not a zstd frame")
    if size != _ZSTD_CONTENTSIZE_UNKNOWN and lib.ZSTD_findFrameCompressedSize(
            src, len(data)) == len(data):
        out = ctypes.create_string_buffer(max(int(size), 1))
        n = _check(lib, lib.ZSTD_decompress(out, size, src, len(data)))
        return out.raw[:n]
    return _stream_decompress(data)


def _stream_decompress(data: bytes) -> bytes:
    lib = _zstd()
    stream = lib.ZSTD_createDStream()
    try:
        _check(lib, lib.ZSTD_initDStream(stream))
        src = ctypes.c_char_p(data)
        inb = _InBuffer(ctypes.cast(src, ctypes.c_void_p), len(data), 0)
        step = 1 << 20
        buf = ctypes.create_string_buffer(step)
        parts = []
        while True:
            outb = _OutBuffer(ctypes.cast(buf, ctypes.c_void_p), step, 0)
            left = _check(lib, lib.ZSTD_decompressStream(stream, ctypes.byref(outb),
                                                         ctypes.byref(inb)))
            parts.append(buf.raw[:outb.pos])
            if inb.pos == inb.size and (left == 0 or outb.pos < step):
                if left != 0:
                    raise ValueError("zstd: truncated frame")
                return b"".join(parts)
    finally:
        lib.ZSTD_freeDStream(stream)


# ---------------------------------------------------------------------------
# OCDBT
# ---------------------------------------------------------------------------

class _Bytes:
    def __init__(self, data: bytes):
        self.data, self.pos = data, 0

    def varint(self) -> int:
        out = shift = 0
        while True:
            b = self.data[self.pos]
            self.pos += 1
            out |= (b & 0x7F) << shift
            if b < 0x80:
                return out
            shift += 7

    def varints(self, n: int) -> list:
        return [self.varint() for _ in range(n)]

    def byte(self) -> int:
        self.pos += 1
        return self.data[self.pos - 1]

    def raw(self, n: int) -> bytes:
        self.pos += n
        return self.data[self.pos - n:self.pos]


def _container(blob: bytes, magic: int, where: str) -> _Bytes:
    if len(blob) < 18 or struct.unpack(">I", blob[:4])[0] != magic:
        raise ValueError(f"{where}: not an OCDBT {'manifest' if magic == _MANIFEST_MAGIC else 'node'}")
    if struct.unpack("<Q", blob[4:12])[0] != len(blob):
        raise ValueError(f"{where}: truncated ({len(blob)} bytes)")
    r = _Bytes(blob[:-4])
    r.pos = 12
    if r.varint() != 0:
        raise ValueError(f"{where}: unknown OCDBT format version")
    compression = r.varint()
    body = blob[r.pos:-4]
    if compression == 1:
        body = zstd_decompress(body)
    elif compression != 0:
        raise ValueError(f"{where}: unknown compression {compression}")
    return _Bytes(body)


def _file_table(r: _Bytes) -> list:
    n = r.varint()
    prefix = [0] + r.varints(n - 1) if n else []
    suffix = r.varints(n)
    r.varints(n)  # base-path lengths: the paths are already whole
    paths, prev = [], ""
    for p, s in zip(prefix, suffix):
        prev = prev[:p] + r.raw(s).decode()
        paths.append(prev)
    return paths


def _keys(r: _Bytes, n: int, interior: bool):
    prefix = [0] + r.varints(n - 1) if n else []
    suffix = r.varints(n)
    common = r.varints(n) if interior else None
    keys, prev = [], b""
    for p, s in zip(prefix, suffix):
        prev = prev[:p] + r.raw(s)
        keys.append(prev)
    return keys, common


class OcdbtStore:
    """The newest version of an OCDBT database as {key: value}: inline
    values as bytes, values held in data files as (path, offset, length)."""

    def __init__(self, root: str):
        self.root = root
        path = os.path.join(root, "manifest.ocdbt")
        with open(path, "rb") as f:
            r = _container(f.read(), _MANIFEST_MAGIC, path)
        r.raw(16)  # uuid
        if r.varint() != 0:
            raise ValueError(f"{path}: numbered manifests are not read")
        r.varint(), r.varint()  # largest inline value, largest decoded node
        r.byte()  # version tree arity
        if r.varint() == 1:
            r.raw(4)  # zstd level
        files = _file_table(r)
        n = r.varint()
        r.varints(n)  # generation numbers
        heights = [r.byte() for _ in range(n)]
        ids, offsets, lengths = r.varints(n), r.varints(n), r.varints(n)
        self.entries: dict = {}
        if n and lengths[-1]:
            self._node(files[ids[-1]], offsets[-1], lengths[-1], b"", heights[-1])

    def _node(self, path: str, offset: int, length: int, prefix: bytes, height: int):
        full = os.path.join(self.root, path)
        with open(full, "rb") as f:
            f.seek(offset)
            r = _container(f.read(length), _NODE_MAGIC, full)
        if r.byte() != height:
            raise ValueError(f"{full}: node height disagrees with its parent")
        files = _file_table(r)
        n = r.varint()
        keys, common = _keys(r, n, interior=height > 0)
        if height > 0:
            ids, offsets, lengths = r.varints(n), r.varints(n), r.varints(n)
            for k, c, i, o, ln in zip(keys, common, ids, offsets, lengths):
                self._node(files[i], o, ln, prefix + k[:c], height - 1)
            return
        sizes = r.varints(n)
        kinds = r.varints(n)
        n_ind = sum(1 for k in kinds if k == 1)
        ids, offsets = r.varints(n_ind), r.varints(n_ind)
        j = 0
        for k, size, kind in zip(keys, sizes, kinds):
            if kind == 1:
                self.entries[prefix + k] = (files[ids[j]], offsets[j], size)
                j += 1
            elif kind == 0:
                self.entries[prefix + k] = r.raw(size)
            else:
                raise ValueError(f"{full}: unknown value kind {kind}")

    def get(self, key: str):
        v = self.entries.get(key.encode())
        if isinstance(v, tuple):
            path, offset, size = v
            with open(os.path.join(self.root, path), "rb") as f:
                f.seek(offset)
                v = f.read(size)
        return v


# ---------------------------------------------------------------------------
# zarr v2 arrays and the tree
# ---------------------------------------------------------------------------

def _read_array(store, name: str) -> torch.Tensor:
    meta = store.get(f"{name}/.zarray")
    if meta is None:
        raise ValueError(f"{store.root}: no array {name!r}")
    meta = json.loads(meta)
    if meta.get("order", "C") != "C" or meta.get("filters"):
        raise ValueError(f"{name}: order {meta.get('order')!r} / filters are not read")
    bf16 = meta["dtype"] == "bfloat16"
    dtype = np.dtype("<u2" if bf16 else meta["dtype"])
    shape, chunks = list(meta["shape"]), list(meta["chunks"])
    comp = (meta.get("compressor") or {}).get("id")
    if comp not in (None, "zstd"):
        raise ValueError(f"{name}: compressor {comp!r} is not read")
    fill = meta.get("fill_value")
    out = np.empty(shape, dtype)
    if fill is None:
        out[...] = 0
    elif bf16:
        out[...] = torch.tensor(float(fill), dtype=torch.bfloat16).view(torch.int16).item() & 0xFFFF
    else:
        out[...] = {"NaN": math.nan, "Infinity": math.inf, "-Infinity": -math.inf}.get(fill, fill)
    sep = meta.get("dimension_separator", ".")
    grid = [math.ceil(s / c) if c else 1 for s, c in zip(shape, chunks)]
    for idx in np.ndindex(*grid):
        raw = store.get(f"{name}/{sep.join(map(str, idx)) if idx else '0'}")
        if raw is None:
            continue
        if comp == "zstd":
            raw = zstd_decompress(raw)
        chunk = np.frombuffer(raw, dtype).reshape(chunks)
        sl = tuple(slice(i * c, min((i + 1) * c, s)) for i, c, s in zip(idx, chunks, shape))
        out[sl] = chunk[tuple(slice(0, s.stop - s.start) for s in sl)]
    t = torch.from_numpy(out)
    return t.view(torch.bfloat16) if bf16 else t


_EMPTY = {"None": lambda: None, "Dict": dict, "List": list}


def _listify(node):
    if isinstance(node, _Seq):
        return [_listify(node[i]) for i in range(len(node))]
    if isinstance(node, dict):
        return {k: _listify(v) for k, v in node.items()}
    return node


class _Seq(dict):
    """A sequence node while the tree is built (indices as keys)."""


def is_orbax_dir(path: str) -> bool:
    return os.path.isfile(os.path.join(path, "_METADATA"))


def read_orbax(path: str):
    """The tree an orbax ``StandardCheckpointer`` saved at ``path``: arrays
    as CPU tensors (bfloat16 leaves as ``torch.bfloat16``), ``scalar``
    leaves as Python numbers, tuples and lists as lists."""
    with open(os.path.join(path, "_METADATA")) as f:
        meta = json.load(f)
    if meta.get("use_zarr3") or not meta.get("use_ocdbt", True):
        raise ValueError(f"{path}: only OCDBT stores of zarr v2 arrays are read")
    store = OcdbtStore(path)
    root: dict = {}
    for entry in meta["tree_metadata"].values():
        keys = entry["key_metadata"]
        vtype = entry["value_metadata"]["value_type"]
        if vtype in _EMPTY:
            value = _EMPTY[vtype]()
        elif vtype in ("jax.Array", "np.ndarray", "scalar"):
            value = _read_array(store, ".".join(str(k["key"]) for k in keys))
            if vtype == "scalar":
                value = value.item()
        else:
            raise ValueError(f"{path}: leaf type {vtype!r} is not read")
        node = root
        for i, k in enumerate(keys):
            key = int(k["key"]) if k["key_type"] == 1 else k["key"]
            if i == len(keys) - 1:
                node[key] = value
            else:
                nxt = keys[i + 1]["key_type"] == 1
                node = node.setdefault(key, _Seq() if nxt else {})
    return _listify(root)
