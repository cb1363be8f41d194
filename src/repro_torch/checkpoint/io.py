"""Checkpoint I/O for param trees of torch tensors (port of
``repro.checkpoint.io``): the reference's file format, readable and
writable by either package.

A msgpack manifest (format, step, the tree's structure as JAX prints it,
``chunk_bytes``, and per-leaf dtype, shape and chunk count) is followed by
each leaf's raw little-endian bytes as msgpack bins of at most
``chunk_bytes``.  Format 3, which :func:`save_checkpoint` writes, puts a
CRC32 after every chunk; formats 2 (chunks, no CRC) and 1 (one bin per
leaf, no ``format`` key) stay readable.  A CRC mismatch or a short read
raises :class:`CheckpointCorruptionError`.

The tree structure string is the one ``str(jax.tree_util.tree_structure)``
gives: dict keys sorted, lists in order, leaves ``*``; leaves are flattened
in that order, so a file from the JAX package lines up leaf for leaf.
bf16 leaves cross bit for bit.  Reading streams one leaf at a time: read
into a host buffer, copy to the device, free the buffer.  Over an ep mesh
a rank keeps only its rows of each ``experts_*`` leaf (``experts=``).

The msgpack subset lives in :mod:`repro_torch.checkpoint.msgpack_lite`;
this module needs no msgpack package.
"""
from __future__ import annotations

import os
import zlib
from typing import Any, Iterator, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.checkpoint import msgpack_lite
from repro_torch.common.device import resolve_device

# default bound on a single msgpack bin (the reference's)
DEFAULT_CHUNK_BYTES = 64 * 1024 * 1024
_FORMAT = 3

# the dtype names numpy (and so the JAX package) writes into the manifest
DTYPES = {
    "float32": torch.float32, "float64": torch.float64,
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "int8": torch.int8, "int16": torch.int16, "int32": torch.int32,
    "int64": torch.int64, "uint8": torch.uint8, "bool": torch.bool,
}
_NAMES = {v: k for k, v in DTYPES.items()}


class CheckpointCorruptionError(ValueError):
    """A chunk failed its CRC32 or arrived truncated.  A ValueError, as in
    the reference, so ``except ValueError`` call sites keep working."""


# ---------------------------------------------------------------------------
# tree structure, in JAX's flattening order
# ---------------------------------------------------------------------------
def flatten(tree) -> Tuple[List[Tuple[str, Any]], str]:
    """((path, leaf) pairs in JAX's flattening order, the structure string
    ``str(jax.tree_util.tree_structure(tree))`` gives)."""
    leaves: List[Tuple[str, Any]] = []
    return leaves, f"PyTreeDef({_flatten_walk(tree, '', leaves)})"


# the walks are module-level functions, not closures: a nested function
# that calls itself holds its own cell, a reference cycle that would keep
# every leaf (a train step's whole gradient tree) alive until the next
# collection
def _flatten_walk(node, path: str, leaves: List[Tuple[str, Any]]) -> str:
    if isinstance(node, dict):
        items = []
        for k in sorted(node):
            items.append(f"{k!r}: {_flatten_walk(node[k], f'{path}.{k}', leaves)}")
        return "{" + ", ".join(items) + "}"
    if isinstance(node, list):
        return "[" + ", ".join(_flatten_walk(v, f"{path}[{i}]", leaves)
                               for i, v in enumerate(node)) + "]"
    if isinstance(node, tuple):
        inner = [_flatten_walk(v, f"{path}[{i}]", leaves) for i, v in enumerate(node)]
        return "(" + ", ".join(inner) + ("," if len(inner) == 1 else "") + ")"
    if node is None:
        return "None"
    leaves.append((path, node))
    return "*"


def unflatten(like, leaves: List[Any]):
    """``like``'s structure with its leaves replaced, in flattening
    order."""
    return _unflatten_walk(like, iter(leaves))


def _unflatten_walk(node, it):
    if isinstance(node, dict):
        out = {k: None for k in node}       # keep the caller's key order
        for k in sorted(node):
            out[k] = _unflatten_walk(node[k], it)
        return out
    if isinstance(node, (list, tuple)):
        return type(node)(_unflatten_walk(v, it) for v in node)
    if node is None:
        return None
    return next(it)


def _leaf_meta(leaf) -> Tuple[str, Tuple[int, ...]]:
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype not in _NAMES:
            raise TypeError(f"checkpoint leaves of dtype {leaf.dtype} are not "
                            f"supported")
        return _NAMES[leaf.dtype], tuple(leaf.shape)
    arr = np.asarray(leaf)
    return str(arr.dtype), tuple(arr.shape)


def _num_chunks(nbytes: int, chunk_bytes: int) -> int:
    return max(1, -(-nbytes // chunk_bytes))


def _host_bytes(leaf) -> np.ndarray:
    """A leaf's raw bytes as a flat uint8 array on the host."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().contiguous().to("cpu")
        if t.numel() == 0:
            return np.empty((0,), np.uint8)
        return t.reshape(-1).view(torch.uint8).numpy()
    arr = np.ascontiguousarray(np.asarray(leaf))
    return arr.reshape(-1).view(np.uint8)


# ---------------------------------------------------------------------------
# writing
# ---------------------------------------------------------------------------
def save_checkpoint(path: str, tree: Any, *, step: int = 0,
                    chunk_bytes: int = DEFAULT_CHUNK_BYTES) -> None:
    """Write ``tree`` as manifest + chunked leaf buffers (format 3).

    Leaves are copied to the host one at a time, and each is written as
    ``ceil(nbytes / chunk_bytes)`` bins, each followed by its CRC32; the
    bytes equal those the JAX package writes for the same tree."""
    if chunk_bytes <= 0:
        raise ValueError(f"chunk_bytes must be positive, got {chunk_bytes}")
    leaves, treedef = flatten(tree)
    metas = [_leaf_meta(l) for _, l in leaves]

    def nbytes(dt, shape):
        return int(np.prod(shape, dtype=np.int64)) * \
            torch.empty((), dtype=DTYPES[dt]).element_size()

    manifest = {
        "format": _FORMAT,
        "step": step,
        "treedef": treedef,
        "chunk_bytes": chunk_bytes,
        "leaves": [{"dtype": dt, "shape": list(shape),
                    "chunks": _num_chunks(nbytes(dt, shape), chunk_bytes)}
                   for dt, shape in metas],
    }
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(msgpack_lite.packb(manifest))
        for _, leaf in leaves:
            raw = memoryview(_host_bytes(leaf))
            for c in range(_num_chunks(len(raw), chunk_bytes)):
                payload = raw[c * chunk_bytes:(c + 1) * chunk_bytes]
                f.write(msgpack_lite.bin_header(len(payload)))
                f.write(payload)
                f.write(msgpack_lite.packb(zlib.crc32(payload)))
            del raw


# ---------------------------------------------------------------------------
# reading
# ---------------------------------------------------------------------------
def _read_manifest(unpacker) -> Tuple[dict, int]:
    try:
        manifest = unpacker.unpack()
    except msgpack_lite.OutOfData as e:
        raise CheckpointCorruptionError(f"checkpoint manifest truncated: {e}")
    if not isinstance(manifest, dict) or "leaves" not in manifest:
        raise ValueError("not a checkpoint: the first object is not a "
                         "manifest")
    return manifest, manifest.get("format", 1)


def read_checkpoint_manifest(path: str) -> dict:
    """The manifest alone (no buffers touched)."""
    with open(path, "rb") as f:
        manifest, fmt = _read_manifest(msgpack_lite.Unpacker(f))
    return dict(manifest, format=fmt)


def _validate_manifest(manifest: dict, like: Any):
    """Structure, leaf count, dtype and shape checks before any buffer is
    read (the reference's messages).  Returns ``like``'s (path, leaf)
    pairs."""
    leaves, treedef = flatten(like)
    stored = manifest.get("treedef")
    if stored != treedef:
        raise ValueError(
            f"checkpoint treedef does not match `like`:\n"
            f"  stored:   {stored}\n  expected: {treedef}")
    if len(manifest["leaves"]) != len(leaves):
        raise ValueError(
            f"checkpoint has {len(manifest['leaves'])} leaves, `like` has "
            f"{len(leaves)}")
    for i, (meta, (_, ref)) in enumerate(zip(manifest["leaves"], leaves)):
        ref_dt, ref_shape = _leaf_meta(ref)
        if meta["dtype"] != ref_dt:
            raise ValueError(
                f"checkpoint leaf {i}: dtype {meta['dtype']} != expected "
                f"{ref_dt} (dtypes must match; no silent cast)")
        if tuple(meta["shape"]) != ref_shape:
            raise ValueError(
                f"checkpoint leaf {i}: shape {tuple(meta['shape'])} != "
                f"expected {ref_shape}")
    return leaves


def _read_leaf(unpacker, meta: dict, fmt: int, leaf_idx: int = 0,
               fault_plan=None) -> torch.Tensor:
    """One leaf from its bins, into a fresh host tensor.  Format 3 checks
    each chunk's CRC32.  ``fault_plan``
    (:meth:`repro_torch.resilience.faults.FaultPlan.truncate_chunk`) may
    shorten a chunk before the check, as a torn write would."""
    if meta["dtype"] not in DTYPES:
        raise ValueError(f"checkpoint leaf {leaf_idx}: dtype {meta['dtype']} "
                         f"is not supported")
    dtype = DTYPES[meta["dtype"]]
    shape = tuple(meta["shape"])
    out = torch.empty(shape, dtype=dtype)
    total = out.numel() * out.element_size()
    flat = np.empty((total,), np.uint8)
    n = meta.get("chunks", 1) if fmt >= 2 else 1
    pos = 0
    try:
        for c in range(n):
            size = unpacker.bin_size()
            if fault_plan is not None:
                buf = memoryview(fault_plan.truncate_chunk(
                    leaf_idx, c, unpacker.read(size)))
            elif pos + size <= total:
                buf = memoryview(flat)[pos:pos + size]
                unpacker.readinto(buf)
            else:
                buf = memoryview(unpacker.read(size))
            if fmt >= 3:
                crc = unpacker.unpack()
                if zlib.crc32(buf) != crc:
                    raise CheckpointCorruptionError(
                        f"checkpoint chunk corrupt: leaf {leaf_idx} chunk {c} "
                        f"CRC32 mismatch ({len(buf)} bytes read)")
            if pos + len(buf) > total:
                raise CheckpointCorruptionError(
                    f"checkpoint leaf {leaf_idx} overruns: chunk {c} ends at "
                    f"byte {pos + len(buf)} of {total}")
            if buf.obj is not flat:
                flat[pos:pos + len(buf)] = np.frombuffer(buf, np.uint8)
            pos += len(buf)
    except msgpack_lite.OutOfData as e:
        raise CheckpointCorruptionError(
            f"checkpoint truncated in leaf {leaf_idx}: {e}") from e
    if pos != total:
        raise CheckpointCorruptionError(
            f"checkpoint leaf truncated: read {pos} bytes, expected "
            f"{total} for shape {shape} dtype {meta['dtype']}")
    if total:
        out = torch.from_numpy(flat).view(dtype).reshape(shape)
    return out


def load_checkpoint_leaves(path: str, like: Any = None, *,
                           fault_plan=None) -> Iterator[torch.Tensor]:
    """Stream a checkpoint's leaves one at a time, in flattening order, as
    fresh host tensors; with ``like``, its structure, dtypes and shapes
    are checked before the first leaf is read."""
    with open(path, "rb") as f:
        unpacker = msgpack_lite.Unpacker(f)
        manifest, fmt = _read_manifest(unpacker)
        if like is not None:
            _validate_manifest(manifest, like)
        for i, meta in enumerate(manifest["leaves"]):
            yield _read_leaf(unpacker, meta, fmt, i, fault_plan)


def load_checkpoint(path: str, like: Any, *, device=None,
                    experts: Optional[slice] = None,
                    fault_plan=None) -> Any:
    """Restore into the structure of ``like`` (the port's param tree, or
    one of meta tensors from ``init_dit(cfg, generator=None)``).

    The file's structure, leaf count, dtypes and shapes must equal
    ``like``'s (no silent cast).  Each leaf is read into host memory,
    copied to ``device`` (default: the device of ``like``'s first leaf;
    for meta tensors ``cuda``, raising without a card, as every entry
    point of the port) and its host buffer dropped before the next.
    ``experts`` keeps only those rows of every ``experts_*`` leaf (an ep
    rank's slice), cut before the copy, so a rank never holds the other
    ranks' experts on its device."""
    out = []
    if device is None:
        first = next((l for _, l in flatten(like)[0]
                      if isinstance(l, torch.Tensor)), None)
        device = first.device if first is not None and \
            first.device.type != "meta" else resolve_device(None)
    device = torch.device(device)
    with open(path, "rb") as f:
        unpacker = msgpack_lite.Unpacker(f)
        manifest, fmt = _read_manifest(unpacker)
        leaves = _validate_manifest(manifest, like)
        for i, meta in enumerate(manifest["leaves"]):
            t = _read_leaf(unpacker, meta, fmt, i, fault_plan)
            if experts is not None and \
                    leaves[i][0].rsplit(".", 1)[-1].startswith("experts_"):
                t = t[experts]
            out.append(t.to(device, copy=True) if device.type != "cpu"
                       else t.clone() if experts is not None else t)
            del t
    return unflatten(like, out)
