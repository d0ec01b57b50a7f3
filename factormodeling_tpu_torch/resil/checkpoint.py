"""Versioned, checksummed, atomic snapshot/resume for long-running loops
(port of ``factormodeling_tpu/resil/checkpoint.py``).

The file format is the JAX package's, byte for byte: the ``FMTSNAP1``
magic, an 8-byte big-endian header length, a JSON header (format version,
SHA-256 of the payload, leaf count, the caller's ``meta`` and the tree's
structure) and an embedded ``.npz`` payload of the array leaves. A snapshot
written by either package loads in the other.

- **atomic**: a snapshot writes to a tempfile in the target directory and
  ``os.replace``-s into place, so a kill mid-write leaves the previous
  snapshot whole;
- **checksummed and versioned**: a flipped bit, a truncated tail or another
  format version raises :class:`SnapshotCorrupt`, never a half load;
- **self-describing**: state is a JSON-like tree (dict / list / tuple /
  None / str-int-float-bool leaves) of numpy arrays or tensors, without
  pickle. Tensor leaves are saved as numpy; on load they come back as
  tensors on the device of the ``like`` template's leaf, or on the device
  the caller names (``device=``), never moved to the CPU unasked;
- **retried**: host IO runs under :func:`io_retry`.

``Checkpointer.resume`` matches the snapshot's ``meta`` against the
caller's configuration (``expect_meta``), so a snapshot of another
configuration is skipped with a warning, never resumed into the wrong run.
"""

from __future__ import annotations

import dataclasses
import hashlib
import io
import json
import os
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

from factormodeling_tpu_torch._device import host_array
from factormodeling_tpu_torch.resil.retry import retry_call

__all__ = ["SNAPSHOT_VERSION", "Checkpointer", "SnapshotCorrupt",
           "fingerprint", "io_retry", "load_snapshot", "save_snapshot",
           "tree_leaves"]

#: snapshot format version; loads refuse other versions
SNAPSHOT_VERSION = 1

_MAGIC = b"FMTSNAP1"


class SnapshotCorrupt(RuntimeError):
    """The snapshot file failed validation (magic/version/checksum/
    structure): resume must not trust any of it."""


def fingerprint(*arrays) -> str:
    """Short content hash (dtype + shape + bytes; None hashes as its own
    token) for ``Checkpointer.resume(expect_meta=...)`` guards: two runs of
    equal shapes but other inputs must not share chunks. Tensors on any
    device hash as their host copies, so a tensor and the numpy array of
    the same values give the JAX package's hash."""
    h = hashlib.sha256()
    for a in arrays:
        if a is None:
            h.update(b"\x00none")
            continue
        arr = host_array(a)
        h.update(str(arr.dtype).encode() + b"|" + str(arr.shape).encode())
        h.update(arr.tobytes())
    return h.hexdigest()[:16]


def io_retry(fn, *, retries: int = 3, backoff: float = 0.05,
             exceptions=(OSError,), no_retry=()):
    """Run ``fn()`` with bounded retries and exponential backoff on host-IO
    errors (a thin delegate of :func:`~.retry.retry_call`): the last
    failure propagates and ``no_retry`` exceptions propagate at once."""
    return retry_call(fn, retries=retries, backoff=backoff,
                      exceptions=exceptions, no_retry=no_retry)


def tree_leaves(tree) -> list:
    """The leaves of a tree of dicts (in sorted key order, as JAX flattens
    them), lists, tuples, NamedTuples and dataclasses; ``None`` is an empty
    subtree. The leaf order of :func:`load_snapshot`'s ``like``."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [x for f in dataclasses.fields(tree)
                for x in tree_leaves(getattr(tree, f.name))]
    return [tree]


def _rehang(template, leaves, device):
    """``template``'s structure with its leaves taken in order from the
    iterator ``leaves``; a tensor leaf of the template gets a tensor on its
    device, any other array leaf a tensor on ``device`` when one is named."""
    if template is None:
        return None
    if isinstance(template, dict):
        vals = {k: _rehang(template[k], leaves, device)
                for k in sorted(template)}
        return {k: vals[k] for k in template}
    if isinstance(template, (list, tuple)):
        vals = [_rehang(v, leaves, device) for v in template]
        if hasattr(template, "_fields"):
            return type(template)(*vals)
        return type(template)(vals)
    if dataclasses.is_dataclass(template) and not isinstance(template, type):
        return dataclasses.replace(template, **{
            f.name: _rehang(getattr(template, f.name), leaves, device)
            for f in dataclasses.fields(template)})
    leaf = next(leaves)
    if isinstance(template, torch.Tensor):
        return torch.tensor(np.asarray(leaf), device=template.device)
    return _placed(leaf, device)


def _placed(leaf, device):
    if device is not None and isinstance(leaf, np.ndarray):
        return torch.tensor(leaf, device=device)
    return leaf


def _placed_tree(tree, device):
    if isinstance(tree, dict):
        return {k: _placed_tree(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_placed_tree(v, device) for v in tree)
    return _placed(tree, device)


def _encode(tree, leaves: list):
    """Recursive structure descriptor; array leaves move to ``leaves``."""
    if tree is None:
        return {"t": "none"}
    if isinstance(tree, dict):
        return {"t": "dict", "k": {str(k): _encode(v, leaves)
                                   for k, v in tree.items()}}
    if isinstance(tree, (list, tuple)):
        return {"t": "list" if isinstance(tree, list) else "tuple",
                "v": [_encode(v, leaves) for v in tree]}
    if isinstance(tree, (str, bool, int, float)):
        return {"t": "json", "v": tree}
    arr = host_array(tree)
    if arr.dtype == object:
        raise TypeError(f"snapshot leaves must be arrays or JSON scalars, "
                        f"got object array from {type(tree).__name__}")
    leaves.append(arr)
    return {"t": "leaf", "i": len(leaves) - 1}


def _decode(desc, leaves):
    t = desc["t"]
    if t == "none":
        return None
    if t == "dict":
        return {k: _decode(v, leaves) for k, v in desc["k"].items()}
    if t in ("list", "tuple"):
        out = [_decode(v, leaves) for v in desc["v"]]
        return out if t == "list" else tuple(out)
    if t == "json":
        return desc["v"]
    if t == "leaf":
        return leaves[desc["i"]]
    raise SnapshotCorrupt(f"unknown structure node type {t!r}")


def save_snapshot(path, state, *, meta: dict | None = None,
                  retries: int = 3, backoff: float = 0.05) -> Path:
    """Atomically write ``state`` (a JSON-like tree of array leaves — see
    module docs) plus ``meta`` to ``path``. Returns the path."""
    path = Path(path)
    leaves: list = []
    structure = _encode(state, leaves)
    buf = io.BytesIO()
    np.savez(buf, **{f"L{i}": a for i, a in enumerate(leaves)})
    payload = buf.getvalue()
    header = json.dumps({
        "version": SNAPSHOT_VERSION,
        "sha256": hashlib.sha256(payload).hexdigest(),
        "n_leaves": len(leaves),
        "meta": meta or {},
        "structure": structure,
    }).encode()

    def write():
        path.parent.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=path.parent,
                                   prefix=path.name + ".tmp")
        try:
            with os.fdopen(fd, "wb") as fh:
                fh.write(_MAGIC)
                fh.write(len(header).to_bytes(8, "big"))
                fh.write(header)
                fh.write(payload)
                fh.flush()
                os.fsync(fh.fileno())
            os.replace(tmp, path)   # atomic on POSIX: old snapshot or new,
        finally:                    # never half of either
            if os.path.exists(tmp):
                os.unlink(tmp)
        return path

    return io_retry(write, retries=retries, backoff=backoff)


def load_snapshot(path, *, like=None, device=None, retries: int = 3,
                  backoff: float = 0.05):
    """Validated load: returns ``(state, meta)``. Raises
    :class:`SnapshotCorrupt` on any validation failure (bad magic/version,
    checksum mismatch, truncation, undecodable structure) and
    ``FileNotFoundError`` when the file is absent — callers distinguish
    "never checkpointed" from "checkpoint damaged".

    ``like``: optional template tree; the loaded leaves are re-hung on its
    structure (:func:`tree_leaves` order), recovering typed trees
    (NamedTuples, dataclasses) the structure codec stored as plain
    containers, and each tensor leaf of the template gets a tensor on that
    leaf's device. Leaf COUNT must match the template's. ``device``: array
    leaves that the template does not place (or all of them, without a
    template) come back as tensors on this device; with neither, as the
    numpy arrays the file holds."""
    path = Path(path)
    # a missing file is "never checkpointed", not a transient IO fault:
    # propagate immediately instead of sleeping through the retry ladder
    # (every fresh checkpointed run resolves resume() through this path)
    raw = io_retry(path.read_bytes, retries=retries, backoff=backoff,
                   no_retry=(FileNotFoundError,))
    if len(raw) < len(_MAGIC) + 8 or raw[:len(_MAGIC)] != _MAGIC:
        raise SnapshotCorrupt(f"{path}: missing/garbled snapshot magic")
    hlen = int.from_bytes(raw[len(_MAGIC):len(_MAGIC) + 8], "big")
    hstart = len(_MAGIC) + 8
    if hstart + hlen > len(raw):
        raise SnapshotCorrupt(f"{path}: truncated header")
    try:
        header = json.loads(raw[hstart:hstart + hlen])
    except json.JSONDecodeError as e:
        raise SnapshotCorrupt(f"{path}: undecodable header ({e})") from None
    if header.get("version") != SNAPSHOT_VERSION:
        raise SnapshotCorrupt(
            f"{path}: snapshot version {header.get('version')} != "
            f"supported {SNAPSHOT_VERSION}")
    payload = raw[hstart + hlen:]
    digest = hashlib.sha256(payload).hexdigest()
    if digest != header.get("sha256"):
        raise SnapshotCorrupt(
            f"{path}: payload checksum mismatch (stored "
            f"{str(header.get('sha256'))[:12]}..., computed {digest[:12]}...)"
            " — truncated or bit-flipped snapshot")
    try:
        with np.load(io.BytesIO(payload), allow_pickle=False) as z:
            leaves = [z[f"L{i}"] for i in range(int(header["n_leaves"]))]
        state = _decode(header["structure"], leaves)
    except SnapshotCorrupt:
        raise
    except Exception as e:
        raise SnapshotCorrupt(f"{path}: undecodable payload ({e})") from None
    if like is not None:
        flat = tree_leaves(state)
        n_like = len(tree_leaves(like))
        if len(flat) != n_like:
            raise SnapshotCorrupt(
                f"{path}: {len(flat)} leaves do not fit the template's "
                f"{n_like}")
        state = _rehang(like, iter(flat), device)
    elif device is not None:
        state = _placed_tree(state, device)
    return state, header.get("meta", {})


class Checkpointer:
    """Save/resume convenience over one snapshot path.

    ``every`` thins saves (``maybe_save(i, ...)`` writes on every
    ``every``-th completed index; call :meth:`save` explicitly at loop
    exit if the tail between grid points must not be lost). ``resume``
    returns ``(state, meta)`` or None (no snapshot / config mismatch);
    corruption raises by default — pass ``on_corrupt="discard"`` to warn
    and restart fresh.
    """

    def __init__(self, path, *, every: int = 1, retries: int = 3,
                 backoff: float = 0.05):
        if every < 1:
            raise ValueError(f"every must be >= 1, got {every}")
        self.path = Path(path)
        self.every = int(every)
        self.retries = int(retries)
        self.backoff = float(backoff)

    def save(self, state, *, meta: dict | None = None) -> Path:
        return save_snapshot(self.path, state, meta=meta,
                             retries=self.retries, backoff=self.backoff)

    def maybe_save(self, i: int, state, *, meta: dict | None = None):
        """Save when ``i`` lands on the ``every`` grid (i is 0-based; the
        i-th completed unit of work)."""
        if (i + 1) % self.every == 0:
            return self.save(state, meta=meta)
        return None

    def resume(self, *, like=None, device=None,
               expect_meta: dict | None = None, on_corrupt: str = "raise"):
        """``(state, meta)`` from the snapshot, or None when there is
        nothing valid to resume.

        ``like`` / ``device``: as :func:`load_snapshot`.
        ``expect_meta``: key/value pairs that must match the snapshot's
        meta (config guard) — a mismatch warns and returns None, so a
        snapshot from a different configuration can never be resumed into
        this run. ``on_corrupt``: "raise" (default) propagates
        :class:`SnapshotCorrupt`; "discard" warns and returns None.
        """
        if on_corrupt not in ("raise", "discard"):
            raise ValueError(f"on_corrupt must be 'raise' or 'discard', "
                             f"got {on_corrupt!r}")
        try:
            state, meta = load_snapshot(self.path, like=like, device=device,
                                        retries=self.retries,
                                        backoff=self.backoff)
        except FileNotFoundError:
            return None
        except SnapshotCorrupt as e:
            if on_corrupt == "raise":
                raise
            print(f"warning: discarding corrupt snapshot: {e}",
                  file=sys.stderr)
            return None
        for key, want in (expect_meta or {}).items():
            if meta.get(key) != want:
                print(f"warning: snapshot {self.path} is for a different "
                      f"configuration ({key}={meta.get(key)!r}, expected "
                      f"{want!r}) — starting fresh", file=sys.stderr)
                return None
        return state, meta
