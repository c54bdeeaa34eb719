"""Fault-tolerant checkpointing: atomic, durable, verified, resumable.

Port of ``repro/checkpoint/checkpointer.py`` with the same on-disk format,
so that either package restores the other's checkpoints:
``<dir>/step_<n:08d>/arrays.npz`` (one archive member per tree leaf, under
the key JAX's ``tree_flatten_with_path`` gives it), ``meta.json`` (step,
sorted keys, ``format_version``, a sha256 per payload file, ``extra``) and
any named blobs beside them.

* atomic: write to ``<dir>.tmp`` then ``os.replace`` (a crashed writer never
  corrupts the last good step);
* durable: every staged file is fsynced, and so are the staging directory
  and the parent directory around the ``os.replace``, so the rename
  survives power loss;
* verified: ``meta.json`` carries a sha256 per payload file, so a torn or
  bit-rotted checkpoint is *detected* at restore time (``verify``) and
  callers fall back to the previous step (``latest_valid_step`` /
  ``valid_steps``);
* resumable: latest-step discovery + data-cursor restore; ``restore`` puts
  every leaf on the device it is given.

**Tree paths.**  A tree is nested mappings, dataclasses, named tuples,
lists and tuples with numpy arrays or tensors as leaves.  A mapping key
renders bare and in sorted order, a dataclass or named-tuple field with a
leading dot (JAX's ``GetAttrKey``), a sequence index as its number; each
component is percent-encoded (``/`` and ``%`` escaped) before the ``/``
join, so ``("a/b",)`` and ``("a", "b")`` never alias.  So
``{"est": {"adj": HashTable(k1, k2, val)}}`` flattens to ``est/adj/.k1``,
``est/adj/.k2``, ``est/adj/.val`` in both packages.

:data:`save_seconds` accumulates the seconds of each phase of
:func:`save` (``savez``, ``fsync``, ``sha256``, ``blobs``, ``meta``) for a
caller that clears it before a save and reads it after.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import shutil
import time
from typing import Any, Dict, List, Mapping, Optional, Tuple
from urllib.parse import quote

import numpy as np
import torch

CKPT_FORMAT_VERSION = 2   # bumped when the on-disk layout changes

#: seconds per phase of :func:`save`, accumulated across calls
save_seconds: Dict[str, float] = {}


def _clock(phase: str, t0: float) -> float:
    now = time.perf_counter()
    save_seconds[phase] = save_seconds.get(phase, 0.0) + now - t0
    return now


def _children(node) -> Optional[List[Tuple[str, Any]]]:
    """``(path component, child)`` pairs of an inner node in JAX's order,
    or ``None`` for a leaf."""
    if isinstance(node, Mapping):
        return [(str(k), node[k]) for k in sorted(node)]
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return [(f".{f.name}", getattr(node, f.name))
                for f in dataclasses.fields(node)]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return [(f".{name}", getattr(node, name)) for name in node._fields]
    if isinstance(node, (list, tuple)):
        return [(str(i), x) for i, x in enumerate(node)]
    return None


def _flatten_paths(tree, prefix: Tuple[str, ...] = ()):
    kids = _children(tree)
    if kids is None:
        yield prefix, tree
        return
    for name, child in kids:
        yield from _flatten_paths(child, prefix + (name,))


def _path_key(path: Tuple[str, ...]) -> str:
    """Collision-proof archive key: each component percent-encoded, then
    joined with ``/``."""
    return "/".join(quote(p, safe="") for p in path)


def _flatten(tree) -> Dict[str, Any]:
    return {_path_key(path): leaf for path, leaf in _flatten_paths(tree)}


def _unflatten(tree, leaves: Dict[Tuple[str, ...], Any],
               prefix: Tuple[str, ...] = ()):
    """``tree``'s structure with each leaf replaced by ``leaves[path]``."""
    kids = _children(tree)
    if kids is None:
        return leaves[prefix]
    new = {name: _unflatten(child, leaves, prefix + (name,))
           for name, child in kids}
    if isinstance(tree, Mapping):
        return {k: new[str(k)] for k in tree}
    if dataclasses.is_dataclass(tree):
        return type(tree)(**{f.name: new[f".{f.name}"]
                             for f in dataclasses.fields(tree)})
    if hasattr(tree, "_fields"):
        return type(tree)(*(new[f".{n}"] for n in tree._fields))
    return type(tree)(new[str(i)] for i in range(len(tree)))


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _numpy_dtype(dtype) -> np.dtype:
    if isinstance(dtype, torch.dtype):
        return torch.empty(0, dtype=dtype).numpy().dtype
    return np.dtype(dtype)


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def _fsync_path(path: str) -> None:
    """fsync a file or directory (directory fsync persists the entry list,
    which is what makes a rename durable on power loss)."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _write_file(path: str, data: bytes) -> None:
    with open(path, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())


def save(ckpt_dir: str, step: int, tree, extra: Optional[dict] = None,
         blobs: Optional[Dict[str, bytes]] = None) -> str:
    """Write one atomic, durable checkpoint at ``<ckpt_dir>/step_<n>``.

    Tensor leaves are copied to the host.  ``blobs`` are opaque byte
    payloads stored beside the array archive (host-side closures such as
    label maps); each is checksummed in ``meta`` like ``arrays.npz`` and
    read back with :func:`load_blob`.
    """
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    arrays = {k: _to_numpy(v) for k, v in _flatten(tree).items()}
    archive = os.path.join(tmp, "arrays.npz")
    t = time.perf_counter()
    np.savez(archive, **arrays)
    t = _clock("savez", t)
    _fsync_path(archive)
    t = _clock("fsync", t)
    checksums = {"arrays.npz": _sha256(archive)}
    t = _clock("sha256", t)
    for name, data in (blobs or {}).items():
        assert name not in ("arrays.npz", "meta.json"), name
        _write_file(os.path.join(tmp, name), data)
        checksums[name] = _sha256(os.path.join(tmp, name))
    t = _clock("blobs", t)
    meta = {"step": step, "keys": sorted(arrays),
            "format_version": CKPT_FORMAT_VERSION,
            "checksums": checksums,
            "extra": extra or {}}
    _write_file(os.path.join(tmp, "meta.json"),
                json.dumps(meta).encode("utf-8"))
    _fsync_path(tmp)                       # staged entries are on disk
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    _fsync_path(ckpt_dir)                  # the rename itself is durable
    _clock("meta", t)
    return final


def checkpoint_steps(ckpt_dir: str) -> List[int]:
    """All step numbers with a (not necessarily valid) final directory."""
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
                  if d.startswith("step_") and not d.endswith(".tmp"))


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = checkpoint_steps(ckpt_dir)
    return max(steps) if steps else None


def verify(ckpt_dir: str, step: int) -> bool:
    """True iff the checkpoint's files are present and match their
    recorded sha256 checksums (torn writes and bit rot are *detected*,
    never silently restored).  Pre-checksum checkpoints
    (``format_version`` < 2) verify on file presence only.
    """
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    try:
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
    except (OSError, ValueError):
        return False
    checksums = meta.get("checksums")
    if checksums is None:                  # legacy format: presence only
        return os.path.exists(os.path.join(path, "arrays.npz"))
    try:
        return all(_sha256(os.path.join(path, name)) == want
                   for name, want in checksums.items())
    except OSError:
        return False


def valid_steps(ckpt_dir: str) -> List[int]:
    """Ascending step numbers whose checkpoints pass :func:`verify`."""
    return [s for s in checkpoint_steps(ckpt_dir) if verify(ckpt_dir, s)]


def latest_valid_step(ckpt_dir: str) -> Optional[int]:
    steps = valid_steps(ckpt_dir)
    return max(steps) if steps else None


def delete_step(ckpt_dir: str, step: int) -> None:
    """Remove one checkpoint directory (retention policy helper)."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    if os.path.isdir(path):
        shutil.rmtree(path)


def restore(ckpt_dir: str, step: int, like, device=None):
    """Restore into the structure of ``like`` (leaves: anything with
    ``shape`` and ``dtype``, a tensor or a numpy array).

    Each archive member must have its ``like`` leaf's shape and is cast to
    its dtype; it comes back as a tensor on ``device``, or as a numpy
    array when ``device`` is ``None``.
    """
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    leaves = {}
    with np.load(os.path.join(path, "arrays.npz")) as data:
        for p, leaf in _flatten_paths(like):
            key = _path_key(p)
            arr = data[key]
            assert arr.shape == tuple(leaf.shape), f"shape mismatch at {key}"
            arr = arr.astype(_numpy_dtype(leaf.dtype), copy=False)
            leaves[p] = (arr if device is None
                         else torch.from_numpy(arr).to(device))
    return _unflatten(like, leaves)


def load_meta(ckpt_dir: str, step: int) -> dict:
    path = os.path.join(ckpt_dir, f"step_{step:08d}", "meta.json")
    with open(path) as f:
        return json.load(f)


def load_blob(ckpt_dir: str, step: int, name: str) -> bytes:
    """Read back one named blob written by :func:`save`."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}", name)
    with open(path, "rb") as f:
        return f.read()
