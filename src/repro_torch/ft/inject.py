"""Fault injection for the crash-consistency layer.

Port of ``repro/ft/inject.py`` over the port's checkpoint modules (the
same file surgery on the same format).  ``tests/test_torch_recovery.py``
and ``chip_smoke.py`` drive these helpers to prove the recovery contract
of :mod:`repro_torch.checkpoint.summary`:

* :func:`drive` feeds a stream chunk-at-a-time with periodic epoch
  checkpoints and can raise :class:`SimulatedCrash` at any chunk boundary
  — the in-process equivalent of ``kill -9`` between dispatches (the
  crashed summarizer object is abandoned; recovery always starts from a
  FRESH summarizer plus the on-disk state, exactly like a real restart);
* the ``*_checkpoint`` / ``*_journal`` helpers corrupt the on-disk state
  the way real crashes and bit rot do: torn staging directories left by a
  death mid-``os.replace``, truncated/duplicated journal tails, flipped
  bytes inside ``arrays.npz`` that only a checksum can catch.

Everything here is deliberately host-side file surgery — no engine
internals are touched, so the harness exercises the same recovery path a
production driver (``repro_torch.launch.stream --resume``) runs.
"""
from __future__ import annotations

import os
from typing import Optional, Sequence

from repro_torch.checkpoint import checkpointer
from repro_torch.checkpoint.journal import _HEADER, _MAGIC, ChunkJournal
from repro_torch.checkpoint.summary import journal_path


class SimulatedCrash(RuntimeError):
    """Raised by :func:`drive` at an injected kill point."""


def drive(summ, stream: Sequence, *, ckpt_every: int = 0,
          kill_at_chunk: Optional[int] = None, start: int = 0) -> int:
    """Feed ``stream[start:]`` through ``summ`` one dispatch chunk at a
    time, checkpointing every ``ckpt_every`` chunks (0 = never).

    ``kill_at_chunk=k`` raises :class:`SimulatedCrash` at the k-th chunk
    boundary of THIS call (before dispatching chunk k) — k = 0 kills
    before any work, k = #chunks kills after the final dispatch but
    before the driver would naturally finish.  Returns the number of
    chunks dispatched.
    """
    size = summ.dispatch_chunk
    stream = list(stream)
    n = 0
    for off in range(start, len(stream), size):
        if kill_at_chunk is not None and n == kill_at_chunk:
            raise SimulatedCrash(f"injected kill at chunk boundary {n}")
        summ.process(stream[off:off + size])
        n += 1
        if ckpt_every and n % ckpt_every == 0:
            summ.save()
    if kill_at_chunk is not None and n == kill_at_chunk:
        raise SimulatedCrash(f"injected kill at final chunk boundary {n}")
    return n


# --------------------------------------------------------------------------- #
# checkpoint faults
# --------------------------------------------------------------------------- #


def _step_dir(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"step_{step:08d}")


def corrupt_checkpoint_arrays(ckpt_dir: str, step: int,
                              offset: int = 256, nbytes: int = 8) -> None:
    """Flip bits inside ``arrays.npz`` — silent corruption that only the
    sha256 in ``meta`` can detect (the file stays a readable npz)."""
    path = os.path.join(_step_dir(ckpt_dir, step), "arrays.npz")
    size = os.path.getsize(path)
    offset = min(offset, max(size - nbytes, 0))
    with open(path, "r+b") as f:
        f.seek(offset)
        chunk = f.read(nbytes)
        f.seek(offset)
        f.write(bytes(b ^ 0xFF for b in chunk))


def drop_checkpoint_file(ckpt_dir: str, step: int,
                         name: str = "arrays.npz") -> None:
    """Remove one payload file — a partially-propagated final directory."""
    os.remove(os.path.join(_step_dir(ckpt_dir, step), name))


def tear_checkpoint_staging(ckpt_dir: str, step: int) -> None:
    """Simulate a crash mid-save, before ``os.replace``: the final
    directory for ``step`` does not exist, only a half-written ``.tmp``
    staging directory (arrays written, no ``meta.json``) is left behind.
    A correct restore must ignore it entirely."""
    import shutil
    final = _step_dir(ckpt_dir, step)
    tmp = final + ".tmp"
    if os.path.isdir(final):   # demote a finished checkpoint to torn state
        shutil.rmtree(tmp, ignore_errors=True)
        os.replace(final, tmp)
        meta = os.path.join(tmp, "meta.json")
        if os.path.exists(meta):
            os.remove(meta)
    else:
        os.makedirs(tmp, exist_ok=True)
        with open(os.path.join(tmp, "arrays.npz"), "wb") as f:
            f.write(b"\x93NUMPY garbage" * 17)


# --------------------------------------------------------------------------- #
# journal faults
# --------------------------------------------------------------------------- #


def truncate_journal_tail(ckpt_dir: str, nbytes: int = 7) -> None:
    """Cut ``nbytes`` off the journal — a torn final append (power loss
    mid-write).  Recovery must keep the valid prefix and stop there."""
    path = journal_path(ckpt_dir)
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.truncate(max(size - nbytes, 0))


def duplicate_journal_tail(ckpt_dir: str) -> None:
    """Re-append the journal's last record verbatim — a crash between the
    durable append and the seq-counter advance.  Replay must dedup it by
    sequence number."""
    path = journal_path(ckpt_dir)
    with open(path, "rb") as f:
        data = f.read()
    off = last = 0
    while off + _HEADER.size <= len(data):
        magic, _seq, length, _crc = _HEADER.unpack_from(data, off)
        if magic != _MAGIC or off + _HEADER.size + length > len(data):
            break
        last, off = off, off + _HEADER.size + length
    with open(path, "ab") as f:
        f.write(data[last:off])
        f.flush()
        os.fsync(f.fileno())


def journal_record_count(ckpt_dir: str) -> int:
    """Well-formed records currently in the journal (fault-free scan)."""
    records, _torn = ChunkJournal(journal_path(ckpt_dir)).scan()
    return len(records)


def latest_checkpoint_step(ckpt_dir: str) -> Optional[int]:
    return checkpointer.latest_step(ckpt_dir)
