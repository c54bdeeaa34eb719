"""Crash-consistent checkpoint/restore/recover for the summarizer tiers.

Port of ``repro/checkpoint/summary.py``, over the port's checkpointer and
journal, with the same closure, manifest, pins and retention: a directory
written by either package is restored or recovered by the other.  The
port's engine writes its tensors in place, so a summarizer's
``_ckpt_tree()`` is a host copy taken at the flushed epoch, and
``_ckpt_apply`` builds fresh tensors; the restore reads shapes and dtypes
from ``_ckpt_like()`` (the live tensors, no copy).

The recovery contract (held bitwise by ``tests/test_torch_recovery.py``,
as ``tests/test_recovery.py`` holds the JAX package's):

    a summarizer killed at ANY chunk boundary and recovered is
    leaf-bitwise equal — EngineState + InternState + telemetry — to the
    run that was never interrupted, and its query answers are identical.

Two mechanisms compose to get there:

* **Epoch checkpoints** — ``flush()`` defines consistent epochs (every
  dispatched chunk fully applied, nothing in flight), and ``save()``
  snapshots the full *recovery closure* at one: the engine state tree
  (``EngineState`` per shard — PRNG position included, ``step_no`` is the
  stream cursor of the trial PRNG), the router's ``InternState``
  (``h2l``/``l2h``), the host-side label closure (hash → label map with
  its lazy buffer folded, or the batched tier's ``_ids``/``_rev``),
  router telemetry, the flush-epoch/journal-seq counters and the stream
  cursor — through the atomic+durable+checksummed
  :mod:`repro_torch.checkpoint.checkpointer`.
* **Chunk journal** — every chunk is durably appended to a write-ahead
  :class:`~repro_torch.checkpoint.journal.ChunkJournal` *before*
  dispatch, and the journal is compacted when a checkpoint lands.
  Recovery restores the newest checkpoint that passes its checksums and
  deterministically replays the journal tail; chunk boundaries fully
  determine padding and the engine-round/PRNG schedule, so the replay is
  bitwise.

The checkpoint **manifest** records the config identity the closure was
taken under; :func:`restore_summarizer` refuses a restore whose pinned
manifest entries (engine config incl. the policy triple, tier,
``n_shards``, ``router_chunk``, drain geometry) differ from the live
summarizer — a mismatched restore would not crash, it would silently
break bitwise replay, which is worse.  Execution *variants* that are
leaf-bitwise state-identical by the standing differential bar —
``replica_exec``, ``trial_backend`` (the port records its probe route),
``routing``, the device count — are recorded informationally but NOT
pinned: a checkpoint taken on a mesh of 8 devices or positions, by
either package, restores onto 1 or 4 (same ``n_shards``; the rows split
over the live mesh), which is the elastic leg.

Retention: the newest :data:`KEEP_EPOCHS` checkpoints are kept and the
journal is compacted to the *oldest* retained checkpoint's sequence
number — so when the newest checkpoint is later found corrupted
(checksum), recovery falls back one epoch and re-earns the present from
the journal instead of loading garbage.
"""
from __future__ import annotations

import os
import pickle
import time
from typing import Optional

from repro_torch.checkpoint import checkpointer
from repro_torch.checkpoint.journal import ChunkJournal

CKPT_CLOSURE_VERSION = 1
KEEP_EPOCHS = 2     # checkpoint fallback depth (journal covers the span)


def journal_path(ckpt_dir: str) -> str:
    return os.path.join(ckpt_dir, "journal.bin")


class ConfigMismatchError(ValueError):
    """The live summarizer's pinned config differs from the checkpoint's."""


def _check_manifest(summ, extra: dict) -> None:
    want = summ._ckpt_manifest()
    saved = extra.get("manifest", {})
    diffs = [f"{key}: checkpoint={saved.get(key)!r} != live={want.get(key)!r}"
             for key in summ._ckpt_pins() if saved.get(key) != want.get(key)]
    if diffs:
        raise ConfigMismatchError(
            "checkpoint/config mismatch — restoring would silently break "
            "the bitwise replay contract:\n  " + "\n  ".join(diffs))


def save_summarizer(summ, ckpt_dir: str) -> str:
    """Write one epoch checkpoint of ``summ``'s recovery closure.

    Flushes the dispatch pipeline first (the epoch must be consistent),
    snapshots tree + host closure + manifest, applies retention, and
    compacts the journal to the oldest retained checkpoint's sequence.
    ``_ckpt_tree()`` copies the state to the host before anything else
    runs: the engine writes its tensors in place.  Its seconds are added
    to ``checkpointer.save_seconds["host_copy"]``.
    """
    flush = getattr(summ, "flush", None)
    if flush is not None:
        flush()
    epoch = int(summ.flush_epoch)
    extra = {"closure_version": CKPT_CLOSURE_VERSION,
             "manifest": summ._ckpt_manifest(),
             "epoch": epoch,
             "journal_seq": int(summ._journal_seq),
             "cursor": int(summ._cursor)}
    t = time.perf_counter()
    tree = summ._ckpt_tree()
    checkpointer._clock("host_copy", t)
    blob = pickle.dumps(summ._ckpt_host(),
                        protocol=pickle.HIGHEST_PROTOCOL)
    path = checkpointer.save(ckpt_dir, epoch, tree,
                             extra=extra, blobs={"host.pkl": blob})
    for s in checkpointer.checkpoint_steps(ckpt_dir)[:-KEEP_EPOCHS]:
        checkpointer.delete_step(ckpt_dir, s)
    # journal compaction: keep every record the oldest retained checkpoint
    # might still need, so a corrupt newest epoch can fall back and replay
    keep_seq = None
    for s in checkpointer.checkpoint_steps(ckpt_dir):
        try:
            e = checkpointer.load_meta(ckpt_dir, s).get("extra", {})
            keep_seq = min(int(e["journal_seq"]),
                           keep_seq if keep_seq is not None else 1 << 62)
        except (OSError, ValueError, KeyError):
            continue
    if keep_seq is not None and os.path.exists(journal_path(ckpt_dir)):
        ChunkJournal(journal_path(ckpt_dir)).truncate(keep_from_seq=keep_seq)
    return path


def restore_summarizer(summ, ckpt_dir: str,
                       step: Optional[int] = None) -> dict:
    """Restore the newest verifiable checkpoint (or ``step``) into ``summ``.

    Torn or corrupted checkpoints (missing files, checksum mismatch,
    unparseable meta) are *rejected* and the previous retained epoch is
    tried instead; a pinned-manifest mismatch raises
    :class:`ConfigMismatchError` immediately (it is a caller bug, not a
    disk fault).  Raises ``FileNotFoundError`` when nothing restorable
    exists.
    """
    steps = checkpointer.checkpoint_steps(ckpt_dir)
    candidates = [step] if step is not None else sorted(steps, reverse=True)
    failures = []
    for s in candidates:
        if not checkpointer.verify(ckpt_dir, s):
            failures.append(
                f"step {s}: integrity check failed (torn or corrupt)")
            continue
        extra = checkpointer.load_meta(ckpt_dir, s).get("extra", {})
        _check_manifest(summ, extra)
        tree = checkpointer.restore(ckpt_dir, s, like=summ._ckpt_like())
        host = pickle.loads(checkpointer.load_blob(ckpt_dir, s, "host.pkl"))
        summ._ckpt_apply(tree, host, extra)
        return dict(step=s, epoch=int(extra["epoch"]),
                    journal_seq=int(extra["journal_seq"]),
                    cursor=int(extra["cursor"]), rejected=failures)
    raise FileNotFoundError(
        f"no restorable checkpoint under {ckpt_dir!r}"
        + (f" — rejected: {'; '.join(failures)}" if failures else ""))


def recover_summarizer(summ, ckpt_dir: str) -> dict:
    """Full crash recovery: restore the last valid epoch, then replay the
    journal tail deterministically.

    Returns a dict with the restored ``epoch``, the number of
    ``replayed_chunks`` and the post-replay stream ``cursor`` — the
    caller resumes feeding the stream from ``cursor``.  A directory with
    no checkpoint at all recovers from scratch via the journal alone
    (a crash before the first checkpoint); a directory whose checkpoints
    are ALL corrupt raises — the journal has been compacted past the
    origin, so a silent from-scratch replay would be wrong.
    """
    try:
        info = restore_summarizer(summ, ckpt_dir)
        from_seq = info["journal_seq"]
    except FileNotFoundError:
        if checkpointer.checkpoint_steps(ckpt_dir):
            raise
        info = dict(step=None, epoch=0, journal_seq=0,
                    cursor=int(summ._cursor), rejected=[])
        from_seq = 0
    summ._recovered = True
    records = ChunkJournal(journal_path(ckpt_dir)).replay(from_seq)
    for _seq, changes in records:
        summ._replay_chunk(changes)
    info["replayed_chunks"] = len(records)
    info["cursor"] = int(summ._cursor)
    return info
