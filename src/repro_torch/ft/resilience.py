"""Fault-tolerance runtime pieces: stragglers, elastic re-mesh, retry loops.

A copy of ``repro/ft/resilience.py`` (which imports no framework), with
the recovery driver reaching the port's ``checkpoint`` and ``ft.inject``.

On a real multi-pod fleet these hooks sit in the launcher process:
  * StragglerDetector - robust per-step timing outlier detection; persistent
    stragglers trigger a re-shard plan that excludes the slow host group.
  * plan_elastic_mesh - given surviving device count, pick the largest valid
    (data, model) mesh <= survivors and emit the reshard plan the
    checkpointer executes (restore under new shardings).
  * run_with_retries - step-loop wrapper: on failure, restore latest
    checkpoint and continue (crash-equivalent restart without job loss).
  * run_stream_with_recovery - the streaming-shaped sibling for the
    summarizer tiers: epoch checkpoints + chunk-journal recovery
    (``repro_torch.checkpoint.summary``) with bounded exponential backoff,
    wired into ``launch/stream.py --checkpoint-dir``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple


@dataclasses.dataclass
class StragglerDetector:
    """Flags hosts whose step time is a robust outlier (median + k*MAD)."""
    k: float = 4.0
    window: int = 32
    min_samples: int = 8
    history: Dict[str, List[float]] = dataclasses.field(default_factory=dict)

    def record(self, host: str, step_time: float) -> None:
        h = self.history.setdefault(host, [])
        h.append(step_time)
        if len(h) > self.window:
            del h[0]

    def stragglers(self) -> List[str]:
        latest = {h: v[-1] for h, v in self.history.items()
                  if len(v) >= self.min_samples}
        if len(latest) < 2:
            return []
        vals = sorted(latest.values())
        med = vals[len(vals) // 2]
        mad = sorted(abs(v - med) for v in vals)[len(vals) // 2]
        thr = med + self.k * max(mad, 0.05 * med, 1e-6)
        return [h for h, v in latest.items() if v > thr]


def plan_elastic_mesh(n_survivors: int, model_parallel: int,
                      ) -> Optional[Tuple[int, int]]:
    """Largest (data, model) mesh that fits the surviving chips.

    Model-parallel degree is preserved (param layout constraint); the data
    axis shrinks to the largest multiple that fits.  Returns None when not
    even one model-parallel group survives.
    """
    if n_survivors < model_parallel:
        return None
    return (n_survivors // model_parallel, model_parallel)


def rebalance_batch(global_batch: int, n_data_shards: int) -> List[int]:
    """Deterministic near-even batch re-slicing after a shrink."""
    base = global_batch // n_data_shards
    extra = global_batch % n_data_shards
    return [base + (1 if i < extra else 0) for i in range(n_data_shards)]


def run_with_retries(step: Callable[[int], None], save_fn: Callable[[int], None],
                     restore_fn: Callable[[], int], n_steps: int,
                     ckpt_every: int = 100, max_failures: int = 3) -> int:
    """Crash-tolerant step loop: failures roll back to the last checkpoint."""
    failures = 0
    i = restore_fn()
    while i < n_steps:
        try:
            step(i)
            i += 1
            if i % ckpt_every == 0:
                save_fn(i)
        except Exception:
            failures += 1
            if failures > max_failures:
                raise
            i = restore_fn()
    return i


def run_stream_with_recovery(make_summarizer: Callable[[], object],
                             stream: Sequence, ckpt_dir: str, *,
                             ckpt_every: int = 16,
                             resume: bool = False,
                             max_failures: int = 3,
                             base_backoff_s: float = 0.05,
                             max_backoff_s: float = 2.0,
                             sleep: Callable[[float], None] = time.sleep):
    """Crash-tolerant streaming driver over a checkpointing summarizer.

    Feeds ``stream`` one dispatch chunk at a time, checkpointing every
    ``ckpt_every`` chunks.  When a chunk fails, the (possibly torn) live
    summarizer is ABANDONED — recovery never trusts in-memory state after
    a fault — and a fresh one from ``make_summarizer()`` restores the
    latest valid epoch, replays the journal tail
    (``repro_torch.checkpoint.summary.recover_summarizer``) and resumes from
    the recovered stream cursor after a bounded exponential backoff.
    ``resume=True`` recovers before the first chunk too (the
    ``launch/stream.py --resume`` path).

    Retries are counted on the summarizer's ``stream_retries`` telemetry
    (reported by ``stats()`` alongside ``router_overflows`` /
    ``router_syncs``); the counter survives summarizer rebuilds but is
    deliberately NOT part of the checkpoint closure — it counts the
    recoveries themselves, so the bitwise recovery bar excludes it.

    Returns the finished summarizer (a final ``save()`` epoch included
    when ``ckpt_every > 0``).
    """
    from repro_torch.ft.inject import drive

    stream = list(stream)
    failures = 0

    def fresh(recover: bool):
        s = make_summarizer()
        if s._ckpt_dir is None:
            s._ckpt_dir = ckpt_dir
        if recover:
            s.recover()
        s.stream_retries = failures
        return s

    summ = fresh(recover=resume)
    while True:
        try:
            drive(summ, stream, ckpt_every=ckpt_every, start=summ.stream_cursor)
            if ckpt_every:
                summ.save()
            return summ
        except Exception:
            failures += 1
            if failures > max_failures:
                raise
            sleep(min(base_backoff_s * (2 ** (failures - 1)), max_backoff_s))
            summ = fresh(recover=True)
