"""Host-side front-end around the batched engine.

Port of the single-engine part of ``repro/core/engine/api.py``:
:class:`BatchedSummarizer` and the state-level exports
(:func:`state_live_edges`, :func:`state_materialize`,
:func:`state_phi_recomputed`).  Crash consistency (checkpoints and the
write-ahead journal) is not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Sequence, Set, Tuple

import numpy as np
import torch

from repro_torch.core.engine.hashtable import TOMB, ht_rebuild
from repro_torch.core.engine.state import (EngineConfig, EngineState,
                                           new_state, state_to_numpy)
from repro_torch.core.engine.trial import step_fn
from repro_torch.core.summary import (SummaryOutput, encoding_cost,
                                      host_node_weight, is_superedge,
                                      pair_key)
from repro_torch.device import resolve_device

Change = Tuple[int, int, bool]


# --------------------------------------------------------------------------- #
# state-level exports (engine-id space, on the host)
# --------------------------------------------------------------------------- #


def _words(t: dict) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    return t["k1"], t["k2"], t["val"]


def _table_arrays(state: EngineState, name: str) -> dict:
    t = getattr(state, name)
    return {w: getattr(t, w).cpu().numpy() for w in ("k1", "k2", "val")}


def _live_edges(arrays: dict) -> Set[Tuple[int, int]]:
    k1, k2, _ = _words(arrays["epos"])
    live = k1 >= 0
    return {(int(a), int(b)) for a, b in zip(k1[live], k2[live]) if a < b}


def state_live_edges(state: EngineState) -> Set[Tuple[int, int]]:
    """Export the live edge set from the slot-position table."""
    return _live_edges({"epos": _table_arrays(state, "epos")})


def _pairs(ma: Set[int], mb: Set[int], same: bool):
    if same:
        mem = sorted(ma)
        for i, u in enumerate(mem):
            for v in mem[i + 1:]:
                yield (u, v)
    else:
        for u in sorted(ma):
            for v in sorted(mb):
                yield (u, v) if u < v else (v, u)


def state_materialize(state: EngineState,
                      cfg: EngineConfig | None = None) -> SummaryOutput:
    """Derive (G*, P, C+, C-) from counts + membership (optimal encoding).

    Lossless under every objective; pass ``cfg`` so a weighted state
    picks each pair's mode by ``is_superedge(W, TW)``.  Asserts that the
    counts agree with the live edge set.
    """
    weighted = cfg is not None and cfg.objective == "weighted"
    arrays = state_to_numpy(state)
    n2s, ssize = arrays["n2s"], arrays["ssize"]
    members: Dict[int, Set[int]] = {}
    for u in np.flatnonzero(n2s >= 0):
        members.setdefault(int(n2s[u]), set()).add(int(u))
    for sid, mem in members.items():
        assert len(mem) == ssize[sid], f"ssize drift at sid {sid}"

    k1, k2, val = _words(arrays["eab"])
    live = k1 >= 0
    edges = _live_edges(arrays)

    if weighted:
        wk1, wk2, wval = _words(arrays["weab"])
        wlive = wk1 >= 0
        wmap = {(int(a), int(b)): int(w)
                for a, b, w in zip(wk1[wlive], wk2[wlive], wval[wlive])}

        def w_of(u: int) -> int:
            return host_node_weight(u, cfg.weight_levels)

    superedges: Set[Tuple[int, int]] = set()
    c_plus: Set[Tuple[int, int]] = set()
    c_minus: Set[Tuple[int, int]] = set()
    for a, b, e in zip(k1[live], k2[live], val[live]):
        a, b, e = int(a), int(b), int(e)
        sa, sb = len(members[a]), len(members[b])
        t = sa * (sa - 1) // 2 if a == b else sa * sb
        pair_edges = list(_pairs(members[a], members[b], a == b))
        actual = [pq for pq in pair_edges if pq in edges]
        assert len(actual) == e, \
            f"eab drift at pair {(a, b)}: {len(actual)} != {e}"
        if weighted:
            wab = wmap.get((a, b), 0)
            w_actual = sum(w_of(p) * w_of(q) for (p, q) in actual)
            assert w_actual == wab, \
                f"weab drift at pair {(a, b)}: {w_actual} != {wab}"
            tw = sum(w_of(p) * w_of(q) for (p, q) in pair_edges)
            mode_super = is_superedge(wab, tw)
        else:
            mode_super = is_superedge(e, t)
        if mode_super:
            superedges.add(pair_key(a, b))
            c_minus.update(pq for pq in pair_edges if pq not in edges)
        else:
            c_plus.update(actual)
    return SummaryOutput(supernodes=members, superedges=superedges,
                         c_plus=c_plus, c_minus=c_minus)


def state_phi_recomputed(state: EngineState,
                         cfg: EngineConfig | None = None) -> int:
    """Refold phi from the live pair table on the host (weighted fold
    when ``cfg`` selects the weighted objective)."""
    weighted = cfg is not None and cfg.objective == "weighted"
    name = "weab" if weighted else "eab"
    k1, k2, val = _words(_table_arrays(state, name))
    if weighted:
        wsum, wsq = state.wsum.cpu().numpy(), state.wsq.cpu().numpy()
    else:
        ssize = state.ssize.cpu().numpy()
    live = k1 >= 0
    tot = 0
    for a, b, e in zip(k1[live], k2[live], val[live]):
        a, b = int(a), int(b)
        if weighted:
            t = ((int(wsum[a]) ** 2 - int(wsq[a])) // 2 if a == b
                 else int(wsum[a]) * int(wsum[b]))
        else:
            sa, sb = int(ssize[a]), int(ssize[b])
            t = sa * (sa - 1) // 2 if a == b else sa * sb
        tot += encoding_cost(int(e), t)
    return tot


# --------------------------------------------------------------------------- #
# single-engine front-end
# --------------------------------------------------------------------------- #


class BatchedSummarizer:
    """Feed a fully dynamic graph stream through the engine step.

    **Id space.** ``process``/``run`` intern arbitrary hashable labels
    (host-side, encounter order) into the engine's dense ``[0, n_cap)``
    ids; outputs stay in engine ids (map through ``self._ids`` /
    ``self._rev``).

    **Device.** The state lives on ``device`` (default ``"cuda"``); the
    table probes run the CUDA kernel there.  With no CUDA device visible
    the constructor raises unless ``device="cpu"`` is passed.
    """

    def __init__(self, cfg: EngineConfig | None = None, *, device="cuda",
                 **overrides) -> None:
        if cfg is None:
            cfg = EngineConfig(**overrides)
        elif overrides:
            cfg = dataclasses.replace(cfg, **overrides)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.state: EngineState = new_state(cfg, self.device)
        self._ids: Dict[object, int] = {}
        self._rev: List[object] = []
        self._epoch = 0             # engine steps applied so far

    # ------------------------------------------------------------------ ids
    def _nid(self, label: object) -> int:
        i = self._ids.get(label)
        if i is None:
            i = len(self._rev)
            if i >= self.cfg.n_cap:
                raise RuntimeError(f"node capacity exceeded: n_cap="
                                   f"{self.cfg.n_cap}")
            self._ids[label] = i
            self._rev.append(label)
        return i

    # --------------------------------------------------------------- stream
    def process(self, changes: Sequence[Change]) -> None:
        b = self.cfg.batch
        changes = list(changes)
        for off in range(0, len(changes), b):
            sl = changes[off:off + b]
            buf = [(self._nid(u), self._nid(v), ins) for (u, v, ins) in sl]
            pad = b - len(buf)
            u = np.array([c[0] for c in buf] + [-1] * pad, np.int32)
            v = np.array([c[1] for c in buf] + [-1] * pad, np.int32)
            ins = np.array([c[2] for c in buf] + [False] * pad, bool)
            step_fn(self.state, u, v, ins, self.cfg)
            self._epoch += 1

    def run(self, stream: Iterable[Change]) -> "BatchedSummarizer":
        self.process(list(stream))
        return self

    def flush(self) -> None:
        """Barrier: waits for the device to finish the queued steps."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ---------------------------------------------------------------- reads
    @property
    def flush_epoch(self) -> int:
        """Engine steps applied to ``state`` so far."""
        return self._epoch

    def query(self):
        """Snapshot read view (``neighbors``/``degree``/``has_edge`` in
        caller-label space, :mod:`repro_torch.serve.query`).  The view
        holds a copy of the state: the engine updates in place."""
        from repro_torch.serve.query import SummaryQuery
        return SummaryQuery(self)

    # ------------------------------------------------------------ maintenance
    def _tables(self) -> Tuple[str, ...]:
        tables = ("adj", "epos", "eab", "snadj", "snpos")
        if self.cfg.objective == "weighted":
            tables += ("weab",)
        return tables

    def table_pressure(self) -> Dict[str, float]:
        """live+tombstone slot fraction per table (probe-chain health)."""
        out = {}
        for name in self._tables():
            k1 = getattr(self.state, name).k1
            out[name] = float(((k1 >= 0) | (k1 == TOMB)).float().mean())
        return out

    def maybe_compact(self, threshold: float = 0.7) -> bool:
        """Rebuild tables whose occupied fraction (live + tombstones)
        crosses ``threshold``."""
        dirty = [n for n, p in self.table_pressure().items() if p > threshold]
        for name in dirty:
            setattr(self.state, name, ht_rebuild(getattr(self.state, name)))
        return bool(dirty)

    # ---------------------------------------------------------------- stats
    @property
    def phi(self) -> int:
        return int(self.state.phi)

    @property
    def num_edges(self) -> int:
        return int(self.state.num_edges)

    def compression_ratio(self) -> float:
        e = self.num_edges
        return float(self.phi) / e if e else 0.0

    def stats(self) -> dict:
        s = self.state
        return dict(phi=int(s.phi), num_edges=int(s.num_edges),
                    trials=int(s.n_trials), accepted=int(s.n_accept),
                    skipped=int(s.n_skipped))

    # ------------------------------------------------------------ materialize
    def live_edges(self) -> Set[Tuple[int, int]]:
        return state_live_edges(self.state)

    def materialize(self) -> SummaryOutput:
        return state_materialize(self.state, self.cfg)

    def phi_recomputed(self) -> int:
        return state_phi_recomputed(self.state, self.cfg)
