"""Host reference for the online query path (the differential oracle).

Copy of ``repro/core/reference/summary_query.py`` (plain Python).

Answers ``neighbors``/``degree``/``has_edge`` from a materialized
:class:`SummaryOutput` (or union-of-parts :class:`ShardedSummaryOutput`)
by walking the output representation itself — membership lookup,
superedge scan, correction patch-up (Lemma 1) — and NEVER by
``decode_edges()``.  Tests triangulate three independent answers per
query: this oracle over the materialized summary, the device kernels in
:mod:`repro_torch.serve.query` over live engine state, and the edge set from
``decode_edges()``; all three must agree exactly.
"""
from __future__ import annotations

from typing import Dict, List, Set

from repro_torch.core.summary import (Pair, ShardedSummaryOutput,
                                      SummaryOutput, pair_key)


class _Part:
    """Lemma-1 indexes for one summary part (one shard's output)."""

    def __init__(self, out: SummaryOutput) -> None:
        self.members: Dict[int, Set[int]] = {
            sid: set(mem) for sid, mem in out.supernodes.items()}
        self.node2sid: Dict[int, int] = {}
        for sid, mem in self.members.items():
            for u in mem:
                self.node2sid[u] = sid
        self.psn: Dict[int, Set[int]] = {}   # sid -> P-neighbor sids
        for (a, b) in out.superedges:
            self.psn.setdefault(a, set()).add(b)
            self.psn.setdefault(b, set()).add(a)
        self.cplus: Dict[int, Set[int]] = {}
        for (u, v) in out.c_plus:
            self.cplus.setdefault(u, set()).add(v)
            self.cplus.setdefault(v, set()).add(u)
        self.cminus: Dict[int, Set[int]] = {}
        for (u, v) in out.c_minus:
            self.cminus.setdefault(u, set()).add(v)
            self.cminus.setdefault(v, set()).add(u)
        self.c_plus_pairs: Set[Pair] = {pair_key(u, v) for (u, v) in out.c_plus}
        self.c_minus_pairs: Set[Pair] = {pair_key(u, v)
                                         for (u, v) in out.c_minus}
        self.superedges: Set[Pair] = set(out.superedges)

    def neighbors(self, u: int) -> Set[int]:
        """N(u) = (members of P-neighbors of S_u  \\  C-(u)) ∪ C+(u)."""
        res: Set[int] = set(self.cplus.get(u, ()))
        for sid in self.psn.get(self.node2sid[u], ()):
            res |= self.members[sid]
        res.discard(u)
        res -= self.cminus.get(u, set())
        return res

    def has_edge(self, u: int, v: int) -> bool:
        p = pair_key(u, v)
        if p in self.c_minus_pairs:
            return False
        if p in self.c_plus_pairs:
            return True
        if u not in self.node2sid or v not in self.node2sid:
            return False
        return pair_key(self.node2sid[u], self.node2sid[v]) in self.superedges


class SummaryQueryOracle:
    """Query reference over a materialized (possibly sharded) summary.

    A sharded output is a union of parts over disjoint edge partitions, so
    per-part answers merge by union (neighbors) / any (has_edge); a label
    present in no part raises ``LookupError`` — the same contract the
    device views pin.
    """

    def __init__(self, out) -> None:
        shards = out.shards if isinstance(out, ShardedSummaryOutput) else [out]
        self._parts: List[_Part] = [_Part(s) for s in shards]

    def _parts_of(self, u) -> List[_Part]:
        parts = [p for p in self._parts if u in p.node2sid]
        if not parts:
            raise LookupError(f"query: label {u!r} is in no summary part")
        return parts

    def neighbors(self, u) -> Set[int]:
        res: Set[int] = set()
        for p in self._parts_of(u):
            res |= p.neighbors(u)
        return res

    def degree(self, u) -> int:
        return len(self.neighbors(u))

    def has_edge(self, u, v) -> bool:
        self._parts_of(u)
        parts_v = self._parts_of(v)
        if u == v:
            return False
        return any(p.has_edge(u, v) for p in parts_v)
