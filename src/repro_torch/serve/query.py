"""Online queries over the live compressed summary (no decompression).

Port of ``repro/serve/query.py``: :class:`SummaryQuery` over a
``BatchedSummarizer`` and :class:`ShardedSummaryQuery` over a
``ShardedSummarizer``.
``neighbors(u)``, ``degree(u)`` and ``has_edge(u, v)`` are answered from
the ``EngineState`` tensors the way Lemma 1 prescribes: membership
lookup (``n2s``), superedge scan over SN(A) under the optimal-encoding
rule ``2e > t + 1``, then the correction patch-up from u's slot list
(``adj``/``epos`` is the correction store).  The composed answer
``(superedge-candidates ∩ listed) ∪ C+-listed`` cross-checks the
summary encoding against the edge store on every query.

The point probes (``eab``, ``epos``, the slot lists) are batched probe
launches, through the same kernel as the write path.

**Sharded reads.**  A query label is hashed (``labelhash``) and resolved
at every position of the summarizer's mesh, on its device, against its
shards' intern tables in one probe launch (:func:`_intern_resolve`), as
JAX's ``shard_map`` query kernels resolve per device; edge partitioning
is a vertex cut, so every shard that knows the node answers there, and
the host merges the answers by union (neighbors), sum (degree) or any
(has_edge: only the pair's owner shard can hold it).

**Snapshots.**  The engine updates its tensors in place, so both views
copy the state when they are created: their answers stay those of
``view.epoch`` while the summarizer goes on.  A checkpoint ``restore()``
(or ``recover()``) on the summarizer fences every view taken before it:
their reads raise ``RuntimeError``, as in the JAX package.
"""
from __future__ import annotations

from typing import List, Sequence, Set, Tuple

import numpy as np
import torch

from repro_torch.core.engine.hashtable import (ht_find_batch,
                                               ht_lookup_batch, probe_many)
from repro_torch.core.engine.ops import host_read, t_of, take
from repro_torch.core.engine.state import (EngineState, copy_state,
                                           state_rows)
from repro_torch.dist import labelhash


# --------------------------------------------------------------------------- #
# engine-id query cores
# --------------------------------------------------------------------------- #


def _neighbors_one(st: EngineState, u: torch.Tensor,
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Lemma-1 neighborhood of one engine-id node (a one-lane tensor) as a
    bool[n_cap] mask, and ``ok``.

    ``u < 0`` or unseen lanes answer an all-False mask with ``ok=False``.
    The scans read exactly ``sndeg(A)`` and ``deg(u)`` slots, one batched
    probe each (one host read for the two counts).
    """
    n_cap = st.n2s.shape[0]
    dev = st.device
    ok = u >= 0
    uu = torch.where(ok, u, 0)
    a = st.n2s[uu]
    ok = ok & (a >= 0)
    a0 = torch.where(ok, a, 0)
    sz_a = st.ssize[a0]

    def pair_is_superedge(b0):
        e = ht_lookup_batch(st.eab, torch.minimum(a0, b0),
                            torch.maximum(a0, b0))
        t = t_of(sz_a, take(st.ssize, b0), a0 == b0)
        return 2 * e > t + 1

    def slot_list(table, key, n):
        sl = torch.arange(n, dtype=torch.int32, device=dev)
        return ht_lookup_batch(table, key.expand(n), sl).clamp(min=0)

    n_sn, n_adj = host_read(torch.cat([torch.where(ok, st.sndeg[a0], 0),
                                       torch.where(ok, st.deg[uu], 0)]))
    # step 2: superedge scan over SN(A) -> candidate supernodes
    se_sid = torch.zeros(n_cap, dtype=torch.bool, device=dev)
    if n_sn:
        b0 = slot_list(st.snadj, a0, n_sn)
        se_sid[b0] = pair_is_superedge(b0)
    cand = se_sid[st.n2s.clamp(min=0)] & (st.n2s >= 0)

    # step 3: correction patch-up from u's slot list (the derived C store):
    # a listed edge whose pair is in C+ mode is a C+ entry; a candidate
    # pair NOT listed is a C- hole (it drops out of cand & listed)
    listed = torch.zeros(n_cap, dtype=torch.bool, device=dev)
    cplus = torch.zeros(n_cap, dtype=torch.bool, device=dev)
    if n_adj:
        w0 = slot_list(st.adj, uu, n_adj)
        listed[w0] = True
        cplus[w0] = ~pair_is_superedge(take(st.n2s, w0))
    return ((cand & listed) | cplus) & ok, ok


def _degree_core(st: EngineState, u: torch.Tensor,
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(degree, ok) per query id; 0 / False for invalid or unseen lanes."""
    ok = u >= 0
    uu = torch.where(ok, u, 0)
    ok = ok & (st.n2s[uu] >= 0)
    return torch.where(ok, st.deg[uu], 0), ok


def _has_edge_core(st: EngineState, u: torch.Tensor, v: torch.Tensor,
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(present, via_superedge, ok) per query pair, batched probes: one
    ``eab`` probe decides the pair's encoding mode, one ``epos`` probe
    consults the correction store."""
    ok = (u >= 0) & (v >= 0) & (u != v)
    uu = torch.where(ok, u, 0)
    vv = torch.where(ok, v, 0)
    a, b = st.n2s[uu], st.n2s[vv]
    ok = ok & (a >= 0) & (b >= 0)
    a0 = torch.where(ok, a, 0)
    b0 = torch.where(ok, b, 0)
    e = ht_lookup_batch(st.eab, torch.minimum(a0, b0), torch.maximum(a0, b0))
    t = t_of(st.ssize[a0], st.ssize[b0], a0 == b0)
    se = (2 * e > t + 1) & ok
    _, listed = ht_find_batch(st.epos, uu, vv)
    return listed & ok, se, ok


# --------------------------------------------------------------------------- #
# host-facing snapshot view
# --------------------------------------------------------------------------- #


def _pad_pow2(a: np.ndarray, fill) -> np.ndarray:
    """Pad a 1-D query array to the next power of two (min 8), as the JAX
    view does, so that batch shapes repeat."""
    n = max(8, 1 << (max(len(a), 1) - 1).bit_length())
    if len(a) == n:
        return a
    return np.concatenate([a, np.full(n - len(a), fill, a.dtype)])


class SummaryQuery:
    """Read view over one ``BatchedSummarizer`` snapshot (caller labels).

    Holds a copy of the engine state and the interned-label horizon at
    construction: labels streamed after ``query()`` raise ``LookupError``
    here, and answers keep matching ``epoch``.
    """

    def __init__(self, summarizer) -> None:
        self._state = summarizer.state.clone()
        self._ids = summarizer._ids          # live dict; horizon pins reads
        self._rev = summarizer._rev
        self._n_seen = len(summarizer._rev)
        self.epoch = summarizer.flush_epoch
        self._summ = summarizer
        self._inc = summarizer._incarnation  # restore fences this view

    def _check_pin(self) -> None:
        """A checkpoint ``restore()`` rewinds the summarizer to a different
        epoch lineage and replaces its label maps; a view pinned before the
        restore would resolve labels against state it was never snapshotted
        from.  Fail loudly instead — take a fresh ``query()`` view."""
        if self._summ._incarnation != self._inc:
            raise RuntimeError(
                f"query view pinned at epoch {self.epoch} predates a "
                f"checkpoint restore on this summarizer; take a fresh "
                f"view with .query()")

    def seen_labels(self) -> List[object]:
        """Labels interned at snapshot time, in encounter order."""
        self._check_pin()
        return list(self._rev[:self._n_seen])

    def _nids(self, labels: Sequence[object]) -> np.ndarray:
        self._check_pin()
        out = np.empty(len(labels), np.int32)
        for i, lab in enumerate(labels):
            nid = self._ids.get(lab)
            if nid is None or nid >= self._n_seen:
                raise LookupError(
                    f"query: label {lab!r} has not been streamed "
                    f"(as of epoch {self.epoch})")
            out[i] = nid
        return out

    def _lanes(self, labels: Sequence[object]) -> torch.Tensor:
        u = _pad_pow2(self._nids(labels), -1)
        return torch.from_numpy(u).to(self._state.device)

    def neighbors_batch(self, labels: Sequence[object]) -> List[Set[object]]:
        u = self._lanes(labels)
        out = []
        for i in range(len(labels)):
            mask, _ = _neighbors_one(self._state, u[i:i + 1])
            out.append({self._rev[w]
                        for w in torch.nonzero(mask).flatten().tolist()})
        return out

    def neighbors(self, label: object) -> Set[object]:
        return self.neighbors_batch([label])[0]

    def degree_batch(self, labels: Sequence[object]) -> List[int]:
        d, _ = _degree_core(self._state, self._lanes(labels))
        return d[:len(labels)].tolist()

    def degree(self, label: object) -> int:
        return self.degree_batch([label])[0]

    def has_edge_batch(self, pairs: Sequence[Tuple[object, object]],
                       ) -> List[bool]:
        u = self._lanes([p[0] for p in pairs])
        v = self._lanes([p[1] for p in pairs])
        present, _, _ = _has_edge_core(self._state, u, v)
        return present[:len(pairs)].tolist()

    def has_edge(self, u: object, v: object) -> bool:
        return self.has_edge_batch([(u, v)])[0]


# --------------------------------------------------------------------------- #
# sharded fan-out
# --------------------------------------------------------------------------- #


def _intern_resolve(ists, hi: torch.Tensor, lo: torch.Tensor,
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Hash words -> ``(local nid, found)``, each ``[R, Q]``, against every
    shard's intern table in one probe launch (prehashed, as the router
    probes them); ``hi < 0`` marks padded query lanes."""
    valid = hi >= 0
    h1 = torch.where(valid, hi, 0)
    h2 = torch.where(valid, lo, 0)
    probed = probe_many([(ist.h2l, h1, h2, True, "find") for ist in ists])
    found = torch.stack([p[1] for p in probed]) & valid
    val = torch.stack([p[2] for p in probed])
    return torch.where(found, val, -1), found


class ShardedSummaryQuery:
    """Read view over one ``ShardedSummarizer`` flush-epoch snapshot.

    Does not flush the dispatch pipeline: on the pipelined router the
    snapshot is the state after ``epoch`` engine stages, one routed chunk
    behind ``process``.  It holds one copy of each mesh position's
    stacked engine and intern states, on that position's device,
    whichever ``replica_exec`` steps them (the engine writes in place, so
    a view without a copy would change under the next ``process``);
    ``copy`` is taken for the JAX package's signature and changes
    nothing.  The snapshot's ``n_dropped`` counters are checked on the
    first answer.
    """

    def __init__(self, summarizer, copy: bool = False) -> None:
        # one clone of each position's stacked replicas; the rows are its
        # views, in shard order
        self._blocks = [(state_rows(copy_state(est)),
                         state_rows(copy_state(ist)))
                        for est, ist in zip(summarizer._est,
                                            summarizer._ist)]
        self._est = [row for rows, _ in self._blocks for row in rows]
        self._ist = [row for _, rows in self._blocks for row in rows]
        self._summ = summarizer
        self._rev_cache: dict = {}
        self._intern_host = None
        self.epoch = summarizer.flush_epoch
        self.n_shards = summarizer.n_shards
        self._inc = summarizer._incarnation  # restore fences this view

    # ------------------------------------------------------------- id space
    # the restore fence: this view resolves nids through the summarizer's
    # live hash -> label map, which a restore replaces with another
    # lineage's
    _check_pin = SummaryQuery._check_pin

    def _gather(self, parts: Sequence[torch.Tensor]) -> list:
        """Each position's ``[n_loc, ...]`` answer, stacked in shard order
        on the first position's device and read in one host read."""
        dev = self._est[0].device
        return host_read(torch.cat([p.to(dev, non_blocking=True)
                                    for p in parts]))

    def _resolve(self, labels: Sequence[object],
                 ) -> Tuple[List[torch.Tensor], np.ndarray]:
        """``(nid, found)`` per shard and label: ``nid[s]`` an ``int32[Q]``
        tensor on shard ``s``'s device (``Q`` padded to a power of two),
        ``found`` ``bool[n_shards, Q]`` on the host; raises
        ``LookupError`` for a label no shard has seen."""
        self._check_pin()
        hi, lo = labelhash.hash_words(list(labels))
        hi, lo = (torch.from_numpy(_pad_pow2(w, -1)) for w in (hi, lo))
        nids, founds = [], []
        for _, ists in self._blocks:
            dev = ists[0].l2h.device
            nid, found = _intern_resolve(ists, hi.to(dev), lo.to(dev))
            nids.extend(nid)
            founds.append(found)
        found = np.array(self._gather(founds), bool)
        self._snapshot_intern()
        seen = found.any(axis=0)
        for i, lab in enumerate(labels):
            if not seen[i]:
                raise LookupError(
                    f"query: label {lab!r} has not been streamed "
                    f"(as of epoch {self.epoch})")
        return nids, found

    def _snapshot_intern(self):
        """Host copy of the snapshot's reverse maps (one read a position,
        memoized); also the capacity tripwire for every answer this view
        serves."""
        if self._intern_host is None:
            n_dropped = sum(int(torch.stack([i.n_dropped for i in ists])
                                .sum()) for _, ists in self._blocks)
            self._summ._raise_if_dropped(n_dropped)
            self._intern_host = ([i.l2h.cpu().numpy() for i in self._ist],
                                 [int(i.n_nodes) for i in self._ist])
        return self._intern_host

    def _rev(self, shard: int) -> List[object]:
        """nid -> caller label for one shard, from the snapshot's intern."""
        if shard not in self._rev_cache:
            self._check_pin()
            l2h, n_nodes = self._snapshot_intern()
            rows = l2h[shard][:n_nodes[shard]]
            self._summ._fold_labels()   # append-only superset map: safe
            h2l = self._summ._h2label
            self._rev_cache[shard] = [
                h2l[int(h)] for h in labelhash.combine(rows[:, 0],
                                                       rows[:, 1])]
        return self._rev_cache[shard]

    def seen_labels(self) -> List[object]:
        """Distinct labels interned in any shard at snapshot time."""
        out, seen = [], set()
        for s in range(self.n_shards):
            for lab in self._rev(s):
                if lab not in seen:
                    seen.add(lab)
                    out.append(lab)
        return out

    # -------------------------------------------------------------- queries
    def neighbors_batch(self, labels: Sequence[object]) -> List[Set[object]]:
        nid, found = self._resolve(labels)
        out: List[Set[object]] = []
        for q in range(len(labels)):
            acc: Set[object] = set()
            for s in np.flatnonzero(found[:, q]):
                mask, _ = _neighbors_one(self._est[s], nid[s][q:q + 1])
                hits = torch.nonzero(mask).flatten().tolist()
                if hits:
                    rev = self._rev(int(s))
                    acc.update(rev[w] for w in hits)
            out.append(acc)
        return out

    def neighbors(self, label: object) -> Set[object]:
        return self.neighbors_batch([label])[0]

    def degree_batch(self, labels: Sequence[object]) -> List[int]:
        nid, _ = self._resolve(labels)
        # per-shard edge partitions are disjoint, so degrees add exactly:
        # each position sums its shards, the first position's device the
        # positions
        dev = self._est[0].device
        d, s = 0, 0
        for rows, _ in self._blocks:
            part = 0
            for st in rows:
                part = part + _degree_core(st, nid[s])[0]
                s += 1
            d = d + part.to(dev)
        return d[:len(labels)].tolist()

    def degree(self, label: object) -> int:
        return self.degree_batch([label])[0]

    def has_edge_by_shard(self, pairs: Sequence[Tuple[object, object]],
                          ) -> np.ndarray:
        """bool[n_shards, len(pairs)]: which shard holds each edge.  At
        most one True per column, the pair's ``shard_key`` owner."""
        nu, _ = self._resolve([p[0] for p in pairs])
        nv, _ = self._resolve([p[1] for p in pairs])
        parts, s = [], 0
        for rows, _ in self._blocks:
            parts.append(torch.stack([
                _has_edge_core(st, nu[s + r], nv[s + r])[0]
                for r, st in enumerate(rows)]))
            s += len(rows)
        return np.array(self._gather(parts), bool)[:, :len(pairs)]

    def has_edge_batch(self, pairs: Sequence[Tuple[object, object]],
                       ) -> List[bool]:
        return [bool(x) for x in self.has_edge_by_shard(pairs).any(axis=0)]

    def has_edge(self, u: object, v: object) -> bool:
        return self.has_edge_batch([(u, v)])[0]
