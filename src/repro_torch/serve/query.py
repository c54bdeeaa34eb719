"""Online queries over the live compressed summary (no decompression).

Port of the single-engine part of ``repro/serve/query.py``.
``neighbors(u)``, ``degree(u)`` and ``has_edge(u, v)`` are answered from
the ``EngineState`` tensors the way Lemma 1 prescribes: membership
lookup (``n2s``), superedge scan over SN(A) under the optimal-encoding
rule ``2e > t + 1``, then the correction patch-up from u's slot list
(``adj``/``epos`` is the correction store).  The composed answer
``(superedge-candidates ∩ listed) ∪ C+-listed`` cross-checks the
summary encoding against the edge store on every query.

The point probes (``eab``, ``epos``, the slot lists) are batched probe
launches, through the same kernel as the write path.

**Snapshots.**  The engine updates its tensors in place, so
:class:`SummaryQuery` copies the state when it is created: its answers
stay those of ``view.epoch`` while the summarizer goes on.
"""
from __future__ import annotations

from typing import List, Sequence, Set, Tuple

import numpy as np
import torch

from repro_torch.core.engine.hashtable import ht_find_batch, ht_lookup_batch
from repro_torch.core.engine.ops import host_read, t_of, take
from repro_torch.core.engine.state import EngineState


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

    def seen_labels(self) -> List[object]:
        """Labels interned at snapshot time, in encounter order."""
        return list(self._rev[:self._n_seen])

    def _nids(self, labels: Sequence[object]) -> np.ndarray:
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
