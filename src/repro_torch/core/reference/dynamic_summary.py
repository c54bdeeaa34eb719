"""Faithful dynamic lossless-summary state machine (Tier A).

Copy of ``repro/core/reference/dynamic_summary.py`` (plain Python).

This module maintains the *exact* output representation of the paper —
summary graph ``G* = (S, P)`` and corrections ``C = (C+, C-)`` — under three
mutations:

* ``insert(u, v)`` / ``delete(u, v)``: one change of the fully dynamic stream,
* ``move(y, target_sid)``: move node ``y`` into another supernode (the basic
  step of every MoSSo variant, Sect. 3.1).

Faithfulness notes
------------------
* Neighborhoods are retrieved from the representation itself exactly as in
  Lemma 1 (C+(u) ∪ members of P-neighbours of S_u, minus C-(u)); the raw edge
  set is never stored.  Memory is therefore O(|V| + |P| + |C+| + |C-|) plus
  the per-pair edge counts ``E_AB`` that the paper's own implementation also
  keeps (proof of Thm. 4).
* ``phi`` is maintained incrementally and equals |P| + |C+| + |C-| at all
  times (asserted in tests against the materialized representation).
* ``delta_phi(y, target)`` is the closed-form objective change of a move used
  by all algorithm variants; tests check it equals the phi difference of
  actually applying the move.

Objective hooks
---------------
All phi accounting below is written in the WEIGHTED generalization — per
pair, the live weight ``W_AB`` against the total pair weight ``TW_AB``,
with the optimal rule ``cost(W, TW) = min(W, TW - W + 1)`` unchanged —
routed through overridable ``_w*`` hooks.  The base class's hooks return
the unweighted counts (w(u) = 1, W = E, TW = T), making it *literally the
same integers* as the historical exact-objective code; the
:class:`WeightedDynamicSummary` subclass supplies hashed node weights and
is the host reference for the engine's ``objective="weighted"``
(``tests/test_policies.py`` pins the uniform-weights bit-identity).
"""
from __future__ import annotations

import itertools
from typing import Callable, Dict, Iterable, List, Optional, Set, Tuple

from repro_torch.core.summary import (Pair, SummaryOutput, encoding_cost,
                                      is_superedge, pair_key, t_count)


def _wtri(sw: int, sq: int) -> int:
    """Total self-pair weight (SW^2 - SQ) / 2; equals T(s, s) when w == 1."""
    return (sw * sw - sq) // 2


class DynamicSummary:
    """Incrementally maintained (G*, C) with optimal per-pair encoding."""

    def __init__(self) -> None:
        self.n2s: Dict[int, int] = {}                # node -> supernode id
        self.members: Dict[int, Set[int]] = {}       # sid -> nodes
        self.deg: Dict[int, int] = {}                # node degree in G
        self.eab: Dict[Pair, int] = {}               # pair -> |E_AB| (>0 only)
        self.sn: Dict[int, Set[int]] = {}            # sid -> sids with E>0
        self.P: Set[Pair] = set()                    # superedges
        self.psn: Dict[int, Set[int]] = {}           # sid -> P-neighbour sids
        self.cplus: Dict[int, Set[int]] = {}         # node -> C+ neighbours
        self.cminus: Dict[int, Set[int]] = {}        # node -> C- neighbours
        self.phi: int = 0
        self.num_edges: int = 0
        self._next_sid: int = 0

    # ------------------------------------------------------------------ nodes
    def ensure_node(self, u: int) -> None:
        if u in self.n2s:
            return
        sid = self._next_sid
        self._next_sid += 1
        self.n2s[u] = sid
        self.members[sid] = {u}
        self.deg[u] = 0
        self.sn[sid] = set()
        self.psn[sid] = set()
        self.cplus[u] = set()
        self.cminus[u] = set()

    def supernode_of(self, u: int) -> int:
        return self.n2s[u]

    def size(self, sid: int) -> int:
        return len(self.members[sid])

    # -------------------------------------------------------------- internals
    def _t(self, a: int, b: int) -> int:
        return t_count(len(self.members[a]), len(self.members[b]), a == b)

    def _count(self, a: int, b: int) -> int:
        return self.eab.get(pair_key(a, b), 0)

    # ------------------------------------------------------- objective hooks
    # The base hooks realize the exact objective: weight 1 per node, so
    # every weighted quantity collapses to its count (same ints, same phi).
    def _w(self, u: int) -> int:
        """Node weight w(u)."""
        return 1

    def _wcount(self, a: int, b: int) -> int:
        """W_AB = sum of w(u)w(v) over live edges of the pair."""
        return self._count(a, b)

    def _bump_wcount(self, a: int, b: int, delta: int) -> None:
        """Maintain W_AB on edge add/remove (no-op when W == E)."""

    def _wsize(self, sid: int) -> int:
        """SW = sum of member weights."""
        return len(self.members.get(sid, ()))

    def _wsq(self, sid: int) -> int:
        """SQ = sum of squared member weights."""
        return len(self.members.get(sid, ()))

    def _wt(self, a: int, b: int) -> int:
        """TW_AB = total pair weight (T under uniform weights)."""
        return self._t(a, b)

    def move_hist(self, y: int) -> Dict[int, int]:
        """Per-supernode mass of y's edges under the objective: the input
        ``h`` of :meth:`delta_phi` (weighted: w(y)w(nbr) sums; exact:
        :meth:`neighbor_hist` counts)."""
        return self.neighbor_hist(y)

    def _member_pairs(self, a: int, b: int) -> Iterable[Pair]:
        if a == b:
            return itertools.combinations(sorted(self.members[a]), 2)
        return itertools.product(sorted(self.members[a]), sorted(self.members[b]))

    def _edge_list(self, a: int, b: int) -> List[Pair]:
        """Recover E_AB from the current encoding of pair (a, b)."""
        p = pair_key(a, b)
        if p in self.P:
            return [(u, v) for (u, v) in self._member_pairs(a, b)
                    if v not in self.cminus[u]]
        # C+ mode: walk the smaller side.
        if a == b:
            mem = self.members[a]
            out = []
            for u in mem:
                for v in self.cplus[u]:
                    if v in mem and u < v:
                        out.append((u, v))
            return out
        if len(self.members[a]) > len(self.members[b]):
            a, b = b, a
        memb = self.members[b]
        return [(u, v) for u in self.members[a] for v in self.cplus[u] if v in memb]

    def _set_count(self, a: int, b: int, new: int) -> None:
        """Update E_AB and the supernode-adjacency index; phi via callers."""
        p = pair_key(a, b)
        old = self.eab.get(p, 0)
        if new == old:
            return
        if new == 0:
            self.eab.pop(p, None)
            if old > 0:
                self.sn[a].discard(b)
                self.sn[b].discard(a)
        else:
            self.eab[p] = new
            if old == 0:
                self.sn[a].add(b)
                self.sn[b].add(a)

    def _reencode(self, a: int, b: int) -> None:
        """Flip the materialized encoding of pair (a,b) if the rule says so.

        phi is *not* touched here: cost() is mode-independent (the min).
        """
        p = pair_key(a, b)
        want = is_superedge(self._wcount(a, b), self._wt(a, b))
        have = p in self.P
        if want == have:
            return
        edges = self._edge_list(a, b)
        if want:
            for (u, v) in edges:
                self.cplus[u].discard(v)
                self.cplus[v].discard(u)
            eset = {pair_key(u, v) for (u, v) in edges}
            self.P.add(p)
            self.psn[a].add(b)
            self.psn[b].add(a)
            for (u, v) in self._member_pairs(a, b):
                if pair_key(u, v) not in eset:
                    self.cminus[u].add(v)
                    self.cminus[v].add(u)
        else:
            self.P.discard(p)
            self.psn[a].discard(b)
            self.psn[b].discard(a)
            for (u, v) in self._member_pairs(a, b):
                self.cminus[u].discard(v)
                self.cminus[v].discard(u)
            for (u, v) in edges:
                self.cplus[u].add(v)
                self.cplus[v].add(u)

    def _add_edge_encoding(self, u: int, v: int) -> None:
        a, b = self.n2s[u], self.n2s[v]
        tw = self._wt(a, b)
        w = self._wcount(a, b)
        wuv = self._w(u) * self._w(v)
        self.phi += encoding_cost(w + wuv, tw) - encoding_cost(w, tw)
        if pair_key(a, b) in self.P:
            self.cminus[u].discard(v)
            self.cminus[v].discard(u)
        else:
            self.cplus[u].add(v)
            self.cplus[v].add(u)
        self._set_count(a, b, self._count(a, b) + 1)
        self._bump_wcount(a, b, wuv)
        self._reencode(a, b)

    def _remove_edge_encoding(self, u: int, v: int) -> None:
        a, b = self.n2s[u], self.n2s[v]
        tw = self._wt(a, b)
        w = self._wcount(a, b)
        wuv = self._w(u) * self._w(v)
        self.phi += encoding_cost(w - wuv, tw) - encoding_cost(w, tw)
        if pair_key(a, b) in self.P:
            self.cminus[u].add(v)
            self.cminus[v].add(u)
        else:
            self.cplus[u].discard(v)
            self.cplus[v].discard(u)
        self._set_count(a, b, self._count(a, b) - 1)
        self._bump_wcount(a, b, -wuv)
        self._reencode(a, b)

    # ------------------------------------------------------------ stream ops
    def insert(self, u: int, v: int) -> None:
        assert u != v, "self-loops are excluded (simple graph)"
        self.ensure_node(u)
        self.ensure_node(v)
        assert not self.has_edge(u, v), f"insert of existing edge {(u, v)}"
        self._add_edge_encoding(u, v)
        self.deg[u] += 1
        self.deg[v] += 1
        self.num_edges += 1

    def delete(self, u: int, v: int) -> None:
        assert self.has_edge(u, v), f"delete of missing edge {(u, v)}"
        self._remove_edge_encoding(u, v)
        self.deg[u] -= 1
        self.deg[v] -= 1
        self.num_edges -= 1

    # --------------------------------------------------------------- queries
    def has_edge(self, u: int, v: int) -> bool:
        """O(1)-ish membership test on the representation (Sect. 3.5)."""
        if u not in self.n2s or v not in self.n2s:
            return False
        if v in self.cminus[u]:
            return False
        return v in self.cplus[u] or pair_key(self.n2s[u], self.n2s[v]) in self.P

    def neighbors(self, u: int) -> Set[int]:
        """Lemma-1 neighborhood retrieval from (G*, C) in O(deg + |C-(u)|)."""
        res = set(self.cplus[u])
        for sid in self.psn[self.n2s[u]]:
            res |= self.members[sid]
        res.discard(u)
        res -= self.cminus[u]
        return res

    # ----------------------------------------------------------------- moves
    def neighbor_hist(self, y: int) -> Dict[int, int]:
        """h[X] = |N(y) ∩ X| per supernode X (reused across candidate scans)."""
        h: Dict[int, int] = {}
        for w in self.neighbors(y):
            s = self.n2s[w]
            h[s] = h.get(s, 0) + 1
        return h

    def _pair_updates(self, y: int, target: int,
                      h: Optional[Dict[int, int]] = None,
                      ) -> Dict[Pair, Tuple[int, int, int, int]]:
        """Per-pair (W_old, TW_old, W_new, TW_new) induced by moving
        y -> target (counts E/T under the base hooks).

        ``target`` may be a not-yet-existing sid (escape to fresh singleton),
        signalled by target not in ``self.members``.
        """
        a = self.n2s[y]
        wy = self._w(y)
        swa, sqa = self._wsize(a), self._wsq(a)
        fresh = target not in self.members
        swb = 0 if fresh else self._wsize(target)
        sqb = 0 if fresh else self._wsq(target)
        if h is None:
            h = self.move_hist(y)

        out: Dict[Pair, Tuple[int, int, int, int]] = {}
        others = (set(self.sn.get(a, ())) | set(self.sn.get(target, ())) |
                  set(h)) - {a, target}
        for x in others:
            swx = self._wsize(x)
            w_ax = self._wcount(a, x)
            out[pair_key(a, x)] = (w_ax, swa * swx,
                                   w_ax - h.get(x, 0), (swa - wy) * swx)
            w_bx = 0 if fresh else self._wcount(target, x)
            out[pair_key(target, x)] = (w_bx, swb * swx,
                                        w_bx + h.get(x, 0), (swb + wy) * swx)
        w_aa = self._wcount(a, a)
        out[(a, a)] = (w_aa, _wtri(swa, sqa),
                       w_aa - h.get(a, 0), _wtri(swa - wy, sqa - wy * wy))
        w_bb = 0 if fresh else self._wcount(target, target)
        out[(target, target)] = (w_bb, _wtri(swb, sqb),
                                 w_bb + h.get(target, 0),
                                 _wtri(swb + wy, sqb + wy * wy))
        w_ab = 0 if fresh else self._wcount(a, target)
        out[pair_key(a, target)] = (w_ab, swa * swb,
                                    w_ab - h.get(target, 0) + h.get(a, 0),
                                    (swa - wy) * (swb + wy))
        return out

    def delta_phi(self, y: int, target: int,
                  h: Optional[Dict[int, int]] = None) -> int:
        """Closed-form change in phi if node y moved into supernode ``target``.

        This is the paper's "computing savings in the objective" step
        (Sect. 3.6.3): only pairs touching SN(S_y) ∪ SN(S_z) matter.
        Pass a precomputed ``move_hist(y)`` when scanning many candidates
        (NOT ``neighbor_hist`` — they differ under weighted objectives).
        """
        if target in self.members and self.n2s[y] == target:
            return 0
        d = 0
        for (e0, t0, e1, t1) in self._pair_updates(y, target, h).values():
            d += encoding_cost(e1, t1) - encoding_cost(e0, t0)
        return d

    def new_sid(self) -> int:
        sid = self._next_sid
        self._next_sid += 1
        return sid

    def move(self, y: int, target: int) -> None:
        """Unconditionally move y into supernode ``target`` (created if new)."""
        a = self.n2s[y]
        if target == a:
            return
        if target not in self.members:
            self.members[target] = set()
            self.sn[target] = set()
            self.psn[target] = set()
            self._next_sid = max(self._next_sid, target + 1)
        nbrs = sorted(self.neighbors(y))
        # 1. detach y's edges from the encoding (degree unchanged).
        for w in nbrs:
            self._remove_edge_encoding(y, w)
        # 1b. y leaves the scope of A's superedges: after the detach, y's
        # C- entries are exactly the potential pairs covered by P at A —
        # they stop existing once y departs (phi is count-derived; the
        # matching cost change is applied in step 3's re-costing).
        for q in list(self.cminus[y]):
            self.cminus[q].discard(y)
        self.cminus[y].clear()
        # 2. membership switch.
        self.members[a].remove(y)
        self.members[target].add(y)
        self.n2s[y] = target
        # 2b. y enters the scope of B's superedges: y currently has no
        # encoded edges, so every potential pair covered by a superedge of
        # B is a non-edge and must appear in C- until step 5 re-attaches.
        for x in list(self.psn.get(target, ())):
            for q in self.members[x]:
                if q != y:
                    self.cminus[y].add(q)
                    self.cminus[q].add(y)
        # 3. re-cost every pair of A and B: TW changed with the weight sums.
        touched = set()
        for x in list(self.sn.get(a, ())) + [a]:
            touched.add(pair_key(a, x))
        for x in list(self.sn.get(target, ())) + [target]:
            touched.add(pair_key(target, x))
        wy = self._w(y)
        dw = {a: wy, target: -wy}
        dq = {a: wy * wy, target: -wy * wy}
        for (p, q) in touched:
            if self._count(p, q) <= 0:
                continue
            # phi was accounted with the OLD TW; recompute with new sums.
            # Note: old TW differs only for pairs involving a or target.
            sw_p = self._wsize(p) + dw.get(p, 0)
            sw_q = self._wsize(q) + dw.get(q, 0)
            if p == q:
                tw_old = _wtri(sw_p, self._wsq(p) + dq.get(p, 0))
            else:
                tw_old = sw_p * sw_q
            tw_new = self._wt(p, q)
            w = self._wcount(p, q)
            self.phi += encoding_cost(w, tw_new) - encoding_cost(w, tw_old)
            self._reencode(p, q)
        # 4. drop A if emptied (all its counts are 0: y was its only member).
        if not self.members[a]:
            assert not self.sn[a], "empty supernode still has edge counts"
            del self.members[a]
            del self.sn[a]
            del self.psn[a]
        # 5. re-attach y's edges under the new membership.
        for w in nbrs:
            self._add_edge_encoding(y, w)

    # ------------------------------------------------------------- materialize
    def materialize(self) -> SummaryOutput:
        cp = set()
        cm = set()
        for u, s in self.cplus.items():
            for v in s:
                cp.add(pair_key(u, v))
        for u, s in self.cminus.items():
            for v in s:
                cm.add(pair_key(u, v))
        return SummaryOutput(
            supernodes={sid: set(m) for sid, m in self.members.items()},
            superedges=set(self.P),
            c_plus=cp,
            c_minus=cm,
        )

    def phi_recomputed(self) -> int:
        """Independent phi from the live pair table (tests cross-check).

        Uses the objective hooks, so under the weighted subclass this
        refolds ``cost(W, TW)`` — the weighted phi.
        """
        tot = 0
        for (a, b) in self.eab:
            tot += encoding_cost(self._wcount(a, b), self._wt(a, b))
        return tot

    def compression_ratio(self) -> float:
        """phi / |E| — Eq. (3) under the exact objective; the weighted
        analog (objective mass per live edge) under weighted hooks."""
        if self.num_edges == 0:
            return 0.0
        return self.phi / self.num_edges

    def representation_size(self) -> int:
        """|V| + |P| + |C+| + |C-| (Thm. 4 memory measure)."""
        return len(self.n2s) + self.phi


class WeightedDynamicSummary(DynamicSummary):
    """Utility-weighted host reference (the engine's ``objective="weighted"``).

    phi = |P| + sum_{C+} w(u)w(v) + sum_{C-} w(u)w(v): superedges cost 1,
    corrections cost their pair weight, and the per-pair optimum is
    ``cost(W_AB, TW_AB)`` with the same closed form as the exact rule
    (arxiv 2006.08949's utility view).  Decoding stays LOSSLESS — weights
    only shift which encoding mode each pair prefers.

    ``node_weight`` defaults to the engine's hashed weights
    (:func:`repro_torch.core.reference.weights.host_node_weight` on the
    node id);
    pass an explicit callable to weigh caller labels through an intern map
    when differencing against device state.  ``weight_levels <= 1`` makes
    every hook collapse to the base class — bit-identical to the exact
    objective (the property test in ``tests/test_policies.py``).
    """

    def __init__(self, weight_levels: int = 0,
                 node_weight: Optional[Callable[[int], int]] = None) -> None:
        super().__init__()
        if node_weight is None:
            from repro_torch.core.reference.weights import host_node_weight
            node_weight = lambda u: host_node_weight(u, weight_levels)
        self.weight_levels = weight_levels
        self._node_weight = node_weight
        self._wcache: Dict[int, int] = {}
        self.wab: Dict[Pair, int] = {}               # pair -> W_AB (>0 only)

    def _w(self, u: int) -> int:
        w = self._wcache.get(u)
        if w is None:
            w = int(self._node_weight(u))
            assert w >= 1, f"node weights must be positive, got w({u})={w}"
            self._wcache[u] = w
        return w

    def _wcount(self, a: int, b: int) -> int:
        return self.wab.get(pair_key(a, b), 0)

    def _bump_wcount(self, a: int, b: int, delta: int) -> None:
        p = pair_key(a, b)
        new = self.wab.get(p, 0) + delta
        if new:
            self.wab[p] = new
        else:
            self.wab.pop(p, None)

    def _wsize(self, sid: int) -> int:
        return sum(self._w(u) for u in self.members.get(sid, ()))

    def _wsq(self, sid: int) -> int:
        return sum(self._w(u) ** 2 for u in self.members.get(sid, ()))

    def _wt(self, a: int, b: int) -> int:
        if a == b:
            return _wtri(self._wsize(a), self._wsq(a))
        return self._wsize(a) * self._wsize(b)

    def move_hist(self, y: int) -> Dict[int, int]:
        wy = self._w(y)
        h: Dict[int, int] = {}
        for n in self.neighbors(y):
            s = self.n2s[n]
            h[s] = h.get(s, 0) + wy * self._w(n)
        return h
