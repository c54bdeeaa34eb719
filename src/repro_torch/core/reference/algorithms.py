"""The four streaming algorithms of the paper (Tier A, faithful).

Copy of ``repro/core/reference/algorithms.py`` (plain Python).

* :class:`MoSSoGreedy`  — Sect. 3.2, baseline: TP=TN={u}, CP=V, argmin dphi.
* :class:`MoSSoMCMC`    — Sect. 3.3 + Appendix C: TN=N(u), SBM-style proposal
  (Eq. 4) and Metropolis–Hastings acceptance (Eq. 5).
* :class:`MoSSoSimple`  — Sect. 3.4 / Alg. 1 blue lines: c samples from N(u),
  1/deg testing filter, corrective escape, CP(y)=N(u).
* :class:`MoSSo`        — Sect. 3.5 / Alg. 1 red lines: GetRandomNeighbor
  sampling on the representation, min-hash coarse clusters, CP=TP ∩ R(y).

All share the trial skeleton of Fig. 3 and accept a proposal iff dphi <= 0
(Alg. 1 line 16).
"""
from __future__ import annotations

import math
import random
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from repro_torch.core.reference.dynamic_summary import DynamicSummary
from repro_torch.core.reference.minhash import MinHashClusters
from repro_torch.core.reference.neighbor_sampler import get_random_neighbors
from repro_torch.core.summary import StreamStats

Change = Tuple[int, int, bool]  # (u, v, is_insert)


class StreamingSummarizer:
    """Common driver: apply each change, then run trials for both endpoints."""

    name = "base"

    def __init__(self, seed: int = 0) -> None:
        self.s = DynamicSummary()
        self.rng = random.Random(seed)
        self.stats = StreamStats()

    # -- hooks ---------------------------------------------------------------
    def on_change(self, u: int, v: int, is_insert: bool) -> None:
        """Update auxiliary structures (e.g. coarse clusters)."""

    def trials(self, u: int) -> None:
        raise NotImplementedError

    # -- driver ---------------------------------------------------------------
    def process(self, u: int, v: int, is_insert: bool) -> None:
        if is_insert:
            self.s.insert(u, v)
            self.stats.insertions += 1
        else:
            self.s.delete(u, v)
            self.stats.deletions += 1
        self.stats.changes += 1
        self.on_change(u, v, is_insert)
        self.trials(u)
        self.trials(v)

    def run(self, stream: Iterable[Change], record_every: int = 0) -> StreamStats:
        for (u, v, ins) in stream:
            self.process(u, v, ins)
            if record_every and self.stats.changes % record_every == 0:
                self.stats.phi_history.append(
                    (self.stats.changes, self.s.phi, self.s.num_edges))
        return self.stats

    # -- shared trial pieces ---------------------------------------------------
    def _attempt(self, y: int, target: Optional[int],
                 h: Optional[Dict[int, int]] = None) -> bool:
        """One Move-if-Saved-Stay-otherwise acceptance test; target None=escape."""
        self.stats.trials += 1
        s = self.s
        if target is None:
            if len(s.members[s.n2s[y]]) <= 1:
                return False  # already a singleton; escape is a no-op
            target = s.new_sid()
            d = s.delta_phi(y, target, h)
            if d <= 0:
                s.move(y, target)
                self.stats.accepted += 1
                self.stats.escapes += 1
                return True
            return False
        if target == s.n2s[y]:
            return False
        d = s.delta_phi(y, target, h)
        if d <= 0:
            s.move(y, target)
            self.stats.accepted += 1
            return True
        return False


class MoSSoGreedy(StreamingSummarizer):
    """Sect. 3.2: exhaustively pick the best destination for the input node."""

    name = "mosso-greedy"

    def trials(self, u: int) -> None:
        s = self.s
        if u not in s.n2s:
            return
        h = s.move_hist(u)
        best_d, best_t = 0, None
        for sid in list(s.members):
            if sid == s.n2s[u]:
                continue
            d = s.delta_phi(u, sid, h)
            if d < best_d:
                best_d, best_t = d, sid
        self.stats.trials += 1
        if best_t is not None:
            s.move(u, best_t)
            self.stats.accepted += 1


class MoSSoMCMC(StreamingSummarizer):
    """Sect. 3.3 + Appendix C: SBM-flavoured proposal + MH acceptance."""

    name = "mosso-mcmc"

    def __init__(self, seed: int = 0, beta: float = 10.0, eps: float = 1.0) -> None:
        super().__init__(seed)
        self.beta = beta
        self.eps = eps

    def _row_sum(self, sid: int) -> int:
        s = self.s
        return sum(s._count(sid, x) for x in s.sn.get(sid, ()))

    def _proposal(self, s_x: int) -> int:
        """Draw S_z with prob (|E_{S_z,S_x}| + eps) / (|E_{S_x}| + eps |S|), Eq. 4."""
        s = self.s
        sids = list(s.members)
        k = len(sids)
        row = self._row_sum(s_x)
        tot = row + self.eps * k
        r = self.rng.random() * tot
        if r >= row:  # epsilon mass: uniform over all supernodes
            return self.rng.choice(sids)
        acc = 0.0
        for x in s.sn.get(s_x, ()):
            acc += s._count(s_x, x)
            if r < acc:
                return x
        return self.rng.choice(sids)

    def _prop_prob(self, target: int, s_x: int, k: int) -> float:
        row = self._row_sum(s_x)
        return (self.s._count(target, s_x) + self.eps) / (row + self.eps * k)

    def trials(self, u: int) -> None:
        s = self.s
        if u not in s.n2s or s.deg.get(u, 0) == 0:
            return
        for y in sorted(s.neighbors(u)):
            self.stats.trials += 1
            nbrs_y = sorted(s.neighbors(y))
            if not nbrs_y:
                continue
            x = self.rng.choice(nbrs_y)
            s_z = self._proposal(s.n2s[x])
            a = s.n2s[y]
            if s_z == a:
                continue
            h = s.neighbor_hist(y)
            d = s.delta_phi(y, s_z)   # h is count-based; delta_phi self-hists
            # Eq. 5 forward/backward proposal mixtures over S_x of y's nbrs.
            k = len(s.members)
            p_sx = {sid: cnt / len(nbrs_y) for sid, cnt in h.items()}
            fwd = sum(p * self._prop_prob(s_z, sx, k) for sx, p in p_sx.items())
            # backward prob must be evaluated *after* the move (Appendix C);
            # move() is exact and revertible so simulate it.
            s.move(y, s_z)
            k2 = len(s.members)
            exists_a = a in s.members
            bwd = 0.0
            if exists_a:
                h2 = s.neighbor_hist(y)
                p2 = {sid: cnt / len(nbrs_y) for sid, cnt in h2.items()}
                bwd = sum(p * self._prop_prob(a, sx, k2) for sx, p in p2.items())
            ratio = (bwd / fwd) if fwd > 0 else 1.0
            accept_p = min(1.0, math.exp(min(50.0, -self.beta * d)) * ratio) \
                if exists_a else (1.0 if d <= 0 else 0.0)
            if self.rng.random() <= accept_p:
                self.stats.accepted += 1
            else:
                s.move(y, a)  # revert


class MoSSoSimple(StreamingSummarizer):
    """Sect. 3.4 (Alg. 1, blue lines)."""

    name = "mosso-simple"

    def __init__(self, seed: int = 0, escape: float = 0.3, c: int = 120) -> None:
        super().__init__(seed)
        self.escape = escape
        self.c = c

    def _testing_nodes(self, tp: Sequence[int]) -> List[int]:
        return [w for w in tp if self.rng.random() * self.s.deg.get(w, 1) <= 1.0]

    def trials(self, u: int) -> None:
        s = self.s
        if u not in s.n2s or s.deg.get(u, 0) == 0:
            return
        nbrs = sorted(s.neighbors(u))
        tp = [self.rng.choice(nbrs) for _ in range(self.c)]
        for y in self._testing_nodes(tp):
            if self.rng.random() <= self.escape:
                self._attempt(y, None)
            else:
                z = self.rng.choice(nbrs)  # CP(y) = N(u)
                self._attempt(y, s.n2s[z])


class MoSSo(StreamingSummarizer):
    """Sect. 3.5 (Alg. 1, red lines) — the full-fledged proposed method."""

    name = "mosso"

    def __init__(self, seed: int = 0, escape: float = 0.3, c: int = 120,
                 minhash_seed: int = 0) -> None:
        super().__init__(seed)
        self.escape = escape
        self.c = c
        self.clusters = MinHashClusters(minhash_seed)

    def on_change(self, u: int, v: int, is_insert: bool) -> None:
        if is_insert:
            self.clusters.on_insert(self.s, u, v)
        else:
            self.clusters.on_delete(self.s, u, v)

    def trials(self, u: int) -> None:
        s = self.s
        if u not in s.n2s or s.deg.get(u, 0) == 0:
            return
        tp = get_random_neighbors(s, u, self.c, self.rng)
        for y in tp:
            if self.rng.random() * s.deg.get(y, 1) > 1.0:
                continue  # 1/deg(w) testing filter
            if self.rng.random() <= self.escape:
                self._attempt(y, None)
            else:
                cp = [z for z in tp if self.clusters.same_cluster(y, z)]
                if not cp:
                    continue
                z = self.rng.choice(cp)
                self._attempt(y, s.n2s[z])


class MoSSoMags(StreamingSummarizer):
    """Mags-DM-style candidate scheme on the MoSSo trial skeleton.

    Host reference for the engine's ``proposal="magsdm"``: the candidate
    destination is the MODAL supernode among the TP samples (the densest
    co-sampled destination, ties to the smallest sid), replacing the
    min-hash CP(y) pick.  TP sampling, the 1/deg testing filter, the
    corrective escape, and Move-if-Saved acceptance are unchanged.  The
    deviation vs the published Mags-DM heuristic is audited in
    ``docs/KNOWN_ISSUES.md``.
    """

    name = "mosso-mags"

    def __init__(self, seed: int = 0, escape: float = 0.3, c: int = 120) -> None:
        super().__init__(seed)
        self.escape = escape
        self.c = c

    def trials(self, u: int) -> None:
        s = self.s
        if u not in s.n2s or s.deg.get(u, 0) == 0:
            return
        tp = get_random_neighbors(s, u, self.c, self.rng)
        for y in tp:
            if self.rng.random() * s.deg.get(y, 1) > 1.0:
                continue  # 1/deg(w) testing filter
            if self.rng.random() <= self.escape:
                self._attempt(y, None)
            else:
                a = s.n2s[y]
                cnt: Dict[int, int] = {}
                for z in tp:
                    sz = s.n2s[z]
                    if sz != a:
                        cnt[sz] = cnt.get(sz, 0) + 1
                if not cnt:
                    continue
                target = max(cnt, key=lambda sid: (cnt[sid], -sid))
                self._attempt(y, target)


ALGORITHMS = {
    "greedy": MoSSoGreedy,
    "mcmc": MoSSoMCMC,
    "simple": MoSSoSimple,
    "mosso": MoSSo,
    "mags": MoSSoMags,
}
