"""GetRandomNeighbor (Alg. 2) — Fast Random (2).

Copy of ``repro/core/reference/neighbor_sampler.py`` (plain Python).

Uniformly samples ``c`` neighbors of ``u`` *from the output representation*
(G*, C) without retrieving all of N(u):

* with prob |C+(u)|/deg(u) draw from the materialized C+ list (Thm. 1 split),
* otherwise run the size-biased MCMC over the P-neighbour supernodes of S_u
  (proposal uniform over k supernodes, acceptance min(1, |S_p|/|S_n|), Thm. 2)
  and rejection-sample a member that is a true neighbor (not in C-(u), != u).

Average cost O(c · (1 + |C-(u)|/deg(u))) per Thm. 3.
"""
from __future__ import annotations

import random
from typing import List

from repro_torch.core.reference.dynamic_summary import DynamicSummary

_MAX_STEPS = 1_000_000  # safety bound; Thm. 3 says expected steps are tiny


def get_random_neighbors(s: DynamicSummary, u: int, c: int,
                         rng: random.Random) -> List[int]:
    """Sample ``c`` neighbors of ``u`` with replacement, uniformly over N(u)."""
    deg = s.deg.get(u, 0)
    if deg == 0:
        return []
    cp = list(s.cplus[u])
    cm = s.cminus[u]
    pn = [sid for sid in s.psn[s.n2s[u]]]
    out: List[int] = []
    if not pn:
        # every neighbor is materialized in C+ (|C+(u)| == deg(u))
        return [rng.choice(cp) for _ in range(c)]
    members = s.members
    s_n = rng.choice(pn)
    steps = 0
    while len(out) < c:
        steps += 1
        assert steps < _MAX_STEPS, "GetRandomNeighbor failed to converge"
        if cp and rng.random() * deg <= len(cp):
            out.append(rng.choice(cp))
            continue
        while True:
            steps += 1
            assert steps < _MAX_STEPS, "GetRandomNeighbor failed to converge"
            s_p = rng.choice(pn)
            if rng.random() <= min(1.0, len(members[s_p]) / len(members[s_n])):
                s_n = s_p
            w = rng.choice(tuple(members[s_n]))
            if w != u and w not in cm:
                out.append(w)
                break
    return out
