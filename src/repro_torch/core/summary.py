"""Lossless-summary primitives (plain Python).

Copies of ``repro/core/summary.py``'s ``pair_key``, ``t_count``,
``encoding_cost``, ``is_superedge`` and ``SummaryOutput``, and of
``repro/core/reference/weights.py``'s ``host_node_weight``.

The output of lossless graph summarization (Sect. 2.1 of the paper) is a
summary graph ``G* = (S, P)`` plus edge corrections ``C = (C+, C-)``.
The optimal encoding rule (Sect. 3.1) lists a supernode pair's ``E_AB``
edges in C+ (cost ``|E_AB|``) or encodes them as one superedge plus the
missing pairs in C- (cost ``1 + |T_AB| - |E_AB|``), whichever is cheaper.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Set, Tuple

import numpy as np

Pair = Tuple[int, int]


def pair_key(a: int, b: int) -> Pair:
    """Canonical (unordered) supernode pair key."""
    return (a, b) if a <= b else (b, a)


def t_count(size_a: int, size_b: int, same: bool) -> int:
    """|T_AB|: number of potential edges between supernodes of the given sizes."""
    if same:
        return size_a * (size_a - 1) // 2
    return size_a * size_b


def encoding_cost(e: int, t: int) -> int:
    """Contribution of one supernode pair to phi: ``min(e, t - e + 1)``,
    0 when no edge exists."""
    if e <= 0:
        return 0
    return min(e, t - e + 1)


def is_superedge(e: int, t: int) -> bool:
    """Optimal-encoding mode for a pair: superedge iff |E| > (|T|+1)/2."""
    return 2 * e > t + 1


@dataclass
class SummaryOutput:
    """A materialized output representation (used for tests / persistence)."""

    supernodes: Dict[int, Set[int]]             # sid -> member nodes
    superedges: Set[Pair]                       # P  (canonical sid pairs)
    c_plus: Set[Pair]                           # C+ (canonical node pairs)
    c_minus: Set[Pair]                          # C- (canonical node pairs)

    @property
    def phi(self) -> int:
        return len(self.superedges) + len(self.c_plus) + len(self.c_minus)

    def phi_weighted(self, node_weight) -> int:
        """Utility-weighted objective: a superedge costs 1, each correction
        its pair weight ``w(u) * w(v)``."""
        corr = sum(node_weight(u) * node_weight(v)
                   for s in (self.c_plus, self.c_minus) for (u, v) in s)
        return len(self.superedges) + corr

    def decode_edges(self) -> Set[Pair]:
        """Losslessly recover E = (Ê ∪ C+) \\ C-  (Sect. 2.1)."""
        edges: Set[Pair] = set()
        members = {sid: sorted(mem) for sid, mem in self.supernodes.items()}
        for a, b in self.superedges:
            if a == b:
                mem = members[a]
                for i, u in enumerate(mem):
                    for v in mem[i + 1:]:
                        edges.add(pair_key(u, v))
            else:
                for u in members[a]:
                    for v in members[b]:
                        edges.add(pair_key(u, v))
        edges |= {pair_key(u, v) for (u, v) in self.c_plus}
        edges -= {pair_key(u, v) for (u, v) in self.c_minus}
        return edges

    def node_count(self) -> int:
        return sum(len(m) for m in self.supernodes.values())


_GOLDEN = np.uint32(0x9E3779B9)
_SEED_CTR = np.uint32(0x5EED)


def _splitmix32(x: np.uint32) -> np.uint32:
    with np.errstate(over="ignore"):
        x = (x ^ (x >> np.uint32(16))) * np.uint32(0x21F0AAAD)
        x = (x ^ (x >> np.uint32(15))) * np.uint32(0x735A2D97)
        return x ^ (x >> np.uint32(15))


def host_node_weight(u: int, weight_levels: int) -> int:
    """Host mirror of ``ops.node_weight``: w(u) for an engine id; 1 when
    levels <= 1."""
    if weight_levels <= 1:
        return 1
    with np.errstate(over="ignore"):
        x = np.uint32(np.int64(u) & 0xFFFFFFFF) + _SEED_CTR * _GOLDEN
    h = _splitmix32(x)
    return 1 + int(h % np.uint32(weight_levels))
