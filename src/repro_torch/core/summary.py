"""Lossless-summary primitives (plain Python).

Copies of ``repro/core/summary.py``'s ``pair_key``, ``t_count``,
``encoding_cost``, ``is_superedge``, ``SummaryOutput``,
``ShardedSummaryOutput`` and ``StreamStats``, and of
``repro/core/reference/weights.py``'s ``host_node_weight`` (which
``repro_torch.core.reference.weights`` re-exports).

The output of lossless graph summarization (Sect. 2.1 of the paper) is a
summary graph ``G* = (S, P)`` plus edge corrections ``C = (C+, C-)``.
The optimal encoding rule (Sect. 3.1) lists a supernode pair's ``E_AB``
edges in C+ (cost ``|E_AB|``) or encodes them as one superedge plus the
missing pairs in C- (cost ``1 + |T_AB| - |E_AB|``), whichever is cheaper.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Set, Tuple

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


@dataclass
class ShardedSummaryOutput:
    """Union-of-parts output of an edge-partitioned summarization run.

    Each shard is an independent lossless summary of its edge partition, so
    the global edge set is the UNION of per-shard decodes.  C- stays scoped
    to its shard: a node may belong to supernodes in several shards, and a
    shard's correction must never subtract an edge owned by another shard,
    which is why the parts are kept rather than flattened into one
    :class:`SummaryOutput`.

    The merge is insensitive to DELIVERY ORDER: whether changes reached a
    shard through host bucketing or through the device router
    (``dist/router.py``), each edge has exactly
    one owner shard (canonical-pair keying), so the per-shard summaries
    cover disjoint edge sets and the union — and the additive ``phi`` — are
    the same.  What delivery order *does* fix is each shard's internal node
    numbering; producers therefore relabel every part back to caller labels
    (via the device intern maps) and offset supernode ids into disjoint
    per-shard ranges before constructing this object.  ``validate()``
    checks the structural half of that contract.
    """

    shards: List[SummaryOutput]

    @property
    def phi(self) -> int:
        """Global objective: per-pair encodings are disjoint across shards."""
        return sum(s.phi for s in self.shards)

    def phi_by_shard(self) -> List[int]:
        return [s.phi for s in self.shards]

    def decode_edges(self) -> Set[Pair]:
        edges: Set[Pair] = set()
        for s in self.shards:
            edges |= s.decode_edges()
        return edges

    def node_count(self) -> int:
        """Distinct nodes across shards (a node may appear in several)."""
        nodes: Set[int] = set()
        for s in self.shards:
            for mem in s.supernodes.values():
                nodes |= mem
        return len(nodes)

    def validate(self) -> "ShardedSummaryOutput":
        """Assert the union-of-parts invariants; returns self for chaining.

        * supernode id ranges are pairwise disjoint across shards (so the
          union never aliases two shards' supernodes), and
        * every part satisfies phi == |P| + |C+| + |C-| by construction
          (``SummaryOutput.phi`` is definitional; here we check each part's
          correction sets stay inside its own supernode universe).
        """
        seen_sids: Set[int] = set()
        for i, s in enumerate(self.shards):
            sids = set(s.supernodes)
            overlap = sids & seen_sids
            assert not overlap, f"shard {i} reuses supernode ids {overlap}"
            seen_sids |= sids
            members: Set[int] = set()
            for mem in s.supernodes.values():
                members |= mem
            for (a, b) in s.superedges:
                assert a in sids and b in sids, \
                    f"shard {i} superedge {(a, b)} leaves its sid range"
            for pair_set, name in ((s.c_plus, "C+"), (s.c_minus, "C-")):
                for (u, v) in pair_set:
                    assert u in members and v in members, \
                        f"shard {i} {name} pair {(u, v)} names a foreign node"
        return self


@dataclass
class StreamStats:
    """Per-run accounting of the Tier-A reference algorithms."""

    changes: int = 0
    insertions: int = 0
    deletions: int = 0
    trials: int = 0
    accepted: int = 0
    escapes: int = 0
    phi_history: List[Tuple[int, int, int]] = field(
        default_factory=list)            # (t, phi, |E|)


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
