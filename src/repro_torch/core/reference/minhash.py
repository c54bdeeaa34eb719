"""Incremental min-hash coarse clustering (Careful Selection (2), Sect. 3.5).

Copy of ``repro/core/reference/minhash.py`` (plain Python).

Each node's cluster id is the minimum of a universal hash over its current
neighborhood.  Two nodes share a cluster with probability equal to the
Jaccard similarity of their neighborhoods (Broder et al. [5]) — exactly the
"nodes with similar connectivity" signal MoSSo wants for candidate pools.

Updates are O(1) per edge insertion and O(deg) only when the arg-min
neighbor of a node is deleted (rare), matching the paper's claim that
min-hash clusters "can be updated rapidly in response to changes".
"""
from __future__ import annotations

from typing import Dict

from repro_torch.core.reference.dynamic_summary import DynamicSummary

_MASK = (1 << 61) - 1
NO_CLUSTER = _MASK  # nodes with empty neighborhoods match nothing


def _mix(x: int, seed: int) -> int:
    """SplitMix64-style integer hash (deterministic across runs)."""
    x = (x + 0x9E3779B97F4A7C15 + seed * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return (x ^ (x >> 31)) & _MASK


class MinHashClusters:
    """Maintains cluster(u) = min_{w in N(u)} h(w) under the edge stream."""

    def __init__(self, seed: int = 0) -> None:
        self.seed = seed
        self.minh: Dict[int, int] = {}

    def hash_node(self, w: int) -> int:
        return _mix(w, self.seed)

    def cluster(self, u: int) -> int:
        return self.minh.get(u, NO_CLUSTER)

    def same_cluster(self, u: int, v: int) -> bool:
        cu = self.cluster(u)
        return cu != NO_CLUSTER and cu == self.cluster(v)

    def _recompute(self, s: DynamicSummary, u: int) -> None:
        nbrs = s.neighbors(u)
        self.minh[u] = min((self.hash_node(w) for w in nbrs), default=NO_CLUSTER)

    def on_insert(self, s: DynamicSummary, u: int, v: int) -> None:
        """Called *after* the summary applied the insertion of {u, v}."""
        self.minh[u] = min(self.minh.get(u, NO_CLUSTER), self.hash_node(v))
        self.minh[v] = min(self.minh.get(v, NO_CLUSTER), self.hash_node(u))

    def on_delete(self, s: DynamicSummary, u: int, v: int) -> None:
        """Called *after* the summary applied the deletion of {u, v}."""
        if self.minh.get(u) == self.hash_node(v):
            self._recompute(s, u)
        if self.minh.get(v) == self.hash_node(u):
            self._recompute(s, v)
