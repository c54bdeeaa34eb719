"""Neighbor sampling for minibatch GNNs (GraphSAGE fanouts): a numpy copy
of ``repro/graph/sampling.py``.

Given a CSR adjacency, sample a fixed fanout per hop around seed nodes and
pad the subgraph to a fixed shape ready for the device.  Host-side numpy:
the device only sees the padded tensors.  With the same ``rng`` it gives
the JAX package's samples exactly.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


class CSRGraph:
    def __init__(self, n_nodes: int, senders: np.ndarray, receivers: np.ndarray):
        order = np.argsort(receivers, kind="stable")
        self.indices = senders[order].astype(np.int32)
        counts = np.bincount(receivers, minlength=n_nodes)
        self.indptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
        self.n_nodes = n_nodes

    def neighbors(self, u: int) -> np.ndarray:
        return self.indices[self.indptr[u]:self.indptr[u + 1]]


def sample_fanout(g: CSRGraph, seeds: np.ndarray, fanouts: Sequence[int],
                  rng: np.random.Generator,
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """k-hop fanout sampling; returns (nodes, senders, receivers).

    ``nodes[0:len(seeds)] == seeds``; edge endpoints index into ``nodes``.
    """
    node_ids: List[int] = list(map(int, seeds))
    pos = {int(u): i for i, u in enumerate(seeds)}
    frontier = list(map(int, seeds))
    s_out: List[int] = []
    r_out: List[int] = []
    for fan in fanouts:
        nxt: List[int] = []
        for u in frontier:
            nbrs = g.neighbors(u)
            if len(nbrs) == 0:
                continue
            take = rng.choice(nbrs, size=min(fan, len(nbrs)), replace=False)
            for v in map(int, take):
                if v not in pos:
                    pos[v] = len(node_ids)
                    node_ids.append(v)
                    nxt.append(v)
                s_out.append(pos[v])
                r_out.append(pos[u])
        frontier = nxt
    return (np.asarray(node_ids, np.int32),
            np.asarray(s_out, np.int32), np.asarray(r_out, np.int32))


def pad_subgraph(nodes: np.ndarray, senders: np.ndarray, receivers: np.ndarray,
                 n_pad: int, e_pad: int):
    """Fixed-shape padding (node 0 self-loops on dead edge slots)."""
    n, e = len(nodes), len(senders)
    if n > n_pad or e > e_pad:
        raise ValueError(f"subgraph of {n} nodes / {e} edges exceeds the "
                         f"padded shape {n_pad} / {e_pad}")
    node_mask = np.zeros(n_pad, bool)
    node_mask[:n] = True
    edge_mask = np.zeros(e_pad, bool)
    edge_mask[:e] = True
    nodes_p = np.zeros(n_pad, np.int32)
    nodes_p[:n] = nodes
    s_p = np.zeros(e_pad, np.int32)
    s_p[:e] = senders
    r_p = np.zeros(e_pad, np.int32)
    r_p[:e] = receivers
    return nodes_p, s_p, r_p, node_mask, edge_mask


def build_triplets(senders: np.ndarray, receivers: np.ndarray,
                   max_per_edge: int, rng: np.random.Generator,
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """(k->j, j->i) directional triplets for DimeNet, capped per edge.

    The cap bounds the O(sum deg^2) triplet blow-up on non-molecular graphs
    (documented in DESIGN.md); molecule-scale graphs are exact.
    """
    in_edges: dict = {}
    for e, r in enumerate(receivers):
        in_edges.setdefault(int(r), []).append(e)
    t_kj: List[int] = []
    t_ji: List[int] = []
    for e_ji, j in enumerate(senders):
        cands = [e for e in in_edges.get(int(j), ())
                 if int(senders[e]) != int(receivers[e_ji])]
        if len(cands) > max_per_edge:
            cands = list(rng.choice(cands, size=max_per_edge, replace=False))
        for e_kj in cands:
            t_kj.append(e_kj)
            t_ji.append(e_ji)
    if not t_kj:
        t_kj, t_ji = [0], [0]
    return np.asarray(t_kj, np.int32), np.asarray(t_ji, np.int32)
