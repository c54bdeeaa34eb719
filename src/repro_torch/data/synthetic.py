"""Deterministic synthetic graph data (port of the graph part of
``repro/data/synthetic.py``).

The arrays are drawn with numpy from the seed, in the JAX package's order,
so a seed gives both packages the same batch; the port's batch is then
placed on ``device`` (``cuda`` unless the caller asks for the CPU).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.graph.sampling import CSRGraph, build_triplets
from repro_torch.models.gnn import GraphBatch


def graph_batch(n_nodes: int, n_edges: int, d_feat: int, n_classes: int,
                seed: int = 0, with_coords: bool = False,
                max_triplets_per_edge: int = 4,
                device="cuda") -> GraphBatch:
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    senders = rng.integers(0, n_nodes, n_edges).astype(np.int32)
    receivers = rng.integers(0, n_nodes, n_edges).astype(np.int32)
    feat = rng.normal(size=(n_nodes, d_feat)).astype(np.float32)
    labels = rng.integers(0, n_classes, n_nodes).astype(np.int32)
    coords = (rng.normal(size=(n_nodes, 3)).astype(np.float32)
              if with_coords else None)
    tkj = tji = None
    if with_coords:
        tkj, tji = build_triplets(senders, receivers, max_triplets_per_edge,
                                  rng)
    arrays = (feat, senders, receivers, np.ones(n_edges, bool),
              np.ones(n_nodes, bool), labels, coords, tkj, tji)
    return GraphBatch(*(None if a is None else torch.from_numpy(a)
                        for a in arrays)).to(device)


def random_csr_graph(n_nodes: int, n_edges: int, seed: int = 0) -> CSRGraph:
    """``n_edges`` directed edges with uniform random endpoints on the host,
    drawn in receiver order (a receiver count per node, then uniform
    senders), so that ``CSRGraph``'s stable sort meets sorted input."""
    rng = np.random.default_rng(seed)
    counts = np.bincount(rng.integers(0, n_nodes, n_edges, dtype=np.int32),
                         minlength=n_nodes)
    receivers = np.repeat(np.arange(n_nodes, dtype=np.int32), counts)
    senders = rng.integers(0, n_nodes, n_edges, dtype=np.int32)
    return CSRGraph(n_nodes, senders, receivers)
