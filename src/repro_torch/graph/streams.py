"""Fully dynamic graph stream generation (Sect. 2.1 / Sect. 4.1).

A copy of ``repro/graph/streams.py`` (plain Python; the port imports
nothing of the JAX package).

The paper builds insertion-only streams by ordering a graph's edges, and
fully dynamic streams by inserting all edges in random order and, for each
edge, emitting a deletion with probability 0.1 at a random later position.
We reproduce both constructions, plus the synthetic generators used in the
appendix experiments (copying model [14] with copy probability beta; also
Barabási–Albert [1] for the preferential-attachment scalability setting).
"""
from __future__ import annotations

import random
from typing import Iterable, List, Sequence, Set, Tuple

Change = Tuple[int, int, bool]  # (u, v, is_insert)


def edges_to_insertion_stream(edges: Sequence[Tuple[int, int]],
                              seed: int = 0, shuffle: bool = True,
                              ) -> List[Change]:
    """Insertion-only (IO) stream: randomly ordered unless timestamps exist."""
    rng = random.Random(seed)
    order = list(edges)
    if shuffle:
        rng.shuffle(order)
    return [(u, v, True) for (u, v) in order]


def edges_to_fully_dynamic_stream(edges: Sequence[Tuple[int, int]],
                                  delete_prob: float = 0.1,
                                  seed: int = 0) -> List[Change]:
    """FD stream per Sect. 4.1: each inserted edge is later deleted w.p. 0.1.

    Deletions are placed at a uniformly random position after the matching
    insertion, preserving stream soundness (no deletion of a missing edge,
    no duplicate insertion of a live edge).
    """
    rng = random.Random(seed)
    order = list(edges)
    rng.shuffle(order)
    stream: List[Change] = [(u, v, True) for (u, v) in order]
    n = len(stream)
    deletions: List[Tuple[int, Change]] = []
    for i, (u, v, _) in enumerate(list(stream)):
        if rng.random() < delete_prob:
            pos = rng.randint(i + 1, n)
            deletions.append((pos, (u, v, False)))
    # stable insert by target position (later positions first keeps indices valid)
    for pos, ch in sorted(deletions, key=lambda x: -x[0]):
        stream.insert(pos, ch)
    return stream


# --------------------------------------------------------------------------- #
# synthetic graph generators
# --------------------------------------------------------------------------- #

def copying_model_edges(n_nodes: int, out_deg: int, beta: float,
                        seed: int = 0) -> List[Tuple[int, int]]:
    """Kleinberg et al. copying model [14] (Appendix A.2, Fig. 7a).

    Each new node copies the endpoints of a random existing node's edges with
    probability ``beta`` and links uniformly at random otherwise.  Output is
    symmetrized with self-loops/multi-edges removed, as in the paper.
    """
    rng = random.Random(seed)
    edges: Set[Tuple[int, int]] = set()
    targets: List[List[int]] = [[] for _ in range(n_nodes)]
    for u in range(1, n_nodes):
        proto = rng.randrange(u)
        proto_targets = targets[proto]
        for j in range(out_deg):
            if proto_targets and rng.random() < beta:
                v = proto_targets[min(j, len(proto_targets) - 1)]
            else:
                v = rng.randrange(u)
            if v != u:
                e = (min(u, v), max(u, v))
                if e not in edges:
                    edges.add(e)
                    targets[u].append(v)
    return sorted(edges)


def barabasi_albert_edges(n_nodes: int, m: int, seed: int = 0,
                          ) -> List[Tuple[int, int]]:
    """BA preferential attachment [1]: the paper's scalability assumption."""
    rng = random.Random(seed)
    edges: Set[Tuple[int, int]] = set()
    repeated: List[int] = list(range(min(m + 1, n_nodes)))
    for u in range(m + 1, n_nodes):
        chosen: Set[int] = set()
        while len(chosen) < m:
            chosen.add(rng.choice(repeated))
        for v in chosen:
            edges.add((min(u, v), max(u, v)))
            repeated.extend((u, v))
    return sorted(edges)


def erdos_renyi_edges(n_nodes: int, n_edges: int, seed: int = 0,
                      ) -> List[Tuple[int, int]]:
    rng = random.Random(seed)
    edges: Set[Tuple[int, int]] = set()
    while len(edges) < n_edges:
        u = rng.randrange(n_nodes)
        v = rng.randrange(n_nodes)
        if u != v:
            edges.add((min(u, v), max(u, v)))
    return sorted(edges)


def sbm_edges(n_nodes: int, n_blocks: int, p_in: float, p_out: float,
              seed: int = 0) -> List[Tuple[int, int]]:
    """Stochastic block model — dense communities compress well (Sect. 3.3)."""
    rng = random.Random(seed)
    block = [rng.randrange(n_blocks) for _ in range(n_nodes)]
    edges: List[Tuple[int, int]] = []
    for u in range(n_nodes):
        for v in range(u + 1, n_nodes):
            p = p_in if block[u] == block[v] else p_out
            if rng.random() < p:
                edges.append((u, v))
    return edges


def validate_stream(stream: Iterable[Change]) -> bool:
    """Soundness check of Sect. 2.1 (insert-new / delete-existing only)."""
    live: Set[Tuple[int, int]] = set()
    for (u, v, ins) in stream:
        e = (min(u, v), max(u, v))
        if ins:
            if e in live or u == v:
                return False
            live.add(e)
        else:
            if e not in live:
                return False
            live.remove(e)
    return True
