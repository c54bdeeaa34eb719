"""GNN message passing on the live lossless summary (port of
``examples/gnn_over_summary.py``).

Summarize a community graph with the batched engine, then compute one
round of sum aggregation ``Y = A @ X`` three ways:

* over the neighborhoods that the ONLINE QUERY PATH serves from the
  engine state (``SummaryQuery.neighbors_batch``; no decode), through
  ``ops.spmm`` and so the CSR kernel on the card;
* over the summary's terms (G*, C+, C-) with ``ops.summary_spmm``, whose
  four segment sums also run the kernel;
* densely over the raw edges with the plain ``ref.dense_spmm_ref``;

and require all three to agree (rtol = atol = 1e-4): losslessness means
the same sums, up to the order of the float additions.

    PYTHONPATH=src python -m repro_torch.launch.gnn_over_summary [--device cpu]
"""
from __future__ import annotations

import argparse
import time
from typing import Iterable, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.engine import BatchedSummarizer, EngineConfig
from repro_torch.graph.streams import edges_to_insertion_stream, sbm_edges
from repro_torch.kernels import ops, ref


def _dirpairs(pairs: Iterable[Tuple[int, int]], device,
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    s: List[int] = []
    d: List[int] = []
    for (u, v) in pairs:
        s += [u, v]
        d += [v, u]
    return (torch.tensor(s, dtype=torch.int32, device=device),
            torch.tensor(d, dtype=torch.int32, device=device))


def summary_terms(bs: BatchedSummarizer, n: int, device) -> tuple:
    """The arguments of ``summary_spmm`` after ``x``, in label space (the
    labels are the ints ``0..n-1``): the materialized summary's membership,
    superedges and corrections.  A node in no supernode gets a singleton
    supernode of its own (no superedge), so its row is its corrections."""
    out = bs.materialize()
    rev = bs._rev
    sup_ids = {sid: i for i, sid in enumerate(sorted(out.supernodes))}
    n2s = np.full(n, -1, np.int64)
    for sid, mem in out.supernodes.items():
        for u in mem:
            n2s[rev[u]] = sup_ids[sid]
    alone = np.flatnonzero(n2s < 0)
    n2s[alone] = len(sup_ids) + np.arange(alone.size)
    n_super = len(sup_ids) + alone.size
    self_loop = np.zeros(n_super, bool)
    p_src: List[int] = []
    p_dst: List[int] = []
    for (a, b) in out.superedges:
        if a == b:
            self_loop[sup_ids[a]] = True
        else:
            p_src += [sup_ids[a], sup_ids[b]]
            p_dst += [sup_ids[b], sup_ids[a]]
    cps, cpd = _dirpairs(((rev[a], rev[b]) for (a, b) in out.c_plus), device)
    cms, cmd = _dirpairs(((rev[a], rev[b]) for (a, b) in out.c_minus),
                         device)
    return (torch.from_numpy(n2s).to(device), n_super,
            torch.tensor(p_src, dtype=torch.int32, device=device),
            torch.tensor(p_dst, dtype=torch.int32, device=device),
            cps, cpd, cms, cmd, torch.from_numpy(self_loop).to(device))


def aggregate_three_ways(bs: BatchedSummarizer,
                         edges: Sequence[Tuple[int, int]], x: torch.Tensor,
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(y_query, y_summary, y_dense)`` for node labels ``0..n-1``
    (``n = x.shape[0]``) and the live undirected ``edges``."""
    device, n = x.device, x.shape[0]
    view = bs.query()
    labels = view.seen_labels()
    nbrs = view.neighbors_batch(labels)      # served from the state
    qs = torch.tensor([v for u, s in zip(labels, nbrs) for v in sorted(s)],
                      dtype=torch.int32, device=device)
    qd = torch.tensor([u for u, s in zip(labels, nbrs) for _ in s],
                      dtype=torch.int32, device=device)
    y_query = ops.spmm(qs, qd, x)
    y_summary = ops.summary_spmm(x, *summary_terms(bs, n, device))
    es, ed = _dirpairs(sorted(edges), device)
    y_dense = ref.dense_spmm_ref(es, ed, x)
    return y_query, y_summary, y_dense


def check_agree(ys, rtol: float = 1e-4, atol: float = 1e-4) -> float:
    """Assert ``allclose`` of each of ``ys`` to the last; returns the
    largest absolute difference."""
    want = ys[-1].cpu().numpy()
    err = 0.0
    for y in ys[:-1]:
        got = y.cpu().numpy()
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)
        err = max(err, float(np.abs(got - want).max(initial=0.0)))
    return err


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--nodes", type=int, default=200)
    ap.add_argument("--blocks", type=int, default=8)
    ap.add_argument("--c", type=int, default=40)
    args = ap.parse_args(argv)

    edges = sbm_edges(args.nodes, args.blocks, 0.5, 0.01, seed=3)
    n = max(max(e) for e in edges) + 1
    bs = BatchedSummarizer(EngineConfig(n_cap=512, m_cap=1 << 13, d_cap=64,
                                        sn_cap=48, c=args.c, escape=0.15,
                                        batch=32), device=args.device)
    t = time.perf_counter()
    bs.run(edges_to_insertion_stream(edges, seed=1))
    print(f"summarized: phi={bs.phi} vs |E|={len(edges)} (ratio "
          f"{bs.compression_ratio():.2f}) in "
          f"{time.perf_counter() - t:.1f} s, device={bs.device}")

    gen = np.random.default_rng(0)
    x = torch.from_numpy(gen.normal(size=(n, 64)).astype(
        np.float32)).to(bs.device)
    ops.reset_counts()
    ys = aggregate_three_ways(bs, edges, x)
    err = check_agree(ys)
    print(f"query-served == summary_spmm == dense (max |diff| {err:.2e}; "
          f"{ops.segment_reduce.launches} segment-reduce kernel launches)")
    out = bs.materialize()
    dense_terms = 2 * len(edges)
    summary_terms_n = (len(out.superedges) * 2 + 2 * len(out.c_plus)
                       + 2 * len(out.c_minus) + n)
    print(f"gather/scatter terms: dense={dense_terms}  summary~"
          f"{summary_terms_n}  ({summary_terms_n / dense_terms:.2f}x)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
