"""Online summary service: read traffic beside the write stream.

Port of ``repro/launch/serve_summary.py``: a :class:`ShardedSummarizer`
consumes the change stream chunk by chunk while ``neighbors``/``degree``/
``has_edge`` reads are answered from flush-epoch query snapshots
(:mod:`repro_torch.serve.query`).  On the pipelined router a snapshot
trails the write head by the one routed chunk whose engine stage has not
run; the ``epoch lag`` histogram shows it.  ``--device`` picks where the
replicas run (default ``cuda``).

``--verify`` checks every sampled read against the host ground truth of
the snapshot's OWN epoch prefix, not the write head's.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve_summary --nodes 400 \
      --reads-per-chunk 64 --verify
"""
from __future__ import annotations

import argparse
import time
from typing import Sequence

import numpy as np

from repro_torch.core.engine import EngineConfig, ShardedSummarizer
from repro_torch.dist.router import REPLICA_EXEC_MODES
from repro_torch.launch.stream import make_stream


def _adjacency(edges) -> dict:
    adj: dict = {}
    for (u, v) in edges:
        adj.setdefault(u, set()).add(v)
        adj.setdefault(v, set()).add(u)
    return adj


def serve_summary(summarizer: ShardedSummarizer, stream: Sequence,
                  reads_per_chunk: int = 64, verify: bool = False,
                  seed: int = 0) -> dict:
    """Interleave write chunks with read batches; return service stats.

    Reads are sampled from the labels streamed so far and answered from a
    fresh ``query()`` snapshot after every chunk.  With ``verify`` each
    read batch is compared to the edge set of the snapshot's epoch prefix.
    """
    rng = np.random.default_rng(seed)
    chunk_n = summarizer.router_chunk
    n_chunks = -(-len(stream) // chunk_n)
    seen: list = []
    seen_set: set = set()
    live_after: list = []       # live edge set after chunk k (verify only)
    live: set = set()

    n_reads = 0
    t_read = 0.0
    lags: list = []
    for k in range(n_chunks):
        chunk = stream[k * chunk_n:(k + 1) * chunk_n]
        summarizer.process(chunk)
        for (u, v, ins) in chunk:
            for lab in (u, v):
                if lab not in seen_set:
                    seen_set.add(lab)
                    seen.append((lab, k + 1))   # first visible at epoch k+1
            if verify:
                e = (min(u, v), max(u, v))
                live.add(e) if ins else live.discard(e)
        if verify:
            live_after.append(frozenset(live))

        view = summarizer.query()
        lags.append(k + 1 - view.epoch)
        # only labels the snapshot's epoch has seen are queryable on it
        pool = [lab for (lab, ep) in seen if ep <= view.epoch]
        if not pool:
            continue
        labs = [pool[i] for i in
                rng.integers(0, len(pool), reads_per_chunk)]
        pairs = list(zip(labs, labs[::-1]))
        t0 = time.perf_counter()
        nbrs = view.neighbors_batch(labs)
        degs = view.degree_batch(labs)
        present = [view.has_edge(u, v) if u != v else False
                   for (u, v) in pairs[:8]]
        t_read += time.perf_counter() - t0
        n_reads += len(labs) * 2 + len(present)

        if verify:
            truth = live_after[view.epoch - 1] if view.epoch else frozenset()
            adj = _adjacency(truth)
            for lab, s, d in zip(labs, nbrs, degs):
                want = adj.get(lab, set())
                if s != want or d != len(want):
                    raise AssertionError(
                        f"epoch {view.epoch} neighbors/degree({lab!r})")
            for (u, v), p in zip(pairs, present):
                if p != ((min(u, v), max(u, v)) in truth):
                    raise AssertionError(
                        f"epoch {view.epoch} has_edge({u!r},{v!r})")

    summarizer.flush()
    final = summarizer.query()
    if final.epoch != n_chunks:
        raise AssertionError(f"final epoch {final.epoch} != {n_chunks}")
    if verify:
        labs = [lab for (lab, _) in seen]
        adj = _adjacency(live_after[-1] if live_after else frozenset())
        for lab, s in zip(labs, final.neighbors_batch(labs)):
            if s != adj.get(lab, set()):
                raise AssertionError(f"final neighbors({lab!r})")

    return dict(chunks=n_chunks, changes=len(stream), reads=n_reads,
                us_per_read=1e6 * t_read / max(n_reads, 1),
                epoch_lags=lags, max_lag=max(lags, default=0),
                reads_overlapped_writes=any(x > 0 for x in lags),
                final_epoch=final.epoch, phi=summarizer.phi,
                num_edges=summarizer.num_edges, verified=bool(verify))


def main(argv=None) -> None:
    dflt = EngineConfig()
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device of the replicas (cuda or cpu)")
    ap.add_argument("--graph", choices=["ba", "copying"], default="ba")
    ap.add_argument("--nodes", type=int, default=400)
    ap.add_argument("--deg", type=int, default=4)
    ap.add_argument("--beta", type=float, default=0.7)
    ap.add_argument("--fully-dynamic", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--shards", type=int, default=None)
    ap.add_argument("--router-chunk", type=int, default=256)
    ap.add_argument("--no-pipeline", action="store_true",
                    help="serial route/engine dispatch: every snapshot "
                         "then sits exactly at the write head (lag 0)")
    ap.add_argument("--replica-exec", choices=list(REPLICA_EXEC_MODES),
                    default=None,
                    help="replica layout (default: 'vmap' on cuda, 'map' "
                         "on cpu)")
    ap.add_argument("--reads-per-chunk", type=int, default=64)
    ap.add_argument("--verify", action="store_true",
                    help="check every sampled read against the snapshot "
                         "epoch's host ground truth")
    ap.add_argument("--c", type=int, default=dflt.c)
    ap.add_argument("--escape", type=float, default=dflt.escape)
    ap.add_argument("--batch", type=int, default=dflt.batch)
    args = ap.parse_args(argv)

    stream = make_stream(args.graph, args.nodes, args.deg, args.beta,
                         args.fully_dynamic, args.seed)
    n_cap = 1 << max(8, (args.nodes * 2).bit_length())
    m_cap = 1 << max(10, (len(stream) * 2).bit_length())
    ss = ShardedSummarizer(
        EngineConfig(n_cap=n_cap, m_cap=m_cap, c=args.c, escape=args.escape,
                     batch=args.batch),
        device=args.device, n_shards=args.shards,
        router_chunk=args.router_chunk, pipeline=not args.no_pipeline,
        replica_exec=args.replica_exec)
    print(f"stream: {len(stream)} changes; shards={ss.n_shards} "
          f"pipeline={ss.pipeline} replica_exec={ss.replica_exec} "
          f"device={ss.device}")
    t0 = time.time()
    out = serve_summary(ss, stream, reads_per_chunk=args.reads_per_chunk,
                        verify=args.verify, seed=args.seed)
    el = time.time() - t0
    print(f"served {out['reads']} reads over {out['chunks']} write chunks "
          f"({out['us_per_read']:.0f} us/read, max epoch lag "
          f"{out['max_lag']}, overlapped={out['reads_overlapped_writes']})")
    print(f"phi={out['phi']} |E|={out['num_edges']} "
          f"verified={out['verified']}  total {el:.1f}s "
          f"({1e6 * el / len(stream):.0f} us/change incl. reads)")


if __name__ == "__main__":
    main()
