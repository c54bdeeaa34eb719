"""MoSSo streaming CLI on the PyTorch engine.

Port of ``repro/launch/stream.py``: summarize a synthetic dynamic graph
stream with :class:`BatchedSummarizer` (the default), the
edge-partitioned :class:`ShardedSummarizer` (``--shards`` replicas over
JAX's default mesh: the first ``gcd(shards, cards)`` cards, one shard a
card without ``--shards``, one position on the CPU; routed on the
devices by default, ``--routing host`` for host bucketing; on a host of
several cards ``--device cuda:0`` takes less time a change, ``PERF.md``
§6) or the faithful Tier-A reference (``--engine reference
--algo ...``, host Python), and report phi, the compression ratio (Eq. 3)
and the time per change.  The search and batch defaults come from the
port's ``EngineConfig``.  ``--device`` picks where the engine runs
(default ``cuda``); the reference tier runs on the host and ignores it.
The JAX CLI defaults to ``--engine reference``; this one to the batched
engine on the card.

With ``--checkpoint-dir`` both engines run crash-consistent: every
dispatch chunk is write-ahead journaled, an epoch checkpoint lands every
``--checkpoint-every`` chunks, and a failed chunk abandons the live
summarizer, restores the latest valid epoch, replays the journal tail and
resumes (``repro_torch.ft.resilience.run_stream_with_recovery``; retries
are reported as ``stream_retries`` in the final stats).  ``--resume``
recovers from the directory before processing, so a killed run continues
from its last journaled chunk.  The directory's format is the JAX
package's: either CLI resumes the other's.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.stream --batch 64
  PYTHONPATH=src python -m repro_torch.launch.stream --engine reference \
      --algo mosso --nodes 2000
  PYTHONPATH=src python -m repro_torch.launch.stream --device cpu \
      --nodes 200 --fully-dynamic
  PYTHONPATH=src python -m repro_torch.launch.stream --engine sharded \
      --shards 4 --routing device --router-chunk 1024
  PYTHONPATH=src python -m repro_torch.launch.stream --engine sharded \
      --checkpoint-dir build/mosso-ckpt --checkpoint-every 8 --resume
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.core.engine import (BatchedSummarizer, EngineConfig,
                                    ShardedSummarizer)
from repro_torch.core.engine.state import OBJECTIVES, PROPOSALS
from repro_torch.core.reference import ALGORITHMS, WeightedDynamicSummary
from repro_torch.dist.router import REPLICA_EXEC_MODES
from repro_torch.ft.resilience import run_stream_with_recovery
from repro_torch.graph.streams import (barabasi_albert_edges,
                                       copying_model_edges,
                                       edges_to_fully_dynamic_stream,
                                       edges_to_insertion_stream)


def make_stream(kind: str, nodes: int, edges_per_node: int, beta: float,
                fully_dynamic: bool, seed: int):
    if kind == "copying":
        edges = copying_model_edges(nodes, edges_per_node, beta, seed)
    else:
        edges = barabasi_albert_edges(nodes, edges_per_node, seed)
    if fully_dynamic:
        return edges_to_fully_dynamic_stream(edges, seed=seed)
    return edges_to_insertion_stream(edges, seed=seed)


def run_reference(args, stream) -> None:
    """The Tier-A reference over the stream, on the host."""
    t0 = time.perf_counter()
    algo = ALGORITHMS[args.algo](seed=args.seed)
    if args.objective == "weighted":
        # the driver hooks are summary-agnostic: swap in the weighted host
        # state machine before any change is processed
        algo.s = WeightedDynamicSummary(weight_levels=args.weight_levels)
    if hasattr(algo, "c"):
        algo.c = args.c
    if hasattr(algo, "escape"):
        algo.escape = args.escape
    algo.run(stream)
    el = time.perf_counter() - t0
    phi, m = algo.s.phi, algo.s.num_edges
    print(f"phi={phi} |E|={m} compression_ratio={phi / max(m, 1):.4f}")
    print(f"total {el:.1f}s ({1e6 * el / max(len(stream), 1):.0f} "
          f"us/change)  trials={algo.stats.trials} "
          f"accepted={algo.stats.accepted}")


def main(argv=None) -> None:
    dflt = EngineConfig()
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device of the engine state (cuda or cpu); "
                         "the reference tier runs on the host and ignores "
                         "it")
    ap.add_argument("--engine", choices=["reference", "batched", "sharded"],
                    default="batched")
    ap.add_argument("--shards", type=int, default=None,
                    help="sharded: engine replicas (default: one per "
                         "position of the default mesh, i.e. every card on "
                         "cuda, 1 on cpu)")
    ap.add_argument("--routing", choices=["device", "host"], default="device",
                    help="sharded: device-side router or host bucketing")
    ap.add_argument("--router-chunk", type=int, default=1024,
                    help="sharded: changes per routed dispatch")
    ap.add_argument("--lane-cap", type=int, default=None,
                    help="sharded: per (source, shard) router lane capacity")
    ap.add_argument("--max-drain-rounds", type=int, default=None,
                    help="sharded: drain round budget (default: enough to "
                         "guarantee full delivery, with no watermark read)")
    ap.add_argument("--chunk-sync", action="store_true",
                    help="sharded: read the watermark every chunk even when "
                         "delivery is guaranteed")
    ap.add_argument("--no-pipeline", action="store_true",
                    help="sharded: run each chunk's engine stage right after "
                         "its route stage (bit-identical results)")
    ap.add_argument("--replica-exec", choices=list(REPLICA_EXEC_MODES),
                    default=None,
                    help="sharded: replica layout; 'vmap' steps the stacked "
                         "replicas as one batch, 'map' each in turn "
                         "(bit-identical; default: 'vmap' on cuda, 'map' on "
                         "cpu)")
    ap.add_argument("--algo", choices=list(ALGORITHMS), default="mosso",
                    help="reference: the Tier-A algorithm")
    ap.add_argument("--graph", choices=["ba", "copying"], default="ba")
    ap.add_argument("--nodes", type=int, default=2000)
    ap.add_argument("--deg", type=int, default=4)
    ap.add_argument("--beta", type=float, default=0.7)
    ap.add_argument("--fully-dynamic", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--c", type=int, default=dflt.c)
    ap.add_argument("--escape", type=float, default=dflt.escape)
    ap.add_argument("--batch", type=int, default=dflt.batch)
    ap.add_argument("--proposal", choices=list(PROPOSALS),
                    default=dflt.proposal,
                    help="candidate scheme (batched/sharded engines; the "
                         "reference analog is --algo mosso vs --algo mags)")
    ap.add_argument("--objective", choices=list(OBJECTIVES),
                    default=dflt.objective,
                    help="move-scoring objective (all engines)")
    ap.add_argument("--weight-levels", type=int, default=dflt.weight_levels,
                    help="weighted objective: node weights 1 + hash % N "
                         "(0/1 = uniform)")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="batched/sharded: crash-consistent mode — "
                         "write-ahead journal every dispatch chunk and "
                         "checkpoint epochs into this directory")
    ap.add_argument("--checkpoint-every", type=int, default=16,
                    help="chunks between epoch checkpoints "
                         "(with --checkpoint-dir)")
    ap.add_argument("--resume", action="store_true",
                    help="recover from --checkpoint-dir (last valid epoch "
                         "+ journal replay) before processing")
    ap.add_argument("--max-failures", type=int, default=3,
                    help="failed chunks tolerated before giving up "
                         "(with --checkpoint-dir)")
    args = ap.parse_args(argv)
    if args.checkpoint_dir and args.engine == "reference":
        ap.error("--checkpoint-dir requires --engine batched or sharded "
                 "(the reference tier has no checkpoint closure)")

    stream = make_stream(args.graph, args.nodes, args.deg, args.beta,
                         args.fully_dynamic, args.seed)
    print(f"stream: {len(stream)} changes")
    if args.engine == "reference":
        run_reference(args, stream)
        return
    n_cap = 1 << max(8, (args.nodes * 2).bit_length())
    m_cap = 1 << max(10, (len(stream) * 2).bit_length())
    cfg = EngineConfig(
        n_cap=n_cap, m_cap=m_cap, c=args.c, escape=args.escape,
        batch=args.batch, proposal=args.proposal, objective=args.objective,
        weight_levels=args.weight_levels)

    def make_summarizer():
        if args.engine == "batched":
            return BatchedSummarizer(cfg, device=args.device,
                                     checkpoint_dir=args.checkpoint_dir)
        # per-shard caps: a vertex cut replicates nodes over shards, so
        # n_cap budgets more than |V| / n_shards
        return ShardedSummarizer(
            cfg, device=args.device, n_shards=args.shards,
            routing=args.routing, router_chunk=args.router_chunk,
            lane_cap=args.lane_cap, max_drain_rounds=args.max_drain_rounds,
            chunk_sync=args.chunk_sync, pipeline=not args.no_pipeline,
            replica_exec=args.replica_exec,
            checkpoint_dir=args.checkpoint_dir)

    if args.checkpoint_dir:
        # the summarizers are built (and rebuilt after a fault) inside
        t0 = time.perf_counter()
        bs = run_stream_with_recovery(
            make_summarizer, stream, args.checkpoint_dir,
            ckpt_every=args.checkpoint_every, resume=args.resume,
            max_failures=args.max_failures)
    else:
        bs = make_summarizer()
        if args.engine == "sharded" and args.routing == "device":
            print(f"router: lane_cap={bs.lane_cap} "
                  f"max_drain_rounds={bs.max_drain_rounds} "
                  f"sync_free={bs.sync_free} pipeline={bs.pipeline} "
                  f"replica_exec={bs.replica_exec}")
        t0 = time.perf_counter()
        bs.run(stream)
    bs.flush()
    el = time.perf_counter() - t0
    device = bs.device
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    phi, m = bs.phi, bs.num_edges
    print(f"phi={phi} |E|={m} compression_ratio={phi / max(m, 1):.4f}")
    print(f"device={name} total {el:.1f}s "
          f"({1e6 * el / max(len(stream), 1):.0f} us/change)  {bs.stats()}")


if __name__ == "__main__":
    main()
