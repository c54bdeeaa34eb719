"""MoSSo streaming CLI on the PyTorch engine.

Port of the ``--engine batched`` path of ``repro/launch/stream.py``:
summarize a synthetic dynamic graph stream with :class:`BatchedSummarizer`
and report phi, the compression ratio (Eq. 3) and the time per change.
The search and batch defaults come from the port's ``EngineConfig``.
``--device`` picks where the engine runs (default ``cuda``).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.stream --batch 64
  PYTHONPATH=src python -m repro_torch.launch.stream --device cpu \
      --nodes 200 --fully-dynamic
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.core.engine import BatchedSummarizer, EngineConfig
from repro_torch.core.engine.state import OBJECTIVES, PROPOSALS
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


def main(argv=None) -> None:
    dflt = EngineConfig()
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device of the engine state (cuda or cpu)")
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
                    default=dflt.proposal)
    ap.add_argument("--objective", choices=list(OBJECTIVES),
                    default=dflt.objective)
    ap.add_argument("--weight-levels", type=int, default=dflt.weight_levels,
                    help="weighted objective: node weights 1 + hash % N "
                         "(0/1 = uniform)")
    args = ap.parse_args(argv)

    stream = make_stream(args.graph, args.nodes, args.deg, args.beta,
                         args.fully_dynamic, args.seed)
    print(f"stream: {len(stream)} changes")
    n_cap = 1 << max(8, (args.nodes * 2).bit_length())
    m_cap = 1 << max(10, (len(stream) * 2).bit_length())
    cfg = EngineConfig(
        n_cap=n_cap, m_cap=m_cap, c=args.c, escape=args.escape,
        batch=args.batch, proposal=args.proposal, objective=args.objective,
        weight_levels=args.weight_levels)
    bs = BatchedSummarizer(cfg, device=args.device)
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
