#!/usr/bin/env python3
"""Probe launches and jobs per change, by engine call site, on the CPU.

    PYTHONPATH=src python tools/probe_sites.py [--nodes N] [--shards R]
        [--search full]

Drives ``BatchedSummarizer(smoke_config(), device="cpu")`` over a fully
dynamic Barabasi-Albert stream of N nodes (degree 4, 10% deletions, seed
0) and counts every call of the probe dispatchers of ``kernels/ops.py``
(``ht_probe``, and ``ht_probe_many`` where the tree has it) by the engine
line that issued it: on the card each call is one launch (more only past
48 jobs).  ``--shards R`` drives ``ShardedSummarizer(n_shards=R)`` with
its defaults instead (device routing, ``router_chunk`` 1024).  ``--search
full`` takes ``full_config()``'s search parameters (``c``, ``batch``,
``escape``, ``d_cap``, ``sn_cap``) with the capacities cut to the stream
(``n_cap``, ``m_cap`` as the stream CLI sizes them), which changes no
trial: the counts are those of the full configuration's path.  Also
prints trials and host reads (``ops.host_read.count``) per change.  The
CPU runs the plain version, so the counts are those of the card's path
and no time here is a device time.
"""
from __future__ import annotations

import argparse
import sys
import traceback
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ENGINE_FILES = ("core/engine/", "serve/query.py", "dist/router.py")


def call_site() -> str:
    """The innermost engine line on the stack outside the hashtable layer
    and the two-table helpers (``ops._lookup_both`` and the like)."""
    for frame in reversed(traceback.extract_stack()[:-2]):
        path = frame.filename.replace("\\", "/")
        if (any(f in path for f in ENGINE_FILES)
                and not path.endswith("hashtable.py")
                and not frame.name.endswith("_both")):
            return f"{'/'.join(path.split('/')[-2:])}:{frame.lineno}"
    return "?"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nodes", type=int, default=120)
    ap.add_argument("--shards", type=int, default=0,
                    help="replicas of a ShardedSummarizer (0: batched)")
    ap.add_argument("--search", choices=["smoke", "full"], default="smoke")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    import dataclasses
    from repro_torch.configs.mosso_stream import full_config, smoke_config
    from repro_torch.core.engine import BatchedSummarizer, ShardedSummarizer
    from repro_torch.core.engine.ops import host_read
    from repro_torch.graph.streams import (barabasi_albert_edges,
                                           edges_to_fully_dynamic_stream)
    from repro_torch.kernels import ops

    calls, jobs = Counter(), Counter()

    def counted(fn, n_jobs):
        def wrapper(*a, **k):
            site = call_site()
            calls[site] += 1
            jobs[site] += n_jobs(a)
            return fn(*a, **k)
        return wrapper

    ops.ht_probe = counted(ops.ht_probe, lambda a: 1)
    if hasattr(ops, "ht_probe_many"):
        ops.ht_probe_many = counted(ops.ht_probe_many, lambda a: len(a[0]))
    stream = edges_to_fully_dynamic_stream(
        barabasi_albert_edges(args.nodes, 4, 0), delete_prob=0.1, seed=0)
    cfg = smoke_config()
    if args.search == "full":
        cfg = dataclasses.replace(
            full_config(),
            n_cap=1 << max(8, (args.nodes * 2).bit_length()),
            m_cap=1 << max(10, (len(stream) * 2).bit_length()))
    host_read.count = 0
    if args.shards:
        bs = ShardedSummarizer(cfg, device="cpu", n_shards=args.shards)
        bs.run(stream)
        bs.flush()
    else:
        bs = BatchedSummarizer(cfg, device="cpu")
        for off in range(0, len(stream), cfg.batch):
            bs.process(stream[off:off + cfg.batch])
    n, syncs = len(stream), host_read.count
    total, total_jobs = sum(calls.values()), sum(jobs.values())
    print(f"{n} changes, phi {bs.phi}, trials {bs.stats()['trials']} "
          f"({bs.stats()['trials'] / n:.2f}/change), host reads {syncs} "
          f"({syncs / n:.2f}/change): {total} probe launches "
          f"({total / n:.2f}/change), {total_jobs} jobs "
          f"({total_jobs / n:.2f}/change)")
    for site, count in sorted(calls.items(), key=lambda x: -x[1]):
        print(f"  {site:28s} {count:7d} launches {count / n:7.3f}/change, "
              f"{jobs[site] / n:7.3f} jobs/change")
    return 0


if __name__ == "__main__":
    sys.exit(main())
