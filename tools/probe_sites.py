#!/usr/bin/env python3
"""Probe launches and jobs per change, by engine call site, on the CPU.

    PYTHONPATH=src python tools/probe_sites.py [--nodes N]

Drives ``BatchedSummarizer(smoke_config(), device="cpu")`` over a fully
dynamic Barabasi-Albert stream of N nodes (degree 4, 10% deletions, seed
0) and counts every call of the probe dispatchers of ``kernels/ops.py``
(``ht_probe``, and ``ht_probe_many`` where the tree has it) by the engine
line that issued it: on the card each call is one launch (more only past
48 jobs).  The CPU runs the plain version, so the counts are those of the
card's path and no time here is a device time.
"""
from __future__ import annotations

import argparse
import sys
import traceback
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ENGINE_FILES = ("core/engine/", "serve/query.py")


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
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs.mosso_stream import smoke_config
    from repro_torch.core.engine import BatchedSummarizer
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
    cfg = smoke_config()
    stream = edges_to_fully_dynamic_stream(
        barabasi_albert_edges(args.nodes, 4, 0), delete_prob=0.1, seed=0)
    bs = BatchedSummarizer(cfg, device="cpu")
    for off in range(0, len(stream), cfg.batch):
        bs.process(stream[off:off + cfg.batch])
    n = len(stream)
    total, total_jobs = sum(calls.values()), sum(jobs.values())
    print(f"{n} changes, phi {bs.phi}: {total} probe launches "
          f"({total / n:.2f}/change), {total_jobs} jobs "
          f"({total_jobs / n:.2f}/change)")
    for site, count in sorted(calls.items(), key=lambda x: -x[1]):
        print(f"  {site:28s} {count:7d} launches {count / n:7.3f}/change, "
              f"{jobs[site] / n:7.3f} jobs/change")
    return 0


if __name__ == "__main__":
    sys.exit(main())
