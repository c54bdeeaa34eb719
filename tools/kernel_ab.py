#!/usr/bin/env python3
"""The intern and rebuild kernels beside a parent checkout's, on one card.

    git archive <commit> src | tar -x -C build/parent
    timeout 900 python3 tools/kernel_ab.py --baseline build/parent

Loads the parent's ``kernels/intern.py`` and ``kernels/ht_rebuild.py``
under other names, pointed at the parent's ``csrc/`` sources (each built
by ``nvcc`` beside this checkout's), and times both versions on the same
inputs in the order parent, this, this, parent: the intern kernel on
``chip_smoke.py`` phase 22(a)'s cases (phase 11's first chunk, 1,024
changes a row of hits, misses and repeats, 64 keys on one start) and the
rebuild kernel on phase 15(b)'s tables (2^25 slots at 70%, plain and
prehashed; 2^24) and a 2^25-slot table as sparse as phase 3's ``adj``
at the end of its stream (4,312 live, 151 tombstones).  Each version's ids, tables and counters must equal the
other's bitwise.  Device time by CUDA events (the intern after a spin
kernel, best of 5 a turn), and the intern's call from Python to a sync.
Writes ``build/kernel_ab.json``.
"""
from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SPARSE_LIVE, SPARSE_DEAD = 4312, 151   # phase 3's adj (2^25 slots) at its end


def load_parent(base: Path, name: str):
    """The parent's wrapper module ``kernels/<name>.py``, its ``SOURCE``
    the parent's ``csrc/<name>.cu``."""
    path = base / "src" / "repro_torch" / "kernels" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"parent_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.SOURCE = base / "src" / "repro_torch" / "csrc" / f"{name}.cu"
    return mod


def intern_turn(fn, base, buckets, n_cap):
    """One turn of one version: ids and state after a call from ``base``,
    the best device time of 5 and the mean call of 5 (µs)."""
    import torch
    import chip_smoke as cs
    from repro_torch.core.engine.state import copy_state
    work = copy_state(base)
    args = cs._intern_args(work, buckets)
    dev, call = [], []
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    out = None
    for _ in range(5):
        for a, b in zip(cs._flat_intern(work), cs._flat_intern(base)):
            a.copy_(b)
        torch.cuda._sleep(2_000_000)
        start.record()
        out = fn(*args, n_cap)
        end.record()
        torch.cuda.synchronize()
        dev.append(1e3 * start.elapsed_time(end))
        for a, b in zip(cs._flat_intern(work), cs._flat_intern(base)):
            a.copy_(b)
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn(*args, n_cap)
        torch.cuda.synchronize()
        call.append(1e6 * (time.perf_counter() - t))
    leaves = [x.clone() for x in (*out, *cs._flat_intern(work))]
    return leaves, min(dev), sum(call) / len(call)


def rebuild_turn(mod, table, pre):
    import torch
    out = mod.ht_rebuild_cuda(*table, prehashed=pre)
    res = tuple(torch.empty_like(t) for t in table)
    status = torch.zeros(1, dtype=torch.int32, device="cuda")
    ms = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        mod.launch_cuda(*table, res, status, prehashed=pre)
        end.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end))
    return list(out), min(ms)


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device is visible", file=sys.stderr)
        return 2
    if "--baseline" not in sys.argv:
        print("kernel_ab: --baseline <parent checkout> is needed",
              file=sys.stderr)
        return 2
    base_dir = Path(sys.argv[sys.argv.index("--baseline") + 1]).resolve()
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as cs
    from repro_torch.configs.mosso_stream import full_config
    from repro_torch.graph.streams import (barabasi_albert_edges,
                                           edges_to_fully_dynamic_stream)
    from repro_torch.kernels import ht_rebuild, intern
    from repro_torch.testing import tables

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    cs.log(f"card: {smi}; torch {torch.__version__}; parent {base_dir}")
    cs.load_rates()
    versions = {"parent": (load_parent(base_dir, "intern"),
                           load_parent(base_dir, "ht_rebuild")),
                "this": (intern, ht_rebuild)}
    order = ("parent", "this", "this", "parent")
    gen = torch.Generator(device="cuda").manual_seed(0)
    cfg = full_config()
    stream = edges_to_fully_dynamic_stream(
        barabasi_albert_edges(cs.NODES, 4, 0), delete_prob=0.1,
        seed=0)[:cs.SHARDED_CHANGES]
    out = dict(card=smi, intern={}, rebuild={})
    held = cs._intern_block(cfg, cfg.n_cap // 2, gen)
    rng = np.random.default_rng(28)
    fresh, chunk = cs.chunk_buckets(stream, cfg)
    cases = {"phase 11 chunk": (fresh, chunk)}
    for kind in ("hits", "misses", "repeats"):
        cases[f"{kind} x1024"] = (held, cs._intern_buckets(held, 1024, kind,
                                                           gen))
    cases["shared_start x1024"] = (held, torch.from_numpy(
        tables.intern_buckets("shared_start", cs.SHARDS, 1024,
                              held.h2l.k1.shape[1], rng)).cuda())
    for name, (base, buckets) in cases.items():
        row = {v: dict(ms=[], call=[]) for v in versions}
        leaves = {}
        for v in order:
            got, ms, call = intern_turn(versions[v][0].intern_cuda, base,
                                        buckets, cfg.n_cap)
            row[v]["ms"].append(ms)
            row[v]["call"].append(call)
            leaves[v] = got
        if not all(torch.equal(a, b) for a, b in zip(leaves["parent"],
                                                      leaves["this"])):
            raise AssertionError(f"intern {name}: parent != this")
        out["intern"][name] = row
        cs.log(f"intern {name}: device us parent {row['parent']['ms']} "
               f"this {row['this']['ms']}; call us parent "
               f"{[round(c, 1) for c in row['parent']['call']]} this "
               f"{[round(c, 1) for c in row['this']['call']]}; equal")
    del held, fresh, cases
    torch.cuda.empty_cache()
    big = {}
    for pre in (False, True):
        big[f"2^25 prehashed={pre}", pre] = cs.bulk_table(
            cs.CAP, *cs.rebuild_counts(cs.CAP, "70%"), pre, gen)[0]
    big["2^24 prehashed=False", False] = cs.bulk_table(
        cs.CAP_SMALL, *cs.rebuild_counts(cs.CAP_SMALL, "70%"), False,
        gen)[0]
    # the occupancy of phase 3's adj table at the end of its stream
    big["2^25 sparse", False] = cs.bulk_table(
        cs.CAP, SPARSE_LIVE + SPARSE_DEAD, SPARSE_DEAD, False, gen)[0]
    for (name, pre), table in big.items():
        row = {v: [] for v in versions}
        got = {}
        for v in order:
            got[v], ms = rebuild_turn(versions[v][1], table, pre)
            row[v].append(ms)
        if not all(torch.equal(a, b) for a, b in zip(got["parent"],
                                                      got["this"])):
            raise AssertionError(f"rebuild {name}: parent != this")
        out["rebuild"][name] = dict(row, bound_ms=cs.rebuild_bound_ms(
            table[0]))
        cs.log(f"rebuild {name}: kernel ms parent {row['parent']} this "
               f"{row['this']} (bound {out['rebuild'][name]['bound_ms']:.3f}"
               f"); equal")
    (ROOT / "build").mkdir(exist_ok=True)
    (ROOT / "build" / "kernel_ab.json").write_text(json.dumps(out, indent=1))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
