#!/usr/bin/env python3
"""The intern kernel on the card: a short run, and the yardsticks it was
chosen against.

    timeout 900 python3 tools/intern_check.py [--sharded] [--router]
        [--host-loop] [--host]

Builds the probe and intern kernels (printing ``nvcc``'s register and
spill lines for ``csrc/intern.cu``), runs ``tests/test_torch_intern_card.py``
(the kernel against its plain version on small stacked blocks), then
``chip_smoke.py``'s phase 22(a) (the kernel against its plain version at
full size, timed beside the byte bound and the ordered tail).
``--sharded`` runs phase 11 (the sharded path's probe launches, intern
launches and host reads a change) before it.  Two yardsticks that the
program does not keep:

* ``--host-loop``: the router's interning before the intern kernel (one
  probe launch for the pre-lookups, one host read, then on the host an
  insert launch a new key), timed on phase 22(a)'s cases of 1,024 hits,
  1,024 misses and phase 11's first chunk; its ids and tables must equal
  the kernel's.
* ``--router``: JAX's lowering of the engine stage under ``"vmap"`` (the
  dense step, ``trial.step_fn(..., dense=True)``, on device slices of the
  interned ids) beside the router's own (the branching step), each in a
  fresh ``ShardedSummarizer(full_config(), device="cuda:0", n_shards=4)``
  over one router chunk of the first ``ROUTER_CHANGES`` changes of phase
  11's stream: every replica and intern leaf equal, or the run fails;
  per lowering host reads a chunk, probe launches a change, us a change.

``--host`` splits a call's host time (the wrapper's checks, the
allocation, the pointers, the stream, the bare launch).  Each phase fails
the run as it does there.  Writes the results to
``build/intern_check.json``.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ROUTER_CHANGES = 64               # --router: one router chunk


def host_loop_intern(rows, buckets, n_cap: int):
    """The router's interning before the intern kernel: one probe launch
    for the ``2 R`` pre-lookups of the intern ``rows`` (row views of a
    stacked state), one host read of the buckets, the pre-lookups and the
    counters, then on the host, for each endpoint not found, in order, an
    insert-mode probe launch and the writes of a new key (a repeat within
    the call takes the id just given).  Returns the ids, numpy
    ``[R, L]``."""
    import numpy as np
    import torch
    from repro_torch.core.engine.hashtable import ht_set, probe_many
    from repro_torch.core.engine.ops import host_read
    uh, ul, vh, vl, _ = buckets.unbind(-1)
    valid = (uh >= 0) & (vh >= 0)
    h1u, h2u, h1v, h2v = (torch.where(valid, w, 0) for w in (uh, ul, vh, vl))
    jobs = []
    for r, ist in enumerate(rows):
        jobs.append((ist.h2l, h1u[r], h2u[r], True, "find"))
        jobs.append((ist.h2l, h1v[r], h2v[r], True, "find"))
    probed = probe_many(jobs)
    n_rep, n_lanes = uh.shape
    flat = np.asarray(host_read(torch.cat(
        [buckets.reshape(-1)]
        + [p[1].to(torch.int32) for p in probed] + [p[2] for p in probed]
        + [torch.stack([i.n_nodes, i.n_dropped]) for i in rows])), np.int32)
    n_b, n_f = buckets.numel(), 2 * n_rep * n_lanes
    host = flat[:n_b].reshape(buckets.shape)
    found = flat[n_b:n_b + n_f].reshape(2 * n_rep, n_lanes)
    val = flat[n_b + n_f:n_b + 2 * n_f].reshape(2 * n_rep, n_lanes)
    counts = flat[n_b + 2 * n_f:].reshape(n_rep, 2)
    u_out = np.full((n_rep, n_lanes), -1, np.int32)
    v_out = np.full((n_rep, n_lanes), -1, np.int32)
    for r, ist in enumerate(rows):
        n_nodes, n_dropped = (int(x) for x in counts[r])
        fresh = {}
        words = (h1u[r], h2u[r], h1v[r], h2v[r])
        for i in np.flatnonzero((host[r, :, 0] >= 0) & (host[r, :, 2] >= 0)):
            nids = []
            for side in (0, 1):
                j = 2 * r + side
                if found[j, i]:
                    nids.append(int(val[j, i]))
                    continue
                key = tuple(int(w) for w in host[r, i, 2 * side:2 * side + 2])
                nid = fresh.get(key)
                if nid is None:
                    if n_nodes < n_cap:
                        nid = fresh[key] = n_nodes
                        hi = words[2 * side][i:i + 1]
                        lo = words[2 * side + 1][i:i + 1]
                        ht_set(ist.h2l, hi, lo, ist.n_nodes.reshape(1),
                               prehashed=True)
                        ist.l2h[nid, 0:1] = hi
                        ist.l2h[nid, 1:2] = lo
                        ist.n_nodes += 1
                        n_nodes += 1
                    else:
                        n_dropped += 1
                        nid = -1
                nids.append(nid)
            if nids[0] >= 0 and nids[1] >= 0:
                u_out[r, i], v_out[r, i] = nids
        if n_dropped != counts[r, 1]:
            ist.n_dropped += n_dropped - int(counts[r, 1])
    return u_out, v_out


def host_loop_vs_kernel(stream, gen) -> list:
    """``--host-loop``: the host loop and the kernel from copies of one
    state, ids and every intern leaf equal; the host loop's time and the
    kernel's call (both to a synchronize) a case."""
    import numpy as np
    import torch
    import chip_smoke as cs
    from repro_torch.configs.mosso_stream import full_config
    from repro_torch.core.engine.state import copy_state, state_rows
    from repro_torch.kernels import ops
    cfg = full_config()
    base = cs._intern_block(cfg, cfg.n_cap // 2, gen)
    cases = [(f"{kind} x1024", base, cs._intern_buckets(base, 1024, kind,
                                                        gen))
             for kind in ("hits", "misses")]
    fresh, buckets = cs.chunk_buckets(stream, cfg)
    cases.append((f"phase 11 chunk 1 x{buckets.shape[1]}", fresh, buckets))
    out = []
    for name, state, bk in cases:
        times = {}
        for form in ("kernel", "host loop"):
            work = copy_state(state)
            torch.cuda.synchronize()
            t = time.perf_counter()
            if form == "kernel":
                u, v = (x.cpu().numpy() for x in ops.intern(
                    *cs._intern_args(work, bk), cfg.n_cap))
            else:
                hu, hv = host_loop_intern(state_rows(work), bk, cfg.n_cap)
            torch.cuda.synchronize()
            times[form] = 1e3 * (time.perf_counter() - t)
            leaves = [x.cpu() for x in cs._flat_intern(work)]
            if form == "kernel":
                want = leaves
            elif not (np.array_equal(hu, u) and np.array_equal(hv, v)
                      and all(torch.equal(a, b)
                              for a, b in zip(leaves, want))):
                raise AssertionError(f"host loop {name}: ids or intern "
                                     f"leaves differ from the kernel's")
            del work
        row = dict(case=name, kernel_call_ms=times["kernel"],
                   host_loop_ms=times["host loop"])
        cs.log(f"host loop {name:>22s}: {row['host_loop_ms']:.2f} ms, the "
               f"kernel's call {row['kernel_call_ms']:.3f} ms (first call "
               f"of the case); ids and intern leaves equal")
        out.append(row)
    del base, fresh, buckets
    torch.cuda.empty_cache()
    return out


def dense_engine_step(cfg, n_shards: int, acc_cap: int):
    """JAX's engine stage under ``"vmap"``, its dense lowering, for the
    router's stacked layout: each position interns its buckets (the
    intern kernel), one host read of every position's counts gives the
    round count (JAX's ``pmax``), then every round steps
    ``trial.step_fn(..., dense=True)`` on device slices of the ids, as
    JAX's ``round_body``.  The signature of
    ``router.make_engine_step``'s stage."""
    import numpy as np
    import torch
    from repro_torch.core.engine.ops import host_read
    from repro_torch.core.engine.trial import step_fn
    from repro_torch.dist import router
    b = cfg.batch

    def engine(ests, ists, telem, buckets, rounds: int) -> None:
        devices = [blk.device for blk in buckets]

        def intern(d: int):
            blk = buckets[d]
            u, v = router.intern_changes(ists[d], blk[..., 0], blk[..., 1],
                                         blk[..., 2], blk[..., 3], cfg.n_cap)
            return u, v, blk[..., 4], (blk[..., 0] >= 0).sum(1)

        interned = router.for_positions(intern, devices)
        counts = np.asarray(host_read(torch.cat(
            [c.to(devices[0], non_blocking=True) for *_, c in interned])))
        erounds = int((-(-counts // b)).max())

        def step(d: int) -> None:
            u, v, ins = (torch.nn.functional.pad(x, (0, b), value=f)
                         for x, f in zip(interned[d][:3], (-1, -1, 0)))
            for r in range(erounds):
                sl = slice(r * b, (r + 1) * b)
                step_fn(ests[d], u[:, sl], v[:, sl], ins[:, sl] != 0, cfg,
                        dense=True)

        router.for_positions(step, devices)
        telem += rounds - 1

    return engine


def dense_router_stage(stream) -> dict:
    """``--router``: the router's engine stage (the branching step) and
    JAX's dense lowering of it (:func:`dense_engine_step`) from fresh
    states over one router chunk; every replica and intern leaf equal
    after the flush.  The counts are set to 0 just before each run and
    read just after."""
    import torch
    import chip_smoke as cs
    from repro_torch.configs.mosso_stream import full_config
    from repro_torch.core.engine import ShardedSummarizer
    from repro_torch.core.engine.ops import host_read, reset_host_reads
    from repro_torch.kernels import ops

    t0 = time.perf_counter()
    cfg = full_config()
    changes = stream[:ROUTER_CHANGES]
    n = len(changes)
    cs.log(f"router: the engine stage at {cs.SHARDS} x full_config on one "
           f"card ('vmap'), branching and dense from fresh states over one "
           f"router chunk of the first {n} changes of phase 11's stream")
    res, leaves = dict(changes=n), {}
    for form in ("branching", "dense"):
        ss = ShardedSummarizer(cfg, device="cuda:0", n_shards=cs.SHARDS,
                               router_chunk=ROUTER_CHANGES)
        if form == "dense":
            ss._engine = dense_engine_step(cfg, cs.SHARDS,
                                           ss.router_geometry.acc_cap)
        torch.cuda.synchronize()
        ops.reset_counts()
        reset_host_reads()
        t = time.perf_counter()
        ss.process(changes)
        ss.flush()
        seconds = time.perf_counter() - t
        launches, interns, reads = (ops.ht_probe.launches,
                                    ops.intern.launches, host_read.count)
        if launches == 0 or interns == 0:
            raise AssertionError(f"router {form}: probe launches "
                                 f"{launches}, intern launches {interns}")
        stats = ss.stats()
        res[form] = dict(seconds=seconds, us_per_change=1e6 * seconds / n,
                         host_reads_per_chunk=reads,
                         probe_launches=launches,
                         launches_per_change=launches / n,
                         intern_launches=interns, trials=stats["trials"],
                         accepted=stats["accepted"], phi=stats["phi"])
        leaves[form] = cs._replica_leaves(ss)
        del ss
        torch.cuda.empty_cache()
    cs._check_leaves(leaves["dense"], leaves["branching"],
                     "router: dense vs branching engine stage")
    res["dense_over_branching_us"] = (res["dense"]["us_per_change"]
                                      / res["branching"]["us_per_change"])
    res["seconds"] = time.perf_counter() - t0
    for form in ("branching", "dense"):
        r = res[form]
        cs.log(f"router {form}: {r['us_per_change']:.1f} us/change, "
               f"{r['host_reads_per_chunk']} host reads a chunk, probe "
               f"launches {r['launches_per_change']:.2f}/change, "
               f"{r['intern_launches']} intern launches; {r['trials']} "
               f"trials, {r['accepted']} accepted, phi {r['phi']}")
    cs.log(f"router: dense == branching, every replica and intern leaf on "
           f"the card; dense / branching us per change "
           f"{res['dense_over_branching_us']:.2f}; {res['seconds']:.1f} s")
    return res


def host_split(stream, gen) -> dict:
    """``--host``: where a call's host time goes, on phase 11's first chunk
    with its arguments built once: ``ops.intern`` and ``intern_cuda``
    enqueued back to back (hits only: the second call of the chunk finds
    every key, so the state does not move), ``check_args`` alone, the
    output's allocation, the pointers, the stream, and the bare ``ctypes``
    launch; mean us of 200 each."""
    import torch
    import chip_smoke as cs
    from repro_torch.configs.mosso_stream import full_config
    from repro_torch.kernels import _build, intern, ops
    fresh, buckets = cs.chunk_buckets(stream, full_config())
    args = cs._intern_args(fresh, buckets)
    n_cap = full_config().n_cap
    ops.intern(*args, n_cap)           # every key held from here on
    torch.cuda.synchronize()
    table, l2h, nn, nd, words = args
    lib = _build.load(intern.SOURCE, intern._bind)
    uv = torch.empty((2, *words[0].shape), dtype=torch.int32, device="cuda")
    ptrs = [t.data_ptr() for t in (*table, l2h, nn, nd, *words)]
    stream_ptr = torch._C._cuda_getCurrentRawStream(0)
    parts = {
        "ops.intern": lambda: ops.intern(*args, n_cap),
        "intern_cuda": lambda: intern.intern_cuda(*args, n_cap),
        "check_args": lambda: intern.check_args(*args, n_cap),
        "torch.empty": lambda: torch.empty((2, *words[0].shape),
                                           dtype=torch.int32,
                                           device="cuda"),
        "data_ptr x12": lambda: [t.data_ptr() for t in (
            *table, l2h, nn, nd, *words)],
        "stream": lambda: torch._C._cuda_getCurrentRawStream(0),
        "ctypes launch": lambda: lib.intern_launch(
            0, buckets.shape[0], buckets.shape[1], table[0].shape[1], n_cap,
            *ptrs, *words[0].stride(), uv[0].data_ptr(), uv[1].data_ptr(),
            stream_ptr),
    }
    out = {}
    for name, fn in parts.items():
        fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(200):
            fn()
        out[name] = 1e6 * (time.perf_counter() - t) / 200
        torch.cuda.synchronize()
    cs.log("host split of an intern call (us, mean of 200 enqueued): "
           + ", ".join(f"{k} {v:.2f}" for k, v in out.items()))
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("intern_check: no CUDA device is visible", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke
    from repro_torch.graph.streams import (barabasi_albert_edges,
                                           edges_to_fully_dynamic_stream)
    from repro_torch.kernels import _build, ht_probe, intern

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    chip_smoke.log(f"card: {smi}; torch {torch.__version__}")
    chip_smoke.load_rates()
    built = _build.build_all([ht_probe.SOURCE, intern.SOURCE])
    for line in built[intern.SOURCE][1].strip().splitlines():
        chip_smoke.log(f"  nvcc: {line.strip()}")
    rc = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
         str(ROOT / "tests" / "test_torch_intern_card.py")],
        cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
    ).returncode
    if rc != 0:
        return rc
    out = dict(card=smi)
    stream = edges_to_fully_dynamic_stream(
        barabasi_albert_edges(chip_smoke.NODES, 4, 0), delete_prob=0.1,
        seed=0)[:chip_smoke.SHARDED_CHANGES]
    if "--sharded" in sys.argv:
        out["sharded"], ss, stream = chip_smoke.sharded_path(
            chip_smoke.NODES, 4, 0)
        del ss
        torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(0)
    out["intern"] = chip_smoke.intern_kernel_vs_plain(stream, gen)
    if "--host" in sys.argv:
        out["host_split"] = host_split(stream, gen)
    if "--host-loop" in sys.argv:
        out["host_loop"] = host_loop_vs_kernel(stream, gen)
    if "--router" in sys.argv:
        out["router"] = dense_router_stage(stream)
    (ROOT / "build").mkdir(exist_ok=True)
    (ROOT / "build" / "intern_check.json").write_text(
        json.dumps(out, indent=1, default=str))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
