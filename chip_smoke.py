#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) when it fails:

1. card: name and power limit, torch/CUDA versions; the three kernels
   built at once (one ``nvcc`` per source in ``src/repro_torch/csrc/``, into
   ``build/``), with ``nvcc``'s register and spill lines;
2. probe kernel vs plain: the CUDA probe kernel against its plain torch
   version, bitwise, on 2^25-slot tables (the full configuration's
   ``adj``/``epos`` capacity) at 53% occupancy (50% live plus 1/32
   tombstones) and at 70% (60% live plus 10% tombstones, where
   ``maybe_compact`` rebuilds), in both modes, plain and prehashed, with
   present, absent, garbage and sentinel keys, at every listed lane
   count; on tables of caps 8, 16 and 32 (half full, full with and
   without tombstones, random words); ``ops.ht_probe_many`` over jobs of
   every cap and mode in one launch and in two; a stacked ``[4, 2^20]``
   table as 4 jobs of one launch (timed beside 4 launches); at the end,
   again on a 2^24-slot table (``eab``/``snadj``/``snpos``) at the listed
   and the main path's lane counts, and times at both loads on the card
   beside the word bound and the sector traffic (device time from
   CUDA-graph replay, and the time of a call from Python);
3. summarizer path: ``BatchedSummarizer(full_config(), device="cuda")``
   over a fully dynamic BA stream; the probe kernel's launch count must
   move, ``phi == phi_recomputed()`` and the lossless decode must equal the
   stream's live edge set; us/change (whole stream and its later steps),
   probe launches, jobs and host syncs per change, table load, peak
   device memory;
4. reads: ``query()`` degree / has_edge / neighbors answers against the
   live edge set, us/query; then graph ops over that live summary: the
   query-served ``spmm`` == ``summary_spmm`` == the dense plain sum over
   the live edges (rtol = atol = 1e-4), both through the CSR kernel, and
   ``minhash_signature`` through the kernel equal to the plain oracle;
   then ``torch.profiler`` over one fresh full-config step (device busy
   share, kernels per change, top ops);
5. the smoke configuration on the card and on the CPU, every state leaf
   bitwise equal after every batch;
6. CSR kernel vs plain: ``csr_segment`` against its plain version for
   sum (rtol = atol = 1e-5), min and max (bitwise), with ±inf inputs and
   empty rows, at the ``full_graph_sm``, ``minibatch_lg`` (F = 128 and
   602) and ``ogb_products`` shapes; kernel, plain and ``torch.sparse.mm``
   times beside the byte bound;
7. GraphSAGE path: one graphsage-reddit ``full_config()`` inference
   request on a synthetic graph of Reddit's size (232,965 nodes,
   114,615,892 directed edges, on the host): 1024 seeds sampled 15-10,
   padded to ``minibatch_lg`` (n = e = 262,144, 602 features), forward on
   the card; its logits against the plain path's (the same forward on the
   CPU), rtol = atol = 1e-4; sampler seconds, ms per request, kernel
   launches per request, and where the forward's device time goes;
8. the egnn, dimenet and graphcast smoke configurations: the forward on
   the card against the plain forward on the CPU, rtol = atol = 1e-4;
9. flash-attention kernel vs plain: the CUDA kernels against their plain
   torch version at the sweep shapes of ``tests/test_kernels.py`` in
   float32 (rtol = atol = 2e-3) and bfloat16 (3e-2), at the smoke head
   widths 8 and 16, again in bf16 at the sweep's D = 64 and 128 shapes
   and two more (GQA, causal and not) in the strided layout the
   transformer hands over, and at the layer shapes of internlm2-20b
   (B = 2, H = 48, Hkv = 8, T = 4096, D = 128) and granite-moe-3b-a800m
   (B = 2, H = 24, Hkv = 8, T = 4096, D = 64), bf16, causal, strided, and
   internlm2-20b's in float32; at each layer shape the kernel variant, its
   device time (CUDA-graph replay) and TFLOP/s, the call from Python, the
   plain version and ``scaled_dot_product_attention`` beside the
   operation bound, and kernel / SDPA;
10. LM path: (a) internlm2-20b's full widths with 2 of its 48 layers in
   float32, B = 1, T = 512: the forward's logits on the card (kernel)
   against the same forward on the CPU (plain), rtol = atol = 1e-3, and
   teacher-forced ``decode_step`` on the card against the forward within
   2e-3; (b) one prefill request at internlm2-20b's ``full_config()`` (48
   layers, bf16, weights drawn on the card from the seed), B = 2,
   T = 4096: finite logits, 48 kernel launches per forward, all of them
   the ``wgmma`` variant (by the wrapper's count and by the profiled
   kernel names), ms cold and warm, device time by kind
   (``torch.profiler``), peak memory; (c)
   ``serve(..., full=True)`` on internlm2-20b, batch 4, prompt 16, 32
   tokens, ms per token beside the weight-read bound; (d) the smoke
   configurations of internlm2-20b, llama3-405b, granite-moe-3b-a800m and
   moonshot-v1-16b-a3b at T = 256, card (kernel) against CPU (plain),
   rtol = atol = 1e-4.

Matrix products run in full float32 (TF32 off).  It prints one JSON line
of kernels, the card's name and power limit, and as its last line
``{"ok": true, "device": {...}}``.  The full per-shape tables go to
``build/chip_smoke.json``.  Without a CUDA device, or without the
repository beside it, it exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory rate
LANES = (1, 3, 20, 32, 48, 64, 160, 16384, 1 << 16, 1 << 20)
CAP = 1 << 25                     # full_config's adj / epos capacity
CAP_SMALL = 1 << 24               # full_config's eab / snadj / snpos capacity
# (live, tombstones) of the 2^25-slot tables: half live plus 1/32 dead,
# and the 70% occupancy (live + tombstones) at which maybe_compact
# rebuilds a table
LOADS = {"53%": (CAP // 2, CAP // 32), "70%": (CAP * 6 // 10, CAP // 10)}
TINY_CAPS = (8, 16, 32)
STACKED = (4, 1 << 20, 16384)     # replicas, cap, lanes of the stacked form
NODES = 600                       # BA nodes of the main path's stream
FP32_OPS_PER_S = 67e12            # H100 SXM float32 rate outside tensor cores
BF16_OPS_PER_S = 989e12           # H100 SXM dense bf16 tensor-core rate
# words in the names of cuBLAS/CUTLASS matrix-product kernels
MATMUL_WORDS = ("gemm", "cutlass", "xmma", "matmul", "sm90", "nvjet", "gemv")
REDDIT_NODES = 232_965            # PyG's Reddit
REDDIT_EDGES = 114_615_892        # its directed edges
SEEDS = 1024                      # seed nodes of one GraphSAGE request
# (name, n, e, f) of the CSR kernel's comparisons: repro configs GNN_SHAPES
CSR_SHAPES = (("full_graph_sm", 3072, 10752, 1433),
              ("minibatch_lg", 262144, 262144, 128),
              ("minibatch_lg", 262144, 262144, 602),
              ("ogb_products", 2449408, 61859328, 100))
# (B, H, Hkv, T, D, causal) of the attention comparisons: the sweep of
# tests/test_kernels.py, then the smoke configs' head widths 8 and 16
ATTN_SHAPES = ((2, 4, 2, 256, 64, True), (1, 8, 8, 128, 128, True),
               (2, 4, 1, 384, 64, False), (2, 8, 2, 256, 8, True),
               (2, 4, 4, 256, 16, True))
# bf16 shapes of the wgmma kernel held to plain in the strided layout: the
# sweep's D = 64 and 128, then GQA over several tiles, causal and not
STRIDED_SHAPES = ((2, 4, 2, 256, 64, True), (1, 8, 8, 128, 128, True),
                  (2, 4, 1, 384, 64, False), (2, 8, 2, 512, 128, False),
                  (1, 4, 1, 1024, 128, True))
LAYER_SHAPE = (2, 48, 8, 4096, 128, True)   # internlm2-20b, B=2 T=4096
GRANITE_LAYER = (2, 24, 8, 4096, 64, True)  # granite-moe-3b-a800m
PREFILL = (2, 4096)               # (B, T) of the prefill request
SERVE = (4, 16, 32)               # batch, prompt, tokens of the serve run


_T0 = time.perf_counter()


def log(msg: str) -> None:
    print(f"[{time.perf_counter() - _T0:7.1f}s] {msg}", flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call between CUDA events, after a warm-up:
    a call from Python, wrapper and launch included."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int, replays: int = 5) -> float:
    """Mean device milliseconds per call: ``reps`` calls captured in one
    CUDA graph and replayed, so the host's cost per call drops out."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * replays)


# --------------------------------------------------------------------- #
# phase 2: kernel vs plain
# --------------------------------------------------------------------- #


def bulk_table(cap: int, n_keys: int, n_tomb: int, prehashed: bool, gen):
    """A valid linear-probe table of ``n_keys`` distinct keys, built in
    rounds (each pending key tries its next slot; one winner per free
    slot), then ``n_tomb`` of them tombstoned.  Every key sits behind a
    run of slots that were occupied when it passed them, and nothing is
    deleted during the build, so every find chain is intact."""
    import torch
    from repro_torch.core.engine.hashtable import EMPTY, TOMB, _probe_start
    dev = "cuda"
    # (node, slot)-like keys; a prehashed table is keyed by full-entropy
    # words (k1 ^ k2 must spread over the table, as label hashes do)
    k1 = torch.randint(0, (1 << 31) - 1 if prehashed else 1 << 20,
                       (n_keys,), generator=gen, device=dev,
                       dtype=torch.int32)
    k2 = torch.arange(n_keys, dtype=torch.int32, device=dev)
    start = _probe_start(k1, k2, cap, prehashed)
    off = torch.zeros_like(start)
    tk1 = torch.full((cap,), EMPTY, dtype=torch.int32, device=dev)
    tk2 = torch.full((cap,), EMPTY, dtype=torch.int32, device=dev)
    tval = torch.zeros((cap,), dtype=torch.int32, device=dev)
    owner = torch.full((cap,), -1, dtype=torch.int64, device=dev)
    pending = torch.arange(n_keys, device=dev)
    rounds = 0
    while pending.numel():
        slot = (start[pending] + off[pending]) & (cap - 1)
        free = tk1[slot] == EMPTY
        cand, cslot = pending[free], slot[free]
        owner[cslot] = cand
        won = owner[cslot] == cand
        w, ws = cand[won], cslot[won]
        tk1[ws], tk2[ws] = k1[w], k2[w]
        tval[ws] = (w + 1).to(torch.int32)
        placed = torch.zeros(n_keys, dtype=torch.bool, device=dev)
        placed[w] = True
        pending = pending[~placed[pending]]
        off[pending] += 1
        rounds += 1
        if rounds > 4096:
            raise RuntimeError(f"bulk insert: {pending.numel()} keys still "
                               f"pending after {rounds} rounds")
    live = (tk1 >= 0).nonzero().flatten()
    dead = live[torch.randperm(live.numel(), generator=gen,
                               device=dev)[:n_tomb]]
    tk1[dead], tk2[dead], tval[dead] = TOMB, TOMB, 0
    return (tk1, tk2, tval), rounds


def queries(tables, lanes: int, gen):
    """Present, absent and garbage (full int32 range) keys, in turn; half
    the garbage lanes are sentinel keys instead: ``(-1, -1)`` finds the
    first EMPTY, ``(-2, -2)`` the first TOMB, and ``(-1, x)`` and
    ``(-2, x)`` stop there (or pass it) without a match.  Random garbage
    never hits them."""
    import torch
    tk1, tk2, _ = tables
    dev = tk1.device
    live = (tk1 >= 0).nonzero().flatten()
    if live.numel() == 0:               # a tiny table of random words
        live = torch.zeros(1, dtype=torch.int64, device=dev)
    pick = live[torch.randint(0, live.numel(), (lanes,), generator=gen,
                              device=dev)]
    kind = torch.arange(lanes, device=dev) % 3
    absent1 = torch.randint(0, 1 << 20, (lanes,), generator=gen, device=dev,
                            dtype=torch.int32)
    absent2 = torch.randint(1 << 30, (1 << 31) - 1, (lanes,), generator=gen,
                            device=dev, dtype=torch.int32)
    g1 = torch.randint(-(1 << 31), (1 << 31) - 1, (lanes,), generator=gen,
                       device=dev, dtype=torch.int32)
    g2 = torch.randint(-(1 << 31), (1 << 31) - 1, (lanes,), generator=gen,
                       device=dev, dtype=torch.int32)
    q1 = torch.where(kind == 0, tk1[pick], torch.where(kind == 1, absent1, g1))
    q2 = torch.where(kind == 0, tk2[pick], torch.where(kind == 1, absent2, g2))
    idx = torch.arange(lanes, device=dev)
    sentinel = (kind == 2) & ((idx // 3) % 2 == 0)
    which = (idx // 6) % 4          # (-1,-1), (-2,-2), (-1,x), (-2,x)
    s1 = torch.where(which % 2 == 0, -1, -2).to(torch.int32)
    s2 = torch.where(which < 2, s1, g2)
    q1 = torch.where(sentinel, s1, q1)
    q2 = torch.where(sentinel, s2, q2)
    return q1.contiguous(), q2.contiguous()


def _traffic_ms(tables, q1, q2, prehashed: bool, words: int) -> float:
    """Least time at the device memory rate for the distinct units of
    ``words`` 4-byte words this call must read, each once: of k1 on every
    pass-1 chain, of k2 only where k1 equals the query's, of val at each
    chain end; plus 8 B of query and 9 B of output per lane."""
    import torch
    from repro_torch.kernels.ht_probe import probe_chains
    tk1, tk2, _ = tables
    cap, n = tk1.shape[0], q1.numel()
    start, i1, _ = probe_chains(tk1, tk2, q1, q2, prehashed=prehashed,
                                mode="find")
    steps = torch.clamp(i1 + 1, max=cap)
    lane = torch.repeat_interleave(torch.arange(n, device=tk1.device), steps)
    first = torch.repeat_interleave(torch.cumsum(steps, 0) - steps, steps)
    off = torch.arange(lane.numel(), device=tk1.device) - first
    slots = (start[lane] + off) & (cap - 1)
    k1_units = torch.unique(slots // words).numel()
    k2_units = torch.unique(slots[tk1[slots] == q1[lane]] // words).numel()
    val_units = torch.unique(((start + i1) & (cap - 1)) // words).numel()
    nbytes = 4 * words * (k1_units + k2_units + val_units) + (8 + 9) * n
    return 1e3 * nbytes / HBM_BYTES_PER_S


def bound_ms(tables, q1, q2, prehashed: bool) -> float:
    """The kernel's bound: the words it must move, each read once.  The
    same in both modes: insert mode's pass 2 runs only for absent keys,
    whose pass-1 chain ends at the first EMPTY, so pass 2 stops on a slot
    pass 1 already read."""
    return _traffic_ms(tables, q1, q2, prehashed, 1)


def sector_ms(tables, q1, q2, prehashed: bool) -> float:
    """The same count in the 32-byte sectors that scattered 4-byte reads
    cost on this card: a scale beside :func:`bound_ms`, not the bound."""
    return _traffic_ms(tables, q1, q2, prehashed, 8)


def check_equal(got, want, what: str) -> int:
    """Raise unless every (slot, found, val) equals the plain version's;
    returns the max |error| (0)."""
    import torch
    err = 0
    for g, w, name in zip(got, want, ("slot", "found", "val")):
        if g.dtype != w.dtype or not torch.equal(g, w):
            raise AssertionError(f"ht_probe {name} differs: {what}")
        if g.numel():
            err = max(err, int((g.long() - w.long()).abs().max()))
    return err


def kernel_vs_plain(tables_by_key, lane_counts, gen, time_it: bool):
    """Bitwise compare (and optionally time) kernel and plain version at
    every (load, prehashed, mode, lanes); ``tables_by_key`` maps
    ``(load, prehashed)`` to a table.  Returns rows and the max |error|."""
    from repro_torch.kernels.ht_probe import ht_probe_cuda, ht_probe_plain
    rows, max_err = [], 0
    for (load, prehashed), tables in tables_by_key.items():
        for mode in ("find", "insert"):
            for lanes in lane_counts:
                q1, q2 = queries(tables, lanes, gen)
                args = (*tables, q1, q2)
                kw = dict(prehashed=prehashed, mode=mode)
                what = (f"load={load} mode={mode} prehashed={prehashed} "
                        f"lanes={lanes}")
                max_err = max(max_err, check_equal(
                    ht_probe_cuda(*args, **kw), ht_probe_plain(*args, **kw),
                    what))
                row = dict(load=load, mode=mode, prehashed=prehashed,
                           lanes=lanes)
                if time_it:
                    reps = 200 if lanes <= 16384 else 20
                    launch = lambda: ht_probe_cuda(*args, **kw)  # noqa: E731
                    row["ms"] = graph_ms(launch, reps)
                    row["call_ms"] = cuda_ms(launch, reps)
                    row["plain_ms"] = cuda_ms(
                        lambda: ht_probe_plain(*args, **kw),
                        5 if lanes <= 16384 else 2)
                    row["bound_ms"] = bound_ms(tables, q1, q2, prehashed)
                    row["sector_ms"] = sector_ms(tables, q1, q2, prehashed)
                rows.append(row)
    return rows, max_err


def tiny_tables(gen) -> dict:
    """Tables of caps 8, 16 and 32 (at or below a tile's 8 threads, and the
    ``weab`` dummy's 8 slots), by name: half live with tombstones; full
    with tombstones (no EMPTY: an absent key's chain wraps all of cap and
    its windows straddle slot cap - 1); full with none; and random words
    in [-2, 3], a content no table holds (duplicate keys, EMPTY slots with
    a second word), on which kernel and plain version must still agree."""
    import torch
    out = {}
    for cap in TINY_CAPS:
        for pre in (False, True):
            out[f"cap{cap} half+tombs pre={pre}"] = (bulk_table(
                cap, cap // 2 + cap // 8, cap // 8, pre, gen)[0], pre)
            out[f"cap{cap} full+tombs pre={pre}"] = (bulk_table(
                cap, cap, cap // 4, pre, gen)[0], pre)
            out[f"cap{cap} full pre={pre}"] = (bulk_table(
                cap, cap, 0, pre, gen)[0], pre)
            words = torch.randint(-2, 4, (3, cap), generator=gen,
                                  device="cuda", dtype=torch.int32)
            out[f"cap{cap} random words pre={pre}"] = (
                tuple(w.contiguous() for w in words), pre)
    return out


def tiny_queries(tables, lanes: int, gen):
    """:func:`queries` plus keys drawn from the table's own words and from
    [-2, 3], so that small tables see hits, sentinels and near misses."""
    import torch
    q1, q2 = queries(tables, lanes, gen)
    small = torch.randint(-2, 4, (2, lanes), generator=gen, device="cuda",
                          dtype=torch.int32)
    pick = torch.arange(lanes, device="cuda") % 4 == 3
    return (torch.where(pick, small[0], q1).contiguous(),
            torch.where(pick, small[1], q2).contiguous())


def tiny_vs_plain(tiny, gen) -> int:
    """The tiny tables, both modes, 1 to 257 lanes, bitwise."""
    from repro_torch.kernels.ht_probe import ht_probe_cuda, ht_probe_plain
    max_err = 0
    for name, (tables, pre) in tiny.items():
        for mode in ("find", "insert"):
            for lanes in (1, 7, 64, 257):
                q1, q2 = tiny_queries(tables, lanes, gen)
                kw = dict(prehashed=pre, mode=mode)
                max_err = max(max_err, check_equal(
                    ht_probe_cuda(*tables, q1, q2, **kw),
                    ht_probe_plain(*tables, q1, q2, **kw),
                    f"{name} mode={mode} lanes={lanes}"))
    return max_err


def multi_job_vs_plain(tables_by_key, tiny, gen) -> dict:
    """``ops.ht_probe_many`` against the plain loop over its jobs,
    bitwise: one launch of jobs on tables of every cap (2^25 at both
    loads, 8 to 32), both modes and lane counts from 1 to 2048; then more
    jobs than one launch takes (two launches)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ht_probe import (MAX_JOBS, ProbeJob,
                                              ht_probe_many_plain)
    sources = [(t, pre) for (_, pre), t in tables_by_key.items()]
    sources += list(tiny.values())
    jobs = []
    for i in range(MAX_JOBS + 12):
        tables, pre = sources[i % len(sources)]
        lanes = (1, 3, 160, 2048)[i % 4]
        q1, q2 = tiny_queries(tables, lanes, gen)
        jobs.append(ProbeJob(*tables, q1, q2, pre, ("find", "insert")[
            (i + i // len(sources)) % 2]))
    out, max_err = {}, 0
    for n_jobs in (len(sources), len(jobs)):
        before = ops.ht_probe.launches
        got = ops.ht_probe_many(jobs[:n_jobs])
        launched = ops.ht_probe.launches - before
        want = ht_probe_many_plain(jobs[:n_jobs])
        for j, (g, w) in enumerate(zip(got, want)):
            max_err = max(max_err, check_equal(
                g, w, f"job {j} of {n_jobs} in one ht_probe_many"))
        if launched != -(-n_jobs // MAX_JOBS):
            raise AssertionError(f"{n_jobs} jobs took {launched} launches")
        out[f"{n_jobs} jobs"] = launched
    log(f"kernel vs plain: ht_probe_many bitwise equal, "
        + ", ".join(f"{k} in {v} launch(es)" for k, v in out.items()))
    return dict(launches=out, max_abs_err=max_err)


def stacked_vs_plain(gen) -> dict:
    """A stacked ``[4, 2^20]`` table (four replicas at 53% occupancy) with
    ``[4, B]`` queries as 4 jobs of one launch, bitwise against the plain
    loop, in both modes; timed beside four one-job launches."""
    import torch
    from repro_torch.kernels.ht_probe import (ht_probe_cuda,
                                              ht_probe_many_cuda,
                                              ht_probe_many_plain,
                                              stacked_jobs)
    r, cap, b = STACKED
    parts = [bulk_table(cap, cap // 2 + cap // 32, cap // 32, False, gen)[0]
             for _ in range(r)]
    tk1, tk2, tval = (torch.stack([p[w] for p in parts]) for w in range(3))
    qs = [queries(p, b, gen) for p in parts]
    q1 = torch.stack([q[0] for q in qs])
    q2 = torch.stack([q[1] for q in qs])
    res, max_err = {}, 0
    for mode in ("find", "insert"):
        jobs = stacked_jobs(tk1, tk2, tval, q1, q2, mode=mode)
        got, _ = ht_probe_many_cuda(jobs)
        for j, (g, w) in enumerate(zip(got, ht_probe_many_plain(jobs))):
            max_err = max(max_err, check_equal(
                g, w, f"stacked [{r}, {cap}] replica {j} mode={mode}"))
        one = graph_ms(lambda: ht_probe_many_cuda(jobs), 50)
        each = graph_ms(lambda: [ht_probe_cuda(*job[:5], mode=mode)
                                 for job in jobs], 50)
        res[mode] = dict(one_launch_ms=one, four_launches_ms=each,
                         call_ms=cuda_ms(lambda: ht_probe_many_cuda(jobs),
                                         50))
        log(f"stacked [{r}, 2^{cap.bit_length() - 1}] x {b} lanes "
            f"mode={mode}: bitwise equal; one launch {one * 1e3:.2f} us "
            f"(call {res[mode]['call_ms'] * 1e3:.2f} us), {r} launches "
            f"{each * 1e3:.2f} us")
    res["max_abs_err"] = max_err
    return res


# --------------------------------------------------------------------- #
# phases 3-5
# --------------------------------------------------------------------- #


def live_edges(stream):
    live = set()
    for (u, v, ins) in stream:
        e = (min(u, v), max(u, v))
        live.add(e) if ins else live.discard(e)
    return live


def main_path(nodes: int, deg: int, seed: int) -> dict:
    """Drive ``full_config()`` on the card over a BA stream of ``nodes``
    nodes; the stream's scale is far below the configuration's
    ``n_cap``/``m_cap``, so the tables stay nearly empty (their load is
    printed) while their capacity is full size."""
    import torch
    from repro_torch.configs.mosso_stream import full_config
    from repro_torch.core.engine import BatchedSummarizer
    from repro_torch.core.engine.ops import host_read
    from repro_torch.core.summary import pair_key
    from repro_torch.graph.streams import (barabasi_albert_edges,
                                           edges_to_fully_dynamic_stream)
    from repro_torch.kernels import ops

    cfg = full_config()
    stream = edges_to_fully_dynamic_stream(
        barabasi_albert_edges(nodes, deg, seed), delete_prob=0.1, seed=seed)
    n_batches = -(-len(stream) // cfg.batch)
    if n_batches < 2:
        raise ValueError(f"stream of {len(stream)} changes is under two "
                         f"batches of {cfg.batch}")
    log(f"main path: full_config (n_cap={cfg.n_cap} m_cap={cfg.m_cap} "
        f"d_cap={cfg.d_cap} sn_cap={cfg.sn_cap} c={cfg.c} "
        f"batch={cfg.batch}); BA n={nodes} m={deg}, fully dynamic: "
        f"{len(stream)} changes in {n_batches} batches")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    bs = BatchedSummarizer(cfg, device="cuda")
    torch.cuda.synchronize()
    state_bytes = torch.cuda.memory_allocated() - base

    ops.reset_counts()
    host_read.count = 0
    step_s = []
    t0 = time.perf_counter()
    for off in range(0, len(stream), cfg.batch):
        t = time.perf_counter()
        bs.process(stream[off:off + cfg.batch])
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
    elapsed = time.perf_counter() - t0
    launches = ops.ht_probe.launches
    jobs = ops.ht_probe.jobs
    by_batch = dict(ops.ht_probe.by_batch)
    syncs = host_read.count
    if launches == 0:
        raise AssertionError("the main path launched no probe kernel")

    phi, phi_re = bs.phi, bs.phi_recomputed()
    if phi != phi_re:
        raise AssertionError(f"phi {phi} != phi_recomputed {phi_re}")
    truth = live_edges(stream)
    decoded = bs.materialize().decode_edges()
    want = {pair_key(bs._ids[u], bs._ids[v]) for (u, v) in truth}
    if decoded != want:
        raise AssertionError(f"lossless decode differs from the live edge "
                             f"set: {len(decoded ^ want)} pairs")
    n = len(stream)
    # steady state: the full steps of the stream's second half (the first
    # steps, on a near-empty graph, pass most TN filters and cost most)
    later = step_s[len(step_s) // 2:-1] or step_s[:1]
    peak = torch.cuda.max_memory_allocated() - base
    pressure = bs.table_pressure()     # after the peak: it allocates
    res = dict(changes=n, batches=n_batches, seconds=elapsed,
               us_per_change=1e6 * elapsed / n,
               step_s=step_s,
               later_step_s=sum(later) / len(later),
               later_us_per_change=1e6 * sum(later) / (cfg.batch
                                                      * len(later)),
               table_occupancy=pressure,
               edges_per_m_cap=len(truth) / cfg.m_cap,
               probe_launches=launches, launches_per_change=launches / n,
               probe_jobs=jobs, jobs_per_change=jobs / n,
               launches_per_step=launches / n_batches,
               host_syncs=syncs, syncs_per_change=syncs / n,
               state_bytes=state_bytes,
               peak_bytes=peak,
               stats=bs.stats(), phi=phi, live_edges=len(truth),
               by_batch={f"{m}:{b}": c for (m, b), c in
                         sorted(by_batch.items(), key=lambda x: -x[1])})
    log(f"main path: {n} changes in {elapsed:.3f} s = "
        f"{res['us_per_change']:.1f} us/change; probe launches "
        f"{launches} ({res['launches_per_change']:.2f}/change, "
        f"{res['launches_per_step']:.1f}/step) serving {jobs} jobs "
        f"({res['jobs_per_change']:.2f}/change); host syncs {syncs} "
        f"({res['syncs_per_change']:.2f}/change); phi={phi} "
        f"|E|={len(truth)}; state {state_bytes / 2**30:.3f} GiB, peak "
        f"{res['peak_bytes'] / 2**30:.3f} GiB; {bs.stats()}")
    log(f"main path: later steps (second half, full) "
        f"{res['later_step_s']:.3f} s/step = "
        f"{res['later_us_per_change']:.1f} us/change; live edges "
        f"{len(truth)} = {100 * res['edges_per_m_cap']:.4f}% of m_cap; "
        f"table occupancy (live + tombstones) "
        + ", ".join(f"{k} {100 * v:.4f}%" for k, v in pressure.items()))
    log(f"main path: phi == phi_recomputed and the decode equals the "
        f"stream's {len(truth)} live edges")
    return res, bs, truth, by_batch, stream


def profile_step(stream, n_changes: int) -> dict:
    """Where one full-config step's time goes: ``torch.profiler`` over a
    fresh summarizer's first ``n_changes`` changes (one padded step)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs.mosso_stream import full_config
    from repro_torch.core.engine import BatchedSummarizer
    bs = BatchedSummarizer(full_config(), device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        bs.process(stream[:n_changes])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    rows = prof.key_averages()

    def dev(e):
        return getattr(e, "self_device_time_total", 0) or 0

    # device-side rows (kernels, copies): their self time is the device's
    gpu = [e for e in rows if str(e.device_type).endswith("CUDA")]
    device_us = sum(dev(e) for e in gpu)
    kernels = sum(e.count for e in gpu)
    top_dev = sorted(gpu, key=dev, reverse=True)[:8]
    top_cpu = sorted(rows, key=lambda e: e.self_cpu_time_total,
                     reverse=True)[:10]
    res = dict(changes=n_changes, wall_s=wall, device_busy_us=device_us,
               device_busy_share=device_us / 1e6 / wall,
               device_kernels=kernels,
               top_device=[(e.key, e.count, dev(e)) for e in top_dev],
               top_cpu=[(e.key, e.count, e.self_cpu_time_total)
                        for e in top_cpu])
    log(f"profile: {n_changes} changes under torch.profiler: wall "
        f"{wall:.3f} s, device busy {device_us / 1e3:.1f} ms "
        f"({100 * res['device_busy_share']:.2f}%), {kernels} device "
        f"kernels ({kernels / n_changes:.0f}/change)")
    for key, count, us in res["top_device"]:
        log(f"  device {us / 1e3:9.2f} ms  x{count:7d}  {key}")
    for key, count, us in res["top_cpu"]:
        log(f"  host   {us / 1e3:9.2f} ms  x{count:7d}  {key}")
    return res


def reads(bs, truth, n_labels: int, seed: int) -> dict:
    import random
    import torch
    rng = random.Random(seed)
    adj = {}
    for (u, v) in truth:
        adj.setdefault(u, set()).add(v)
        adj.setdefault(v, set()).add(u)
    view = bs.query()
    labels = rng.sample(view.seen_labels(), min(n_labels,
                                                len(view.seen_labels())))
    edges = sorted(truth)
    pairs = [edges[rng.randrange(len(edges))] for _ in range(n_labels // 2)]
    pairs += [(rng.choice(labels), rng.choice(labels))
              for _ in range(n_labels - len(pairs))]
    out = {}
    for name, fn, want in (
            ("degree", lambda: view.degree_batch(labels),
             [len(adj.get(x, ())) for x in labels]),
            ("has_edge", lambda: view.has_edge_batch(pairs),
             [(min(a, b), max(a, b)) in truth for (a, b) in pairs]),
            ("neighbors", lambda: view.neighbors_batch(labels),
             [adj.get(x, set()) for x in labels])):
        torch.cuda.synchronize()
        t = time.perf_counter()
        got = fn()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        if got != want:
            bad = sum(g != w for g, w in zip(got, want))
            raise AssertionError(f"query {name}: {bad} wrong answers")
        n = len(want)
        out[name] = dict(queries=n, us_per_query=1e6 * dt / n)
        log(f"reads: {name} x{n} right, {1e6 * dt / n:.1f} us/query")
    return out


def cuda_vs_cpu(seed: int) -> int:
    import numpy as np
    from repro_torch.configs.mosso_stream import smoke_config
    from repro_torch.core.engine import BatchedSummarizer
    from repro_torch.core.engine.state import state_to_numpy
    from repro_torch.graph.streams import (edges_to_fully_dynamic_stream,
                                           sbm_edges)
    cfg = smoke_config()
    stream = edges_to_fully_dynamic_stream(
        sbm_edges(60, 4, 0.5, 0.04, seed=seed), delete_prob=0.15,
        seed=seed + 1)
    on_card = BatchedSummarizer(cfg, device="cuda")
    on_cpu = BatchedSummarizer(cfg, device="cpu")
    n = 0
    for off in range(0, len(stream), cfg.batch):
        chunk = stream[off:off + cfg.batch]
        on_card.process(chunk)
        on_cpu.process(chunk)
        a, b = state_to_numpy(on_card.state), state_to_numpy(on_cpu.state)
        for k in a:
            for w, x in (a[k].items() if isinstance(a[k], dict)
                         else ((None, a[k]),)):
                y = b[k][w] if w else b[k]
                if not (x.dtype == y.dtype and np.array_equal(x, y)):
                    raise AssertionError(f"leaf {k}{'.' + w if w else ''} "
                                         f"differs after batch {n}")
        n += 1
    log(f"cuda vs cpu: smoke_config, {len(stream)} changes, every state "
        f"leaf bitwise equal after each of {n} batches (phi={on_cpu.phi})")
    return n



# --------------------------------------------------------------------- #
# graph ops: the CSR segment-reduce kernel and the paths that run it
# --------------------------------------------------------------------- #


def close(got, want, reduce: str, rtol: float = 1e-5,
          atol: float = 1e-5, what: str = "sum") -> float:
    """Max |got - want| after holding them equal: min/max bitwise, sum
    within the tolerances (NaN nowhere); ``what`` names a sum's check."""
    import torch
    if reduce == "sum":
        bad = ~((got - want).abs() <= atol + rtol * want.abs())
        if bool(bad.any()):
            raise AssertionError(f"{what} differs in {int(bad.sum())} "
                                 f"entries beyond rtol={rtol} atol={atol}")
    elif not torch.equal(got, want):
        raise AssertionError(f"{reduce} differs in "
                             f"{int((got != want).sum())} entries")
    fin = torch.isfinite(want)
    if not bool((torch.isfinite(got) == fin).all()):
        raise AssertionError(f"{reduce}: ±inf pattern differs")
    d = (got - want)[fin].abs()
    return float(d.max()) if d.numel() else 0.0


def csr_bound_ms(layout, x) -> tuple:
    """Least time for one segment-reduce at the device memory rate, each
    input read once (the senders, the offsets, the distinct rows of x
    that an edge gathers) and the output written once; and the gather
    count, which reads every edge's row: E (4 + 4F) + 4 (N + 1) + 4 N F.
    The adds (E F at the float32 rate) take far less."""
    import torch
    e = int(layout.row_off[-1] - layout.row_off[0])
    n, f = layout.row_off.numel() - 1, x.shape[1]
    used = torch.unique(layout.senders[int(layout.row_off[0]):
                                       int(layout.row_off[-1])]).numel()
    once = 4 * e + 4 * (n + 1) + 4 * f * used + 4 * n * f
    gather = e * (4 + 4 * f) + 4 * (n + 1) + 4 * n * f
    ops_ms = 1e3 * e * f / FP32_OPS_PER_S
    return (max(1e3 * once / HBM_BYTES_PER_S, ops_ms),
            1e3 * gather / HBM_BYTES_PER_S)


def library_spmm(layout, x):
    """``torch.sparse.mm`` on the CSR adjacency: the yardstick for sum,
    timed here and used nowhere in the port."""
    import warnings
    import torch
    lo, hi = int(layout.row_off[0]), int(layout.row_off[-1])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)   # "beta", invariants
        adj = torch.sparse_csr_tensor(
            (layout.row_off - lo).to(torch.int64),
            layout.senders[lo:hi].to(torch.int64),
            torch.ones(hi - lo, dtype=torch.float32, device=x.device),
            size=(layout.row_off.numel() - 1, x.shape[0]))
    return lambda: torch.sparse.mm(adj, x)


def time_csr(layout, x, reduce: str, big: bool) -> dict:
    import torch
    from repro_torch.kernels.csr_segment import (csr_segment_cuda,
                                                 csr_segment_plain)
    launch = lambda: csr_segment_cuda(*layout, x, reduce)  # noqa: E731
    row = dict(ms=graph_ms(launch, 3 if big else 20, 3),
               call_ms=cuda_ms(launch, 3 if big else 20),
               plain_ms=cuda_ms(lambda: csr_segment_plain(*layout, x,
                                                          reduce),
                                1 if big else 3))
    row["bound_ms"], row["gather_bound_ms"] = csr_bound_ms(layout, x)
    row["library_ms"] = (cuda_ms(library_spmm(layout, x), 3 if big else 20)
                         if reduce == "sum" else None)
    torch.cuda.empty_cache()
    return row


def csr_vs_plain(gen) -> tuple:
    """Kernel vs plain for sum/min/max at each shape of ``CSR_SHAPES``,
    uniform random edges (empty rows where e/n is small); min/max on x
    with ±inf planted in some rows.  Returns the rows and the max error."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.csr_segment import (csr_segment_cuda,
                                                 csr_segment_plain)
    rows, max_err = [], 0.0
    for name, n, e, f in CSR_SHAPES:
        t = time.perf_counter()
        s = torch.randint(0, n, (e,), generator=gen, device="cuda",
                          dtype=torch.int32)
        r = torch.randint(0, n, (e,), generator=gen, device="cuda",
                          dtype=torch.int32)
        x = torch.randn((n, f), generator=gen, device="cuda")
        x_inf = x.clone()
        x_inf[:64:2, :8] = float("inf")
        x_inf[1:64:2, :8] = float("-inf")
        layout = ops.csr_layout(s, r, n)
        empty = int((layout.degree() == 0).sum())
        for reduce in ("sum", "min", "max"):
            xin = x if reduce == "sum" else x_inf
            got = csr_segment_cuda(*layout, xin, reduce)
            want = csr_segment_plain(*layout, xin, reduce)
            torch.cuda.synchronize()
            err = close(got, want, reduce)
            max_err = max(max_err, err)
            del got, want
            row = dict(shape=name, n=n, e=e, f=f, reduce=reduce,
                       empty_rows=empty, max_abs_err=err,
                       **time_csr(layout, xin, reduce, big=e > 10 ** 7))
            rows.append(row)
            lib = ("" if row["library_ms"] is None else
                   f", torch.sparse.mm {row['library_ms'] * 1e3:.1f} us")
            log(f"csr_segment {name} n={n} e={e} F={f} {reduce}: kernel == "
                f"plain (max |err| {err:.2e}; {empty} empty rows); kernel "
                f"{row['ms'] * 1e3:.1f} us (call {row['call_ms'] * 1e3:.1f}"
                f" us), plain {row['plain_ms'] * 1e3:.1f} us{lib}; bound "
                f"{row['bound_ms'] * 1e3:.1f} us (each input once), "
                f"{row['gather_bound_ms'] * 1e3:.1f} us (every edge's row)")
        del s, r, x, x_inf, layout
        torch.cuda.empty_cache()
        log(f"csr_segment {name}: {time.perf_counter() - t:.1f} s")
    return rows, max_err


def graph_ops_over_summary(bs, truth, seed: int) -> dict:
    """Query-served spmm == summary_spmm == dense over the live summary,
    and the min-hash signatures through the kernel == the plain oracle."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.launch.gnn_over_summary import (aggregate_three_ways,
                                                     check_agree)
    n = max(max(e) for e in truth) + 1
    x = torch.from_numpy(np.random.default_rng(seed).normal(
        size=(n, 64)).astype(np.float32)).cuda()
    ops.reset_counts()
    t = time.perf_counter()
    ys = aggregate_three_ways(bs, sorted(truth), x)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = ops.segment_reduce.launches
    if launches == 0:
        raise AssertionError("graph ops over the summary launched no "
                             "segment-reduce kernel")
    err = check_agree(ys)
    s = torch.tensor([u for (u, v) in truth] + [v for (u, v) in truth],
                     dtype=torch.int32, device="cuda")
    r = torch.tensor([v for (u, v) in truth] + [u for (u, v) in truth],
                     dtype=torch.int32, device="cuda")
    ops.reset_counts()
    sig = ops.minhash_signature(s, r, n, seed + 11)
    if ops.segment_reduce.launches != 1:
        raise AssertionError("minhash_signature did not launch the kernel")
    want = ref.minhash_signature_ref(s.cpu(), r.cpu(), n, seed + 11)
    if not torch.equal(sig.cpu(), want):
        raise AssertionError("minhash_signature differs from the oracle")
    log(f"graph ops over the live summary: query-served spmm == "
        f"summary_spmm == dense over {len(truth)} live edges, n={n} "
        f"(max |diff| {err:.2e}; {launches} kernel launches; {wall:.2f} s "
        f"with the neighbor queries); minhash_signature of {n} nodes "
        f"equals the oracle")
    return dict(nodes=n, live_edges=len(truth), launches=launches,
                max_abs_diff=err, seconds=wall)


def device_breakdown(run, kinds) -> dict:
    """Device time of ``run()`` by kind, from ``torch.profiler``: ``kinds``
    maps each kind to words of its kernels' names (the first kind with a
    word in a kernel's name takes it; the rest is "other")."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t
    device_us = {k: 0.0 for k in (*kinds, "other")}
    top = {k: [] for k in device_us}
    count = 0
    for e in prof.key_averages():
        if not str(e.device_type).endswith("CUDA"):
            continue
        us = getattr(e, "self_device_time_total", 0) or 0
        count += e.count
        key = e.key.lower()
        kind = next((k for k, words in kinds.items()
                     if any(w in key for w in words)), "other")
        device_us[kind] += us
        top[kind].append((us, e.count, e.key[:120]))
    return dict(device_us=device_us, device_kernels=count,
                profiled_wall_s=wall,
                top={k: sorted(v, reverse=True)[:4] for k, v in top.items()})


def graphsage_request(seed: int) -> dict:
    """One graphsage-reddit full_config() inference request at full width
    (see phase 7), held to the plain path on the CPU."""
    import numpy as np
    import torch
    from repro_torch.configs.base import GNN_SHAPES
    from repro_torch.configs.graphsage_reddit import FANOUTS, full_config
    from repro_torch.data.synthetic import random_csr_graph
    from repro_torch.graph.sampling import pad_subgraph, sample_fanout
    from repro_torch.kernels import ops
    from repro_torch.kernels.csr_segment import (csr_segment_cuda,
                                                 csr_segment_plain)
    from repro_torch.models.gnn import (GraphBatch, gnn_forward, init_gnn,
                                        params_to)

    cfg = full_config()
    shape = GNN_SHAPES["minibatch_lg"]
    t = time.perf_counter()
    g = random_csr_graph(REDDIT_NODES, REDDIT_EDGES, seed)
    feats = np.random.default_rng(seed + 1).standard_normal(
        (REDDIT_NODES, cfg.d_in), dtype=np.float32)
    setup_s = time.perf_counter() - t
    log(f"graphsage: graph of {g.n_nodes} nodes, {int(g.indptr[-1])} "
        f"directed edges and {cfg.d_in} features on the host in "
        f"{setup_s:.1f} s")
    params = init_gnn(cfg, seed, device="cuda")

    def serve(rng):
        """One request: sample, pad, batch to the card, forward.  Returns
        the batch, the logits and the host seconds of each part."""
        t0 = time.perf_counter()
        seeds = rng.choice(g.n_nodes, SEEDS, replace=False)
        nodes, s, r = sample_fanout(g, seeds, FANOUTS, rng)
        padded = pad_subgraph(nodes, s, r, shape["n"], shape["e"])
        t1 = time.perf_counter()
        nodes_p, s_p, r_p, nmask, emask = padded
        arrays = (feats[nodes_p], s_p, r_p, emask, nmask,
                  np.zeros(shape["n"], np.int32))
        batch = GraphBatch(*(torch.from_numpy(a).cuda() for a in arrays))
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        logits = gnn_forward(params, batch, cfg)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        return batch, logits, dict(nodes=len(nodes), edges=len(s),
                                   sampler_s=t1 - t0, batch_s=t2 - t1,
                                   forward_s=t3 - t2, request_s=t3 - t0)

    rng = np.random.default_rng(seed + 2)
    torch.cuda.synchronize()
    # the path: counts set to 0 just before, read just after
    ops.reset_counts()
    batch, logits, first = serve(rng)
    launches = ops.segment_reduce.launches
    if launches == 0:
        raise AssertionError("the GraphSAGE request launched no "
                             "segment-reduce kernel")
    if tuple(logits.shape) != (shape["n"], cfg.n_classes) or not bool(
            torch.isfinite(logits).all()):
        raise AssertionError(f"logits {tuple(logits.shape)} not finite "
                             f"[{shape['n']}, {cfg.n_classes}]")
    # the plain path: the same forward on the CPU
    t = time.perf_counter()
    want = gnn_forward(params_to(params, "cpu"), batch.to("cpu"), cfg)
    plain_s = time.perf_counter() - t
    got = logits.cpu()
    bad = ~((got - want).abs() <= 1e-4 + 1e-4 * want.abs())
    if bool(bad.any()):
        raise AssertionError(f"GraphSAGE logits differ from the plain path "
                             f"in {int(bad.sum())} entries (rtol=atol=1e-4)")
    logit_err = float((got - want).abs().max())
    # steady forward time on the card (the same batch), and warm requests
    fwd_ms = cuda_ms(lambda: gnn_forward(params, batch, cfg), 20)
    warm = [serve(rng)[2] for _ in range(5)]
    med = {k: sorted(w[k] for w in warm)[len(warm) // 2]
           for k in ("sampler_s", "batch_s", "forward_s", "request_s")}
    breakdown = device_breakdown(
        lambda: gnn_forward(params, batch, cfg),
        {"csr_segment kernel": ("csr_segment",),
         "layout (sort/search)": ("sort", "radix", "search", "scan",
                                  "nonzero", "select"),
         "matmul": MATMUL_WORDS})
    # the kernel at this request's inputs: layer 1's projected rows, F=128
    layout = ops.csr_layout(batch.senders, batch.receivers, shape["n"],
                            batch.edge_mask)
    z = batch.node_feat @ params["layers"][0]["w_nbr"]
    k_err = close(csr_segment_cuda(*layout, z, "sum"),
                  csr_segment_plain(*layout, z, "sum"), "sum")
    kernel = dict(max_abs_err=k_err, **time_csr(layout, z, "sum", False))
    res = dict(graph_setup_s=setup_s, first=first, warm=warm,
               warm_median=med, launches=launches, forward_ms=fwd_ms,
               plain_forward_s=plain_s, logit_max_abs_err=logit_err,
               breakdown=breakdown, kernel=kernel)
    log(f"graphsage request: {SEEDS} seeds, fanout {FANOUTS}: "
        f"{first['nodes']} nodes, {first['edges']} edges, padded to "
        f"n=e={shape['n']}; {launches} segment-reduce launches per request;"
        f" logits [{shape['n']}, {cfg.n_classes}] == the CPU plain path "
        f"(max |err| {logit_err:.2e}; CPU forward {plain_s:.2f} s)")
    for name, r in (("first (cold)", first), ("warm median of 5", med)):
        log(f"graphsage {name}: request {1e3 * r['request_s']:.1f} ms = "
            f"sampler {1e3 * r['sampler_s']:.1f} ms (host) + batch to the "
            f"card {1e3 * r['batch_s']:.1f} ms + forward "
            f"{1e3 * r['forward_s']:.2f} ms")
    log(f"graphsage forward on one batch, CUDA events over 20: "
        f"{fwd_ms:.3f} ms")
    # the forward's matmuls: per layer x @ w_self and x @ w_nbr, then the head
    dims = [cfg.d_in] + [cfg.d_hidden] * cfg.n_layers
    flops = 2 * shape["n"] * (sum(2 * a * b for a, b in zip(dims, dims[1:]))
                              + cfg.d_hidden * cfg.n_classes)
    res["matmul_flops"] = flops
    us = breakdown["device_us"]
    log("graphsage forward device time (torch.profiler): " + ", ".join(
        f"{k} {v:.1f} us" for k, v in us.items())
        + f" ({breakdown['device_kernels']} device kernels); matmuls "
        f"{flops / 1e9:.1f} GFLOP = "
        f"{flops / max(us['matmul'], 1e-9) / 1e6:.1f} TFLOP/s")
    for kind, rows in breakdown["top"].items():
        for t_us, count, key in rows:
            log(f"  {kind:22s} {t_us:9.1f} us  x{count:3d}  {key}")
    log(f"csr_segment at the request's layer-1 input (F=128, "
        f"{int(layout.row_off[-1])} edges): kernel {kernel['ms'] * 1e3:.1f}"
        f" us, plain {kernel['plain_ms'] * 1e3:.1f} us, torch.sparse.mm "
        f"{kernel['library_ms'] * 1e3:.1f} us, bound "
        f"{kernel['bound_ms'] * 1e3:.1f} us")
    return res


def smoke_archs(seed: int) -> dict:
    """egnn / dimenet / graphcast smoke configs: the forward on the card
    (the CSR kernel) against the same forward on the CPU (plain)."""
    import torch
    from repro_torch.configs import dimenet, egnn, graphcast
    from repro_torch.data.synthetic import graph_batch
    from repro_torch.kernels import ops
    from repro_torch.models.gnn import gnn_forward, init_gnn, params_to
    out = {}
    for mod, coords in ((egnn, True), (dimenet, True), (graphcast, False)):
        cfg = mod.smoke_config()
        batch = graph_batch(2048, 8192, cfg.d_in, cfg.n_classes, seed=seed,
                            with_coords=coords, device="cpu")
        params = init_gnn(cfg, seed, device="cpu")
        want = gnn_forward(params, batch, cfg)
        card = params_to(params, "cuda")
        ops.reset_counts()
        got = gnn_forward(card, batch.to("cuda"), cfg)
        torch.cuda.synchronize()
        launches = ops.segment_reduce.launches
        if launches == 0:
            raise AssertionError(f"{cfg.name} launched no kernel")
        got = got.cpu()
        bad = ~((got - want).abs() <= 1e-4 + 1e-4 * want.abs())
        if bool(bad.any()):
            raise AssertionError(f"{cfg.name}: card forward differs from "
                                 f"the CPU in {int(bad.sum())} entries")
        err = float((got - want).abs().max())
        out[cfg.name] = dict(launches=launches, max_abs_err=err)
        log(f"{cfg.name}: forward on the card == plain forward on the CPU "
            f"(n=2048, e=8192; max |err| {err:.2e}; {launches} kernel "
            f"launches)")
    return out


# --------------------------------------------------------------------- #
# LM inference: the flash-attention kernel and the paths that run it
# --------------------------------------------------------------------- #


def attn_inputs(b, h, hkv, t, d, dtype, gen, strided: bool = False):
    """q, k, v drawn on the card; ``strided`` lays them out as the
    transformer hands them over: ``[B, T, heads, D]`` memory viewed as
    ``[B, heads, T, D]``."""
    import torch

    def draw(heads):
        shape = (b, t, heads, d) if strided else (b, heads, t, d)
        x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        return x.transpose(1, 2) if strided else x
    return draw(h), draw(hkv), draw(hkv)


def attn_bound_ms(q, k, causal: bool) -> float:
    """Least time for one attention call: the larger of its useful flops
    (2 D for q.k and 2 D for p.v per (query, key) pair it keeps; causal
    keeps T (T + 1) / 2 pairs per head) at the card's peak for the dtype
    (bf16 tensor cores, or float32 outside them) and its bytes (q, k, v
    read once, o written once) at the device memory rate."""
    import torch
    b, h, tq, d = q.shape
    tk = k.shape[2]
    pairs = tq * (tq + 1) // 2 if causal else tq * tk
    flops = 4 * d * b * h * pairs
    rate = BF16_OPS_PER_S if q.dtype == torch.bfloat16 else FP32_OPS_PER_S
    nbytes = q.element_size() * (2 * q.numel() + 2 * k.numel())
    return max(1e3 * flops / rate, 1e3 * nbytes / HBM_BYTES_PER_S)


def attention_vs_plain(gen) -> tuple:
    """Phase 9: kernel vs plain at every listed shape, and its times at the
    layer shapes.  Returns (rows, max |err|, {arch: bf16 layer row})."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     flash_attention_plain,
                                                     kernel_variant)
    rows, max_err = [], 0.0
    bf16, f32 = (torch.bfloat16, 3e-2), (torch.float32, 2e-3)
    shapes = [(*dt, *s, False) for dt in (f32, bf16) for s in ATTN_SHAPES]
    shapes += [(*bf16, *s, True) for s in STRIDED_SHAPES]
    # the layer shapes: internlm2-20b's in float32 (SIMT) and bf16
    # (wgmma), granite's in bf16 (wgmma); strided, as the transformer
    shapes += [(*f32, *LAYER_SHAPE, True), (*bf16, *LAYER_SHAPE, True),
               (*bf16, *GRANITE_LAYER, True)]
    layers = {}
    for dtype, tol, b, h, hkv, t, d, causal, strided in shapes:
        shape = (b, h, hkv, t, d, causal)
        q, k, v = attn_inputs(b, h, hkv, t, d, dtype, gen, strided=strided)
        got = flash_attention_cuda(q, k, v, causal=causal)
        want = flash_attention_plain(q, k, v, causal=causal)
        torch.cuda.synchronize()
        err = close(got.float(), want.float(), "sum", tol, tol,
                    f"flash_attention {dtype} {shape} strided={strided}")
        max_err = max(max_err, err)
        variant = kernel_variant(dtype, d)
        row = dict(dtype=str(dtype), b=b, h=h, hkv=hkv, t=t, d=d,
                   causal=causal, strided=strided, variant=variant, tol=tol,
                   max_abs_err=err)
        rows.append(row)
        log(f"flash_attention {variant:5s} {str(dtype)[6:]:8s} B={b} H={h} "
            f"Hkv={hkv} T={t} D={d} causal={causal} strided={strided}: "
            f"kernel == plain (max |err| {err:.2e}, tol {tol})")
        del got, want
        if shape in (LAYER_SHAPE, GRANITE_LAYER):
            def launch():
                return flash_attention_cuda(q, k, v, causal=True)
            row["ms"] = graph_ms(launch, 3, 3)
            row["call_ms"] = cuda_ms(launch, 5)
            row["plain_ms"] = cuda_ms(
                lambda: flash_attention_plain(q, k, v, causal=True), 2)
            row["library_ms"] = cuda_ms(
                lambda: F.scaled_dot_product_attention(
                    q, k, v, is_causal=True, enable_gqa=True), 10)
            row["bound_ms"] = attn_bound_ms(q, k, True)
            flops = 4 * d * b * h * (t * (t + 1) // 2)
            row["tflops"] = flops / row["ms"] / 1e9
            row["kernel_over_library"] = row["ms"] / row["library_ms"]
            arch = "internlm2-20b" if shape == LAYER_SHAPE else \
                "granite-moe-3b-a800m"
            if dtype == torch.bfloat16:
                layers[arch] = row
            log(f"flash_attention at {arch}'s layer shape, "
                f"{str(dtype)[6:]} ({variant}): kernel {row['ms']:.3f} ms "
                f"({row['tflops']:.1f} TFLOP/s; call {row['call_ms']:.3f} "
                f"ms), plain {row['plain_ms']:.3f} ms, "
                f"scaled_dot_product_attention {row['library_ms']:.3f} ms "
                f"(kernel / SDPA {row['kernel_over_library']:.2f}), bound "
                f"{row['bound_ms']:.3f} ms (operations, {flops / 1e9:.1f} "
                f"GFLOP at the {str(dtype)[6:]} peak)")
        del q, k, v
    torch.cuda.empty_cache()
    return rows, max_err, layers


def lm_card_vs_cpu(seed: int) -> dict:
    """Phase 10(a): internlm2-20b's full widths, 2 layers, float32."""
    import dataclasses
    import torch
    from repro_torch.configs import internlm2_20b
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as tfm
    cfg = dataclasses.replace(internlm2_20b.full_config(), n_layers=2,
                              param_dtype=torch.float32,
                              compute_dtype=torch.float32)
    params = tfm.init_transformer(cfg, seed, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    toks = torch.randint(0, cfg.vocab, (1, 512), generator=gen,
                         device="cuda")
    ops.reset_counts()
    logits = tfm.forward(params, toks, cfg)
    torch.cuda.synchronize()
    launches = ops.attention.launches
    if launches != cfg.n_layers:
        raise AssertionError(f"2-layer forward launched the attention "
                             f"kernel {launches} times")
    t = time.perf_counter()
    want = tfm.forward(tfm.params_to(params, "cpu"), toks.cpu(), cfg)
    cpu_s = time.perf_counter() - t
    err = close(logits.cpu(), want, "sum", 1e-3, 1e-3,
                "2-layer f32 logits, card vs CPU")
    del want
    cache = tfm.init_cache(cfg, 1, 512, device="cuda")
    t = time.perf_counter()
    dec_err = 0.0
    for i in range(512):
        lg, cache = tfm.decode_step(params, cache, toks[:, i], cfg)
        dec_err = max(dec_err, float((lg - logits[:, i]).abs().max()))
    torch.cuda.synchronize()
    dec_s = time.perf_counter() - t
    if dec_err >= 2e-3:
        raise AssertionError(f"decode diverged from forward: {dec_err}")
    log(f"lm (a): internlm2-20b widths, 2 layers, f32, B=1 T=512: logits on "
        f"the card == the CPU's (max |err| {err:.2e}, rtol=atol=1e-3; CPU "
        f"forward {cpu_s:.1f} s; {launches} kernel launches); 512 "
        f"teacher-forced decode steps == forward (max |err| {dec_err:.2e} "
        f"< 2e-3; {1e3 * dec_s / 512:.2f} ms/step)")
    return dict(max_abs_err=err, decode_max_abs_err=dec_err,
                launches=launches, cpu_forward_s=cpu_s,
                decode_ms_per_step=1e3 * dec_s / 512)


def lm_prefill_request(seed: int) -> dict:
    """Phase 10(b): one prefill request at internlm2-20b's full config."""
    import torch
    from repro_torch.configs import internlm2_20b
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as tfm
    from repro_torch.models.common import param_count
    cfg = internlm2_20b.full_config()
    b, t = PREFILL
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params = tfm.init_transformer(cfg, seed, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = param_count(params)
    param_bytes = torch.cuda.memory_allocated() - base
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    toks = torch.randint(0, cfg.vocab, (b, t), generator=gen, device="cuda")
    log(f"lm (b): internlm2-20b full_config: {n_params / 1e9:.3f} B "
        f"parameters ({param_bytes / 1e9:.2f} GB on the card) drawn in "
        f"{init_s:.1f} s; prompt B={b} T={t}")
    torch.cuda.reset_peak_memory_stats()
    # the path: counts set to 0 just before, read just after
    ops.reset_counts()
    t0 = time.perf_counter()
    logits = tfm.forward(params, toks, cfg)
    torch.cuda.synchronize()
    cold_ms = 1e3 * (time.perf_counter() - t0)
    launches = ops.attention.launches
    peak = torch.cuda.max_memory_allocated()
    by_variant = dict(ops.attention.by_variant)
    if launches != cfg.n_layers or by_variant != {"wgmma": cfg.n_layers}:
        raise AssertionError(f"the prefill forward launched the attention "
                             f"kernel {launches} times ({by_variant}), not "
                             f"{cfg.n_layers} of the wgmma variant")
    if tuple(logits.shape) != (b, t, cfg.vocab_padded) or not bool(
            torch.isfinite(logits[..., :cfg.vocab]).all()):
        raise AssertionError(f"logits {tuple(logits.shape)} not finite")
    del logits
    warm = []
    for _ in range(2):
        t0 = time.perf_counter()
        tfm.forward(params, toks, cfg)
        torch.cuda.synchronize()
        warm.append(1e3 * (time.perf_counter() - t0))
    warm_ms = min(warm)
    breakdown = device_breakdown(
        lambda: tfm.forward(params, toks, cfg),
        {"attention kernel": ("flash_attention",), "matmul": MATMUL_WORDS})
    names = [key for _, _, key in breakdown["top"]["attention kernel"]]
    if not names or not all("flash_attention_wgmma_kernel" in n
                            for n in names):
        raise AssertionError(f"profiled attention kernels: {names}")
    # projections, FFN and head: 2 flops per weight per token
    mm_flops = 2 * b * t * (n_params - cfg.vocab_padded * cfg.d_model
                            - 2 * cfg.n_layers * cfg.d_model - cfg.d_model)
    attn_flops = cfg.n_layers * 4 * cfg.d_head * b * cfg.n_heads * (
        t * (t + 1) // 2)
    us = breakdown["device_us"]
    res = dict(batch=b, seq=t, params=n_params, param_bytes=param_bytes,
               init_s=init_s, cold_ms=cold_ms, warm_ms=warm_ms,
               warm_runs_ms=warm, launches=launches, by_variant=by_variant,
               peak_bytes=peak, matmul_flops=mm_flops,
               attention_flops=attn_flops, breakdown=breakdown,
               tokens_per_s=b * t / (warm_ms / 1e3))
    log(f"lm (b): prefill forward cold {cold_ms:.1f} ms, warm "
        f"{warm_ms:.1f} ms ({res['tokens_per_s']:.0f} tokens/s); "
        f"{launches} attention-kernel launches per forward "
        f"({by_variant}); peak device "
        f"memory {peak / 1e9:.2f} GB")
    log("lm (b): forward device time (torch.profiler): " + ", ".join(
        f"{k} {v / 1e3:.1f} ms" for k, v in us.items())
        + f" ({breakdown['device_kernels']} device kernels); matmuls "
        f"{mm_flops / 1e12:.1f} TFLOP = "
        f"{mm_flops / max(us['matmul'], 1e-9) / 1e6:.1f} TFLOP/s; attention"
        f" {attn_flops / 1e12:.2f} TFLOP = "
        f"{attn_flops / max(us['attention kernel'], 1e-9) / 1e6:.1f} "
        f"TFLOP/s")
    for kind, rows in breakdown["top"].items():
        for t_us, count, key in rows:
            log(f"  {kind:16s} {t_us / 1e3:10.2f} ms  x{count:4d}  {key}")
    del params
    torch.cuda.empty_cache()
    return res


def lm_serve(seed: int, n_params: int) -> dict:
    """Phase 10(c): the serve loop at internlm2-20b's full config
    (``n_params``: its parameter count, for the weight-read bound)."""
    import torch
    from repro_torch.configs import internlm2_20b
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import serve
    cfg = internlm2_20b.full_config()
    batch, prompt_len, n_tok = SERVE
    ops.reset_counts()
    t0 = time.perf_counter()
    out = serve(internlm2_20b.ARCH_ID, batch, prompt_len, n_tok, seed,
                device="cuda", full=True)
    total_s = time.perf_counter() - t0
    toks = out["tokens"]
    if tuple(toks.shape) != (batch, n_tok) or not bool(
            ((toks >= 0) & (toks < cfg.vocab)).all()):
        raise AssertionError(f"serve gave tokens {tuple(toks.shape)} "
                             f"outside [0, {cfg.vocab})")
    # every bf16 weight is read once per token except the embedding
    # table, of which a step gathers one row per request
    n = n_params - cfg.vocab_padded * cfg.d_model + batch * cfg.d_model
    bound_ms = 1e3 * 2 * n / HBM_BYTES_PER_S
    res = dict(batch=batch, prompt_len=prompt_len, tokens=n_tok,
               prefill_s=out["prefill_s"], decode_s=out["decode_s"],
               ms_per_token=out["ms_per_token"], bound_ms=bound_ms,
               total_s=total_s, attention_launches=ops.attention.launches)
    log(f"lm (c): serve(internlm2-20b, full=True) batch {batch}, prompt "
        f"{prompt_len}, {n_tok} tokens: {out['ms_per_token']:.2f} ms/token "
        f"decode (weight-read bound {bound_ms:.2f} ms), teacher-forced "
        f"prefill {1e3 * out['prefill_s'] / prompt_len:.2f} ms/token; "
        f"{total_s:.1f} s with the weights drawn; attention-kernel launches "
        f"{ops.attention.launches} (decode takes kernels/ref.py)")
    torch.cuda.empty_cache()
    return res


def lm_decode_profile(seed: int, ms_per_token: float) -> dict:
    """Where a full-config decode step's time goes: ``torch.profiler``
    over the serve loop (batch 4, 4 prompt tokens teacher-forced, 4
    generated: 8 steps) on weights drawn anew.  The device busy share is
    the profiled device time per step over the unprofiled ms per token of
    phase 10(c) (the profiler slows the host)."""
    import torch
    from repro_torch.configs import internlm2_20b
    from repro_torch.launch.serve import generate
    from repro_torch.models import transformer as tfm
    cfg = internlm2_20b.full_config()
    params = tfm.init_transformer(cfg, seed, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    prompt = torch.randint(0, cfg.vocab, (SERVE[0], 4), generator=gen,
                           device="cuda")
    generate(params, cfg, prompt, 2)               # warm-up
    prof = device_breakdown(lambda: generate(params, cfg, prompt, 4), {})
    steps = 8
    device_us = prof["device_us"]["other"]
    kernels = prof["device_kernels"]
    res = dict(steps=steps, device_ms_per_step=device_us / 1e3 / steps,
               profiled_wall_ms_per_step=1e3 * prof["profiled_wall_s"]
               / steps,
               kernels_per_step=kernels / steps,
               device_busy_share=device_us / 1e3 / steps / ms_per_token)
    log(f"lm (c): decode step under torch.profiler: device "
        f"{res['device_ms_per_step']:.2f} ms/step, {kernels / steps:.0f} "
        f"device kernels/step; device busy "
        f"{100 * res['device_busy_share']:.1f}% of the unprofiled "
        f"{ms_per_token:.2f} ms/token (profiled wall "
        f"{res['profiled_wall_ms_per_step']:.2f} ms/step)")
    del params
    torch.cuda.empty_cache()
    return res


def lm_smoke_archs(seed: int) -> dict:
    """Phase 10(d): the four LM smoke configs, card vs CPU, T = 256."""
    import torch
    from repro_torch.configs import (granite_moe_3b_a800m, internlm2_20b,
                                     llama3_405b, moonshot_v1_16b_a3b)
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as tfm
    out = {}
    for mod in (internlm2_20b, llama3_405b, granite_moe_3b_a800m,
                moonshot_v1_16b_a3b):
        cfg = mod.smoke_config()
        params = tfm.init_transformer(cfg, seed, device="cpu")
        toks = torch.randint(0, cfg.vocab, (2, 256),
                             generator=torch.Generator().manual_seed(seed))
        want = tfm.forward(params, toks, cfg)
        ops.reset_counts()
        got = tfm.forward(tfm.params_to(params, "cuda"), toks.cuda(), cfg)
        torch.cuda.synchronize()
        launches = ops.attention.launches
        if launches != cfg.n_layers:
            raise AssertionError(f"{cfg.name} launched the kernel "
                                 f"{launches} times")
        err = close(got.cpu(), want, "sum", 1e-4, 1e-4,
                    f"{cfg.name} card vs CPU")
        out[cfg.name] = dict(launches=launches, max_abs_err=err,
                             d_head=cfg.d_head)
        log(f"lm (d): {cfg.name} (D={cfg.d_head}) forward on the card == "
            f"the CPU's at B=2 T=256 (max |err| {err:.2e}; {launches} kernel"
            f" launches)")
    return out


# --------------------------------------------------------------------- #


def main() -> int:
    seed = 0

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {ROOT}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import (_build, csr_segment, flash_attention,
                                     ht_probe)
    # full float32 matrix products on the card, as on the CPU
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    log(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda},"
        f" python {sys.version.split()[0]}")
    t = time.perf_counter()
    built = _build.build_all([ht_probe.SOURCE, csr_segment.SOURCE,
                              flash_attention.SOURCE])
    build_s = time.perf_counter() - t
    log(f"build: {', '.join(p.name for p, _ in built.values())} in "
        f"{build_s:.2f} s (one nvcc per source, started together)")
    for _, nvcc_out in built.values():
        for line in nvcc_out.strip().splitlines():
            log(f"  nvcc: {line.strip()}")

    # 2. kernel vs plain at the full configuration's table size, at PR
    # 11's load and at the compaction threshold
    gen = torch.Generator(device="cuda").manual_seed(seed)
    tables = {}
    for load, (n_live, n_tomb) in LOADS.items():
        for pre in (False, True):
            t = time.perf_counter()
            tables[load, pre], rounds = bulk_table(CAP, n_live + n_tomb,
                                                   n_tomb, pre, gen)
            log(f"table: cap=2^25 load {load} prehashed={pre}: {n_live} "
                f"live + {n_tomb} tombstones in {rounds} rounds "
                f"({time.perf_counter() - t:.1f} s)")
    _, max_err = kernel_vs_plain(tables, LANES, gen, time_it=False)
    log(f"kernel vs plain: bitwise equal (slot, found, val) at loads "
        f"{list(LOADS)} x find/insert x plain/prehashed at lanes "
        f"{list(LANES)}, sentinel keys among the garbage lanes")
    tiny = tiny_tables(gen)
    max_err = max(max_err, tiny_vs_plain(tiny, gen))
    log(f"kernel vs plain: bitwise equal on {len(tiny)} tiny tables (caps "
        f"{list(TINY_CAPS)}: half, full with and without tombstones, "
        f"random words) in find/insert at 1-257 lanes")
    multi = multi_job_vs_plain(tables, tiny, gen)
    stacked = stacked_vs_plain(gen)
    max_err = max(max_err, multi["max_abs_err"], stacked["max_abs_err"])

    # 3. main path (counts set to 0 just before, read just after)
    path_res, bs, truth, by_batch, stream = main_path(NODES, 4, seed)
    # 4. reads
    read_res = reads(bs, truth, 256, seed)
    #    and the graph ops over the live summary (counts set to 0 inside)
    summary_ops = graph_ops_over_summary(bs, truth, seed)
    del bs
    # key_averages() takes ~0.7 ms per event: 8 changes are ~60k kernels
    prof_res = profile_step(stream, 8)
    # 5. the smoke configuration on the card and on the CPU
    cuda_vs_cpu(seed)

    # the kernel at the main path's lane counts on a table of the main
    # path's other capacity (eab / snadj / snpos), at 53% load
    lanes = sorted(set(LANES) | {b for (_, b) in by_batch})
    t = time.perf_counter()
    small, rounds = bulk_table(CAP_SMALL, CAP_SMALL // 2 + CAP_SMALL // 32,
                               CAP_SMALL // 32, False, gen)
    _, err = kernel_vs_plain({("53%", False): small}, lanes, gen,
                             time_it=False)
    max_err = max(max_err, err)
    del small
    log(f"kernel vs plain: bitwise equal on a cap=2^24 table ({rounds} "
        f"rounds, {time.perf_counter() - t:.1f} s) in find/insert at lanes "
        f"{lanes}")

    # times of the kernel at the listed and the main path's shapes, at
    # both loads
    rows, _ = kernel_vs_plain(tables, lanes, gen, time_it=True)
    for (mode, b), count in by_batch.items():
        for r in rows:
            if (r["load"], r["mode"], r["lanes"], r["prehashed"]) == (
                    "53%", mode, b, False):
                r["main_path_jobs"] = count
    for r in rows:
        log(f"ht_probe load={r['load']} mode={r['mode']:6s} "
            f"prehashed={r['prehashed']!s:5s} lanes={r['lanes']:8d}: "
            f"kernel {r['ms'] * 1e3:8.2f} us (call {r['call_ms'] * 1e3:7.2f}"
            f" us), plain {r['plain_ms'] * 1e3:11.2f} us, bound "
            f"{r['bound_ms'] * 1e3:9.3f} us (sectors "
            f"{r['sector_ms'] * 1e3:9.3f} us), main-path jobs "
            f"{r.get('main_path_jobs', 0)}")
    log("ht_probe: no single PyTorch call walks a probe chain, so "
        "library_ms is null")
    top = max(rows, key=lambda r: r.get("main_path_jobs", 0))
    del tables
    torch.cuda.empty_cache()

    # 6. the CSR kernel vs plain at the GNN shapes
    csr_rows, csr_err = csr_vs_plain(gen)
    # 7. the GraphSAGE path (counts set to 0 inside, just before it)
    sage = graphsage_request(seed)
    # 8. the other archs' smoke configs, card vs CPU
    archs = smoke_archs(seed)
    torch.cuda.empty_cache()

    # 9. the flash-attention kernel vs plain, and its times at the layer
    # shape
    attn_rows, attn_err, layers = attention_vs_plain(gen)
    layer = layers["internlm2-20b"]
    # 10. the LM path: (a) full widths, 2 layers, card vs CPU; (b) one
    # full-config prefill request (counts set to 0 inside, just before
    # it); (c) the serve loop at full config; (d) the smoke configs
    lm_a = lm_card_vs_cpu(seed)
    torch.cuda.empty_cache()
    lm_b = lm_prefill_request(seed)
    lm_c = lm_serve(seed, lm_b["params"])
    lm_c["profile"] = lm_decode_profile(seed, lm_c["ms_per_token"])
    lm_d = lm_smoke_archs(seed)

    out_dir = ROOT / "build"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(dict(
        card=smi, torch=torch.__version__, cuda=torch.version.cuda,
        build_s=build_s, kernel_rows=rows, probe_multi_job=multi,
        probe_stacked=stacked, main_path=path_res,
        profile=prof_res, reads=read_res, summary_ops=summary_ops,
        csr_rows=csr_rows, graphsage=sage, smoke_archs=archs,
        attention_rows=attn_rows, lm_card_vs_cpu=lm_a, lm_prefill=lm_b,
        lm_serve=lm_c, lm_smoke_archs=lm_d), indent=1))

    entry = dict(name="ht_probe", route="cuda",
                 source="src/repro_torch/csrc/ht_probe.cu",
                 replaces="src/repro/kernels/ht_probe.py:61",
                 launches=path_res["probe_launches"], max_abs_err=max_err,
                 ms=top["ms"], call_ms=top["call_ms"],
                 plain_ms=top["plain_ms"],
                 bound_ms=top["bound_ms"], bound_by="bytes",
                 library_ms=None, variant="tile8", mode=top["mode"],
                 lanes=top["lanes"], load=top["load"],
                 jobs=path_res["probe_jobs"])
    k = sage["kernel"]
    csr_entry = dict(name="csr_segment", route="cuda",
                     source="src/repro_torch/csrc/csr_segment.cu",
                     replaces="src/repro/kernels/csr_segment.py:34",
                     launches=sage["launches"],
                     max_abs_err=max(csr_err, k["max_abs_err"]),
                     ms=k["ms"], call_ms=k["call_ms"],
                     plain_ms=k["plain_ms"], bound_ms=k["bound_ms"],
                     bound_by="bytes", library_ms=k["library_ms"],
                     shape="graphsage request, layer 1, F=128, sum")
    attn_entry = dict(name="flash_attention", route="cuda",
                      source="src/repro_torch/csrc/flash_attention.cu",
                      replaces="src/repro/kernels/flash_attention.py:25",
                      launches=lm_b["launches"], max_abs_err=attn_err,
                      ms=layer["ms"], call_ms=layer["call_ms"],
                      plain_ms=layer["plain_ms"], bound_ms=layer["bound_ms"],
                      bound_by="operations", library_ms=layer["library_ms"],
                      variant=layer["variant"],
                      shape="internlm2-20b layer: B=2 H=48 Hkv=8 T=4096 "
                            "D=128 bf16 causal",
                      granite_layer={key: layers["granite-moe-3b-a800m"][key]
                                     for key in ("ms", "library_ms",
                                                 "bound_ms", "plain_ms",
                                                 "max_abs_err")})
    print(json.dumps({"kernels": [entry, csr_entry, attn_entry]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
