#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) when it fails:

1. card: name and power limit, torch/CUDA versions; the five kernels
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
   table as 4 jobs of one launch, given as 4 row jobs and as one stacked
   job (timed beside 4 launches); at the end,
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
   602), ``ogb_products`` and ``molecule`` shapes, and min at F = 1
   (``minhash_signature``'s width) at ``minibatch_lg``'s n and e; kernel,
   plain and ``torch.sparse.mm`` times beside the byte bound;
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
   rtol = atol = 1e-4;
11. sharded path: ``ShardedSummarizer(full_config(), device="cuda:0",
   n_shards=4)`` (one card on any host; device routing, ``router_chunk``
   1024, the card's default ``replica_exec="vmap"``: one stacked step)
   over the first ``SHARDED_CHANGES`` (one router chunk) of phase 3's
   stream, cut to keep the script inside its time limit; the probe
   kernel's launch count must move, ``phi == phi_recomputed()``, the
   merged lossless decode and ``live_edges()``
   must equal the stream's live edge set, and sharded degree / has_edge /
   neighbors reads from a ``query()`` snapshot must agree with it; us per
   change, probe launches and jobs per change, the largest lanes per
   job, host reads per change, peak device memory with and without the
   snapshot, ``stats()``; then the probe kernel bitwise against its plain
   version at this path's shapes: 4 prehashed 2^22-slot intern tables
   holding ``n_cap`` keys each, both modes at every lane count the path
   sent, and one ``ht_probe_many`` of a read's 4 resolve jobs (the only
   probe of the intern tables left: the chunk's interning is the intern
   kernel's, phase 22);
12. the router's paths at ``smoke_config()`` with 3 shards: device
   routing, host routing, key skew at ``lane_cap=2`` and a bounded drain
   budget, each on the card (``"vmap"``, its default) and on the CPU
   (``"map"``, its default) with every replica leaf
   bitwise equal after every ``process`` call, and device routing equal
   to host routing after the stream; then ``serve_summary(...,
   verify=True)`` on the card;
13. batched crash consistency at full width:
   ``BatchedSummarizer(full_config(), checkpoint_dir=...)`` over the first
   288 changes of phase 3's stream (2 chunks: one of 256 and the stream's
   tail of 32, the chunk a recovery replays; cut from 5, then 3 chunks,
   then the tail from 256 changes, by the script's time limit).  Run A is
   uninterrupted with a ``save()`` after every chunk
   (``tools/recovery_check.py`` also times each chunk beside the same chunk
   unjournaled); its directory is copied at chunk boundary 2, before the
   last save, which is what a kill there leaves on disk
   (``ft.inject.drive`` with ``kill_at_chunk=2``, as the CPU tests and
   phase 14(b) kill, without processing the chunks again), and a fresh
   summarizer ``recover()``s that copy (epoch 1 + 1 journaled
   chunk): every leaf bitwise, ``stats()`` (less ``stream_retries``) and
   degree / has_edge / neighbors reads equal A's; then A's newest
   checkpoint is corrupted and ``recover()`` must
   fall back one epoch and land bitwise.  Seconds per ``save()`` by phase
   (host copy, ``np.savez``, fsync, sha256), bytes on disk, ms per journal
   append, seconds per ``restore()`` and ``recover()``, us per change
   journaled over the first chunk beside phase 3's first step;
14. sharded crash consistency: (a) one ``save()`` of phase 11's live
   4 x ``full_config()`` summarizer (~5.6 GiB) restored into a fresh one
   is cut from this script by its time limit (``tools/recovery_check.py``
   runs it; (b) saves and recovers stacked summarizers on the card);
   (b) the kill-at-every-chunk-boundary
   bar at ``smoke_config()``, 3 shards, ``router_chunk`` 32, on the card
   and on the CPU, every leaf bitwise the uninterrupted run's and card ==
   CPU, the card's recoveries launching the probe and intern kernels;
   (c) ``python -m repro_torch.launch.summarize_stream 60
   --router-chunk 64`` on the card, by its own assertions.  Checkpoints
   go under ``build/chip_smoke_ckpt/`` and are removed after each phase;
15. ``ht_rebuild`` on the card (its parts run where their inputs live):
   (a) after phase 2, the rebuild kernel bitwise against the sequential
   fold (k1, k2, val) on tables of caps 8, 16 and 32 built by ``ht_set``
   whose runs wrap past slot 0 (and full ones), 2^16 and 2^20 slots at
   53% and 70%, plain and prehashed, and 2^22 at 70%, where the host fold
   that the kernel replaces is timed; a 2^20-slot prehashed table at 60%
   whose keys home into narrow windows (``repro_torch.testing.tables``:
   runs over 32 slots, across the kernel's tile ends, one past a tile's
   halo, one wrapping past the last slot), timed; full tables (no EMPTY
   slot) of 32 and 8,192 slots; a table with a key behind an EMPTY
   slot of its chain must raise; (b) the kernel on phase 2's 2^25-slot
   tables at 70% (plain and prehashed) and a 2^24-slot one: every old
   live key found by the probe kernel with its old value, the live count
   kept, no tombstone, every key at or after its home inside its run; the
   kernel's and the whole call's device time (CUDA events, best of
   several) beside the byte bound of the table's live sectors, the old
   table's longest run, the call from Python; (c) after phase 5,
   ``smoke_config()`` on the card and on the CPU with
   ``maybe_compact(threshold=0.0)`` after batch 2 and mid-stream, every
   state leaf bitwise equal after every batch; (d) after phase 4,
   ``maybe_compact(threshold=0.0)`` on phase 3's live ``full_config()``
   summarizer (every table of 2^24-2^25 slots rebuilt, counts set to 0
   just before), timed, then ``phi == phi_recomputed()``, the lossless
   decode, degree / has_edge / neighbors reads against the live edge set
   and 256 more changes still lossless; the kernel against the fold on
   that summarizer's ``adj`` table, timed (the ``kernels`` line's row);
16. training, after phase 8: (a) the CSR segment sum's backward (the
   kernel over the transposed layout) against torch's autograd of the
   plain version, rtol = atol = 1e-5, at the GraphSAGE request's two
   layer inputs (phase 7's batch: masked edges, empty rows) and at
   ``_agg``'s edge-id form; the backward's launch timed beside its byte
   bound and ``torch.sparse.mm`` of the transposed adjacency; (b) SASRec
   ``full_config()`` (10^6 items, d 50, L 50) trained at B = 65,536 from
   ``sasrec_batches``: one step on the first 1,024 rows card vs CPU (loss
   1e-5, gradients 1e-4), 4 AdamW steps (the loss must fall), ms per
   step, peak memory, one profiled step's device busy share, and
   ``serve_topk`` at ``serve_p99`` (B 512, C 4,096) and
   ``retrieval_cand`` (B 1, C 10^6), scores card vs CPU (1e-4); (c)
   graphsage-reddit ``full_config()`` trained on phase 7's batch (n = e =
   262,144, F 602, random labels): one step card vs CPU (loss and every
   gradient, 1e-4), every parameter's gradient nonzero on the card, 4
   AdamW steps, ms per step and CSR launches per step (forward and
   backward); (d) ``python -m repro_torch.launch.train`` for
   granite-moe-3b-a800m, graphsage-reddit and sasrec (4 steps, the three
   at once), and each trained to step 3 with a checkpoint and restarted
   to step 6: equal to the same restart on the CPU (1e-4), the GNN's
   equal to an unbroken run (1e-5);
17. MLA, after phase 10: (a) the flash-attention kernel at ``d_v != d_q``
   against its plain version: at minicpm3-4b's smoke pair (D, Dv) =
   (32, 24), one KV head, causal and not, in float32 and bf16, at its
   layer's widths (288, 256) with B = 2, H = 40, Hkv = 1 and T = 512,
   causal and not, in bf16, and at its full layer (T = 4096, causal,
   contiguous as the transformer hands it over) in bf16 (the ``mla``
   variant) and float32 (SIMT), every bf16 (288, 256) shape in both of
   the ``mla`` kernel's modes (v a view of k's first 256 columns, the
   transformer's call, read from k's tiles; and v a tensor of its own),
   with the kernel's registers and spills from ``nvcc``; float32 within
   rtol = atol = 2e-3, bf16 within rtol = atol = 3e-2 and a largest
   per-row relative error ``||got - want|| / ||want||`` of 1e-2; the bf16
   layer's device time in both modes, the call from Python, the plain
   version and ``scaled_dot_product_attention`` (k and v copied out to 40
   heads, under ``EFFICIENT_ATTENTION``: no fused backend takes the GQA
   call at ``d_v != d_q``) beside the operation bound, the shared mode
   below SDPA's time or the phase fails; (b) minicpm3-4b's full widths
   with 2 of its 62 layers in float32, B = 1, T = 512, card vs CPU
   (1e-3) and decode vs forward (2e-3); (c) one prefill request at its
   ``full_config()`` (62 layers, bf16, 4.26 B parameters drawn on the
   card), B = 2, T = 4096: finite logits, 62 kernel launches, all of the
   ``mla`` variant (by the wrapper's count and by the profiled kernel
   names), ms cold and warm, device time by kind (the attention beside 62
   x the kernel's time at the layer), peak memory; (d)
   ``serve(minicpm3-4b, full=True)``, batch 4, prompt 16, 32 tokens, ms
   per token beside the weight-read bound, and a profiled decode step;
   (e) its smoke config at T = 256, card (kernel) vs CPU (plain), 1e-4;
18. the dry-run (``launch/dryrun.py``), after phase 16: (a) at a 1-rank
   mesh, the ``graphsage-reddit`` ``minibatch_lg``, ``sasrec``
   ``train_batch`` and ``mosso-stream`` ``stream_batch`` cells at full
   configuration: the predicted bytes of the parameters, the AdamW state
   and the inputs (the engine state, for mosso) equal the bytes of the
   tensors phases 16(c), 16(b) and 3 held on the card, and the predicted
   FLOPs ``FlopCounterMode`` over one of their steps on the card (for
   mosso, one dense step at the dry-run's one trip a loop from a fresh
   ``full_config()`` state over phase 3's first batch: 0), the
   predicted peak beside ``max_memory_allocated()`` (mosso: over that
   step) and the roofline's time beside the measured step, with their
   ratios; (b) ``compressed_psum``
   over an NCCL group of one rank equal to ``int8_dequantize(
   *int8_quantize(x))`` bitwise and within ``scale / 2`` of ``x`` (plus
   two float32 ulps of ``max |x|``: the quantizer rounds in float32); (c) in a
   subprocess on the CPU, started first, ``internlm2-20b`` and
   ``llama3-405b`` ``train_4k`` at the 16 x 16 production mesh (a fake
   process group of 256 ranks), each rank's GB beside the card's 80;
19. ``replica_exec``, after phase 11: ``ShardedSummarizer(
   full_config(), device="cuda:0", n_shards=4)`` under ``"map"`` and
   ``"vmap"`` side by side over the first 256 changes of phase 11's
   stream, in one ``process`` call (the router chunk; cut from 1,024,
   then 512, by the script's time limit), every replica and intern leaf
   equal on the card after the call and after the flush, and ``stats()`` equal; per mode us per change, probe launches
   and jobs per change, host syncs per change, the replicas' bytes, the
   peak above them while stepping and a ``query()`` snapshot's bytes.
   The ``"vmap"`` run's replicas after each call and the flush are kept
   on the card for phase 20;
20. the mesh, after phase 19: ``ShardedSummarizer(full_config(),
   mesh=EngineMesh(devices), n_shards=4)`` over phase 19's changes and
   calls, ``devices`` the first 4 cards (2 on a host of 2 or 3), or
   ``["cuda:0"] * 4`` on a host of one, its positions stepped in turn
   (the default); under ``"vmap"`` over phase 19's changes (its
   ``"map"`` half was cut by the time limit: at one replica a position
   the two step alike, and phase 19 drives ``"map"``), every replica
   and intern leaf equal on the card to phase 19's one-position run
   after each call and after the flush, the engine counters of
   ``stats()`` equal to that run's at the same point; us per change,
   host reads and probe launches per change by position, the peak
   memory of each card;
   then one hub chunk at ``lane_cap`` 2 (the star of JAX's
   ``tests/test_router.py:409``, 90 leaves, ``router_chunk`` 128) on 4 ×
   ``smoke_config()`` (the route stage's skew does not depend on the
   engine's size; at ``full_config()`` the two runs took 40 s on an
   H100), which
   must take at least two drain rounds, leaf-bitwise to the same chunk
   at one position;
21. the dense step (``step_fn(..., dense=True)``, JAX's masked data
   flow) and the branching step on the card at ``full_config()``: from
   phase 3's state after its first batch (256 changes; a host copy), each
   form over the next ``DENSE_CHANGES`` changes as one batch (a whole
   batch would run thousands of live trials, each through
   ``apply_move``'s masked neighbour slots): every state leaf equal, or
   the phase fails; per form host reads a step, probe launches
   and jobs a change, us a change, live trials and accepted moves;
22. the intern kernel (``csrc/intern.cu``, the router's interning; after
   phase 11, whose run must launch it): (a) against its plain version,
   bitwise in the ids and every intern leaf, on 4 stacked intern tables of
   2^22 slots holding 2^19 keys each, at 1, 256, 1,024 and 2,048 changes
   a row of hits only, misses only and repeats; a drop case at ``n_cap``
   1,536; phase 11's first chunk routed to its 4 shards on fresh intern
   states; the hard cases of ``repro_torch.testing.tables`` on tables
   that also hold 2^15 tombstones (64 keys a row on one start, groups
   spilling into other groups' starts, starts before tombstones, starts
   in the last 32 slots, 3,000 changes a row: two shared-memory
   segments) and the room running out mid-chunk with repeats of dropped
   keys; at 256 and 1,024 changes, the chunk, one start, the spills and
   the long rows, the device time, a call from Python and the plain
   version beside the byte bound and the ordered tail's dependent steps;
   (b), the router's engine stage under
   JAX's dense lowering beside the port's, is ``tools/intern_check.py
   --router``'s, not this script's; (c) phase 11's probe launches and
   host reads a change beside the router's with its host intern loop
   (``HOST_LOOP_COUNTS``).

Matrix products run in full float32 (TF32 off).  It prints one JSON line
of kernels, the card's name and power limit, and as its last line
``{"ok": true, "device": {...}}``.  The full per-shape tables go to
``build/chip_smoke.json``.  Without a CUDA device, or without the
repository beside it, it exits non-zero and prints no result.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CKPT_ROOT = ROOT / "build" / "chip_smoke_ckpt"   # phases 13-14, removed
# the card's published rates have one copy, in the port's launch/mesh.py
# (set by main() and by load_rates(), which put src/ on the path first)
HBM_BYTES_PER_S = BF16_OPS_PER_S = None
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
SHARDS = 4                        # replicas of the sharded path (phase 11)
SHARDED_CHANGES = 1024            # phase 11: the first changes (one chunk)
MODES_CHANGES = 256               # phases 19-20: map and vmap on these changes
MODES_CHUNK = 256                 # phases 19-20: router chunk = process call
MESH_POSITIONS = 4                # phase 20: mesh positions (one per shard)
HUB_LEAVES = 90                   # phase 20: the hub chunk's star
HUB_CHUNK = 128                   # phase 20: its router chunk
RECOVERY_CHUNKS = 2               # phase 13: chunks of phase 3's stream,
RECOVERY_TAIL = 32                # the last of them this many changes
DENSE_CHANGES = 4                 # phase 21: changes after the first batch
                                  # (cut from 8 by the time limit)
INTERN_LANES = (1, 256, 1024, 2048)  # phase 22(a): changes a row of a call
INTERN_DROP_CAP = 1536            # phase 22(a): the drop case's n_cap
INTERN_LONG = 3000                # phase 22(a): changes a row, two segments
# phase 22(a): the hard cases timed beside the random ones
INTERN_TIMED = ("shared_start", "spills", "long")
# phase 22(c): phase 11's probe launches and host reads a change when the
# router interned on the host (a pre-lookup launch, a host read, an insert
# launch a new key), by the number of changes phase 11 ran then
HOST_LOOP_COUNTS = {1280: (34.40, 20.38), 1024: (34.35, 18.65)}
REBUILD_TINY_CAPS = (8, 16, 32)   # phase 15(a): tables with wrapped runs
REBUILD_CAPS = (1 << 16, 1 << 20)  # phase 15(a): at 53% and 70%
REBUILD_BIG = 1 << 22             # phase 15(a): at 70%, the host fold timed
FP32_OPS_PER_S = 67e12            # H100 SXM float32 rate outside tensor cores
# words in the names of cuBLAS/CUTLASS matrix-product kernels
MATMUL_WORDS = ("gemm", "cutlass", "xmma", "matmul", "sm90", "nvjet", "gemv")
REDDIT_NODES = 232_965            # PyG's Reddit
REDDIT_EDGES = 114_615_892        # its directed edges
SEEDS = 1024                      # seed nodes of one GraphSAGE request
# (name, n, e, f, reduces) of the CSR kernel's comparisons: repro configs
# GNN_SHAPES; the F 1 row is minhash_signature's width at minibatch_lg's n, e
CSR_SHAPES = (("full_graph_sm", 3072, 10752, 1433, ("sum", "min", "max")),
              ("minibatch_lg", 262144, 262144, 128, ("sum", "min", "max")),
              ("minibatch_lg", 262144, 262144, 602, ("sum", "min", "max")),
              ("ogb_products", 2449408, 61859328, 100, ("sum", "min", "max")),
              ("molecule", 3840, 16384, 32, ("sum", "min", "max")),
              ("minibatch_lg", 262144, 262144, 1, ("min",)))
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
# minicpm3-4b's MLA layer (B, H, Hkv, T, D, Dv): one KV head over the
# latent, q and k kv_lora + rope_dim wide, v kv_lora; then the (B, H, Hkv,
# T, causal) of the comparisons at its smoke pair (32, 24)
MLA_LAYER = (2, 40, 1, 4096, 288, 256)
MLA_SMOKE_SHAPES = ((2, 4, 1, 256, True), (2, 4, 1, 256, False),
                    (1, 4, 1, 128, True))
# (B, H, Hkv, T, causal) at the layer's widths and a short T, where the
# outputs average over few keys and stay large
MLA_SHORT_SHAPES = ((2, 40, 1, 512, True), (2, 40, 1, 512, False))
# the MLA comparisons' tolerances (rtol, atol, largest per-row relative
# error ||got - want|| / ||want||): float32, and bf16, where the row error
# carries the check (the kernel's p is rounded to bf16 before p v, so an
# early row whose output cancels misses an elementwise 2e-3)
MLA_F32_TOL = (2e-3, 2e-3, None)
MLA_BF16_TOL = (3e-2, 3e-2, 1e-2)
MLA_SDPA_BACKEND = "EFFICIENT_ATTENTION"   # phase 17(a)'s SDPA yardstick
PREFILL = (2, 4096)               # (B, T) of the prefill request
SERVE = (4, 16, 32)               # batch, prompt, tokens of the serve run
TRAIN_STEPS = 4                   # phase 16: AdamW steps of each training run
CHECK_ROWS = 1024                 # phase 16(b): rows held card vs CPU
TRAIN_ARCHS = ("granite-moe-3b-a800m", "graphsage-reddit", "sasrec")


DRYRUN_CELLS = ("graphsage-reddit/minibatch_lg", "sasrec/train_batch",
                "mosso-stream/stream_batch")   # phase 18(a), at 1 rank
DRYRUN_FULL = ("internlm2-20b", "llama3-405b")  # phase 18(c): train_4k
CARD_GB = 80.0                    # the H100's device memory, in GB


_T0 = time.perf_counter()


def load_rates() -> None:
    """Set ``HBM_BYTES_PER_S`` and ``BF16_OPS_PER_S`` from the port's
    ``launch/mesh.py`` (the tools call this after putting ``src/`` on the
    path; ``main()`` does)."""
    global HBM_BYTES_PER_S, BF16_OPS_PER_S
    from repro_torch.launch.mesh import HBM_BW, PEAK_FLOPS_BF16
    HBM_BYTES_PER_S, BF16_OPS_PER_S = HBM_BW, PEAK_FLOPS_BF16


try:       # a tool that imports this module has put src/ on the path
    load_rates()
except ImportError:   # alone, or src/ not on the path yet: main() sets them
    pass


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
    loop, in both modes, given as 4 row-view jobs (``stacked_jobs``) and
    as the one stacked job the sharded engine's ``"vmap"`` step sends
    (the plain version's stacked loop); timed beside four one-job
    launches."""
    import torch
    from repro_torch.kernels.ht_probe import (ProbeJob, ht_probe_cuda,
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
        want = ht_probe_many_plain(jobs)
        for j, (g, w) in enumerate(zip(got, want)):
            max_err = max(max_err, check_equal(
                g, w, f"stacked [{r}, {cap}] replica {j} mode={mode}"))
        job2d = [ProbeJob(tk1, tk2, tval, q1, q2, False, mode)]
        (g2,), launched = ht_probe_many_cuda(job2d)
        if launched != 1:
            raise AssertionError(f"one stacked job took {launched} launches")
        (w2,) = ht_probe_many_plain(job2d)
        for j in range(r):
            for got_j, want_j in ((tuple(x[j] for x in g2), want[j]),
                                  (tuple(x[j] for x in w2), want[j])):
                max_err = max(max_err, check_equal(
                    got_j, want_j, f"one stacked [{r}, {cap}] job, replica "
                    f"{j} mode={mode}"))
        one = graph_ms(lambda: ht_probe_many_cuda(jobs), 50)
        each = graph_ms(lambda: [ht_probe_cuda(*job[:5], mode=mode)
                                 for job in jobs], 50)
        res[mode] = dict(one_launch_ms=one, four_launches_ms=each,
                         call_ms=cuda_ms(lambda: ht_probe_many_cuda(jobs),
                                         50),
                         stacked_job_call_ms=cuda_ms(
                             lambda: ht_probe_many_cuda(job2d), 50))
        log(f"stacked [{r}, 2^{cap.bit_length() - 1}] x {b} lanes "
            f"mode={mode}: bitwise equal as {r} row jobs and as one "
            f"stacked job; one launch {one * 1e3:.2f} us (call "
            f"{res[mode]['call_ms'] * 1e3:.2f} us; the stacked job's call "
            f"{res[mode]['stacked_job_call_ms'] * 1e3:.2f} us), {r} "
            f"launches {each * 1e3:.2f} us")
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


def main_path(nodes: int, deg: int, seed: int,
              keep_first: bool = False) -> dict:
    """Drive ``full_config()`` on the card over a BA stream of ``nodes``
    nodes; the stream's scale is far below the configuration's
    ``n_cap``/``m_cap``, so the tables stay nearly empty (their load is
    printed) while their capacity is full size.  With ``keep_first`` the
    result's ``"first_batch"`` holds a host copy of the state and the
    label ids after the first batch (phase 21 starts there), taken
    outside the timed steps."""
    import torch
    from repro_torch.configs.mosso_stream import full_config
    from repro_torch.core.engine import BatchedSummarizer
    from repro_torch.core.engine.ops import host_read
    from repro_torch.core.engine.state import copy_state
    from repro_torch.core.summary import pair_key
    from repro_torch.launch.steps import state_leaves
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
    first = None
    t0 = time.perf_counter()
    for off in range(0, len(stream), cfg.batch):
        t = time.perf_counter()
        bs.process(stream[off:off + cfg.batch])
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
        if keep_first and first is None:
            t = time.perf_counter()
            first = (copy_state(bs.state, "cpu"), dict(bs._ids))
            t0 += time.perf_counter() - t     # not a step's time
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
               state_tensor_bytes=tensor_bytes(state_leaves(bs.state)),
               peak_bytes=peak,
               stats=bs.stats(), phi=phi, live_edges=len(truth),
               by_batch={f"{m}:{b}": c for (m, b), c in
                         sorted(by_batch.items(), key=lambda x: -x[1])})
    if keep_first:
        res["first_batch"] = first
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


def cuda_vs_cpu(seed: int, compact: bool = False) -> int:
    """The smoke configuration on the card and on the CPU, every state
    leaf bitwise equal after every batch; with ``compact``, both also
    ``maybe_compact(threshold=0.0)`` after batch 2 and mid-stream
    (phase 15(c)), and the card's rebuild kernel must have launched."""
    import numpy as np
    from repro_torch.configs.mosso_stream import smoke_config
    from repro_torch.core.engine import BatchedSummarizer
    from repro_torch.core.engine.state import state_to_numpy
    from repro_torch.graph.streams import (edges_to_fully_dynamic_stream,
                                           sbm_edges)
    from repro_torch.kernels import ops
    cfg = smoke_config()
    stream = edges_to_fully_dynamic_stream(
        sbm_edges(60, 4, 0.5, 0.04, seed=seed), delete_prob=0.15,
        seed=seed + 1)
    n_batches = -(-len(stream) // cfg.batch)
    compact_at = {2, n_batches // 2} if compact else set()
    on_card = BatchedSummarizer(cfg, device="cuda")
    on_cpu = BatchedSummarizer(cfg, device="cpu")

    def check(what):
        a, b = state_to_numpy(on_card.state), state_to_numpy(on_cpu.state)
        for k in a:
            for w, x in (a[k].items() if isinstance(a[k], dict)
                         else ((None, a[k]),)):
                y = b[k][w] if w else b[k]
                if not (x.dtype == y.dtype and np.array_equal(x, y)):
                    raise AssertionError(f"leaf {k}{'.' + w if w else ''} "
                                         f"differs {what}")

    launches = ops.ht_rebuild.launches
    n = 0
    for off in range(0, len(stream), cfg.batch):
        chunk = stream[off:off + cfg.batch]
        on_card.process(chunk)
        on_cpu.process(chunk)
        check(f"after batch {n}")
        if n in compact_at:
            if not (on_card.maybe_compact(threshold=0.0)
                    and on_cpu.maybe_compact(threshold=0.0)):
                raise AssertionError("maybe_compact rebuilt nothing")
            check(f"after maybe_compact at batch {n}")
        n += 1
    launches = ops.ht_rebuild.launches - launches
    if compact and not launches:
        raise AssertionError("maybe_compact on the card launched no "
                             "rebuild kernel")
    log(f"{'phase 15(c): ' if compact else ''}cuda vs cpu: smoke_config, "
        f"{len(stream)} changes, every state leaf bitwise equal after each "
        f"of {n} batches (phi={on_cpu.phi})"
        + (f" and after maybe_compact(threshold=0.0) at batches "
           f"{sorted(compact_at)} ({launches} rebuild launches on the card)"
           if compact else ""))
    return n


# --------------------------------------------------------------------- #
# phases 11-12: the sharded summarizer
# --------------------------------------------------------------------- #


def sharded_path(nodes: int, deg: int, seed: int) -> dict:
    """Drive ``ShardedSummarizer(full_config(), n_shards=SHARDS)`` on the
    card (device routing, default geometry) over the first
    ``SHARDED_CHANGES`` changes of the phase-3 stream (returned), check
    phi, the lossless decode and sharded reads against the live edge set,
    and log the per-change counts, the largest lanes per probe job and
    peak memory with and without a query snapshot."""
    import random
    import torch
    from repro_torch.configs.mosso_stream import full_config
    from repro_torch.core.engine import ShardedSummarizer
    from repro_torch.core.engine.ops import host_read
    from repro_torch.graph.streams import (barabasi_albert_edges,
                                           edges_to_fully_dynamic_stream)
    from repro_torch.kernels import ops

    cfg = full_config()
    stream = edges_to_fully_dynamic_stream(
        barabasi_albert_edges(nodes, deg, seed), delete_prob=0.1,
        seed=seed)[:SHARDED_CHANGES]
    log(f"sharded path: full_config x {SHARDS} shards on one card "
        f"(n_cap={cfg.n_cap} m_cap={cfg.m_cap} per shard, batch="
        f"{cfg.batch}, router_chunk 1024, device routing, the card's "
        f"default replica_exec 'vmap'); the stream is "
        f"cut to the first {len(stream)} changes of phase 3's (BA n={nodes}"
        f" m={deg}, fully dynamic) by the run's time limit, far below the "
        f"{SHARDS} x n_cap nodes the replicas hold")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ss = ShardedSummarizer(cfg, device="cuda:0", n_shards=SHARDS)
    torch.cuda.synchronize()
    state_bytes = torch.cuda.memory_allocated() - base
    if ss.replica_exec != "vmap":
        raise AssertionError(f"the card's default replica_exec is "
                             f"{ss.replica_exec!r}, not 'vmap'")

    ops.reset_counts()
    host_read.count = 0
    call_s = []
    t0 = time.perf_counter()
    for off in range(0, len(stream), ss.router_chunk):
        t = time.perf_counter()
        ss.process(stream[off:off + ss.router_chunk])
        torch.cuda.synchronize()
        call_s.append(time.perf_counter() - t)
    t = time.perf_counter()
    ss.flush()
    call_s.append(time.perf_counter() - t)
    elapsed = time.perf_counter() - t0
    launches, jobs = ops.ht_probe.launches, ops.ht_probe.jobs
    interns = ops.intern.launches
    by_batch = dict(ops.ht_probe.by_batch)
    syncs = host_read.count
    if launches == 0 or interns == 0:
        raise AssertionError(f"the sharded path launched no probe kernel "
                             f"({launches}) or no intern kernel ({interns})")
    peak = torch.cuda.max_memory_allocated() - base
    stats = ss.stats()
    if stats["router_host_dict_ops"] or stats["router_syncs"]:
        raise AssertionError(f"sync-free dispatch did host work: {stats}")

    phi, phi_re = ss.phi, ss.phi_recomputed()
    if phi != phi_re:
        raise AssertionError(f"phi {phi} != phi_recomputed {phi_re}")
    truth = live_edges(stream)
    decoded = ss.materialize().validate().decode_edges()
    if decoded != truth or ss.live_edges() != truth:
        raise AssertionError(f"sharded decode differs from the live edge "
                             f"set: {len(decoded ^ truth)} pairs")

    # sharded reads from a snapshot (4 cloned replicas)
    torch.cuda.reset_peak_memory_stats()
    view = ss.query()
    torch.cuda.synchronize()
    snap_peak = torch.cuda.max_memory_allocated() - base
    rng = random.Random(seed)
    adj = {}
    for (u, v) in truth:
        adj.setdefault(u, set()).add(v)
        adj.setdefault(v, set()).add(u)
    labels = rng.sample(sorted(adj), min(128, len(adj)))
    edges = sorted(truth)
    pairs = [edges[rng.randrange(len(edges))] for _ in range(64)]
    pairs += [(rng.choice(labels), rng.choice(labels)) for _ in range(64)]
    reads, read_batch = {}, {}
    for name, fn, want in (
            ("degree", lambda: view.degree_batch(labels),
             [len(adj[x]) for x in labels]),
            ("has_edge", lambda: view.has_edge_batch(pairs),
             [(min(a, b), max(a, b)) in truth for (a, b) in pairs]),
            ("neighbors", lambda: view.neighbors_batch(labels),
             [adj[x] for x in labels])):
        ops.reset_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        got = fn()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        if got != want:
            bad = sum(g != w for g, w in zip(got, want))
            raise AssertionError(f"sharded query {name}: {bad} wrong")
        if ops.ht_probe.launches == 0:
            raise AssertionError(f"sharded query {name} launched no probe")
        reads[name] = dict(queries=len(want), us_per_query=1e6 * dt
                           / len(want), probe_launches=ops.ht_probe.launches)
        for key, count in ops.ht_probe.by_batch.items():
            read_batch[key] = read_batch.get(key, 0) + count
        log(f"sharded reads: {name} x{len(want)} right, "
            f"{reads[name]['us_per_query']:.1f} us/query, "
            f"{ops.ht_probe.launches} probe launches")
    del view

    n = len(stream)
    # pipelined: chunk i's engine stage runs in call i + 1 (the last one
    # in the flush); the later chunks are the second half of the chunks
    sizes = [len(stream[o:o + ss.router_chunk])
             for o in range(0, n, ss.router_chunk)]
    half = len(sizes) // 2
    later_us = 1e6 * sum(call_s[half + 1:]) / sum(sizes[half:])
    max_lanes = max(b for (_, b) in by_batch)
    res = dict(changes=n, shards=SHARDS, nodes=nodes, seconds=elapsed,
               replica_exec=ss.replica_exec,
               acc_cap=ss.router_geometry.acc_cap,
               call_s=call_s, us_per_change=1e6 * elapsed / n,
               later_us_per_change=later_us,
               probe_launches=launches, launches_per_change=launches / n,
               probe_jobs=jobs, jobs_per_change=jobs / n,
               intern_launches=interns,
               host_syncs=syncs, syncs_per_change=syncs / n,
               max_lanes_per_job=max_lanes,
               by_batch={f"{m}:{b}": c for (m, b), c in
                         sorted(by_batch.items(), key=lambda x: -x[1])},
               read_by_batch={f"{m}:{b}": c for (m, b), c in
                              sorted(read_batch.items())},
               lanes=sorted({b for (_, b) in (*by_batch, *read_batch)}),
               state_bytes=state_bytes, peak_bytes=peak,
               snapshot_peak_bytes=snap_peak, stats=stats, phi=phi,
               live_edges=len(truth), reads=reads)
    log(f"sharded path: {n} changes in {elapsed:.3f} s = "
        f"{res['us_per_change']:.1f} us/change (process calls + flush: "
        + ", ".join(f"{x:.2f}" for x in call_s)
        + f" s; later calls {res['later_us_per_change']:.1f} us/change); "
        f"probe launches {launches} ({launches / n:.2f}/change) serving "
        f"{jobs} jobs ({jobs / n:.2f}/change); intern launches {interns}; "
        f"host reads {syncs} "
        f"({syncs / n:.2f}/change); largest job {max_lanes} lanes "
        f"(a one-thread-per-lane probe wins from 2^14-2^16 lanes, by load); "
        f"phi={phi} |E|={len(truth)}")
    log(f"sharded path: state {state_bytes / 2**30:.3f} GiB, peak "
        f"{peak / 2**30:.3f} GiB, with a query snapshot "
        f"{snap_peak / 2**30:.3f} GiB; jobs by (mode:lanes) "
        + ", ".join(f"{k} x{v}" for k, v in list(res["by_batch"].items())[:8])
        + f"; {stats}")
    log("sharded path: phi == phi_recomputed, the merged decode and "
        "live_edges() equal the stream's live edges")
    return res, ss, stream


def replica_exec_modes(stream) -> dict:
    """Phase 19: ``ShardedSummarizer(full_config(), n_shards=SHARDS)``
    under ``replica_exec="map"`` and ``"vmap"`` side by side on the card
    over the first ``MODES_CHANGES`` changes of phase 11's stream, in
    ``process`` calls of ``MODES_CHUNK`` (the router chunk), the two
    modes in turn: every replica and intern leaf equal on the card
    (``torch.equal``) after each call and after the flush, or the phase
    fails.  Per mode: us per change (its calls and flush, each ended by a
    device sync), probe launches and jobs per change, host syncs per
    change (``ops.host_read.count``), the replicas' bytes, the peak above
    them while stepping, and a ``query()`` snapshot's bytes."""
    import torch
    from repro_torch.configs.mosso_stream import full_config
    from repro_torch.core.engine import ShardedSummarizer
    from repro_torch.core.engine.ops import host_read
    from repro_torch.core.engine.state import copy_state
    from repro_torch.kernels import ops

    cfg = full_config()
    stream = stream[:MODES_CHANGES]
    modes = ("map", "vmap")
    runs, res = {}, {}
    torch.cuda.synchronize()
    for mode in modes:
        before = torch.cuda.memory_allocated()
        runs[mode] = ShardedSummarizer(cfg, device="cuda:0",
                                       n_shards=SHARDS,
                                       router_chunk=MODES_CHUNK,
                                       replica_exec=mode)
        torch.cuda.synchronize()
        res[mode] = dict(state_bytes=torch.cuda.memory_allocated() - before,
                         seconds=0.0, launches=0, jobs=0, syncs=0,
                         step_peak_bytes=0)

    snapshots = []      # the vmap run after each call and the flush

    def equal(what: str) -> None:
        a, b = ((runs[mode]._est, runs[mode]._ist) for mode in modes)
        check_blocks(a, b, f"replica_exec map vs vmap {what}")
        snapshots.append([[copy_state(x) for x in part] for part in b])

    def timed(mode: str, fn) -> None:
        r = res[mode]
        ops.reset_counts()
        host_read.count = 0
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        r["seconds"] += time.perf_counter() - t
        r["launches"] += ops.ht_probe.launches
        r["jobs"] += ops.ht_probe.jobs
        r["syncs"] += host_read.count
        r["step_peak_bytes"] = max(r["step_peak_bytes"],
                                   torch.cuda.max_memory_allocated() - held)

    calls = 0
    for off in range(0, len(stream), MODES_CHUNK):
        for mode in modes:
            timed(mode, lambda: runs[mode].process(
                stream[off:off + MODES_CHUNK]))
        calls += 1
        equal(f"after process call {calls}")
    for mode in modes:
        timed(mode, runs[mode].flush)
    equal("after the flush")
    stats = {mode: ss.stats() for mode, ss in runs.items()}
    if stats["map"] != stats["vmap"]:
        raise AssertionError(f"replica_exec map vs vmap: stats differ "
                             f"{stats}")
    n = len(stream)
    for mode, ss in runs.items():
        r = res[mode]
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        view = ss.query()
        torch.cuda.synchronize()
        r["snapshot_bytes"] = torch.cuda.max_memory_allocated() - held
        del view
        r.update(us_per_change=1e6 * r["seconds"] / n,
                 launches_per_change=r["launches"] / n,
                 jobs_per_change=r["jobs"] / n,
                 syncs_per_change=r["syncs"] / n)
        log(f"replica_exec={mode}: {n} changes in {r['seconds']:.3f} s = "
            f"{r['us_per_change']:.1f} us/change; probe launches "
            f"{r['launches_per_change']:.2f}/change serving "
            f"{r['jobs_per_change']:.2f} jobs/change; host syncs "
            f"{r['syncs_per_change']:.2f}/change; replicas "
            f"{r['state_bytes'] / 2**30:.3f} GiB, peak above them while "
            f"stepping {r['step_peak_bytes'] / 2**20:.1f} MiB, a query() "
            f"snapshot {r['snapshot_bytes'] / 2**30:.3f} GiB")
    log(f"replica_exec: map == vmap, every replica and intern leaf on the "
        f"card after each of {calls} process calls of {MODES_CHUNK} and "
        f"the flush; vmap / map us per change "
        f"{res['vmap']['us_per_change'] / res['map']['us_per_change']:.3f},"
        f" host syncs {res['vmap']['syncs'] / res['map']['syncs']:.3f}, "
        f"probe launches "
        f"{res['vmap']['launches'] / res['map']['launches']:.3f}")
    del runs
    torch.cuda.empty_cache()
    return dict(changes=n, shards=SHARDS, router_chunk=MODES_CHUNK,
                calls=calls, stats=stats["vmap"], **res), snapshots


def _leaf_items(st):
    """``(name, tensor)`` of every leaf of a state (each table word)."""
    from repro_torch.core.engine.hashtable import HashTable
    for f in dataclasses.fields(st):
        v = getattr(st, f.name)
        if isinstance(v, HashTable):
            yield from ((f"{f.name}.{w}", getattr(v, w))
                        for w in ("k1", "k2", "val"))
        else:
            yield f.name, v


def check_blocks(got, want, what: str) -> None:
    """Two runs' replicas (each ``(engine blocks, intern blocks)``, a
    summarizer's ``(_est, _ist)``, split over any number of positions)
    equal on the card, leaf for leaf in shard order: the blocks of each
    leaf gathered on ``want``'s first device."""
    import torch
    for part, g_blocks, w_blocks in zip(("engine", "intern"), got, want):
        g_items = [dict(_leaf_items(b)) for b in g_blocks]
        w_items = [dict(_leaf_items(b)) for b in w_blocks]
        for k, w0 in w_items[0].items():
            dev = w0.device
            a, b = (items[0][k] if len(items) == 1 else
                    torch.cat([i[k].to(dev) for i in items])
                    for items in (g_items, w_items))
            if a.dtype != b.dtype or not torch.equal(a.to(dev), b):
                raise AssertionError(f"{what}: {part} leaf {k} differs")


ENGINE_COUNTERS = ("phi", "num_edges", "trials", "accepted", "skipped")


def mesh_devices():
    """Phase 20's positions: the first 4 cards (2 on a host of 2 or 3:
    the 4 shards must split evenly), or one card at every position."""
    import torch
    count = torch.cuda.device_count()
    if count >= 2:
        n = MESH_POSITIONS if count >= MESH_POSITIONS else 2
        return [f"cuda:{i}" for i in range(n)], f"{n} distinct cards"
    return ["cuda:0"] * MESH_POSITIONS, "one card at every position"


def mesh_path(stream, snapshots, modes: dict) -> dict:
    """Phase 20: ``ShardedSummarizer(full_config(), mesh=EngineMesh(...),
    n_shards=SHARDS)`` in phase 19's calls, under ``"vmap"`` over its
    changes: every replica and intern
    leaf equal on the card to phase 19's one-position run (``snapshots``:
    after each call and the flush; the pipelined state after call k + 1
    is the flushed state after call k) after each call and after the
    flush; us per change (calls and flush, each ended by a sync of every
    card), host reads and probe launches per change by position
    (``None``: the route stage's reads), each card's peak above what it
    held before.  Then one hub chunk at ``lane_cap`` 2 on the mesh and at
    one position, at ``smoke_config()``, leaf-bitwise after the flush,
    with at least two drain rounds."""
    from collections import Counter

    import torch
    from repro_torch.configs.mosso_stream import full_config, smoke_config
    from repro_torch.core.engine import ShardedSummarizer
    from repro_torch.core.engine.ops import host_read, reset_host_reads
    from repro_torch.dist import labelhash
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import EngineMesh

    t0 = time.perf_counter()
    count = torch.cuda.device_count()
    devices, layout = mesh_devices()
    cards = sorted(set(devices))
    log(f"phase 20: torch.cuda.device_count() = {count}; the mesh "
        f"{devices} ({layout}); {SHARDS} x full_config over the first "
        f"{MODES_CHANGES} changes of phase 11's stream in process calls of "
        f"{MODES_CHUNK}, as phase 19")
    cfg = full_config()
    stream = stream[:MODES_CHANGES]
    n = len(stream)
    res = dict(device_count=count, devices=devices, layout=layout,
               changes=len(stream), shards=SHARDS,
               router_chunk=MODES_CHUNK)

    def sync() -> None:
        for c in cards:
            torch.cuda.synchronize(c)

    mode, changes = "vmap", stream
    sync()
    held = {c: torch.cuda.memory_allocated(c) for c in cards}
    for c in cards:
        torch.cuda.reset_peak_memory_stats(c)
    ss = ShardedSummarizer(cfg, mesh=EngineMesh(devices),
                           n_shards=SHARDS, router_chunk=MODES_CHUNK,
                           replica_exec=mode)
    if len(ss._est) != len(devices):
        raise AssertionError(f"phase 20: {len(ss._est)} positions")
    r = dict(seconds=0.0, reads=Counter(), launches=Counter(), jobs=0)

    def timed(fn) -> None:
        ops.reset_counts()
        reset_host_reads()
        sync()
        t = time.perf_counter()
        fn()
        sync()
        r["seconds"] += time.perf_counter() - t
        r["reads"].update(host_read.by_position)
        r["launches"].update(ops.ht_probe.by_position)
        r["jobs"] += ops.ht_probe.jobs

    calls, n = 0, len(changes)
    for off in range(0, n, MODES_CHUNK):
        timed(lambda: ss.process(changes[off:off + MODES_CHUNK]))
        check_blocks((ss._est, ss._ist), snapshots[calls],
                     f"phase 20 {mode}: the mesh vs one position after "
                     f"process call {calls + 1}")
        calls += 1
    timed(ss.flush)
    check_blocks((ss._est, ss._ist), snapshots[calls],
                 f"phase 20 {mode}: the mesh vs one position after the "
                 f"flush")
    stats = ss.stats()
    bad = [k for k in ENGINE_COUNTERS if stats[k] != modes["stats"][k]]
    if bad or sum(r["launches"].values()) == 0:
        raise AssertionError(f"phase 20 {mode}: counters {bad} differ "
                             f"from phase 19's, or no probe launch: "
                             f"{stats} {dict(r['launches'])}")
    peak = {c: torch.cuda.max_memory_allocated(c) - held[c]
            for c in cards}
    one = modes[mode]
    out = dict(changes=n, seconds=r["seconds"],
               us_per_change=1e6 * r["seconds"] / n,
               reads_per_change={str(k): v / n
                                 for k, v in sorted(r["reads"].items(),
                                                    key=str)},
               launches_per_change={str(k): v / n for k, v in sorted(
                   r["launches"].items(), key=str)},
               jobs_per_change=r["jobs"] / n,
               peak_bytes=peak, stats=stats,
               one_position=dict(us_per_change=one["us_per_change"],
                                 syncs_per_change=one["syncs_per_change"],
                                 launches_per_change=one[
                                     "launches_per_change"]))
    res[mode] = out
    log(f"phase 20 {mode}: the mesh == one position over {n} changes, "
        f"every replica and intern leaf after each of {calls} calls and "
        f"the flush; "
        f"{out['us_per_change']:.1f} us/change (one position, phase 19: "
        f"{one['us_per_change']:.1f}); host reads per change by "
        f"position {out['reads_per_change']} (one position: "
        f"{one['syncs_per_change']:.2f} in all); probe launches per "
        f"change by position {out['launches_per_change']} (one "
        f"position: {one['launches_per_change']:.2f}); peak above the "
        f"held memory by card "
        + ", ".join(f"{c}: {b / 2**30:.3f} GiB" for c, b in peak.items()))
    del ss
    torch.cuda.empty_cache()

    # the hub chunk: a star whose centre's hash undercuts every leaf's, so
    # every change routes to one shard, 2 a (source, shard) lane and round
    leaves = [f"x{i:03d}" for i in range(HUB_LEAVES)]
    lo = min(labelhash.hash_label(x) for x in leaves)
    hub = next(h for h in (f"hub{j}" for j in range(100_000))
               if labelhash.hash_label(h) < lo)
    chunk = [(hub, x, True) for x in leaves]
    runs = {name: ShardedSummarizer(smoke_config(), n_shards=SHARDS,
                                    router_chunk=HUB_CHUNK, lane_cap=2, **kw)
            for name, kw in (("mesh", dict(mesh=EngineMesh(devices))),
                             ("one", dict(device="cuda:0")))}
    for ss in runs.values():
        ss.process(chunk)
        ss.flush()
    mesh, one = runs["mesh"], runs["one"]
    check_blocks((mesh._est, mesh._ist), (one._est, one._ist),
                 "phase 20 hub chunk: the mesh vs one position")
    hub_stats = {name: ss.stats() for name, ss in runs.items()}
    rounds = hub_stats["mesh"]["router_drain_rounds"] + 1
    bad = [k for k in ENGINE_COUNTERS
           if hub_stats["mesh"][k] != hub_stats["one"][k]]
    if rounds < 2 or bad or hub_stats["mesh"]["router_overflows"]:
        raise AssertionError(f"phase 20 hub chunk: {rounds} drain rounds, "
                             f"counters {bad} differ: {hub_stats}")
    res["hub"] = dict(leaves=HUB_LEAVES, router_chunk=HUB_CHUNK, lane_cap=2,
                      drain_rounds=rounds,
                      one_position_drain_rounds=hub_stats["one"][
                          "router_drain_rounds"] + 1,
                      stats=hub_stats["mesh"])
    del runs, mesh, one, ss
    torch.cuda.empty_cache()
    res["seconds"] = time.perf_counter() - t0
    log(f"phase 20 hub chunk: {HUB_LEAVES} changes to one shard at lane_cap "
        f"2, {rounds} drain rounds on the mesh "
        f"({res['hub']['one_position_drain_rounds']} at one position), "
        f"every leaf equal to one position's; phase 20 "
        f"{res['seconds']:.1f} s")
    return res


def intern_vs_plain(sharded: dict, gen) -> int:
    """The probe kernel at phase 11's shapes, bitwise against its plain
    version: ``SHARDS`` prehashed tables of ``intern_cap(full_config())``
    slots holding ``n_cap`` keys (a full intern table: ~25% load, no
    tombstones), probed in both modes at every lane count that phase 11
    sent (the stream and the reads); then one ``ops.ht_probe_many`` of
    the ``SHARDS`` jobs of a read's resolve at the largest read batch, the
    one probe of the intern tables that phase 11 still sends (the chunk's
    interning is the intern kernel's).  Returns the max |error| (0)."""
    import torch
    from repro_torch.configs.mosso_stream import full_config
    from repro_torch.dist.router import intern_cap
    from repro_torch.kernels import ops
    from repro_torch.kernels.ht_probe import ProbeJob, ht_probe_many_plain
    cfg = full_config()
    cap = intern_cap(cfg)
    t = time.perf_counter()
    tables = [bulk_table(cap, cfg.n_cap, 0, True, gen)[0]
              for _ in range(SHARDS)]
    build_s = time.perf_counter() - t
    lanes = sharded["lanes"]
    _, max_err = kernel_vs_plain({("25%", True): tables[0]}, lanes, gen,
                                 time_it=False)
    read_lanes = max(int(k.split(":")[1]) for k in sharded["read_by_batch"])
    jobs = [ProbeJob(*tab, *queries(tab, read_lanes, gen), True, "find")
            for tab in tables]
    before = ops.ht_probe.launches
    got = ops.ht_probe_many(jobs)
    if ops.ht_probe.launches - before != 1:
        raise AssertionError(f"{len(jobs)} resolve jobs took "
                             f"{ops.ht_probe.launches - before} launches")
    for j, (g, w) in enumerate(zip(got, ht_probe_many_plain(jobs))):
        max_err = max(max_err, check_equal(
            g, w, f"resolve job {j} of {len(jobs)} x {read_lanes} lanes"))
    log(f"kernel vs plain: bitwise equal on {SHARDS} prehashed cap=2^"
        f"{cap.bit_length() - 1} intern tables of {cfg.n_cap} keys (built "
        f"in {build_s:.1f} s) in find/insert at phase 11's lanes {lanes}; "
        f"one ht_probe_many of {SHARDS} x {read_lanes} lanes, one launch")
    del tables
    torch.cuda.empty_cache()
    return max_err


def _replica_leaves(ss):
    from repro_torch.dist.router import sharded_state_to_numpy
    return sharded_state_to_numpy(ss._est, ss._ist)


def _check_leaves(a, b, what: str) -> None:
    import numpy as np
    for part_a, part_b in zip(a, b):
        for k in part_a:
            for w, x in (part_a[k].items() if isinstance(part_a[k], dict)
                         else ((None, part_a[k]),)):
                y = part_b[k][w] if w else part_b[k]
                if not (x.dtype == y.dtype and np.array_equal(x, y)):
                    raise AssertionError(f"{what}: leaf "
                                         f"{k}{'.' + w if w else ''} differs")


def sharded_router_paths(seed: int) -> dict:
    """Phase 12: device routing, host routing, key skew at ``lane_cap=2``
    and a bounded drain budget at ``smoke_config()`` with 3 shards, on the
    card and on the CPU, every replica leaf bitwise equal after every
    ``process`` call, and device routing equal to host routing after the
    stream; then a short ``serve_summary(..., verify=True)`` on the card."""
    from repro_torch.configs.mosso_stream import smoke_config
    from repro_torch.core.engine import ShardedSummarizer
    from repro_torch.dist import labelhash
    from repro_torch.graph.streams import (barabasi_albert_edges,
                                           edges_to_fully_dynamic_stream)
    from repro_torch.kernels import ops
    from repro_torch.launch.serve_summary import serve_summary

    cfg = smoke_config()
    chunk = 64
    stream = edges_to_fully_dynamic_stream(
        barabasi_albert_edges(40, 3, seed), delete_prob=0.15, seed=seed + 1)
    leaves = [f"x{i:03d}" for i in range(32)]
    lo = min(labelhash.hash_label(x) for x in leaves)
    hub = next(h for h in (f"hub{j}" for j in range(100_000))
               if labelhash.hash_label(h) < lo)
    skew = ([(hub, x, True) for x in leaves]
            + [(hub, x, False) for x in leaves[::3]])
    cases = {"device": (stream, dict(routing="device")),
             "host": (stream, dict(routing="host")),
             "skew_lane_cap_2": (skew, dict(routing="device", lane_cap=2)),
             "bounded_drain": (skew, dict(routing="device", lane_cap=8,
                                          max_drain_rounds=2))}
    out, final = {}, {}
    for name, (changes, kw) in cases.items():
        runs = {dev: ShardedSummarizer(cfg, device=dev, n_shards=3,
                                       router_chunk=chunk, **kw)
                for dev in ("cuda:0", "cpu")}
        ops.reset_counts()
        calls = 0
        for off in range(0, len(changes), chunk):
            for ss in runs.values():
                ss.process(changes[off:off + chunk])
            _check_leaves(_replica_leaves(runs["cuda:0"]),
                          _replica_leaves(runs["cpu"]),
                          f"{name} call {calls} card vs cpu")
            calls += 1
        stats = {dev: ss.stats() for dev, ss in runs.items()}   # flushed
        final[name] = _replica_leaves(runs["cuda:0"])
        if stats["cuda:0"] != stats["cpu"]:
            raise AssertionError(f"{name}: stats differ {stats}")
        if ops.ht_probe.launches == 0:
            raise AssertionError(f"{name} launched no probe kernel")
        truth = live_edges(changes)
        if runs["cuda:0"].materialize().decode_edges() != truth:
            raise AssertionError(f"{name}: lossless decode failed")
        out[name] = dict(calls=calls, stats=stats["cuda:0"],
                         probe_launches=ops.ht_probe.launches)
        log(f"sharded router paths: {name}: card == cpu, every replica "
            f"leaf bitwise after each of {calls} process calls; "
            f"{ops.ht_probe.launches} probe launches; {stats['cuda:0']}")
    _check_leaves(final["device"], final["host"],
                  "device routing vs host routing on the card")
    s = out["skew_lane_cap_2"]["stats"]
    b = out["bounded_drain"]["stats"]
    if s["router_drain_rounds"] < 2 or b["router_overflows"] == 0:
        raise AssertionError(f"the skew cases did not drain: {s} {b}")
    log("sharded router paths: device routing == host routing on the card, "
        "bitwise after the stream")
    ss = ShardedSummarizer(cfg, device="cuda:0", n_shards=3,
                           router_chunk=chunk)
    t = time.perf_counter()
    served = serve_summary(ss, stream, reads_per_chunk=16, verify=True,
                           seed=seed)
    served["seconds"] = time.perf_counter() - t
    if not served["verified"] or served["max_lag"] != 1:
        raise AssertionError(f"serve_summary: {served}")
    log(f"serve_summary on the card: {served['reads']} reads over "
        f"{served['chunks']} chunks verified against each snapshot's epoch "
        f"prefix, {served['us_per_read']:.1f} us/read, max epoch lag "
        f"{served['max_lag']}, {served['seconds']:.2f} s")
    out["serve_summary"] = served
    return out


# --------------------------------------------------------------------- #
# phases 13-14: crash consistency
# --------------------------------------------------------------------- #


def _dir_bytes(path) -> int:
    return sum(f.stat().st_size for f in Path(path).rglob("*")
               if f.is_file())


def _flat(summ) -> dict:
    from repro_torch.checkpoint.checkpointer import _flatten
    return _flatten(summ._ckpt_tree())


def _check_flat(got: dict, want: dict, what: str) -> None:
    import numpy as np
    if sorted(got) != sorted(want):
        raise AssertionError(f"{what}: archive keys differ")
    for k, x in want.items():
        if not (got[k].dtype == x.dtype and np.array_equal(got[k], x)):
            raise AssertionError(f"{what}: leaf {k} differs")


def _stats(summ) -> dict:
    s = summ.stats()
    s.pop("stream_retries")
    return s


def _read_all(view, labels, pairs) -> tuple:
    return (view.degree_batch(labels), view.has_edge_batch(pairs),
            view.neighbors_batch(labels))


def _read_sample(stream, seed: int, n: int = 64):
    import random
    rng = random.Random(seed)
    labels = sorted({x for c in stream for x in c[:2]})
    labels = rng.sample(labels, min(n, len(labels)))
    pairs = [c[:2] for c in rng.sample(stream, min(n, len(stream)))]
    return labels, pairs


def batched_recovery(stream, phase3_step_s, seed: int,
                     twin: bool = False) -> dict:
    """Phase 13: ``BatchedSummarizer(full_config(), checkpoint_dir=...)``
    on the card over the first ``RECOVERY_CHUNKS`` chunks of phase 3's
    stream, the last of them ``RECOVERY_TAIL`` changes (a stream's tail:
    the chunk each recovery replays).  Run A: uninterrupted, ``save()``
    after every chunk; with ``twin``, each chunk is also fed to a
    summarizer without a checkpoint directory, in alternating
    order, and both are timed (the two must end bitwise equal; it adds
    ``RECOVERY_CHUNKS`` chunks to the phase).  Run B: run A's directory
    as a kill at the last chunk boundary leaves it (copied after the last
    chunk, before its save: the epoch before it and the chunk
    journaled); a fresh summarizer ``recover()``s it (that epoch + 1
    journaled chunk) and
    finishes the stream: every leaf, ``stats()`` less ``stream_retries``
    and the reads must equal A's.  Then A's newest checkpoint is
    corrupted and a fresh ``recover()`` must fall back one epoch and
    still land bitwise.  Times ``save()`` by phase, ``restore()``,
    ``recover()`` and the journal appends; us per change journaled (and
    not journaled, with ``twin``) and phase 3's over the same changes."""
    import shutil
    import torch
    from repro_torch.checkpoint import checkpointer
    from repro_torch.checkpoint.journal import ChunkJournal
    from repro_torch.configs.mosso_stream import full_config
    from repro_torch.core.engine import BatchedSummarizer
    from repro_torch.ft import inject
    from repro_torch.kernels import ops

    cfg = full_config()
    b = cfg.batch
    prefix = stream[:(RECOVERY_CHUNKS - 1) * b + RECOVERY_TAIL]
    root = CKPT_ROOT / "batched"
    shutil.rmtree(root, ignore_errors=True)
    CKPT_ROOT.mkdir(parents=True, exist_ok=True)
    dir_a, dir_b = str(root / "a"), str(root / "b")
    log(f"batched recovery: full_config over the first {len(prefix)} "
        f"changes of phase 3's stream ({RECOVERY_CHUNKS} chunks of up to "
        f"{b}, the last {RECOVERY_TAIL}); "
        f"checkpoints under {root}; free disk "
        f"{shutil.disk_usage(CKPT_ROOT).free / 2**30:.1f} GiB")

    appends = []
    append = ChunkJournal.append

    def timed_append(self, seq, changes):
        t = time.perf_counter()
        append(self, seq, changes)
        appends.append(time.perf_counter() - t)

    ChunkJournal.append = timed_append
    try:
        # run A (counts set to 0 just before, read just after), each chunk
        # beside the same chunk on a summarizer that journals nothing
        a = BatchedSummarizer(cfg, device="cuda", checkpoint_dir=dir_a)
        plain = BatchedSummarizer(cfg, device="cuda") if twin else None
        ops.reset_counts()
        step_s, plain_s, saves = [], [], []
        for i, off in enumerate(range(0, len(prefix), b)):
            runs = ((a, step_s), (plain, plain_s))[:1 + twin]
            for summ, times in runs[::-1] if i % 2 == 0 else runs:
                t = time.perf_counter()
                summ.process(prefix[off:off + b])
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t)
            if i + 1 == RECOVERY_CHUNKS:
                # run B's directory: what a kill at this boundary leaves
                # (the epoch before saved, this chunk journaled, no save
                # after it)
                shutil.copytree(dir_a, dir_b)
            checkpointer.save_seconds.clear()
            t = time.perf_counter()
            path = a.save()
            total = time.perf_counter() - t
            saves.append(dict(checkpointer.save_seconds, total=total,
                              epoch=i + 1, bytes=_dir_bytes(path)))
        launches_a = ops.ht_probe.launches
        if launches_a == 0:
            raise AssertionError("run A launched no probe kernel")
        want = _flat(a)
        want_stats = _stats(a)
        if twin:
            _check_flat(_flat(plain), want, "journaled vs not journaled")
        del plain
        labels, pairs = _read_sample(prefix, seed)
        view = a.query()
        want_reads = _read_all(view, labels, pairs)
        del view, a
        torch.cuda.empty_cache()
        n_appends = len(appends)

        # run B: the kill's directory, recovered by a fresh summarizer
        restored = BatchedSummarizer(cfg, device="cuda",
                                     checkpoint_dir=dir_b)
        t = time.perf_counter()
        restored.restore()
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t
        del restored
        rec = BatchedSummarizer(cfg, device="cuda", checkpoint_dir=dir_b)
        ops.reset_counts()
        t = time.perf_counter()
        info = rec.recover()
        torch.cuda.synchronize()
        recover_s = time.perf_counter() - t
        if (info["epoch"], info["replayed_chunks"]) != \
                (RECOVERY_CHUNKS - 1, 1) or info["cursor"] != len(prefix):
            raise AssertionError(f"recover(): {info}")
        inject.drive(rec, prefix, start=rec.stream_cursor)
        torch.cuda.synchronize()
        launches_b = ops.ht_probe.launches
        if launches_b == 0:
            raise AssertionError("the recovery launched no probe kernel")
        _check_flat(_flat(rec), want, "recovered run B vs run A")
        if _stats(rec) != want_stats:
            raise AssertionError(f"stats: {rec.stats()} != {want_stats}")
        view = rec.query()
        if _read_all(view, labels, pairs) != want_reads:
            raise AssertionError("run B's reads differ from run A's")
        del view, rec
        torch.cuda.empty_cache()
        log(f"batched recovery: run A's directory at chunk boundary "
            f"{RECOVERY_CHUNKS} (a kill's), recover() restored epoch {info['epoch']} and replayed "
            f"{info['replayed_chunks']} chunk; continued, every leaf, "
            f"stats() and {len(labels)} degree / {len(pairs)} has_edge / "
            f"{len(labels)} neighbors reads equal run A's, bitwise")

        # the newest checkpoint corrupted: fall back one epoch
        newest = checkpointer.latest_step(dir_a)
        inject.corrupt_checkpoint_arrays(dir_a, newest)
        fb = BatchedSummarizer(cfg, device="cuda", checkpoint_dir=dir_a)
        t = time.perf_counter()
        fb_info = fb.recover()
        torch.cuda.synchronize()
        fallback_s = time.perf_counter() - t
        if not (fb_info["step"] < newest and fb_info["rejected"]
                and fb_info["cursor"] == len(prefix)):
            raise AssertionError(f"fallback recover(): {fb_info}")
        _check_flat(_flat(fb), want, "fallback recovery vs run A")
        if _stats(fb) != want_stats:
            raise AssertionError("fallback recovery: stats differ")
        del fb
        torch.cuda.empty_cache()
    finally:
        ChunkJournal.append = append
        shutil.rmtree(root, ignore_errors=True)

    n = len(prefix)
    # per change over the first chunk, the same changes as phase 3's
    # first step
    journaled_us = 1e6 * step_s[0] / b
    plain_us = 1e6 * plain_s[0] / b if twin else None
    phase3_us = 1e6 * phase3_step_s[0] / b
    res = dict(changes=n, chunks=RECOVERY_CHUNKS, saves=saves,
               restore_s=restore_s, recover_s=recover_s,
               fallback_recover_s=fallback_s, fallback_info=fb_info,
               recover_info=info, journal_append_s=appends[:n_appends],
               journal_append_ms=1e3 * sum(appends[:n_appends]) / n_appends,
               journaled_us_per_change=journaled_us,
               journaled_chunk_s=step_s, plain_chunk_s=plain_s,
               plain_us_per_change=plain_us,
               phase3_us_per_change_same_changes=phase3_us,
               run_a_probe_launches=launches_a,
               recovery_probe_launches=launches_b)
    for s in saves:
        log(f"batched save at epoch {s['epoch']}: {s['total']:.3f} s "
            f"(host copy {s['host_copy']:.3f}, np.savez {s['savez']:.3f}, "
            f"fsync {s['fsync']:.3f}, sha256 {s['sha256']:.3f}, host.pkl "
            f"{s['blobs']:.3f}, meta + rename {s['meta']:.3f}); "
            f"{s['bytes']} bytes ({s['bytes'] / 2**30:.3f} GiB) on disk")
    log(f"batched recovery: restore() {restore_s:.3f} s, recover() "
        f"{recover_s:.3f} s (restore + 1 replayed chunk), fallback "
        f"recover() {fallback_s:.3f} s (epoch {fb_info['epoch']} + "
        f"{fb_info['replayed_chunks']} chunk); journal append "
        f"{res['journal_append_ms']:.3f} ms per chunk "
        f"({n_appends} appends); {journaled_us:.1f} us/change journaled "
        f"over the first chunk"
        + (f" against {plain_us:.1f} not journaled (chunks alternating: "
           + ", ".join(f"{x:.2f}/{y:.2f}" for x, y in zip(step_s, plain_s))
           + " s; the two runs bitwise equal)" if twin else "")
        + f" and phase 3's first step {phase3_us:.1f}; probe "
        f"launches {launches_a} (run A{' and its twin' if twin else ''}), "
        f"{launches_b} (recovery + rest)")
    return res


def sharded_checkpoint(ss, stream, seed: int) -> dict:
    """Phase 14(a): one ``save()`` of phase 11's live 4 x ``full_config()``
    summarizer, restored into a fresh ``ShardedSummarizer(full_config(),
    n_shards=4)``: every replica and intern leaf equal on the card, the
    hash -> label map, ``stats()`` and a query snapshot's degree /
    has_edge / neighbors reads equal.  Save and restore seconds, bytes,
    and the free disk before the save."""
    import shutil
    import torch
    from repro_torch.checkpoint import checkpointer
    from repro_torch.configs.mosso_stream import full_config
    from repro_torch.core.engine import ShardedSummarizer
    from repro_torch.core.engine.hashtable import HashTable
    from repro_torch.kernels import ops

    root = CKPT_ROOT / "sharded"
    shutil.rmtree(root, ignore_errors=True)
    CKPT_ROOT.mkdir(parents=True, exist_ok=True)
    free = shutil.disk_usage(CKPT_ROOT).free
    log(f"sharded checkpoint: free disk before the save {free / 2**30:.1f} "
        f"GiB under {CKPT_ROOT}")
    try:
        checkpointer.save_seconds.clear()
        t = time.perf_counter()
        path = ss.save(str(root))
        save_s = time.perf_counter() - t
        parts = dict(checkpointer.save_seconds)
        n_bytes = _dir_bytes(path)
        fresh = ShardedSummarizer(full_config(), device="cuda:0",
                                  n_shards=ss.n_shards,
                                  router_chunk=ss.router_chunk)
        ops.reset_counts()
        t = time.perf_counter()
        info = fresh.restore(str(root))
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t
    finally:
        shutil.rmtree(root, ignore_errors=True)
    for what, xs, ys in (("replica", ss.states, fresh.states),
                         ("intern", ss.interns, fresh.interns)):
        for r, (x, y) in enumerate(zip(xs, ys)):
            for f in dataclasses.fields(x):
                u, v = getattr(x, f.name), getattr(y, f.name)
                pairs = ([(getattr(u, w), getattr(v, w))
                          for w in ("k1", "k2", "val")]
                         if isinstance(u, HashTable) else [(u, v)])
                for p, q in pairs:
                    if not (p.dtype == q.dtype and p.device == q.device
                            and torch.equal(p, q)):
                        raise AssertionError(f"{what} {r} leaf {f.name} "
                                             f"differs after restore")
    if fresh.host_label_map() != ss.host_label_map():
        raise AssertionError("restored hash -> label map differs")
    if _stats(fresh) != _stats(ss):
        raise AssertionError(f"stats: {fresh.stats()} != {ss.stats()}")
    labels, pairs = _read_sample(stream, seed)
    view = ss.query()
    want = _read_all(view, labels, pairs)
    del view
    ops.reset_counts()
    view = fresh.query()
    got = _read_all(view, labels, pairs)
    del view
    if got != want:
        raise AssertionError("reads of the restored summarizer differ")
    if ops.ht_probe.launches == 0:
        raise AssertionError("the restored reads launched no probe kernel")
    res = dict(save_s=save_s, save_parts=parts, bytes=n_bytes,
               restore_s=restore_s, free_bytes=free, epoch=info["epoch"],
               read_probe_launches=ops.ht_probe.launches)
    del fresh
    torch.cuda.empty_cache()
    log(f"sharded checkpoint: save() {save_s:.3f} s (host copy "
        f"{parts['host_copy']:.3f}, np.savez {parts['savez']:.3f}, fsync "
        f"{parts['fsync']:.3f}, sha256 {parts['sha256']:.3f}, host.pkl "
        f"{parts['blobs']:.3f}, meta + rename {parts['meta']:.3f}); "
        f"{n_bytes} bytes ({n_bytes / 2**30:.3f} GiB); restore() "
        f"{restore_s:.3f} s into a fresh 4-shard summarizer: every replica "
        f"and intern leaf, the label map, stats() and {len(labels)} degree "
        f"/ {len(pairs)} has_edge / {len(labels)} neighbors reads equal")
    return res


def sharded_kill_bar(seed: int) -> dict:
    """Phase 14(b): ``smoke_config()``, 3 shards, ``router_chunk`` 32,
    device routing, on the card and on the CPU: killed at every chunk
    boundary (checkpoint every 2 chunks) and recovered by a fresh
    summarizer, then continued; every leaf, the host closure and
    ``stats()`` equal the uninterrupted run's, and the card's equal the
    CPU's.  The card's kills, recoveries and continuations must launch
    the probe and intern kernels (counts set to 0 just before them)."""
    import shutil
    import numpy as np
    from repro_torch.configs.mosso_stream import smoke_config
    from repro_torch.core.engine import ShardedSummarizer
    from repro_torch.ft import inject
    from repro_torch.graph.streams import (barabasi_albert_edges,
                                           edges_to_fully_dynamic_stream)
    from repro_torch.kernels import ops

    cfg = smoke_config()
    chunk = 32
    stream = edges_to_fully_dynamic_stream(
        barabasi_albert_edges(40, 3, seed), delete_prob=0.15, seed=seed + 1)
    n_chunks = -(-len(stream) // chunk)
    root = CKPT_ROOT / "kill_bar"

    def make(dev, d=None):
        return ShardedSummarizer(cfg, device=dev, n_shards=3,
                                 router_chunk=chunk, checkpoint_dir=d)

    def closure(summ):
        summ.flush()
        host = dict(summ._ckpt_host())
        host["drain_rounds"] = np.asarray(host["drain_rounds"]).tolist()
        return _flat(summ), host, _stats(summ)

    out = {}
    try:
        finals = {}
        for dev in ("cuda", "cpu"):
            ref = make(dev)
            ref.process(stream)
            want = finals[dev] = closure(ref)
            ops.reset_counts()
            t = time.perf_counter()
            for k in range(n_chunks + 1):
                d = str(root / f"{dev}{k}")
                try:
                    inject.drive(make(dev, d), stream, ckpt_every=2,
                                 kill_at_chunk=k)
                    raise AssertionError("the kill point was never reached")
                except inject.SimulatedCrash:
                    pass
                rec = make(dev, d)
                rec.recover()
                if rec.stream_cursor != min(k * chunk, len(stream)):
                    raise AssertionError(f"{dev} kill {k}: cursor "
                                         f"{rec.stream_cursor}")
                inject.drive(rec, stream, start=rec.stream_cursor)
                got = closure(rec)
                _check_flat(got[0], want[0], f"{dev} kill {k}")
                if got[1:] != want[1:]:
                    raise AssertionError(f"{dev} kill {k}: host closure or "
                                         f"stats differ")
            out[dev] = dict(kills=n_chunks + 1,
                            seconds=time.perf_counter() - t,
                            probe_launches=ops.ht_probe.launches,
                            intern_launches=ops.intern.launches)
        if out["cuda"]["probe_launches"] == 0 or \
                out["cuda"]["intern_launches"] == 0:
            raise AssertionError(f"the card's recoveries launched no probe "
                                 f"or no intern: {out['cuda']}")
        _check_flat(finals["cuda"][0], finals["cpu"][0], "card vs cpu")
        if finals["cuda"][1:] != finals["cpu"][1:]:
            raise AssertionError("card vs cpu: host closure or stats differ")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(f"sharded kill bar: smoke_config, 3 shards, {len(stream)} changes "
        f"in {n_chunks} chunks of {chunk}; killed at each of "
        f"{n_chunks + 1} boundaries and recovered, every leaf, the host "
        f"closure and stats() bitwise the uninterrupted run's, on the card "
        f"({out['cuda']['seconds']:.1f} s, {out['cuda']['probe_launches']} "
        f"probe and {out['cuda']['intern_launches']} intern launches) and "
        f"on the CPU ({out['cpu']['seconds']:.1f} s); "
        f"card == cpu")
    return out


def summarize_stream_driver() -> dict:
    """Phase 14(c): ``python -m repro_torch.launch.summarize_stream`` on
    the card at 60 nodes, ``router_chunk`` 64 (4 chunks, killed at
    boundary 3): kill, recover, identical reads, bitwise continuation, by
    its own assertions."""
    import os
    import shutil
    d = CKPT_ROOT / "summarize_stream"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t = time.perf_counter()
    try:
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.summarize_stream",
             "60", "--router-chunk", "64", "--checkpoint-dir", str(d)],
            env=env,
            capture_output=True, text=True, timeout=600)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    seconds = time.perf_counter() - t
    for line in proc.stdout.strip().splitlines():
        log(f"  summarize_stream: {line}")
    if proc.returncode != 0:
        raise AssertionError(f"summarize_stream exited {proc.returncode}: "
                             f"{proc.stderr[-3000:]}")
    if "crash-recover verified: bitwise state match" not in proc.stdout:
        raise AssertionError("summarize_stream did not verify its recovery")
    log(f"summarize_stream on the card: exit 0 in {seconds:.1f} s")
    return dict(seconds=seconds, stdout=proc.stdout)



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
    """Kernel vs plain for each shape's reduces in ``CSR_SHAPES``,
    uniform random edges (empty rows where e/n is small); min/max on x
    with ±inf planted in some rows.  Returns the rows and the max error."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.csr_segment import (csr_segment_cuda,
                                                 csr_segment_plain)
    rows, max_err = [], 0.0
    for name, n, e, f, reduces in CSR_SHAPES:
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
        for reduce in reduces:
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


def graphsage_request(seed: int) -> tuple:
    """One graphsage-reddit full_config() inference request at full width
    (see phase 7), held to the plain path on the CPU.  Returns the results
    and the request's padded batch (phase 16 trains on it)."""
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
    return res, batch


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
# phase 16: training on the card
# --------------------------------------------------------------------- #


def _tree_err(got, want, rtol: float, atol: float, what: str) -> float:
    """Max |got - want| over two trees of tensors (``got`` on the card,
    ``want`` on the CPU), after holding every leaf within the
    tolerances."""
    import torch
    from repro_torch.models.common import tree_leaves
    err = 0.0
    for i, (a, b) in enumerate(zip(tree_leaves(got), tree_leaves(want))):
        a = a.detach().cpu()
        bad = ~((a - b).abs() <= atol + rtol * b.abs())
        if bool(bad.any()):
            raise AssertionError(f"{what}: leaf {i} {tuple(b.shape)} differs "
                                 f"in {int(bad.sum())} entries beyond "
                                 f"rtol={rtol} atol={atol}")
        if b.numel():
            err = max(err, float((a - b).abs().max()))
    return err


def tensor_bytes(tree) -> int:
    """Bytes of the tensors of a tree (dicts, lists, tuples, NamedTuples)."""
    import torch
    import torch.utils._pytree as pytree
    return sum(t.numel() * t.element_size() for t in pytree.tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def held_by_step(params, opt, batch, step) -> dict:
    """Phase 18(a)'s yardsticks from a training phase: the bytes it holds
    on the card (parameters, AdamW state, one batch) and
    ``FlopCounterMode`` over one more step on them."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as fc:
        step(params, opt, *batch)
    torch.cuda.synchronize()
    return dict(params=tensor_bytes(params), opt_state=tensor_bytes(opt),
                inputs=tensor_bytes(batch),
                flops=int(fc.get_total_flops()))


def csr_backward_vs_plain(batch, gen) -> dict:
    """Phase 16(a): the segment sum's backward (the kernel over the
    transposed layout) against torch's autograd of the plain version on
    the same card, rtol = atol = 1e-5: at the GraphSAGE request's two
    layer inputs (phase 7's padded batch: masked edges and empty rows),
    and at ``_agg``'s edge-id form over the same edges; then the
    backward's launch timed beside its byte bound and ``torch.sparse.mm``
    of the transposed adjacency, and the transposed layout's build."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.csr_segment import csr_segment_plain
    n = batch.node_feat.shape[0]
    layout = ops.csr_layout(batch.senders, batch.receivers, n,
                            batch.edge_mask)
    edges = torch.arange(batch.senders.shape[0], device="cuda")
    by_edge = ops.csr_layout(edges, batch.receivers, n, batch.edge_mask)
    masked = int((~batch.edge_mask).sum())
    empty = int((layout.degree() == 0).sum())
    f = 128                                    # d_hidden: both layers' width
    rows, max_err = [], 0.0
    for what, lay, n_src in (("layer 1 (z = x @ w_nbr)", layout, n),
                             ("layer 2 (h)", layout, n),
                             ("_agg's edge ids", by_edge, edges.numel())):
        x = torch.randn((n_src, f), generator=gen, device="cuda")
        g = torch.randn((n, f), generator=gen, device="cuda")
        grads = []
        for fn in (lambda t: ops.segment_reduce_csr(lay, t, "sum"),
                   lambda t: csr_segment_plain(*lay, t, "sum")):
            xr = x.clone().requires_grad_(True)
            torch.sum(fn(xr) * g).backward()
            grads.append(xr.grad)
        torch.cuda.synchronize()
        err = close(grads[0], grads[1], "sum", what=f"backward at {what}")
        max_err = max(max_err, err)
        rows.append(dict(what=what, n_src=n_src, f=f, max_abs_err=err))
        log(f"phase 16(a): csr backward at {what}: kernel == plain autograd "
            f"(max |err| {err:.2e}; [{n_src}, {f}], {masked} masked edges, "
            f"{empty} empty rows)")
    # the backward's one launch, at layer 1: the transposed layout's sum
    # of a [n, 128] gradient
    g = torch.randn((n, f), generator=gen, device="cuda")
    t_layout = layout.transposed(n)
    res = dict(rows=rows, max_abs_err=max_err, masked_edges=masked,
               empty_rows=empty, **time_csr(t_layout, g, "sum", False))
    res["transpose_ms"] = cuda_ms(lambda: ops.Csr(*layout).transposed(n),
                                  10)
    log(f"phase 16(a): csr backward launch at layer 1 (transposed "
        f"layout, {int(t_layout.row_off[-1] - t_layout.row_off[0])} "
        f"edges, F={f}): kernel {res['ms'] * 1e3:.1f} us (call "
        f"{res['call_ms'] * 1e3:.1f} us), plain "
        f"{res['plain_ms'] * 1e3:.1f} us, torch.sparse.mm of the "
        f"transposed adjacency {res['library_ms'] * 1e3:.1f} us, bound "
        f"{res['bound_ms'] * 1e3:.1f} us (each input once); building "
        f"the transposed layout {res['transpose_ms'] * 1e3:.1f} us "
        f"(once per step)")
    return res


def sasrec_training(seed: int) -> dict:
    """Phase 16(b): SASRec ``full_config()`` trained at
    ``RECSYS_SHAPES["train_batch"]`` (B 65,536, L 50) from
    ``sasrec_batches``: one step's loss and gradients on the first 1,024
    rows card vs CPU (rtol = atol = 1e-4), then ``TRAIN_STEPS`` AdamW steps
    (ms per step, peak memory, the loss falling), one profiled step's
    device busy share; then ``serve_topk`` at ``serve_p99`` and
    ``retrieval_cand``, scores card vs CPU."""
    import numpy as np
    import torch
    from repro_torch.configs.base import RECSYS_SHAPES
    from repro_torch.configs.sasrec import full_config
    from repro_torch.data.synthetic import sasrec_batches
    from repro_torch.kernels import ops
    from repro_torch.models.sasrec import (init_sasrec, params_to,
                                           score_candidates, serve_topk,
                                           train_loss)
    from repro_torch.optim import adamw
    from repro_torch.train.step import make_train_step, value_and_grad

    cfg = full_config()
    batch, steps = RECSYS_SHAPES["train_batch"]["batch"], TRAIN_STEPS
    params = init_sasrec(cfg, seed, "cuda")
    loss_fn = lambda p, *b: train_loss(p, *b, cfg)  # noqa: E731
    data = sasrec_batches(cfg.n_items, batch, cfg.seq_len, seed=seed,
                          device="cuda")
    first = next(data)

    # one step's loss and gradients, card vs CPU, on the first 1,024 rows
    small = tuple(x[:CHECK_ROWS] for x in first)
    loss_c, grads_c = value_and_grad(loss_fn, params, *small)
    loss_h, grads_h = value_and_grad(loss_fn, params_to(params, "cpu"),
                                     *(x.cpu() for x in small))
    if abs(float(loss_c) - float(loss_h)) > 1e-5 * abs(float(loss_h)):
        raise AssertionError(f"SASRec loss card {float(loss_c)} != CPU "
                             f"{float(loss_h)}")
    grad_err = _tree_err(grads_c, grads_h, 1e-4, 1e-4, "SASRec gradient")
    del grads_c, grads_h
    log(f"phase 16(b): sasrec full_config one step on {CHECK_ROWS} rows: "
        f"loss card {float(loss_c):.6f} == CPU {float(loss_h):.6f}, "
        f"gradients within 1e-4 (max |err| {grad_err:.2e})")

    opt_cfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=1000)
    opt = adamw.init(params, opt_cfg)
    step = make_train_step(loss_fn, opt_cfg)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_counts()
    losses, step_s, data_s, b = [], [], [], first
    for i in range(steps):
        if i:
            t = time.perf_counter()
            b = next(data)
            torch.cuda.synchronize()
            data_s.append(time.perf_counter() - t)
        t = time.perf_counter()
        params, opt, metrics = step(params, opt, *b)
        losses.append(float(metrics["loss"]))   # a host read, as train.py
        step_s.append(time.perf_counter() - t)
    attn_launches = ops.attention.launches
    res = dict(batch=batch, seq_len=cfg.seq_len, n_items=cfg.n_items,
               losses=losses, step_s=step_s, data_s=data_s,
               grad_max_abs_err=grad_err, loss_1024=float(loss_c),
               attention_launches=attn_launches)
    if not losses[-1] < losses[0]:
        raise AssertionError(f"SASRec loss did not fall: {losses}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"SASRec loss not finite: {losses}")
    steady = sorted(step_s[1:])[len(step_s[1:]) // 2]
    res["ms_per_step"] = 1e3 * steady
    res["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    res["held"] = held_by_step(params, opt, b, step)
    prof = device_breakdown(
        lambda: step(params, opt, *b),
        {"matmul": MATMUL_WORDS,
         "index (embedding gather/scatter)": ("index", "scatter",
                                              "gather", "embedding"),
         "softmax": ("softmax",)})
    res["profile"] = prof
    res["device_ms"] = sum(prof["device_us"].values()) / 1e3
    res["busy_share"] = res["device_ms"] / res["ms_per_step"]
    log(f"phase 16(b): sasrec full_config training, B={batch} L="
        f"{cfg.seq_len}: {steps} AdamW steps, loss "
        + " -> ".join(f"{x:.4f}" for x in losses)
        + f"; {res['ms_per_step']:.1f} ms per step (median of steps "
        f"2-{steps}, first {1e3 * step_s[0]:.1f} ms), batch drawn on "
        f"the host {1e3 * sum(data_s) / max(len(data_s), 1):.1f} ms; "
        f"peak {res['peak_gb']:.2f} GB; one step's device time "
        f"{res['device_ms']:.1f} ms = {100 * res['busy_share']:.1f}% "
        f"busy ({prof['device_kernels']} kernels; "
        + ", ".join(f"{k} {v / 1e3:.1f} ms"
                    for k, v in prof["device_us"].items())
        + f"); attention launches {attn_launches} (T=50: the reference)")
    for kind, rows in prof["top"].items():
        for t_us, count, key in rows[:2]:
            log(f"  {kind:34s} {t_us:10.1f} us  x{count:3d}  {key}")

    # serving: serve_topk at serve_p99 and retrieval_cand, card vs CPU
    rng = np.random.default_rng(seed + 5)
    cpu_params = params_to(params, "cpu")
    res["serve"] = {}
    for name in ("serve_p99", "retrieval_cand"):
        shape = RECSYS_SHAPES[name]
        seq = first[0][:shape["batch"]]
        cand = torch.from_numpy(rng.integers(
            1, cfg.n_items, shape["n_cand"]).astype(np.int32)).cuda()
        with torch.no_grad():
            vals, idx = serve_topk(params, seq, cand, cfg)
            want = score_candidates(cpu_params, seq.cpu(), cand.cpu(), cfg)
            got = score_candidates(params, seq, cand, cfg).cpu()
        bad = ~((got - want).abs() <= 1e-4 + 1e-4 * want.abs())
        if bool(bad.any()):
            raise AssertionError(f"{name}: scores card vs CPU differ in "
                                 f"{int(bad.sum())} entries")
        # the card's top 10 are the CPU's scores at those candidates, and
        # no other candidate beats the tenth (within the tolerance)
        at = torch.gather(want, 1, idx.cpu().long())
        kth = torch.topk(want, 10, dim=-1).values[:, -1:]
        if not (bool(((at - vals.cpu()).abs() <= 2e-4).all())
                and bool((at >= kth - 2e-4).all())):
            raise AssertionError(f"{name}: the card's top 10 are not the "
                                 f"CPU's")
        row = dict(batch=shape["batch"], n_cand=shape["n_cand"],
                   max_abs_err=float((got - want).abs().max()))
        with torch.no_grad():
            row["ms"] = cuda_ms(lambda: serve_topk(params, seq, cand,
                                                   cfg), 20)
        log(f"phase 16(b): sasrec serve_topk at {name} (B="
            f"{shape['batch']}, C={shape['n_cand']}): "
            f"{row['ms']:.3f} ms per request; scores card == CPU "
            f"(max |err| {row['max_abs_err']:.2e}), top 10 agree")
        res["serve"][name] = row
    return res


def graphsage_training(batch, seed: int) -> dict:
    """Phase 16(c): graphsage-reddit ``full_config()`` trained on phase
    7's sampled subgraph (padded to ``minibatch_lg``, n = e = 262,144, F
    602) with random labels on its live nodes: one step's loss and
    gradients card vs CPU (rtol = atol = 1e-4), every parameter's card
    gradient nonzero, then ``TRAIN_STEPS`` AdamW steps: ms per step and CSR
    launches per step, forward and backward."""
    import numpy as np
    import torch
    from repro_torch.configs.graphsage_reddit import full_config
    from repro_torch.kernels import ops
    from repro_torch.models.common import tree_leaves
    from repro_torch.models.gnn import gnn_loss, init_gnn, params_to
    from repro_torch.optim import adamw
    from repro_torch.train.step import make_train_step, value_and_grad

    cfg = full_config()
    n = batch.node_feat.shape[0]
    labels = np.random.default_rng(seed + 3).integers(
        0, cfg.n_classes, n).astype(np.int32)
    batch = batch._replace(labels=torch.from_numpy(labels).cuda())
    params = init_gnn(cfg, seed, device="cuda")
    loss_fn = lambda p, g: gnn_loss(p, g, cfg)  # noqa: E731
    ops.reset_counts()
    loss_c, grads_c = value_and_grad(loss_fn, params, batch)
    torch.cuda.synchronize()
    launches = (ops.segment_reduce.launches,
                ops.segment_reduce.backward_launches)
    t = time.perf_counter()
    loss_h, grads_h = value_and_grad(loss_fn, params_to(params, "cpu"),
                                     batch.to("cpu"))
    cpu_s = time.perf_counter() - t
    if abs(float(loss_c) - float(loss_h)) > 1e-4 + 1e-4 * abs(float(loss_h)):
        raise AssertionError(f"GraphSAGE loss card {float(loss_c)} != CPU "
                             f"{float(loss_h)}")
    grad_err = _tree_err(grads_c, grads_h, 1e-4, 1e-4, "GraphSAGE gradient")
    zero = [i for i, g in enumerate(tree_leaves(grads_c))
            if not bool((g != 0).any())]
    if zero:
        raise AssertionError(f"GraphSAGE leaves {zero} got no gradient on "
                             f"the card")
    log(f"phase 16(c): graphsage full_config one step, n=e={n}: loss card "
        f"{float(loss_c):.6f} == CPU {float(loss_h):.6f}, every one of "
        f"{len(tree_leaves(grads_c))} parameters with a nonzero gradient, "
        f"within 1e-4 of the CPU's (max |err| {grad_err:.2e}; CPU step "
        f"{cpu_s:.2f} s); CSR launches {launches[0] - launches[1]} forward "
        f"+ {launches[1]} backward")
    if launches[1] == 0:
        raise AssertionError("the GraphSAGE backward launched no kernel")

    opt_cfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=1000)
    opt = adamw.init(params, opt_cfg)
    step = make_train_step(loss_fn, opt_cfg)
    # the path: counts set to 0 just before, read just after
    torch.cuda.reset_peak_memory_stats()
    ops.reset_counts()
    losses, step_s = [], []
    for _ in range(TRAIN_STEPS):
        t = time.perf_counter()
        params, opt, metrics = step(params, opt, batch)
        losses.append(float(metrics["loss"]))
        step_s.append(time.perf_counter() - t)
    fwd = ops.segment_reduce.launches - ops.segment_reduce.backward_launches
    bwd = ops.segment_reduce.backward_launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    held = held_by_step(params, opt, (batch,), step)
    if fwd == 0 or bwd == 0:
        raise AssertionError(f"GraphSAGE training launched {fwd} forward "
                             f"and {bwd} backward CSR kernels")
    res = dict(n=n, losses=losses, step_s=step_s, cpu_step_s=cpu_s,
               grad_max_abs_err=grad_err, loss=float(loss_c),
               launches=fwd + bwd,
               forward_launches_per_step=fwd / TRAIN_STEPS,
               backward_launches_per_step=bwd / TRAIN_STEPS,
               peak_gb=peak_gb, held=held)
    steady = sorted(step_s[1:])[len(step_s[1:]) // 2]
    res["ms_per_step"] = 1e3 * steady
    log(f"phase 16(c): graphsage full_config training: {TRAIN_STEPS} AdamW "
        f"steps, loss " + " -> ".join(f"{x:.4f}" for x in losses)
        + f"; {res['ms_per_step']:.2f} ms per step (median of steps "
        f"2-{TRAIN_STEPS}, first {1e3 * step_s[0]:.1f} ms); CSR launches per "
        f"step {fwd / TRAIN_STEPS:g} forward + {bwd / TRAIN_STEPS:g} backward")
    return res


def train_launcher() -> dict:
    """Phase 16(d): ``python -m repro_torch.launch.train`` for
    granite-moe-3b-a800m (MoE), graphsage-reddit and sasrec, the three at
    once; then, in this process, each arch trained to step 3 with a
    checkpoint and restarted to step 6 on the card: the GNN (one fixed
    batch) equal to an unbroken 6-step run, and every arch's restart
    equal to the same restart on the CPU from a copy of the directory
    (the trainer restarts its data stream, as JAX's does)."""
    import os
    import shutil
    from repro_torch.launch.train import train
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = {arch: subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", arch,
         "--steps", str(TRAIN_STEPS)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for arch in TRAIN_ARCHS}
    res = {}
    try:
        for arch, proc in procs.items():
            out, _ = proc.communicate(timeout=600)
            if proc.returncode != 0:
                raise AssertionError(f"launch.train --arch {arch} failed:"
                                     f"\n{out}")
            res[arch] = dict(cli=out.strip().splitlines()[-1])
            log(f"phase 16(d): python -m repro_torch.launch.train --arch "
                f"{arch} --steps {TRAIN_STEPS}: {res[arch]['cli']}")
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for arch in TRAIN_ARCHS:
        d = CKPT_ROOT / f"train_{arch}"
        shutil.rmtree(d, ignore_errors=True)
        first = train(arch, 3, ckpt_dir=str(d), ckpt_every=3,
                      log_every=0)["losses"]
        shutil.copytree(d, str(d) + "_cpu")
        t = time.perf_counter()
        rest = train(arch, 6, ckpt_dir=str(d), ckpt_every=3,
                     log_every=0)["losses"]
        restart_s = time.perf_counter() - t
        cpu = train(arch, 6, ckpt_dir=str(d) + "_cpu", ckpt_every=3,
                    log_every=0, device="cpu")["losses"]
        diff = max(abs(a - b) for a, b in zip(rest, cpu))
        if len(rest) != 3 or diff > 1e-4 * max(abs(x) for x in cpu):
            raise AssertionError(f"{arch}: restart on the card {rest} != on "
                                 f"the CPU {cpu}")
        row = dict(first=first, restarted=rest, restarted_cpu=cpu,
                   restart_s=restart_s)
        if arch == "graphsage-reddit":
            full = train(arch, 6, log_every=0)["losses"]
            gap = max(abs(a - b) for a, b in zip(first + rest, full))
            if gap > 1e-5 * max(abs(x) for x in full):
                raise AssertionError(f"{arch}: restarted {first + rest} != "
                                     f"unbroken {full}")
            row["unbroken"] = full
        shutil.rmtree(d)
        shutil.rmtree(str(d) + "_cpu")
        res[arch].update(row)
        log(f"phase 16(d): {arch} restarted at step 3 from its checkpoint: "
            f"losses " + ", ".join(f"{x:.5f}" for x in rest)
            + f" == the CPU's restart (max |diff| {diff:.1e})"
            + (" and == the unbroken run's" if "unbroken" in row else "")
            + f"; restart and 3 steps {restart_s:.2f} s")
    return res


# --------------------------------------------------------------------- #
# LM inference: the flash-attention kernel and the paths that run it
# --------------------------------------------------------------------- #


def attn_inputs(b, h, hkv, t, d, dtype, gen, strided: bool = False,
                dv=None):
    """q, k, v drawn on the card (v ``dv`` wide, default ``d``);
    ``strided`` lays them out as the GQA transformer hands them over:
    ``[B, T, heads, D]`` memory viewed as ``[B, heads, T, D]``."""
    import torch

    def draw(heads, width):
        shape = (b, t, heads, width) if strided else (b, heads, t, width)
        x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        return x.transpose(1, 2) if strided else x
    return draw(h, d), draw(hkv, d), draw(hkv, dv or d)


def attn_flops(q, v, causal: bool) -> int:
    """Useful flops of one attention call: 2 D for q.k and 2 Dv for p.v
    per (query, key) pair it keeps; causal keeps T (T + 1) / 2 pairs per
    head."""
    b, h, tq, d = q.shape
    tk, dv = v.shape[2], v.shape[3]
    pairs = tq * (tq + 1) // 2 if causal else tq * tk
    return 2 * (d + dv) * b * h * pairs


def attn_bound_ms(q, k, v, causal: bool) -> float:
    """Least time for one attention call: the larger of its useful flops
    (:func:`attn_flops`) at the card's peak for the dtype (bf16 tensor
    cores, or float32 outside them) and its bytes (q, k, v read once, o
    written once; v not again when it is a view of k) at the device
    memory rate."""
    import torch
    from repro_torch.kernels.flash_attention import v_shares_k
    b, h, tq, _ = q.shape
    rate = BF16_OPS_PER_S if q.dtype == torch.bfloat16 else FP32_OPS_PER_S
    v_bytes = 0 if v_shares_k(k, v) else v.numel()
    nbytes = q.element_size() * (q.numel() + k.numel() + v_bytes
                                 + b * h * tq * v.shape[3])
    return max(1e3 * attn_flops(q, v, causal) / rate,
               1e3 * nbytes / HBM_BYTES_PER_S)


def mla_library_call(q, k, v):
    """``scaled_dot_product_attention`` on an MLA call (one KV head,
    ``d_v != d_q``, causal) with k and v copied out to q's heads, under
    ``MLA_SDPA_BACKEND`` alone: none of the fused backends takes the GQA
    call at ``d_v != d_q`` on the H100, and a refusal of this one fails
    the phase rather than timing another backend."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    h = q.shape[1]
    ke = k.expand(-1, h, -1, -1).contiguous()
    ve = v.expand(-1, h, -1, -1).contiguous()
    backend = getattr(SDPBackend, MLA_SDPA_BACKEND)

    def call():
        with sdpa_kernel([backend]):
            return F.scaled_dot_product_attention(q, ke, ve, is_causal=True)
    return call


def mla_build_lines(nvcc_out: str) -> list:
    """The ``mla`` kernel's lines of ``nvcc -Xptxas -v``: registers and
    spills of each mode (its two instantiations: ``<true>`` v in k's
    tiles, ``<false>`` v's own), and any warning that names it."""
    lines, mode = [], None
    for line in nvcc_out.splitlines():
        if "flash_attention_mla_kernel" in line and "Compiling" in line:
            mode = "v in k" if "ILb1E" in line else "v its own"
        elif "flash_attention_mla_kernel" in line and "Compiling" not in \
                line and "Function properties" not in line:
            lines.append(line.strip())
        elif mode and ("spill" in line or "registers" in line):
            text = line.strip().replace("ptxas info    : ", "")
            lines.append(f"{mode}: {text}")
            if "registers" in line:
                mode = None
    return lines


def row_rel_err(got, want) -> float:
    """The largest ``||got - want|| / ||want||`` over output rows (the
    last axis)."""
    num = (got - want).norm(dim=-1)
    return float((num / want.norm(dim=-1).clamp_min(1e-30)).max())


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
            row["bound_ms"] = attn_bound_ms(q, k, v, True)
            flops = attn_flops(q, v, True)
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


def mla_attention_vs_plain(gen, nvcc_out: str) -> dict:
    """Phase 17(a): the kernel at MLA's ``d_v != d_q`` against its plain
    version: at the smoke pair (32, 24) in float32 and bf16, at the
    layer's widths (288, 256) and a short T (``MLA_SHORT_SHAPES``) in
    bf16, then at minicpm3-4b's layer (``MLA_LAYER``, causal, contiguous
    as the transformer hands it over) in bf16 (the ``mla`` variant, timed
    beside the call from Python, the plain version, ``mla_library_call``
    and the operation bound) and float32 (SIMT; its launch timed).  Every
    bf16 (288, 256) shape runs in both of the ``mla`` kernel's modes: v a
    view of k's first 256 columns (the transformer's call: the latent read
    once) and v a tensor of its own.  Each is held elementwise and, in
    bf16, row by row (``MLA_BF16_TOL``); the shared mode at the layer must
    beat ``mla_library_call`` in the same run.  ``nvcc_out``: the
    build's output of ``flash_attention.cu`` (empty if it was reused),
    whose ``mla`` lines are logged."""
    import torch
    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     flash_attention_plain,
                                                     kernel_variant)
    build = mla_build_lines(nvcc_out)
    for line in build or ["(the build was reused: no nvcc output)"]:
        log(f"phase 17(a): nvcc, mla kernel: {line}")
    bf16, f32 = (torch.bfloat16, MLA_BF16_TOL), (torch.float32, MLA_F32_TOL)
    cases = [(*dt, *shape[:4], 32, 24, shape[4]) for dt in (f32, bf16)
             for shape in MLA_SMOKE_SHAPES]
    cases += [(*bf16, *shape[:4], *MLA_LAYER[4:], shape[4])
              for shape in MLA_SHORT_SHAPES]
    cases += [(*bf16, *MLA_LAYER, True), (*f32, *MLA_LAYER, True)]
    rows, max_err, layer = [], 0.0, {}
    for dtype, (rtol, atol, row_tol), b, h, hkv, t, d, dv, causal in cases:
        q, k, v_own = attn_inputs(b, h, hkv, t, d, dtype, gen, dv=dv)
        variant = kernel_variant(dtype, d, dv)
        modes = (("v in k", k[..., :dv]), ("v its own", v_own)) \
            if variant == "mla" else (("v its own", v_own),)
        for mode, v in modes:
            got = flash_attention_cuda(q, k, v, causal=causal).float()
            want = flash_attention_plain(q, k, v, causal=causal).float()
            torch.cuda.synchronize()
            what = (f"flash_attention {dtype} {(b, h, hkv, t, d, dv, causal)}"
                    f" {mode}")
            err = close(got, want, "sum", rtol, atol, what)
            row_err = row_rel_err(got, want)
            if row_tol is not None and not row_err <= row_tol:
                raise AssertionError(f"{what}: a row's relative error "
                                     f"{row_err:.3e} exceeds {row_tol}")
            # where an elementwise rtol 2e-2, atol 2e-3 would not hold
            tight = (got - want).abs() > 2e-3 + 2e-2 * want.abs()
            rows_at = tight.any(dim=-1).nonzero()[:, -1]
            max_err = max(max_err, err)
            row = dict(dtype=str(dtype), b=b, h=h, hkv=hkv, t=t, d=d, dv=dv,
                       causal=causal, variant=variant, mode=mode, rtol=rtol,
                       atol=atol, row_tol=row_tol, max_abs_err=err,
                       max_row_rel_err=row_err,
                       max_abs_want=float(want.abs().max()),
                       beyond_2e_2_2e_3=int(tight.sum()),
                       rows_beyond=sorted(set(rows_at.tolist())))
            rows.append(row)
            log(f"phase 17(a): flash_attention {variant:4s} "
                f"{str(dtype)[6:]:8s} B={b} H={h} Hkv={hkv} T={t} (D, Dv)="
                f"({d}, {dv}) causal={causal} {mode}: kernel == plain (max "
                f"|err| {err:.2e}, rtol {rtol} atol {atol}; largest row "
                f"error {row_err:.2e} of the row, tol {row_tol}; max |out| "
                f"{row['max_abs_want']:.2f}; {row['beyond_2e_2_2e_3']} "
                f"entries beyond rtol 2e-2 atol 2e-3, in query rows "
                f"{row['rows_beyond'][:8]})")
            del got, want
            if (b, h, hkv, t, d, dv) != MLA_LAYER:
                continue

            def launch():
                return flash_attention_cuda(q, k, v, causal=True)
            if dtype == torch.float32:
                row["call_ms"] = cuda_ms(launch, 2)
                log(f"phase 17(a): at minicpm3-4b's layer shape, float32 "
                    f"({variant}): call {row['call_ms']:.3f} ms")
                continue
            row["ms"] = graph_ms(launch, 3, 3)
            row["call_ms"] = cuda_ms(launch, 5)
            row["plain_ms"] = cuda_ms(
                lambda: flash_attention_plain(q, k, v, causal=True), 2)
            row["library_ms"] = cuda_ms(mla_library_call(q, k, v), 5)
            row["library_call"] = (f"k, v expanded to {h} heads, "
                                   f"{MLA_SDPA_BACKEND}")
            row["bound_ms"] = attn_bound_ms(q, k, v, True)
            flops = attn_flops(q, v, True)
            row["tflops"] = flops / row["ms"] / 1e9
            row["kernel_over_library"] = row["ms"] / row["library_ms"]
            row["kernel_over_bound"] = row["ms"] / row["bound_ms"]
            layer[mode] = row
            log(f"phase 17(a): flash_attention at minicpm3-4b's layer "
                f"shape, bf16 ({variant}, {mode}): kernel {row['ms']:.3f} "
                f"ms ({row['tflops']:.1f} TFLOP/s, "
                f"{row['kernel_over_bound']:.2f}x the bound; call "
                f"{row['call_ms']:.3f} ms), plain {row['plain_ms']:.3f} ms,"
                f" scaled_dot_product_attention ({row['library_call']}) "
                f"{row['library_ms']:.3f} ms (kernel / SDPA "
                f"{row['kernel_over_library']:.2f}), bound "
                f"{row['bound_ms']:.3f} ms (operations, {flops / 1e9:.1f} "
                f"GFLOP at the bf16 peak)")
        del q, k, v_own, v
    torch.cuda.empty_cache()
    shared = layer["v in k"]
    if not shared["ms"] < shared["library_ms"]:
        raise AssertionError(f"the mla kernel with v in k's tiles takes "
                             f"{shared['ms']:.3f} ms at minicpm3-4b's layer,"
                             f" not below scaled_dot_product_attention's "
                             f"{shared['library_ms']:.3f} ms")
    return dict(rows=rows, max_abs_err=max_err, layer=shared,
                separate=layer["v its own"], build=build)


def mla_serving(seed: int, gen, nvcc_out: str) -> dict:
    """Phase 17: (a) the kernel at ``d_v != d_q`` vs plain, timed at
    minicpm3-4b's layer; (b) its full widths, 2 layers, card vs CPU; (c)
    one full-config prefill request (counts set to 0 inside, just before
    it); (d) the serve loop at full config, and a profiled decode step;
    (e) its smoke config card vs CPU.  ``nvcc_out``: the build's output
    of ``flash_attention.cu``, whose ``mla`` lines (a) logs."""
    import torch
    from repro_torch.configs import minicpm3_4b
    t = time.perf_counter()
    out = dict(attention=mla_attention_vs_plain(gen, nvcc_out))
    out["card_vs_cpu"] = lm_card_vs_cpu(seed, minicpm3_4b, "phase 17(b)")
    torch.cuda.empty_cache()
    out["prefill"] = lm_prefill_request(seed, minicpm3_4b, "mla",
                                        "phase 17(c)")
    pre, kernel_ms = out["prefill"], out["attention"]["layer"]["ms"]
    attn_ms = pre["breakdown"]["device_us"]["attention kernel"] / 1e3
    pre["attention_over_launches_x_kernel"] = attn_ms / (
        pre["launches"] * kernel_ms)
    log(f"phase 17(c): the prefill's profiled attention {attn_ms:.1f} ms "
        f"against {pre['launches']} launches x the kernel's {kernel_ms:.3f}"
        f" ms at the layer (v in k) = {pre['launches'] * kernel_ms:.1f} ms:"
        f" ratio {pre['attention_over_launches_x_kernel']:.3f}")
    out["serve"] = lm_serve(seed, out["prefill"]["params"], minicpm3_4b,
                            "phase 17(d)")
    out["serve"]["profile"] = lm_decode_profile(
        seed, out["serve"]["ms_per_token"], minicpm3_4b, "phase 17(d)")
    out["smoke"] = lm_smoke_archs(seed, (minicpm3_4b,), "phase 17(e)")
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t
    log(f"phase 17: {out['seconds']:.1f} s")
    return out


def lm_card_vs_cpu(seed: int, mod=None, tag: str = "lm (a)") -> dict:
    """Phase 10(a): internlm2-20b's full widths (or ``mod``'s: phase
    17(b), minicpm3-4b), 2 layers, float32."""
    import dataclasses
    import torch
    from repro_torch.configs import internlm2_20b
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as tfm
    mod = mod or internlm2_20b
    cfg = dataclasses.replace(mod.full_config(), n_layers=2,
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
    log(f"{tag}: {mod.ARCH_ID} widths, 2 layers, f32, B=1 T=512: logits on "
        f"the card == the CPU's (max |err| {err:.2e}, rtol=atol=1e-3; CPU "
        f"forward {cpu_s:.1f} s; {launches} kernel launches); 512 "
        f"teacher-forced decode steps == forward (max |err| {dec_err:.2e} "
        f"< 2e-3; {1e3 * dec_s / 512:.2f} ms/step)")
    return dict(max_abs_err=err, decode_max_abs_err=dec_err,
                launches=launches, cpu_forward_s=cpu_s,
                decode_ms_per_step=1e3 * dec_s / 512)


def lm_prefill_request(seed: int, mod=None, variant: str = "wgmma",
                       tag: str = "lm (b)") -> dict:
    """Phase 10(b): one prefill request at internlm2-20b's full config (or
    ``mod``'s: phase 17(c), minicpm3-4b), every attention launch of the
    kernel ``variant``."""
    import torch
    from repro_torch.configs import internlm2_20b
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as tfm
    from repro_torch.models.common import param_count
    mod = mod or internlm2_20b
    cfg = mod.full_config()
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
    log(f"{tag}: {mod.ARCH_ID} full_config: {n_params / 1e9:.3f} B "
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
    if launches != cfg.n_layers or by_variant != {variant: cfg.n_layers}:
        raise AssertionError(f"the prefill forward launched the attention "
                             f"kernel {launches} times ({by_variant}), not "
                             f"{cfg.n_layers} of the {variant} variant")
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
    if not names or not all(f"flash_attention_{variant}_kernel" in n
                            for n in names):
        raise AssertionError(f"profiled attention kernels: {names}")
    # projections (MLA's absorbed k_b and v_b too), FFN and head: 2 flops
    # per matrix weight per token
    mm_flops = 2 * b * t * (params["lm_head"].numel() + sum(
        w.numel() for w in params["layers"].values() if w.dim() >= 3))
    if cfg.attn == "mla":   # one KV head over [c_kv, k_rope], v = c_kv
        d_qk, d_v = cfg.kv_lora + cfg.rope_dim, cfg.kv_lora
    else:
        d_qk = d_v = cfg.d_head
    attn_flops = cfg.n_layers * 2 * (d_qk + d_v) * b * cfg.n_heads * (
        t * (t + 1) // 2)
    us = breakdown["device_us"]
    res = dict(batch=b, seq=t, params=n_params, param_bytes=param_bytes,
               init_s=init_s, cold_ms=cold_ms, warm_ms=warm_ms,
               warm_runs_ms=warm, launches=launches, by_variant=by_variant,
               peak_bytes=peak, matmul_flops=mm_flops,
               attention_flops=attn_flops, breakdown=breakdown,
               tokens_per_s=b * t / (warm_ms / 1e3))
    log(f"{tag}: prefill forward cold {cold_ms:.1f} ms, warm "
        f"{warm_ms:.1f} ms ({res['tokens_per_s']:.0f} tokens/s); "
        f"{launches} attention-kernel launches per forward "
        f"({by_variant}); peak device "
        f"memory {peak / 1e9:.2f} GB")
    log(f"{tag}: forward device time (torch.profiler): " + ", ".join(
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


def lm_serve(seed: int, n_params: int, mod=None,
             tag: str = "lm (c)") -> dict:
    """Phase 10(c): the serve loop at internlm2-20b's full config (or
    ``mod``'s: phase 17(d), minicpm3-4b; ``n_params``: its parameter
    count, for the weight-read bound)."""
    import torch
    from repro_torch.configs import internlm2_20b
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import serve
    mod = mod or internlm2_20b
    cfg = mod.full_config()
    batch, prompt_len, n_tok = SERVE
    ops.reset_counts()
    t0 = time.perf_counter()
    out = serve(mod.ARCH_ID, batch, prompt_len, n_tok, seed,
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
    log(f"{tag}: serve({mod.ARCH_ID}, full=True) batch {batch}, prompt "
        f"{prompt_len}, {n_tok} tokens: {out['ms_per_token']:.2f} ms/token "
        f"decode (weight-read bound {bound_ms:.2f} ms), teacher-forced "
        f"prefill {1e3 * out['prefill_s'] / prompt_len:.2f} ms/token; "
        f"{total_s:.1f} s with the weights drawn; attention-kernel launches "
        f"{ops.attention.launches} (decode takes kernels/ref.py)")
    torch.cuda.empty_cache()
    return res


def lm_decode_profile(seed: int, ms_per_token: float, mod=None,
                      tag: str = "lm (c)") -> dict:
    """Where a full-config decode step's time goes (internlm2-20b's, or
    ``mod``'s): ``torch.profiler`` over the serve loop (batch 4, 4 prompt
    tokens teacher-forced, 4 generated: 8 steps) on weights drawn anew.
    The device busy share is the profiled device time per step over the
    unprofiled ms per token of phase 10(c) or 17(d) (the profiler slows
    the host)."""
    import torch
    from repro_torch.configs import internlm2_20b
    from repro_torch.launch.serve import generate
    from repro_torch.models import transformer as tfm
    mod = mod or internlm2_20b
    cfg = mod.full_config()
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
    log(f"{tag}: decode step under torch.profiler: device "
        f"{res['device_ms_per_step']:.2f} ms/step, {kernels / steps:.0f} "
        f"device kernels/step; device busy "
        f"{100 * res['device_busy_share']:.1f}% of the unprofiled "
        f"{ms_per_token:.2f} ms/token (profiled wall "
        f"{res['profiled_wall_ms_per_step']:.2f} ms/step)")
    del params
    torch.cuda.empty_cache()
    return res


def lm_smoke_archs(seed: int, mods=None, tag: str = "lm (d)") -> dict:
    """Phase 10(d): the four GQA smoke configs (or ``mods``: phase 17(e),
    minicpm3-4b's), card vs CPU, T = 256."""
    import torch
    from repro_torch.configs import (granite_moe_3b_a800m, internlm2_20b,
                                     llama3_405b, moonshot_v1_16b_a3b)
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as tfm
    out = {}
    for mod in mods or (internlm2_20b, llama3_405b, granite_moe_3b_a800m,
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
        log(f"{tag}: {cfg.name} (D={cfg.d_head}) forward on the card == "
            f"the CPU's at B=2 T=256 (max |err| {err:.2e}; {launches} kernel"
            f" launches)")
    return out


# --------------------------------------------------------------------- #


# --------------------------------------------------------------------- #
# phase 15: ht_rebuild on the card
# --------------------------------------------------------------------- #


def set_built_table(cap: int, load: float, prehashed: bool, rng):
    """A small table as ``ht_set`` and deletes make it, built on the CPU
    and moved to the card: ``load`` of the slots live, a tenth (fewer when
    nearly full) tombstoned after the upserts; four keys homed in the
    last two slots go in first, so that their chain wraps past slot 0, in
    the old table and the rebuilt one."""
    import torch
    from repro_torch.core.engine.hashtable import (TOMB, _probe_start,
                                                   ht_new, ht_set)
    n_live = max(1, int(cap * load))
    n_tomb = min(cap // 10, cap - n_live)
    hi = (1 << 31) - 1 if prehashed else 1 << 20
    keys = []
    while len(keys) < n_live + n_tomb:
        k = (rng.randrange(hi), rng.randrange(hi))
        home = int(_probe_start(torch.tensor([k[0]]), torch.tensor([k[1]]),
                                cap, prehashed))
        if k not in keys and (len(keys) >= min(4, n_live)
                              or home >= cap - 2):
            keys.append(k)
    ht = ht_new(cap, "cpu")
    for a, b in keys:
        ht_set(ht, torch.tensor([a], dtype=torch.int32),
               torch.tensor([b], dtype=torch.int32),
               rng.randrange(-2 ** 31, 2 ** 31), prehashed=prehashed)
    for a, b in rng.sample(keys[min(4, n_live):], n_tomb):
        slot = (ht.k1 == a) & (ht.k2 == b)        # as ht_delete writes it
        ht.k1[slot], ht.k2[slot], ht.val[slot] = TOMB, TOMB, 0
    return ht.k1.cuda(), ht.k2.cuda(), ht.val.cuda()


def wrapped(table, prehashed: bool) -> bool:
    """Whether some key of a table sits before its home slot."""
    import torch
    from repro_torch.core.engine.hashtable import _probe_start
    k1, k2, _ = table
    idx = torch.nonzero(k1 >= 0).flatten()
    home = _probe_start(k1[idx], k2[idx], k1.shape[0], prehashed)
    return bool((idx < home).any())


def rebuild_vs_plain(table, prehashed: bool, what: str):
    """The kernel's table (``ht_rebuild_cuda``) against the sequential
    fold on a host copy, bitwise; returns it, the fold's seconds and the
    largest |kernel - fold| over k1, k2 and val (0)."""
    import torch
    from repro_torch.kernels import ht_rebuild as hr
    got = hr.ht_rebuild_cuda(*table, prehashed=prehashed)
    cpu = [t.cpu() for t in table]
    t = time.perf_counter()
    want = hr.ht_rebuild_plain(*cpu, prehashed=prehashed)
    plain_s = time.perf_counter() - t
    err = max(int((g.cpu().long() - w.long()).abs().max())
              for g, w in zip(got, want))
    if err:
        raise AssertionError(f"ht_rebuild differs from the plain fold by up "
                             f"to {err}: {what}")
    return got, plain_s, err


def rebuild_bound_ms(k1) -> float:
    """The least bytes a rebuild of this table moves, over the card's
    memory rate: k1 read whole (4 B a slot), k2 and val read by the 32 B
    sectors (8 slots) that hold a live key, k1, k2 and val written whole
    (12 B a slot).  About 24 B a slot at 70% load, 16 at a near-empty
    table."""
    cap = k1.shape[0]
    sectors = int((k1 >= 0).view(-1, 8).any(1).sum())
    return (16 * cap + 2 * 32 * sectors) / HBM_BYTES_PER_S * 1e3


def longest_old_run(k1) -> int:
    """The longest run of non-EMPTY slots of a table (one kernel thread
    replays each), a run wrapping past slot 0 counted whole."""
    import torch
    from repro_torch.core.engine.hashtable import EMPTY
    filled = k1 != EMPTY
    if bool(filled.all()):
        return k1.shape[0]
    first = int(torch.nonzero(~filled)[0])
    filled = torch.roll(filled, -(first + 1))      # ends at an EMPTY slot
    run = torch.cumsum((~filled).to(torch.int64), 0)[filled]
    return int(torch.bincount(run).max()) if run.numel() else 0


def time_rebuild(table, prehashed: bool, reps: int = 5) -> dict:
    """The kernel alone (CUDA events around one launch into a table
    allocated before, best of ``reps``), the whole call (allocation,
    launch and the status read; CUDA events and the host clock, best of
    3), the longest run of the old table, and the byte bound, which is
    held against the whole call."""
    import torch
    from repro_torch.kernels import ht_rebuild as hr
    k1 = table[0]
    out = tuple(torch.empty_like(t) for t in table)
    status = torch.zeros(1, dtype=torch.int32, device=k1.device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    kernel = []
    for _ in range(reps):
        start.record()
        hr.launch_cuda(*table, out, status, prehashed=prehashed)
        end.record()
        torch.cuda.synchronize()
        kernel.append(start.elapsed_time(end))
    if int(status.item()):
        raise AssertionError("ht_rebuild: the kernel found a broken chain")
    device, host = [], []
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        start.record()
        hr.ht_rebuild_cuda(*table, prehashed=prehashed)
        end.record()
        torch.cuda.synchronize()
        host.append(1e3 * (time.perf_counter() - t))
        device.append(start.elapsed_time(end))
    return dict(cap=k1.shape[0], live=int((k1 >= 0).sum()),
                longest_run=longest_old_run(k1), kernel_ms=min(kernel),
                ms=min(device), call_ms=min(host),
                bound_ms=rebuild_bound_ms(k1))


def check_rebuilt(old, new, prehashed: bool, what: str) -> None:
    """The rebuilt table of ``old`` without the plain fold: every old live
    key found (probe kernel) with its old value, the live count kept, no
    tombstone, and every key at or after its home inside its run (no
    EMPTY slot between its home and its slot)."""
    import torch
    from repro_torch.core.engine.hashtable import EMPTY, TOMB, _probe_start
    from repro_torch.kernels.ht_probe import ht_probe_cuda
    k1, k2, val = new
    cap = k1.shape[0]
    idx = torch.nonzero(old[0] >= 0).flatten()
    _, found, got = ht_probe_cuda(k1, k2, val, old[0][idx], old[1][idx],
                                  prehashed=prehashed, mode="find")
    if not bool(found.all()) or not torch.equal(got, old[2][idx]):
        raise AssertionError(f"ht_rebuild {what}: an old key is lost or "
                             f"its value changed")
    filled = k1 != EMPTY
    if int((k1 >= 0).sum()) != idx.numel() or bool((k1 == TOMB).any()):
        raise AssertionError(f"ht_rebuild {what}: live count changed or a "
                             f"tombstone is left")
    pos = torch.arange(cap, device=k1.device)
    last_empty = torch.cummax(torch.where(filled, -1, pos), 0).values
    last_empty = torch.where(last_empty < 0, last_empty[-1] - cap,
                             last_empty)
    depth = pos - last_empty - 1       # filled slots before each in its run
    slots = torch.nonzero(filled).flatten()
    home = _probe_start(k1[slots], k2[slots], cap, prehashed)
    if not bool((((slots - home) & (cap - 1)) <= depth[slots]).all()):
        raise AssertionError(f"ht_rebuild {what}: a key sits outside the "
                             f"run of its home")


def rebuild_kernel_vs_plain(seed: int) -> dict:
    """Phase 15(a): the kernel bitwise against the fold on tables of caps
    8/16/32 made by ``ht_set`` with wrapped runs (and full), 2^16 and 2^20
    at 53% and 70% plain and prehashed, and 2^22 at 70%, whose fold is
    timed; a 2^20-slot prehashed table at 60% whose keys home into narrow
    windows (runs over 32 slots, across the kernel's tile ends, past a
    tile's halo, one wrapping past the last slot), timed; full tables
    (no EMPTY slot) of one tile and of several; a table with a key behind
    an EMPTY slot of its chain raises."""
    import random

    import numpy as np
    import torch
    from repro_torch.core.engine.hashtable import _probe_start, ht_new
    from repro_torch.kernels import ht_rebuild as hr
    from repro_torch.testing import tables
    rng = random.Random(seed)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    n = err = 0
    for cap in REBUILD_TINY_CAPS:
        for pre in (False, True):
            for load in (0.5, 0.7, 0.9, 1.0):
                table = set_built_table(cap, load, pre, rng)
                got, _, e = rebuild_vs_plain(table, pre, f"cap={cap} "
                                             f"load={load} prehashed={pre}")
                err = max(err, e)
                if load < 1.0 and not wrapped(got, pre):
                    raise AssertionError(f"cap={cap}: no run wrapped")
                n += 1
    plain_s = {}
    for cap in REBUILD_CAPS:
        for load in ("53%", "70%"):
            for pre in (False, True):
                table, _ = bulk_table(cap, *rebuild_counts(cap, load), pre,
                                      gen)
                _, s, e = rebuild_vs_plain(table, pre, f"cap={cap} "
                                           f"load={load} prehashed={pre}")
                err = max(err, e)
                plain_s[f"{cap}:{load}:{pre}"] = s
                n += 1
    table, _ = bulk_table(REBUILD_BIG, *rebuild_counts(REBUILD_BIG, "70%"),
                          False, gen)
    _, big_s, e = rebuild_vs_plain(table, False, "cap=2^22 load=70%")
    err = max(err, e)
    # keys homed into narrow windows (repro_torch.testing.tables): runs
    # over 32 slots, across tile ends, past a tile's halo, wrapping
    nrng = np.random.default_rng(seed + 15)
    cap = REBUILD_CAPS[-1]
    hard = tables.clustered_table(
        cap, 0.6, tables.rebuild_clusters(cap, hr.TILE, hr.HALO, nrng), nrng)
    runs = tables.describe_runs(hard[0], hr.TILE, hr.HALO)
    if not all(runs[k] for k in ("over_32", "cross_tile", "past_halo",
                                 "wraps")):
        raise AssertionError(f"phase 15(a): the clustered table lacks a "
                             f"hard run: {runs}")
    hard = tuple(torch.from_numpy(a).cuda() for a in hard)
    _, hard_s, hard_e = rebuild_vs_plain(hard, True, "clustered 2^20")
    n += 1
    err = max(err, hard_e)
    for full_cap in (32, 8192):                 # one tile, several tiles
        keys = tables.crafted_keys(nrng.integers(0, full_cap, full_cap))
        fk1, fk2, _ = tables.round_build(full_cap, *keys, tables.homes(
            *keys, full_cap, True))
        fval = nrng.integers(-2 ** 31, 2 ** 31, full_cap).astype(np.int32)
        tables.tombstone(fk1, fk2, fval, 2, nrng)
        _, _, e = rebuild_vs_plain(
            tuple(torch.from_numpy(a).cuda() for a in (fk1, fk2, fval)),
            True, f"full cap={full_cap}")
        err = max(err, e)
        n += 1
    hard_time = time_rebuild(hard, True)
    broken = ht_new(64, "cuda")
    home = int(_probe_start(torch.tensor([7]), torch.tensor([9]), 64, False))
    broken.k1[(home + 2) % 64], broken.k2[(home + 2) % 64] = 7, 9
    try:
        hr.ht_rebuild_cuda(broken.k1, broken.k2, broken.val)
    except ValueError:
        pass
    else:
        raise AssertionError("ht_rebuild took a key behind an EMPTY slot")
    res = dict(tables=n + 1, plain_s=plain_s, plain_s_2p22=big_s,
               max_abs_err=err, big=time_rebuild(table, False),
               clustered=dict(hard_time, runs=runs, plain_s=hard_s))
    b = res["big"]
    log(f"phase 15(a): ht_rebuild kernel == plain fold bitwise on {n + 1} "
        f"tables (caps {list(REBUILD_TINY_CAPS)} built by ht_set with "
        f"wrapped runs and full, {[c.bit_length() - 1 for c in REBUILD_CAPS]}"
        f" (2^k) at 53%/70% plain and prehashed, 2^22 at 70%, a clustered "
        f"2^20 table, full tables of 32 and 8,192 slots); a broken chain "
        f"raises; the host fold at 2^22, 70%: {big_s:.2f} s against the "
        f"kernel call's {b['call_ms']:.3f} ms")
    log(f"phase 15(a): the clustered 2^20 table ({runs['runs']} runs, "
        f"{runs['over_32']} over 32 slots, {runs['cross_tile']} across a "
        f"tile end of {hr.TILE}, {runs['past_halo']} past the halo of "
        f"{hr.HALO}, the longest {runs['longest']} slots, "
        f"{runs['wraps']} wrapping): kernel {hard_time['kernel_ms']:.3f} "
        f"ms, call {hard_time['ms']:.3f} ms, bound "
        f"{hard_time['bound_ms']:.3f} ms")
    return res


def rebuild_counts(cap: int, load: str):
    """(keys, tombstones) of a table at 53% (50% live + 1/32 tombstones)
    or 70% (60% live + 10%), the shares of phase 2."""
    live, tomb = {"53%": (cap // 2, cap // 32),
                  "70%": (cap * 6 // 10, cap // 10)}[load]
    return live + tomb, tomb


def rebuild_full_size(big_tables, gen) -> list:
    """Phase 15(b): the kernel alone on 2^25-slot tables at 70% (phase 2's,
    plain and prehashed) and a 2^24-slot one: invariants, device times
    beside the byte bound, the longest run, the call from Python."""
    from repro_torch.kernels import ht_rebuild as hr
    tables = dict(big_tables)
    t = time.perf_counter()
    tables["2^24", False], _ = bulk_table(
        CAP_SMALL, *rebuild_counts(CAP_SMALL, "70%"), False, gen)
    build_s = time.perf_counter() - t
    rows = []
    for (name, pre), table in tables.items():
        new = hr.ht_rebuild_cuda(*table, prehashed=pre)
        what = f"{name} load 70% prehashed={pre}"
        check_rebuilt(table, new, pre, what)
        row = dict(table=name, prehashed=pre, **time_rebuild(table, pre))
        rows.append(row)
        log(f"phase 15(b): ht_rebuild {what}: every old key found with its "
            f"value, live {row['live']}, no tombstone, every key inside the "
            f"run of its home; kernel {row['kernel_ms']:.3f} ms, call "
            f"{row['ms']:.3f} ms on the device ({row['call_ms']:.3f} ms "
            f"from Python), bound {row['bound_ms']:.3f} ms (bytes, against "
            f"the call); the old table's longest run {row['longest_run']} "
            f"slots")
    log(f"phase 15(b): the 2^24-slot table built in {build_s:.1f} s")
    return rows


def compact_live_summarizer(bs, truth, seed: int) -> dict:
    """Phase 15(d): ``maybe_compact(threshold=0.0)`` on phase 3's live
    ``full_config()`` summarizer (counts set to 0 just before, read just
    after), then phi, the decode and the reads against the live edge set,
    and 256 more changes still lossless.  The kernel against the fold at
    this path's ``adj`` table, timed."""
    import random
    import torch
    from repro_torch.core.summary import pair_key
    from repro_torch.kernels import ops
    adj = tuple(t.clone() for t in (bs.state.adj.k1, bs.state.adj.k2,
                                    bs.state.adj.val))
    pressure = bs.table_pressure()
    dirty = [name for name, p in pressure.items() if p > 0.0]
    ops.reset_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    if not bs.maybe_compact(threshold=0.0):
        raise AssertionError("maybe_compact(threshold=0.0) rebuilt nothing")
    torch.cuda.synchronize()
    compact_s = time.perf_counter() - t
    launches = ops.ht_rebuild.launches
    if launches != len(dirty):
        raise AssertionError(f"maybe_compact launched the rebuild kernel "
                             f"{launches} times for {len(dirty)} tables")
    for name in pressure:
        if getattr(bs.state, name).k1.device.type != "cuda":
            raise AssertionError(f"table {name} left the card")

    def lossless(live, what):
        if bs.phi != bs.phi_recomputed():
            raise AssertionError(f"{what}: phi != phi_recomputed")
        want = {pair_key(bs._ids[u], bs._ids[v]) for (u, v) in live}
        if bs.materialize().decode_edges() != want:
            raise AssertionError(f"{what}: the decode differs from the "
                                 f"live edge set")

    lossless(truth, "after maybe_compact")
    read_res = reads(bs, truth, 256, seed)
    rng = random.Random(seed + 15)
    nodes = sorted({u for e in truth for u in e})
    changes = [(u, v, False) for (u, v) in rng.sample(sorted(truth), 128)]
    new = set()
    while len(new) < 128:
        u, v = rng.sample(nodes, 2)
        e = (min(u, v), max(u, v))
        if e not in truth:
            new.add(e)
    changes += [(u, v, True) for (u, v) in sorted(new)]
    rng.shuffle(changes)
    live = set(truth)
    t = time.perf_counter()
    for off in range(0, len(changes), bs.cfg.batch):
        bs.process(changes[off:off + bs.cfg.batch])
    torch.cuda.synchronize()
    more_s = time.perf_counter() - t
    for (u, v, ins) in changes:
        (live.add if ins else live.discard)((u, v))
    lossless(live, "256 changes after maybe_compact")
    _, plain_s, err = rebuild_vs_plain(adj, False, "phase 3's adj table")
    timing = time_rebuild(adj, False)
    res = dict(compact_s=compact_s, launches=launches, pressure=pressure,
               reads=read_res, more_changes=len(changes),
               more_us_per_change=1e6 * more_s / len(changes),
               adj=dict(timing, plain_ms=1e3 * plain_s, max_abs_err=err))
    log(f"phase 15(d): maybe_compact(threshold=0.0) on phase 3's live "
        f"full_config summarizer: {launches} rebuild launches, "
        f"{compact_s:.3f} s; phi == phi_recomputed, lossless, reads right; "
        f"256 more changes ({res['more_us_per_change']:.1f} us/change) "
        f"lossless; its adj table (2^25 slots, {timing['live']} live): "
        f"kernel {timing['kernel_ms']:.3f} ms, call {timing['ms']:.3f} ms "
        f"({timing['call_ms']:.3f} from Python), plain fold "
        f"{1e3 * plain_s:.1f} ms, bound {timing['bound_ms']:.3f} ms")
    return res


_FULL_DRYRUN = r"""
import json, sys
from repro_torch.launch import dryrun
print("RESULT " + json.dumps([dryrun.run_cell(a, "train_4k", verbose=False)
                             for a in sys.argv[1:]]))
"""


def _batch(changes, cfg, ids: dict):
    """``changes`` as one padded batch of engine ids, interned in
    encounter order into ``ids`` as ``BatchedSummarizer`` interns."""
    import numpy as np
    pad = cfg.batch - len(changes)
    u = [ids.setdefault(x, len(ids)) for (x, _, _) in changes]
    v = [ids.setdefault(y, len(ids)) for (_, y, _) in changes]
    return (np.array(u + [-1] * pad, np.int32),
            np.array(v + [-1] * pad, np.int32),
            np.array([i for (_, _, i) in changes] + [False] * pad))


def dense_step_forms(stream, first=None) -> dict:
    """Phase 21: the dense step (``trial.step_fn(..., dense=True)``, JAX's
    masked data flow) beside the branching step on the card at
    ``full_config()``: from the state after the first batch of phase 3's
    stream (256 changes; ``first``, phase 3's host copy of its state and
    label ids, or else a fresh state stepped over that batch by the
    branching step), each form steps a copy of that state over the next
    ``DENSE_CHANGES`` changes as one batch (padded to ``batch``): every
    state leaf equal on the card after the step, or the phase fails.  Per
    form: host reads a step, probe launches and jobs a change, us a change
    (the step and a device sync), the live trials, accepted moves and
    skips of the step.  The
    counts are set to 0 just before each form and read just after; the
    dense form must launch the probe kernel."""
    import torch
    from repro_torch.configs.mosso_stream import full_config
    from repro_torch.core.engine.ops import host_read, reset_host_reads
    from repro_torch.core.engine.state import copy_state, new_state
    from repro_torch.core.engine.trial import step_fn
    from repro_torch.kernels import ops

    t0 = time.perf_counter()
    cfg = full_config()
    b, n = cfg.batch, DENSE_CHANGES
    if first is None:
        ids = {}
        st0 = new_state(cfg, "cuda")
        step_fn(st0, *_batch(stream[:b], cfg, ids), cfg)
    else:
        st0, ids = copy_state(first[0], "cuda"), dict(first[1])
    u, v, ins = _batch(stream[b:b + n], cfg, ids)
    log(f"phase 21: the dense step and the branching step at full_config "
        f"(d_cap={cfg.d_cap}, c={cfg.c}, batch={b}) over changes {b}-"
        f"{b + n - 1} of phase 3's stream as one batch, each from the "
        f"state after its first {b} ("
        + ("phase 3's" if first is not None else "stepped by the branching "
           "step") + ")")
    counters = ("n_trials", "n_accept", "n_skipped")
    before = {k: int(getattr(st0, k)) for k in counters}
    states, res = {}, dict(changes=n, start=b)
    for form, dense in (("branching", False), ("dense", True)):
        st = copy_state(st0)
        torch.cuda.synchronize()
        ops.reset_counts()
        reset_host_reads()
        t = time.perf_counter()
        step_fn(st, u, v, ins, cfg, dense=dense)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t
        launches, jobs, reads = (ops.ht_probe.launches, ops.ht_probe.jobs,
                                 host_read.count)
        if launches == 0:
            raise AssertionError(f"phase 21 {form}: no probe launch")
        states[form] = st
        step = {k: int(getattr(st, k)) - before[k] for k in counters}
        res[form] = dict(seconds=seconds, us_per_change=1e6 * seconds / n,
                         host_reads=reads, probe_launches=launches,
                         launches_per_change=launches / n,
                         jobs_per_change=jobs / n, trials=step["n_trials"],
                         accepted=step["n_accept"],
                         skipped=step["n_skipped"])
    for (k, a), (_, c) in zip(_leaf_items(states["dense"]),
                              _leaf_items(states["branching"])):
        if a.dtype != c.dtype or not torch.equal(a, c):
            raise AssertionError(f"phase 21: dense vs branching leaf {k} "
                                 f"differs")
    d, br = res["dense"], res["branching"]
    res["dense_over_branching_us"] = d["us_per_change"] / br["us_per_change"]
    res["seconds"] = time.perf_counter() - t0
    for form in ("branching", "dense"):
        r = res[form]
        log(f"phase 21 {form}: {r['us_per_change']:.1f} us/change, "
            f"{r['host_reads']} host reads a step, probe launches "
            f"{r['launches_per_change']:.2f}/change serving "
            f"{r['jobs_per_change']:.2f} jobs/change; {r['trials']} live "
            f"trials, {r['accepted']} accepted, {r['skipped']} skipped")
    log(f"phase 21: dense == branching, every state leaf on the card; "
        f"dense / branching us per change "
        f"{res['dense_over_branching_us']:.2f}; {res['seconds']:.1f} s")
    del states, st0
    torch.cuda.empty_cache()
    return res


def dense_one_trip(stream) -> dict:
    """Phase 18(a)'s measurement of the mosso cell: one dense step at
    ``full_config()`` on a fresh state on the card, at the dry-run's trip
    setting (``trial.ONE_TRIP``: its first change, one trial, one
    neighbour slot) over the first batch of phase 3's stream: the peak of
    ``max_memory_allocated()`` above what the card held before the state
    (the state, the batch and the step's temporaries; the dry-run's peak
    at 1 rank), the step's ms, and ``FlopCounterMode``'s FLOPs over the
    same step from another fresh state."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.configs.mosso_stream import full_config
    from repro_torch.core.engine.state import new_state
    from repro_torch.core.engine.trial import ONE_TRIP, step_fn

    cfg = full_config()
    u, v, ins = _batch(stream[:cfg.batch], cfg, {})
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    st = new_state(cfg, "cuda")
    tu, tv, tins = (torch.from_numpy(x).to("cuda") for x in (u, v, ins))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    step_fn(st, tu, tv, tins, cfg, dense=True, trips=ONE_TRIP)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t)
    peak = torch.cuda.max_memory_allocated() - base
    st = new_state(cfg, "cuda")
    with FlopCounterMode(display=False) as fc:
        step_fn(st, tu, tv, tins, cfg, dense=True, trips=ONE_TRIP)
    del st, tu, tv, tins
    torch.cuda.empty_cache()
    return dict(peak_gb=peak / 1e9, ms=ms, flops=fc.get_total_flops())


# --------------------------------------------------------------------- #
# phase 22: the intern kernel
# --------------------------------------------------------------------- #


def _intern_block(cfg, keys: int, gen, n_cap=None, n_tomb: int = 0):
    """``SHARDS`` stacked intern states of ``intern_cap(cfg)`` slots on
    the card, each table holding ``keys`` prehashed keys (phase 2's bulk
    build; ids 0..keys-1, ``n_nodes`` = keys), ``n_tomb`` of them then
    deleted, ``l2h`` of ``n_cap`` rows (default ``cfg.n_cap``)."""
    import torch
    from repro_torch.core.engine.hashtable import HashTable
    from repro_torch.dist.router import InternState, intern_cap
    tables = [bulk_table(intern_cap(cfg), keys, n_tomb, True, gen)[0]
              for _ in range(SHARDS)]
    k1, k2, val = (torch.stack([t[w] for t in tables]) for w in range(3))
    val -= (k1 >= 0).to(torch.int32)           # bulk ids start at 1
    n_cap = cfg.n_cap if n_cap is None else n_cap
    i32 = dict(dtype=torch.int32, device="cuda")
    return InternState(h2l=HashTable(k1, k2, val),
                       l2h=torch.full((SHARDS, n_cap, 2), -1, **i32),
                       n_nodes=torch.full((SHARDS,), keys, **i32),
                       n_dropped=torch.zeros(SHARDS, **i32))


def _intern_buckets(ist, lanes: int, kind: str, gen):
    """``int32[SHARDS, lanes, 5]`` buckets on the card: ``"hits"`` both
    endpoints keys of the row's table, ``"misses"`` keys no table holds,
    all distinct, ``"repeats"`` keys no table holds drawn from a pool of
    ``lanes // 4 + 1`` a row (each novel key interned once, then found)."""
    import torch
    dev = "cuda"
    r = torch.arange(SHARDS, device=dev)[:, None, None]
    if kind == "hits":
        live = [(ist.h2l.k1[i] >= 0).nonzero().flatten()
                for i in range(SHARDS)]
        pick = torch.stack([lv[torch.randint(0, lv.numel(), (lanes, 2),
                                             generator=gen, device=dev)]
                            for lv in live])
        hi, lo = ist.h2l.k1[r, pick], ist.h2l.k2[r, pick]
    else:
        pool = 2 * lanes if kind == "misses" else lanes // 4 + 1
        phi = torch.randint(0, (1 << 31) - 1, (SHARDS, pool), generator=gen,
                            device=dev, dtype=torch.int32)
        # bulk keys have k2 < 2^20: a k2 of 2^30 and up is absent
        plo = (1 << 30) + torch.arange(pool, device=dev, dtype=torch.int32)
        plo = plo.expand(SHARDS, pool)
        if kind == "misses":
            pick = torch.arange(2 * lanes, device=dev).reshape(lanes, 2)
            pick = pick.expand(SHARDS, lanes, 2)
        else:
            pick = torch.randint(0, pool, (SHARDS, lanes, 2), generator=gen,
                                 device=dev)
        hi, lo = phi[r, pick], plo[r, pick]
    ins = torch.ones((SHARDS, lanes, 1), dtype=torch.int32, device=dev)
    return torch.cat([hi[..., :1], lo[..., :1], hi[..., 1:], lo[..., 1:],
                      ins], -1).contiguous()


def _intern_args(ist, buckets):
    return ((ist.h2l.k1, ist.h2l.k2, ist.h2l.val), ist.l2h, ist.n_nodes,
            ist.n_dropped, tuple(buckets[..., k] for k in range(4)))


def intern_case(base, buckets, n_cap: int, name: str, time_it: bool):
    """One phase 22(a) case: the kernel on a copy of ``base`` against the
    plain version on a host copy, bitwise (ids and every leaf); with
    ``time_it`` the kernel's device time (after a spin kernel, so the
    host's launch is hidden), a call from Python (to a sync) and its host
    part (calls enqueued back to back), the plain version, the byte bound
    and the ordered tail's dependent steps."""
    import torch
    from repro_torch.core.engine.state import copy_state
    from repro_torch.kernels import ops
    from repro_torch.kernels.ht_probe import ProbeJob, ht_probe_many_plain
    from repro_torch.kernels.intern import intern_plain
    n_rep, lanes = buckets.shape[:2]
    host_base, host_b = copy_state(base, "cpu"), buckets.cpu()
    st = copy_state(base)
    u, v = ops.intern(*_intern_args(st, buckets), n_cap)
    plain = copy_state(host_base)
    t = time.perf_counter()
    pu, pv = intern_plain(*_intern_args(plain, host_b), n_cap)
    plain_ms = 1e3 * (time.perf_counter() - t)
    got = copy_state(st, "cpu")
    err = 0
    for what, a, b in (("u", u.cpu(), pu), ("v", v.cpu(), pv),
                       *((k, getattr(got.h2l, k), getattr(plain.h2l, k))
                         for k in ("k1", "k2", "val")),
                       *((k, getattr(got, k), getattr(plain, k))
                         for k in ("l2h", "n_nodes", "n_dropped"))):
        if a.dtype != b.dtype or not torch.equal(a, b):
            raise AssertionError(f"phase 22(a) {name}: intern kernel vs "
                                 f"plain, {what} differs")
        if a.numel():
            err = max(err, int((a.long() - b.long()).abs().max()))
    valid = int(((host_b[..., 0] >= 0) & (host_b[..., 2] >= 0)).sum())
    inserts = int((plain.n_nodes - host_base.n_nodes).sum())
    dropped = int((plain.n_dropped - host_base.n_dropped).sum())
    res = dict(case=name, rows=n_rep, lanes=lanes, changes=valid,
               inserts=inserts, dropped=dropped, plain_ms=plain_ms,
               max_abs_err=err)
    if not time_it:
        return res
    # the ordered tail: endpoints of valid changes not found at entry
    q = torch.stack([host_b[..., 0], host_b[..., 2]], -1).reshape(n_rep, -1)
    q2 = torch.stack([host_b[..., 1], host_b[..., 3]], -1).reshape(n_rep, -1)
    ok = ((host_b[..., 0] >= 0) & (host_b[..., 2] >= 0))
    ok = ok.repeat_interleave(2, 1)
    (_, found, _), = ht_probe_many_plain([ProbeJob(
        host_base.h2l.k1, host_base.h2l.k2, host_base.h2l.val,
        torch.where(ok, q, 0), torch.where(ok, q2, 0), True, "find")])
    tail = int((ok & ~found).sum(1).max())
    nbytes = (16 + 8) * n_rep * lanes + 12 * 2 * valid + 20 * inserts \
        + 16 * n_rep
    work = copy_state(base)

    def restore():
        for a, b in zip(_flat_intern(work), _flat_intern(base)):
            a.copy_(b)

    reps = 10
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    args = _intern_args(work, buckets)     # the router's own views
    dev_ms = call_ms = 0.0
    for _ in range(reps):
        restore()
        torch.cuda._sleep(2_000_000)     # keeps the card busy meanwhile
        start.record()
        ops.intern(*args, n_cap)
        end.record()
        torch.cuda.synchronize()
        dev_ms += start.elapsed_time(end) / reps
        restore()
        torch.cuda.synchronize()
        t = time.perf_counter()
        ops.intern(*args, n_cap)
        torch.cuda.synchronize()
        call_ms += 1e3 * (time.perf_counter() - t) / reps
    # the host's part of a call: the wrapper's checks, allocation and
    # launch, enqueued back to back without a sync
    t = time.perf_counter()
    for _ in range(reps):
        ops.intern(*args, n_cap)
    host_ms = 1e3 * (time.perf_counter() - t) / reps
    torch.cuda.synchronize()
    res.update(ms=dev_ms, call_ms=call_ms, host_ms=host_ms,
               bound_ms=1e3 * nbytes / HBM_BYTES_PER_S, bound_bytes=nbytes,
               tail_steps=tail)
    del work, st
    return res


def _flat_intern(ist):
    return (ist.h2l.k1, ist.h2l.k2, ist.h2l.val, ist.l2h, ist.n_nodes,
            ist.n_dropped)


def chunk_buckets(stream, cfg):
    """Phase 11's first chunk routed to its ``SHARDS`` shards as the
    sharded path routes it: fresh stacked intern states on the card and
    the ``int32[SHARDS, acc_cap, 5]`` buckets."""
    import numpy as np
    import torch
    from repro_torch.core.engine.state import stack_states
    from repro_torch.dist import labelhash, router
    chunk = stream[:SHARDED_CHANGES]
    uh, ul = labelhash.hash_words([c[0] for c in chunk])
    vh, vl = labelhash.hash_words([c[1] for c in chunk])
    fl = np.array([c[2] for c in chunk], np.int32)
    pad = SHARDED_CHANGES - len(chunk)
    words = np.stack([np.concatenate([w, np.full(pad, f, np.int32)])
                      for w, f in ((uh, -1), (ul, -1), (vh, -1), (vl, -1),
                                   (fl, 0))])
    route, _ = router.make_route_step(
        1, SHARDS, SHARDED_CHANGES,
        router.default_lane_cap(SHARDED_CHANGES, 1, SHARDS, cfg.batch))
    (buckets,), _, _, _ = route([torch.from_numpy(words).to("cuda")])
    return stack_states([router.intern_new(cfg, "cuda")] * SHARDS), buckets


def intern_kernel_vs_plain(stream, gen) -> dict:
    """Phase 22(a): the intern kernel against its plain version, bitwise,
    on ``SHARDS`` stacked intern tables of ``intern_cap(full_config())``
    slots (2^22), each holding ``n_cap / 2`` keys: at 1, 256, 1,024 and
    2,048 changes a row of hits only, misses only and repeats; a drop
    case at ``n_cap`` 1,536 (1,024 keys held, 2,048 changes of repeats);
    and phase 11's first chunk (routed to its 4 shards: 1,024 lanes a
    row) on fresh intern states, the mix the sharded path interns first.
    Then the hard cases of ``repro_torch.testing.tables`` on tables that
    also hold ``n_cap / 32`` tombstones: 64 keys a row on one start,
    groups spilling into other groups' starts, starts just before
    tombstones, starts in the last 32 slots (chains wrapping past
    ``cap - 1``), ``INTERN_LONG`` changes a row (more than one
    shared-memory segment) and, on the 1,024-key tables, the room running
    out mid-chunk (``n_cap`` 300 above ``n_nodes``, a pool drawn with
    repeats: repeats of dropped keys).  At 256 and 1,024 changes, at the
    mix, 64 on one start, the spills and the long rows: the kernel's
    device time, a call from Python and the plain version's time beside
    the byte bound and the ordered tail's dependent steps (the largest
    row's endpoints not found at entry) at the time a step costs, fitted
    from the misses-only times at 256 and 1,024 changes."""
    import numpy as np
    import torch
    from repro_torch.configs.mosso_stream import full_config
    from repro_torch.testing import tables

    t0 = time.perf_counter()
    cfg = full_config()
    base = _intern_block(cfg, cfg.n_cap // 2, gen)
    rows = []
    for lanes in INTERN_LANES:
        for kind in ("hits", "misses", "repeats"):
            rows.append(intern_case(
                base, _intern_buckets(base, lanes, kind, gen), cfg.n_cap,
                f"{kind} x{lanes}", time_it=lanes in (256, 1024)))
    del base
    small = _intern_block(cfg, 1024, gen, n_cap=INTERN_DROP_CAP)
    drop = intern_case(small, _intern_buckets(small, 2048, "repeats", gen),
                       INTERN_DROP_CAP, "drops x2048", time_it=False)
    if drop["dropped"] == 0 or drop["inserts"] != SHARDS * (
            INTERN_DROP_CAP - 1024):
        raise AssertionError(f"phase 22(a): the drop case dropped nothing "
                             f"or filled no row: {drop}")
    rows.append(drop)
    del small
    fresh, buckets = chunk_buckets(stream, cfg)
    mix = intern_case(fresh, buckets, cfg.n_cap, f"phase 11 chunk 1 "
                      f"x{buckets.shape[1]}", time_it=True)
    rows.append(mix)
    del fresh, buckets
    rng = np.random.default_rng(22)
    base = _intern_block(cfg, cfg.n_cap // 2, gen, n_tomb=cfg.n_cap // 32)
    cap = base.h2l.k1.shape[1]
    for kind in tables.INTERN_KINDS:
        if kind == "room":
            continue
        lanes = INTERN_LONG if kind == "long" else 1024
        k1 = base.h2l.k1.cpu().numpy() if kind == "tombs" else None
        b = torch.from_numpy(tables.intern_buckets(
            kind, SHARDS, lanes, cap, rng, k1=k1)).cuda()
        rows.append(intern_case(base, b, cfg.n_cap, f"{kind} x{lanes}",
                                time_it=kind in INTERN_TIMED))
    del base
    small = _intern_block(cfg, 1024, gen, n_cap=1024 + 300)
    room = intern_case(small, torch.from_numpy(tables.intern_buckets(
        "room", SHARDS, 1024, cap, rng)).cuda(), 1024 + 300, "room x1024",
        time_it=False)
    if room["inserts"] != SHARDS * 300 or room["dropped"] == 0:
        raise AssertionError(f"phase 22(a): the room case filled no row or "
                             f"dropped nothing: {room}")
    rows.append(room)
    del small
    torch.cuda.empty_cache()
    at = {r["case"]: r for r in rows}
    m256, m1024 = at["misses x256"], at["misses x1024"]
    step_us = 1e3 * (m1024["ms"] - m256["ms"]) / max(
        1, m1024["tail_steps"] - m256["tail_steps"])
    for r in rows:
        if "tail_steps" in r:
            r["latency_scale_ms"] = r["tail_steps"] * step_us / 1e3
    for r in rows:
        line = (f"phase 22(a) intern {r['case']:>22s}: kernel == plain "
                f"(changes {r['changes']}, inserts {r['inserts']}, dropped "
                f"{r['dropped']}); plain {r['plain_ms']:.2f} ms")
        if "ms" in r:
            line += (f"; kernel {1e3 * r['ms']:.2f} us (call "
                     f"{1e3 * r['call_ms']:.2f} us, of it on the host "
                     f"{1e3 * r['host_ms']:.2f} us), bytes bound "
                     f"{1e3 * r['bound_ms']:.3f} us, ordered tail "
                     f"{r['tail_steps']} steps = "
                     f"{1e3 * r['latency_scale_ms']:.2f} us at "
                     f"{step_us:.4f} us a step")
        log(line)
    res = dict(rows=rows, us_per_tail_step=step_us, mix=mix,
               max_abs_err=max(r["max_abs_err"] for r in rows),
               seconds=time.perf_counter() - t0)
    log(f"phase 22(a): the intern kernel equals its plain version bitwise "
        f"in {len(rows)} cases; no PyTorch call interns keys in order, so "
        f"library_ms is null; {res['seconds']:.1f} s")
    return res


def _free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def dryrun_card(path_res: dict, sage_train: dict, sasrec_train: dict,
                dense: dict) -> dict:
    """What phases 3, 16(c) and 16(b) held and measured on the card, by
    phase 18(a)'s cell (``dense``: :func:`dense_one_trip`)."""
    return {
        "graphsage-reddit/minibatch_lg": dict(
            sage_train["held"], peak_gb=sage_train["peak_gb"],
            ms=sage_train["ms_per_step"]),
        "sasrec/train_batch": dict(
            sasrec_train["held"], peak_gb=sasrec_train["peak_gb"],
            ms=sasrec_train["ms_per_step"]),
        "mosso-stream/stream_batch": dict(
            state=path_res["state_tensor_bytes"], **dense)}


def dryrun_vs_card(card: dict, seed: int) -> dict:
    """Phase 18: the dry-run (``launch/dryrun.py``) against the card.
    (c) starts first, in a subprocess on the CPU: ``internlm2-20b`` and
    ``llama3-405b`` ``train_4k`` at the 16 x 16 production mesh (a fake
    group of 256 ranks), each rank's GB beside the card's 80.  (a) in this
    process, at a 1-rank mesh (a fake group of one rank): the
    ``full_config()`` cells of phases 16(c), 16(b) and 3; the predicted
    bytes of the parameters, the optimizer state and the inputs (the
    engine state, for mosso) must equal the bytes of the tensors those
    phases held on the card, and (GraphSAGE, SASRec) the predicted FLOPs
    ``FlopCounterMode`` over their step on the card; the predicted peak is
    printed beside ``max_memory_allocated()`` and the roofline's time
    beside the measured step, with their ratios.  (b) ``compressed_psum``
    over an NCCL group of one rank equals ``int8_dequantize(
    *int8_quantize(x))`` bitwise and lies within ``scale / 2`` of ``x``
    (and two float32 ulps of ``max |x|``)."""
    import os
    import torch
    import torch.distributed as dist
    from repro_torch.dist.collectives import (compressed_psum,
                                              int8_dequantize, int8_quantize)
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as launch_mesh

    t0 = time.perf_counter()
    full = subprocess.Popen(
        [sys.executable, "-c", _FULL_DRYRUN, *DRYRUN_FULL],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                 CUDA_VISIBLE_DEVICES=""))
    res = {"cells": {}}
    try:
        # (a) at a 1-rank mesh
        launch_mesh.init_fake_world(1)
        mesh = launch_mesh.make_host_mesh()
        for key in DRYRUN_CELLS:
            arch, shape = key.split("/")
            t = time.perf_counter()
            rec = dryrun.run_cell(arch, shape, mesh=mesh, verbose=False)
            mem, held = rec["memory"], card[key]
            pred = ({"state": mem["state_bytes"]} if arch == "mosso-stream"
                    else {"params": mem["params_bytes"],
                          "opt_state": mem["opt_state_bytes"],
                          "inputs": mem["inputs_bytes"]})
            pred["flops"] = int(rec["cost"]["flops"])
            for k, v in pred.items():
                if v != held[k]:
                    raise AssertionError(
                        f"phase 18(a) {key}: predicted {k} {v} != the "
                        f"card's {held[k]}")
            row = dict(pred, trace_s=time.perf_counter() - t,
                       predicted_peak_gb=mem.get(
                           "peak_bytes", mem["argument_size_in_bytes"]) / 1e9,
                       card_peak_gb=held["peak_gb"])
            row["peak_ratio"] = row["card_peak_gb"] / row[
                "predicted_peak_gb"]
            terms = rec["roofline"]
            row["roofline_ms"] = 1e3 * max(terms["t_compute"],
                                           terms["t_memory"],
                                           terms["t_collective"])
            row["dominant"] = terms["dominant"]
            row["card_ms"] = held["ms"]
            row["time_ratio"] = row["card_ms"] / row["roofline_ms"]
            res["cells"][key] = row
            log(f"phase 18(a) {key} at 1 rank: predicted == the card's "
                + ", ".join(f"{k} {v}" for k, v in pred.items())
                + f"; peak predicted {row['predicted_peak_gb']:.3f} GB, "
                f"card {row['card_peak_gb']:.3f} GB (card / predicted "
                f"{row['peak_ratio']:.3f})"
                + f"; roofline {row['roofline_ms']:.3f} ms "
                f"({row['dominant']}), card {row['card_ms']:.3f} ms per "
                f"step (card / roofline {row['time_ratio']:.2f}); traced "
                f"in {row['trace_s']:.1f} s")
        dist.destroy_process_group()

        # (b) compressed_psum over NCCL, one rank
        dist.init_process_group(
            "nccl", init_method=f"tcp://localhost:{_free_port()}", rank=0,
            world_size=1, device_id=torch.device("cuda", 0))
        gen = torch.Generator(device="cuda").manual_seed(seed + 18)
        x = torch.randn((4096, 1024), generator=gen, device="cuda")
        q, scale = int8_quantize(x)
        want = int8_dequantize(q, scale)
        got = compressed_psum(x)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError("phase 18(b): compressed_psum over one rank "
                                 "!= int8_dequantize(*int8_quantize(x))")
        err = float((got.double() - x.double()).abs().max())
        half = 0.5 * float(scale)
        # scale / 2 in exact arithmetic; x / scale and q * scale round in
        # float32, which moves the bound by two ulps of the largest |x|
        slack = 2 * 2.0 ** -23 * float(x.abs().max())
        if err > half + slack:
            raise AssertionError(f"phase 18(b): |psum - x| {err} > scale / 2 "
                                 f"{half} + {slack:.2e}")
        dist.destroy_process_group()
        res["psum"] = dict(max_abs_err=err, half_scale=half, slack=slack)
        log(f"phase 18(b): compressed_psum over an NCCL group of 1 rank == "
            f"int8_dequantize(*int8_quantize(x)) bitwise on [4096, 1024] "
            f"float32; max |out - x| {err:.9e} <= scale / 2 {half:.9e} "
            f"(+ two float32 ulps of max |x|, {slack:.2e})")

        # (c) the full-width dry-run, started first
        out, err_text = full.communicate(timeout=600)
        if full.returncode != 0:
            raise AssertionError(f"phase 18(c) exited {full.returncode}: "
                                 f"{err_text[-2000:]}")
    finally:
        if full.poll() is None:
            full.kill()
            full.wait()
        if dist.is_initialized():
            dist.destroy_process_group()
    recs = json.loads([l for l in out.splitlines()
                       if l.startswith("RESULT ")][-1][len("RESULT "):])
    res["full"] = {}
    for rec in recs:
        if rec["status"] != "ok":
            raise AssertionError(f"phase 18(c) {rec['arch']}: {rec}")
        mem = rec["memory"]
        row = dict(args_gb=mem["argument_size_in_bytes"] / 1e9,
                   peak_gb=mem["peak_bytes"] / 1e9,
                   flops=rec["cost"]["flops"],
                   dominant=rec["roofline"]["dominant"],
                   trace_s=rec["t_trace_s"])
        res["full"][rec["arch"]] = row
        log(f"phase 18(c) {rec['arch']} train_4k at 16 x 16: each rank "
            f"holds {row['args_gb']:.2f} GB of parameters, AdamW state and "
            f"inputs, peak {row['peak_gb']:.2f} GB beside the card's "
            f"{CARD_GB:.0f} GB ({row['peak_gb'] / CARD_GB:.2f}x); "
            f"{row['flops']:.3e} FLOPs per rank, {row['dominant']}-bound; "
            f"traced in {row['trace_s']:.1f} s")
    res["seconds"] = time.perf_counter() - t0
    log(f"phase 18: {res['seconds']:.1f} s")
    return res


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
    load_rates()
    from repro_torch.kernels import (_build, csr_segment, flash_attention,
                                     ht_probe, ht_rebuild, intern)
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
                              flash_attention.SOURCE, ht_rebuild.SOURCE,
                              intern.SOURCE])
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

    # 3. main path (counts set to 0 just before, read just after); the
    # state after its first batch kept on the host for phase 21
    path_res, bs, truth, by_batch, stream = main_path(NODES, 4, seed,
                                                      keep_first=True)
    first_batch = path_res.pop("first_batch")
    # 4. reads
    read_res = reads(bs, truth, 256, seed)
    #    and the graph ops over the live summary (counts set to 0 inside)
    summary_ops = graph_ops_over_summary(bs, truth, seed)
    # 15(d). maybe_compact on the live summarizer (counts set to 0 inside,
    # just before it)
    rebuild_d = compact_live_summarizer(bs, truth, seed)
    del bs
    # key_averages() takes ~0.9 ms per event: 4 changes are ~34k kernels
    prof_res = profile_step(stream, 4)
    # 5. the smoke configuration on the card and on the CPU; 15(c). again
    # with maybe_compact after batch 2 and mid-stream
    cuda_vs_cpu(seed)
    cuda_vs_cpu(seed + 1, compact=True)

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
    # 15(a)-(b). the rebuild kernel against the fold, then alone at full
    # size on phase 2's 2^25-slot tables at 70% and a 2^24-slot one
    rebuild_a = rebuild_kernel_vs_plain(seed)
    rebuild_b = rebuild_full_size(
        {("2^25", pre): tables["70%", pre] for pre in (False, True)}, gen)
    del tables
    torch.cuda.empty_cache()

    # 6. the CSR kernel vs plain at the GNN shapes
    csr_rows, csr_err = csr_vs_plain(gen)
    # 7. the GraphSAGE path (counts set to 0 inside, just before it)
    sage, sage_batch = graphsage_request(seed)
    # 8. the other archs' smoke configs, card vs CPU
    archs = smoke_archs(seed)
    torch.cuda.empty_cache()
    # 16. training: (a) the CSR backward vs plain autograd; (b) SASRec at
    # full width (no kernel on its path); (c) GraphSAGE at full width on
    # phase 7's batch (counts set to 0 inside, just before its steps);
    # (d) the launcher and restarts
    t = time.perf_counter()
    csr_bwd = csr_backward_vs_plain(sage_batch, gen)
    sasrec_train = sasrec_training(seed)
    torch.cuda.empty_cache()
    sage_train = graphsage_training(sage_batch, seed)
    del sage_batch
    torch.cuda.empty_cache()
    launcher = train_launcher()
    log(f"phase 16: {time.perf_counter() - t:.1f} s")
    # 18. the dry-run against the card: the bytes and FLOPs phases 16(c),
    # 16(b) and 3 held and ran, compressed_psum over NCCL, and the
    # full-width train_4k cells at 16 x 16
    dryrun_res = dryrun_vs_card(dryrun_card(
        path_res, sage_train, sasrec_train, dense_one_trip(stream)), seed)

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
    torch.cuda.empty_cache()
    # 17. MLA serving at minicpm3-4b's widths (counts set to 0 inside,
    # just before its prefill)
    mla = mla_serving(seed, gen, built[flash_attention.SOURCE][1])

    # 11. the sharded summarizer at full width over the phase-3 stream
    # (counts set to 0 inside, just before it); 12. the router's paths,
    # card vs CPU, and the serve loop
    sharded, ss, sharded_stream = sharded_path(NODES, 4, seed)
    # 14(a), a full-width save and restore of phase 11's live summarizer,
    # is cut by the time limit (tools/recovery_check.py runs it; 14(b)
    # saves and recovers stacked summarizers on the card)
    del ss
    torch.cuda.empty_cache()
    # 19. replica_exec "map" and "vmap" side by side, leaf-bitwise; 20. the
    # same changes over a mesh of positions, leaf-bitwise to phase 19's
    modes, snapshots = replica_exec_modes(sharded_stream)
    mesh_res = mesh_path(sharded_stream, snapshots, modes)
    del snapshots
    torch.cuda.empty_cache()
    #     the probe kernel at phase 11's shapes on full-size intern tables
    max_err = max(max_err, intern_vs_plain(sharded, gen))
    # 22(a). the intern kernel vs plain at full size, timed; (c) phase 11's
    # counts beside the host intern loop's
    intern_res = intern_kernel_vs_plain(sharded_stream, gen)
    log(f"phase 22(c): phase 11 probe launches "
        f"{sharded['launches_per_change']:.2f}/change, host reads "
        f"{sharded['syncs_per_change']:.2f}/change, intern launches "
        f"{sharded['intern_launches']} ("
        f"{sharded['intern_launches'] / sharded['changes']:.4f}/change); "
        f"with the host intern loop: "
        + "; ".join(f"{p:.2f} and {r:.2f} over {n} changes"
                    for n, (p, r) in HOST_LOOP_COUNTS.items()))
    router_paths = sharded_router_paths(seed)
    # 13. batched crash consistency at full width (counts set to 0 inside,
    # just before each run); 14(b). the kill-at-every-boundary bar, card
    # and CPU (counts set to 0 inside, just before the card's kills);
    # 14(c). the recovering stream driver
    recovery = batched_recovery(stream, path_res["step_s"], seed)
    kill_bar = sharded_kill_bar(seed)
    driver = summarize_stream_driver()
    # 21. the dense step beside the branching step, from phase 3's state
    # after its first batch (counts set to 0 just before each, read just
    # after)
    dense = dense_step_forms(stream, first_batch)
    del first_batch

    out_dir = ROOT / "build"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(dict(
        card=smi, torch=torch.__version__, cuda=torch.version.cuda,
        build_s=build_s, kernel_rows=rows, probe_multi_job=multi,
        probe_stacked=stacked, main_path=path_res,
        profile=prof_res, reads=read_res, summary_ops=summary_ops,
        csr_rows=csr_rows, graphsage=sage, smoke_archs=archs,
        attention_rows=attn_rows, lm_card_vs_cpu=lm_a, lm_prefill=lm_b,
        lm_serve=lm_c, lm_smoke_archs=lm_d, sharded=sharded,
        sharded_router_paths=router_paths, replica_exec_modes=modes,
        mesh=mesh_res,
        batched_recovery=recovery, sharded_kill_bar=kill_bar,
        summarize_stream=driver, rebuild_kernel_vs_plain=rebuild_a,
        rebuild_full_size=rebuild_b,
        rebuild_live_summarizer=rebuild_d, csr_backward=csr_bwd,
        sasrec_training=sasrec_train, graphsage_training=sage_train,
        train_launcher=launcher, mla=mla, dryrun=dryrun_res,
        dense_step=dense, intern=intern_res),
        indent=1))

    entry = dict(name="ht_probe", route="cuda",
                 source="src/repro_torch/csrc/ht_probe.cu",
                 replaces="src/repro/kernels/ht_probe.py:61",
                 launches=path_res["probe_launches"], max_abs_err=max_err,
                 ms=top["ms"], call_ms=top["call_ms"],
                 plain_ms=top["plain_ms"],
                 bound_ms=top["bound_ms"], bound_by="bytes",
                 library_ms=None, variant="tile8", mode=top["mode"],
                 lanes=top["lanes"], load=top["load"],
                 jobs=path_res["probe_jobs"],
                 sharded_launches=sharded["probe_launches"],
                 sharded_jobs=sharded["probe_jobs"],
                 sharded_replica_exec=sharded["replica_exec"],
                 modes_per_change={
                     mode: {k: modes[mode][k] for k in (
                         "us_per_change", "launches_per_change",
                         "jobs_per_change", "syncs_per_change")}
                     for mode in ("map", "vmap")},
                 mesh_devices=mesh_res["devices"],
                 mesh_launches_per_change={
                     "vmap": mesh_res["vmap"]["launches_per_change"]},
                 sharded_max_lanes_per_job=sharded["max_lanes_per_job"],
                 recovery_launches=recovery["recovery_probe_launches"],
                 sharded_recovery_launches=kill_bar["cuda"]["probe_launches"],
                 dense_step_launches=dense["dense"]["probe_launches"])
    k = sage["kernel"]
    csr_entry = dict(name="csr_segment", route="cuda",
                     source="src/repro_torch/csrc/csr_segment.cu",
                     replaces="src/repro/kernels/csr_segment.py:34",
                     launches=sage["launches"],
                     max_abs_err=max(csr_err, k["max_abs_err"],
                                     csr_bwd["max_abs_err"]),
                     ms=k["ms"], call_ms=k["call_ms"],
                     plain_ms=k["plain_ms"], bound_ms=k["bound_ms"],
                     bound_by="bytes", library_ms=k["library_ms"],
                     shape="graphsage request, layer 1, F=128, sum",
                     train_launches=sage_train["launches"],
                     forward_launches_per_train_step=sage_train[
                         "forward_launches_per_step"],
                     backward_launches_per_train_step=sage_train[
                         "backward_launches_per_step"],
                     backward={key: csr_bwd[key] for key in (
                         "ms", "call_ms", "plain_ms", "bound_ms",
                         "library_ms", "transpose_ms", "max_abs_err")},
                     shapes=[{key: r[key] for key in (
                         "shape", "f", "reduce", "ms", "plain_ms",
                         "bound_ms", "gather_bound_ms", "library_ms",
                         "max_abs_err")} for r in csr_rows])
    mla_layer = mla["attention"]["layer"]
    attn_entry = dict(name="flash_attention", route="cuda",
                      source="src/repro_torch/csrc/flash_attention.cu",
                      replaces="src/repro/kernels/flash_attention.py:25",
                      launches=lm_b["launches"],
                      max_abs_err=max(attn_err,
                                      mla["attention"]["max_abs_err"]),
                      ms=layer["ms"], call_ms=layer["call_ms"],
                      plain_ms=layer["plain_ms"], bound_ms=layer["bound_ms"],
                      bound_by="operations", library_ms=layer["library_ms"],
                      variant=layer["variant"],
                      shape="internlm2-20b layer: B=2 H=48 Hkv=8 T=4096 "
                            "D=128 bf16 causal",
                      granite_layer={key: layers["granite-moe-3b-a800m"][key]
                                     for key in ("ms", "library_ms",
                                                 "bound_ms", "plain_ms",
                                                 "max_abs_err")},
                      mla_layer=dict(
                          {key: mla_layer[key] for key in (
                              "variant", "mode", "ms", "call_ms",
                              "plain_ms", "bound_ms", "library_ms",
                              "library_call", "max_abs_err",
                              "max_row_rel_err")},
                          bound_by="operations",
                          separate_ms=mla["attention"]["separate"]["ms"],
                          build=mla["attention"]["build"],
                          launches=mla["prefill"]["launches"],
                          by_variant=mla["prefill"]["by_variant"],
                          prefill_attention_over_launches_x_kernel=mla[
                              "prefill"]["attention_over_launches_x_kernel"],
                          shape="minicpm3-4b layer: B=2 H=40 Hkv=1 T=4096 "
                                "D=288 Dv=256 bf16 causal, v a view of "
                                "k's first 256 columns"))
    adj = rebuild_d["adj"]
    rebuild_entry = dict(name="ht_rebuild", route="cuda",
                         source="src/repro_torch/csrc/ht_rebuild.cu",
                         replaces="src/repro/core/engine/hashtable.py:285",
                         launches=rebuild_d["launches"],
                         max_abs_err=max(adj["max_abs_err"],
                                         rebuild_a["max_abs_err"]),
                         ms=adj["ms"], kernel_ms=adj["kernel_ms"],
                         call_ms=adj["call_ms"], plain_ms=adj["plain_ms"],
                         bound_ms=adj["bound_ms"], bound_by="bytes",
                         library_ms=None, live=adj["live"],
                         longest_run=adj["longest_run"],
                         shape="phase 3's adj table, 2^25 slots",
                         full_size_70pct=[
                             {k: r[k] for k in (
                                 "table", "prehashed", "kernel_ms", "ms",
                                 "call_ms", "bound_ms", "longest_run")}
                             for r in rebuild_b],
                         plain_s_2p22=rebuild_a["plain_s_2p22"],
                         clustered_2p20={
                             k: rebuild_a["clustered"][k] for k in (
                                 "kernel_ms", "ms", "call_ms", "bound_ms",
                                 "runs")})
    mix = intern_res["mix"]
    intern_entry = dict(name="intern", route="cuda",
                        source="src/repro_torch/csrc/intern.cu",
                        replaces="src/repro/dist/router.py:305",
                        launches=sharded["intern_launches"],
                        max_abs_err=intern_res["max_abs_err"], ms=mix["ms"],
                        call_ms=mix["call_ms"],
                        plain_ms=mix["plain_ms"], bound_ms=mix["bound_ms"],
                        bound_by="bytes", library_ms=None,
                        latency_scale_ms=mix["latency_scale_ms"],
                        tail_steps=mix["tail_steps"],
                        sharded_recovery_launches=kill_bar["cuda"][
                            "intern_launches"],
                        shape=f"phase 11's first chunk: {SHARDS} rows of "
                              f"{mix['lanes']} changes on fresh 2^22-slot "
                              f"intern tables",
                        cases=[{k: r.get(k) for k in (
                            "case", "ms", "call_ms", "host_ms", "plain_ms",
                            "bound_ms", "latency_scale_ms", "inserts",
                            "dropped")}
                            for r in intern_res["rows"]])
    print(json.dumps({"kernels": [entry, csr_entry, attn_entry,
                                  rebuild_entry, intern_entry]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
