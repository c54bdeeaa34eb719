"""End-to-end driver: sharded, device-routed summarization of a stream with
crash-consistent checkpointing, killed mid-stream and recovered.

Port of ``examples/summarize_stream.py``.  Feeds a fully dynamic stream
through :class:`ShardedSummarizer` on the default ``routing="device"``
path (labels hashed on the host, routed and interned on the device, the
route of chunk k+1 issued before the engine stage of chunk k), with a
write-ahead journal and an epoch checkpoint every 2 chunks; then:

* the run is killed at a chunk boundary between two checkpoints
  (:func:`repro_torch.ft.inject.drive`);
* a FRESH summarizer recovers from the directory (last epoch checkpoint +
  journal replay, ``recover()``), lands on the killed run's stream cursor,
  and answers degree and neighbor reads exactly as a view of the killed
  run did;
* it continues to the end of the stream and must equal an uninterrupted
  run leaf for leaf (every replica and intern leaf, through the archive
  keys of the checkpoint format) and in ``stats()``.

Every check raises on failure.  ``--device`` defaults to ``cuda``.

Run:  PYTHONPATH=src python -m repro_torch.launch.summarize_stream [n_nodes]
          [--device cpu] [--proposal {minhash,magsdm}]
          [--objective {exact,weighted}] [--checkpoint-dir DIR]
"""
from __future__ import annotations

import argparse
import shutil
import tempfile
import time

import numpy as np

from repro_torch.checkpoint.checkpointer import _flatten
from repro_torch.core.engine import EngineConfig, ShardedSummarizer
from repro_torch.core.engine.state import OBJECTIVES, PROPOSALS
from repro_torch.dist.router import default_replica_exec
from repro_torch.ft.inject import SimulatedCrash, drive
from repro_torch.graph.streams import (barabasi_albert_edges,
                                       edges_to_fully_dynamic_stream)


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def _leaves_equal(a, b) -> bool:
    fa, fb = _flatten(a._ckpt_tree()), _flatten(b._ckpt_tree())
    return fa.keys() == fb.keys() and all(
        fa[k].dtype == fb[k].dtype and np.array_equal(fa[k], fb[k])
        for k in fa)


def main(argv=None) -> dict:
    dflt = EngineConfig()
    ap = argparse.ArgumentParser()
    ap.add_argument("n_nodes", type=int, nargs="?", default=2000)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the engine state (cuda or cpu)")
    ap.add_argument("--proposal", choices=list(PROPOSALS),
                    default=dflt.proposal)
    ap.add_argument("--objective", choices=list(OBJECTIVES),
                    default=dflt.objective)
    ap.add_argument("--weight-levels", type=int, default=dflt.weight_levels)
    ap.add_argument("--shards", type=int, default=2)
    ap.add_argument("--router-chunk", type=int, default=512)
    ap.add_argument("--checkpoint-dir", default=None,
                    help="checkpoint directory, emptied first (default: a "
                         "temporary directory, removed at the end)")
    args = ap.parse_args(argv)

    n_nodes = args.n_nodes
    edges = barabasi_albert_edges(n_nodes, 4, seed=0)
    stream = edges_to_fully_dynamic_stream(edges, delete_prob=0.1, seed=1)
    print(f"stream: {len(stream)} changes over {n_nodes} nodes")
    # per-shard caps budget the vertex-cut replication, not |V| / n_shards
    cfg = EngineConfig(n_cap=1 << max(8, (2 * n_nodes).bit_length()),
                       m_cap=1 << max(10, (2 * len(stream)).bit_length()),
                       d_cap=64, sn_cap=48, c=24, batch=64, escape=0.2,
                       proposal=args.proposal, objective=args.objective,
                       weight_levels=args.weight_levels)
    print(f"policy: proposal={cfg.proposal} objective={cfg.objective} "
          f"commit={cfg.commit}")

    own_dir = args.checkpoint_dir is None
    ckpt_dir = (tempfile.mkdtemp(prefix="mosso_stream_ckpt_") if own_dir
                else args.checkpoint_dir)
    shutil.rmtree(ckpt_dir, ignore_errors=True)

    def make_engine(checkpoint_dir=None):
        return ShardedSummarizer(cfg, device=args.device,
                                 n_shards=args.shards,
                                 router_chunk=args.router_chunk,
                                 checkpoint_dir=checkpoint_dir)

    try:
        ss = make_engine(ckpt_dir)
        _check(ss.routing == "device" and ss.sync_free and ss.pipeline,
               "the default router is not the sync-free pipelined path")
        _check(ss.replica_exec == default_replica_exec(ss.device),
               ss.replica_exec)
        print(f"router: chunk={ss.router_chunk} lane_cap={ss.lane_cap} "
              f"sync_free={ss.sync_free} pipeline={ss.pipeline} "
              f"replica_exec={ss.replica_exec} device={ss.device}")

        # crash mid-stream: each chunk is journaled before its dispatch, a
        # checkpoint lands every 2 chunks, and the kill fires at an odd
        # chunk boundary (between checkpoints: the journal earns it back)
        n_chunks = -(-len(stream) // ss.router_chunk)
        kill_at = max(n_chunks // 2, 1) | 1
        t0 = time.perf_counter()
        try:
            drive(ss, stream, ckpt_every=2, kill_at_chunk=kill_at)
            raise AssertionError("kill point never reached: stream too "
                                 "short?")
        except SimulatedCrash as e:
            half = ss.stream_cursor
            t_half = time.perf_counter() - t0
            print(f"[t={half}] ratio={ss.compression_ratio():.3f} "
                  f"phi={ss.phi} ({1e6 * t_half / max(half, 1):.0f} "
                  f"us/change)")
            print(f"crash injected: {e}")

        st = ss.stats()
        _check(st["router_syncs"] == 0 and st["router_host_dict_ops"] == 0,
               f"dispatch was not sync-free and dict-free: {st}")
        print(f"dispatch telemetry: syncs={st['router_syncs']} "
              f"host_dict_ops={st['router_host_dict_ops']} "
              f"drain_rounds={st['router_drain_rounds']}")
        ss.flush()                           # pin the view at the kill point
        q_pre = ss.query()
        probe = sorted({u for (u, v, _ins) in stream[:half]})[:64]
        answers_pre = {u: (q_pre.degree(u), sorted(q_pre.neighbors(u)))
                       for u in probe}
        del q_pre

        # recovery: the crashed object is abandoned, as a restart would;
        # a fresh engine restores the last epoch and replays the journal
        ss2 = make_engine(ckpt_dir)
        t = time.perf_counter()
        info = ss2.recover()
        t_recover = time.perf_counter() - t
        print(f"recovered: epoch={info['epoch']} "
              f"replayed_chunks={info['replayed_chunks']} "
              f"cursor={info['cursor']} in {t_recover:.2f} s")
        _check(ss2.stream_cursor == half,
               f"recovered cursor {ss2.stream_cursor} != {half}")
        _check(info["replayed_chunks"] >= 1, f"nothing replayed: {info}")
        ss2.flush()
        q_post = ss2.query()
        answers_post = {u: (q_post.degree(u), sorted(q_post.neighbors(u)))
                        for u in probe}
        del q_post
        _check(answers_post == answers_pre,
               "recovered query answers diverged")
        print(f"query answers identical across recovery ({len(probe)} "
              f"labels)")

        # both runs to the end: the recovered one must land bitwise on the
        # uninterrupted run's state
        ref = make_engine()
        t0 = time.perf_counter()
        ref.process(stream)
        ss2.process(stream[ss2.stream_cursor:])
        ref.flush()
        ss2.flush()
        t_rest = time.perf_counter() - t0
        _check(_leaves_equal(ref, ss2),
               "the recovered run's state differs from the uninterrupted "
               "run's")
        s_ref, s_rec = ref.stats(), ss2.stats()
        _check(s_ref == s_rec, f"stats differ: {s_ref} != {s_rec}")
        print(f"crash-recover verified: bitwise state match, "
              f"phi={ref.phi}")
        print(f"[t={len(stream)}] ratio={ss2.compression_ratio():.3f} "
              f"phi={ss2.phi} |E|={ss2.num_edges}")
        print(f"stats: {s_rec}")
        rate = (2 * len(stream) - half) / t_rest
        print(f"throughput after recovery: {rate:.0f} changes/s on "
              f"{ss2.device} (both runs)")
        return dict(changes=len(stream), kill_cursor=half,
                    recover_s=t_recover, info=info, stats=s_rec,
                    changes_per_s=rate)
    finally:
        if own_dir:
            shutil.rmtree(ckpt_dir, ignore_errors=True)


if __name__ == "__main__":
    main()
