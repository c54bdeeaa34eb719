"""PyTorch port: sharded reads and the sharded CLIs, against JAX.

``ShardedSummaryQuery`` of the port against the JAX package's at every
flush epoch of a pipelined run (each snapshot one routed chunk behind the
write head): ``seen_labels``, ``neighbors_batch``, ``degree_batch``,
``has_edge_by_shard`` and ``has_edge_batch`` equal, and equal to the
ground truth of the snapshot's own epoch prefix; ``LookupError`` on a
label the snapshot has not seen; a snapshot unchanged by later writes;
the capacity tripwire on the first answer.  Then the CLIs: the
port's ``launch.stream --engine sharded`` prints the JAX CLI's ``phi`` and
``|E|``, and ``launch.serve_summary --verify`` exits 0.  Tolerance: exact.
The engine configuration is the one the stream CLI builds for 40 nodes,
so the JAX package compiles its steps once for the file.
"""
import os
import re
import runpy
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.engine import ShardedSummarizer as JaxSharded  # noqa: E402
from repro.core.engine.state import EngineConfig as JaxConfig  # noqa: E402
from repro_torch.core.engine import EngineConfig  # noqa: E402
from repro_torch.core.engine import ShardedSummarizer  # noqa: E402
from repro_torch.launch.stream import make_stream  # noqa: E402
from test_torch_router import assert_replicas_equal, live_set  # noqa: E402

SRC = Path(__file__).resolve().parent.parent / "src"
# the stream CLI's configuration and stream at these flags
FLAGS = ["--shards", "2", "--nodes", "40", "--deg", "3", "--batch", "16",
         "--c", "4", "--router-chunk", "32", "--fully-dynamic"]
CFG = dict(n_cap=256, m_cap=1024, c=4, batch=16)
CHUNK = 32


def stream40():
    return make_stream("ba", 40, 3, 0.7, True, 0)


def adjacency(edges) -> dict:
    adj: dict = {}
    for (u, v) in edges:
        adj.setdefault(u, set()).add(v)
        adj.setdefault(v, set()).add(u)
    return adj


def answers(view, labels, pairs) -> tuple:
    return (view.neighbors_batch(labels), view.degree_batch(labels),
            view.has_edge_by_shard(pairs).tolist(),
            view.has_edge_batch(pairs))


def test_sharded_reads_equal_jax_at_every_epoch():
    stream = stream40()
    j = JaxSharded(JaxConfig(**CFG), n_shards=2, router_chunk=CHUNK,
                   trial_backend="xla", replica_exec="map")
    p = ShardedSummarizer(EngineConfig(**CFG), device="cpu", n_shards=2,
                          router_chunk=CHUNK)
    assert p.pipeline and j.pipeline
    rng = np.random.default_rng(0)
    held = []
    calls = [stream[o:o + CHUNK] for o in range(0, len(stream), CHUNK)]
    for k, chunk in enumerate(calls + [None]):
        if chunk is None:
            j.flush()
            p.flush()
        else:
            j.process(chunk)
            p.process(chunk)
        view, jview = p.query(), j.query(copy=True)
        assert view.epoch == jview.epoch == k
        assert_replicas_equal(p, j, f"call {k}")
        if view.epoch == 0:
            with pytest.raises(LookupError):
                view.degree_batch([stream[0][0]])
            continue
        # the snapshot's epoch prefix: the first `epoch` calls
        truth = live_set([c for call in calls[:view.epoch] for c in call])
        adj = adjacency(truth)
        labels = view.seen_labels()
        assert labels == jview.seen_labels()
        edges = sorted(truth)
        pairs = [edges[i] for i in rng.integers(0, len(edges), 12)]
        pairs += [(labels[a], labels[b])
                  for a, b in rng.integers(0, len(labels), (12, 2))]
        got = answers(view, labels, pairs)
        assert got == answers(jview, labels, pairs), k
        assert got[0] == [adj.get(x, set()) for x in labels]
        assert got[1] == [len(adj.get(x, ())) for x in labels]
        assert got[3] == [pair in truth or pair[::-1] in truth
                          for pair in pairs]
        assert all(sum(col) <= 1 for col in zip(*got[2]))
        held.append((view, jview, labels, pairs, got))
        # a label of the routed chunk still pending is not in the snapshot
        new = {x for c in calls[view.epoch:k + 1] for x in c[:2]} \
            - set(labels)
        for lab in sorted(new)[:1]:
            with pytest.raises(LookupError, match="has not been streamed"):
                view.neighbors(lab)
    # snapshots taken earlier still answer for their own epoch
    for view, jview, labels, pairs, got in held:
        assert answers(view, labels, pairs) == got
    with pytest.raises(LookupError, match="never"):
        held[-1][0].degree("never")
    assert p.stats() == j.stats()


def test_query_capacity_tripwire_on_first_answer():
    p = ShardedSummarizer(EngineConfig(**dict(CFG, n_cap=8)), device="cpu",
                          n_shards=2, router_chunk=CHUNK, pipeline=False)
    stream = stream40()[:CHUNK]
    p.process(stream)
    view = p.query()
    with pytest.raises(RuntimeError, match="node capacity exceeded"):
        view.degree_batch([stream[0][0]])


def _run(*args: str) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=str(SRC))
    return subprocess.run([sys.executable, "-m", *args], env=env,
                          capture_output=True, text=True, timeout=300)


def _phi_and_edges(out: str) -> tuple:
    m = re.search(r"phi=(\d+) \|E\|=(\d+)", out)
    assert m, out
    return int(m.group(1)), int(m.group(2))


def test_sharded_stream_cli_prints_the_jax_cli_phi(monkeypatch, capsys):
    proc = _run("repro_torch.launch.stream", "--engine", "sharded",
                "--device", "cpu", *FLAGS)
    assert proc.returncode == 0, proc.stderr
    assert "router: lane_cap=32 max_drain_rounds=1 sync_free=True " \
           "pipeline=True replica_exec=map" in proc.stdout
    # `python -m repro.launch.stream` with the same flags, in this process
    monkeypatch.setattr(sys, "argv", ["repro.launch.stream", "--engine",
                                      "sharded", *FLAGS])
    runpy.run_module("repro.launch.stream", run_name="__main__")
    want = capsys.readouterr().out
    assert _phi_and_edges(proc.stdout) == _phi_and_edges(want)
    stats = re.search(r"\{.*\}", proc.stdout.splitlines()[-1]).group(0)
    assert "'router_syncs': 0" in stats and "'n_shards': 2" in stats


def test_serve_summary_verify_exits_zero():
    proc = _run("repro_torch.launch.serve_summary", "--device", "cpu",
                "--verify", "--nodes", "40", "--deg", "3", "--batch", "16",
                "--c", "4", "--router-chunk", "32", "--reads-per-chunk",
                "16", "--shards", "2", "--fully-dynamic")
    assert proc.returncode == 0, proc.stderr
    assert "verified=True" in proc.stdout
    assert "max epoch lag 1" in proc.stdout
