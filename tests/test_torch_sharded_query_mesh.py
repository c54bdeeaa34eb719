"""PyTorch port: sharded reads over a mesh of positions.

``ShardedSummaryQuery`` over the port's ``ShardedSummarizer`` at 4
positions (``EngineMesh(["cpu"] * 4)``, 8 shards) against the port's at
1 position and the JAX package's on a mesh of eight fake host devices
(one subprocess, ``torch_mesh_jax.run_jax_8``): ``degree``, ``has_edge``
and ``neighbors`` of every label of the stream and of edge and non-edge
pairs, at every epoch of a pipelined stream (the views do not flush, so
each answers one routed chunk behind ``process``).  Each position
resolves a batch once, on its device, for its shards' intern tables;
the host merges.  Tolerance: exact.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.engine import EngineConfig  # noqa: E402
from repro_torch.core.engine import ShardedSummarizer  # noqa: E402
from repro_torch.launch.mesh import EngineMesh  # noqa: E402
from repro_torch.serve import query  # noqa: E402
from test_torch_router import CFG, ba_stream  # noqa: E402
from torch_mesh_jax import run_jax_8  # noqa: E402

QCFG = dict(CFG, batch=8)
SHARDS, CHUNK = 8, 32
STREAM = ba_stream(5)[:96]

JAX_CODE = """
from repro.core.engine import ShardedSummarizer
from repro.core.engine.state import EngineConfig

s = ShardedSummarizer(EngineConfig(**IN["cfg"]), n_shards=IN["shards"],
                      router_chunk=IN["chunk"], trial_backend="xla")
assert s.router_geometry.n_dev == 8
OUT["epochs"] = []
for off in range(0, len(IN["stream"]), IN["chunk"]):
    s.process(IN["stream"][off:off + IN["chunk"]])
    view = s.query(copy=True)
    seen = set(view.seen_labels())
    labels = [u for u in IN["labels"] if u in seen]
    ok = all(u in seen and v in seen for (u, v) in IN["pairs"])
    OUT["epochs"].append(dict(
        epoch=view.epoch, labels=labels,
        degree=view.degree_batch(labels) if labels else [],
        has_edge=view.has_edge_batch(IN["pairs"]) if ok else None,
        neighbors=view.neighbors_batch(labels) if labels else []))
"""


def labels_and_pairs():
    labels = sorted({x for (u, v, _) in STREAM for x in (u, v)})
    edges = sorted({(min(u, v), max(u, v)) for (u, v, _) in STREAM})
    pairs = edges[::3] + [(labels[i], labels[-1 - i]) for i in range(12)]
    return labels, pairs


@pytest.fixture(scope="module")
def jax8(tmp_path_factory):
    labels, pairs = labels_and_pairs()
    return run_jax_8(JAX_CODE, dict(
        cfg=QCFG, shards=SHARDS, chunk=CHUNK, stream=STREAM, labels=labels,
        pairs=pairs), tmp_path_factory.mktemp("jax8_query"))


def answers(p, labels, pairs):
    """Every epoch's answers of a pipelined run's views."""
    out = []
    for off in range(0, len(STREAM), CHUNK):
        p.process(STREAM[off:off + CHUNK])
        view = p.query()
        seen = set(view.seen_labels())
        ls = [u for u in labels if u in seen]
        # a pair is asked once both its labels have been streamed
        ok = all(u in seen and v in seen for (u, v) in pairs)
        out.append(dict(
            epoch=view.epoch, labels=ls,
            degree=view.degree_batch(ls) if ls else [],
            has_edge=view.has_edge_batch(pairs) if ok else None,
            neighbors=view.neighbors_batch(ls) if ls else []))
    return out


@pytest.mark.parametrize("replica_exec", ["map", "vmap"])
def test_reads_at_4_positions_equal_1_position_and_jax_8(jax8, replica_exec,
                                                        monkeypatch):
    labels, pairs = labels_and_pairs()
    resolves = []
    inner = query._intern_resolve

    def counting(ists, hi, lo):
        resolves.append((len(ists), ists[0].l2h.device))
        return inner(ists, hi, lo)
    monkeypatch.setattr(query, "_intern_resolve", counting)
    runs = {n: ShardedSummarizer(EngineConfig(**QCFG),
                                 mesh=EngineMesh(["cpu"] * n),
                                 n_shards=SHARDS, router_chunk=CHUNK,
                                 replica_exec=replica_exec)
            for n in (4, 1)}
    got = {n: answers(p, labels, pairs) for n, p in runs.items()}
    assert got[4] == got[1]
    want = jax8["epochs"]
    assert len(got[4]) == len(want)
    for e, (g, w) in enumerate(zip(got[4], want)):
        assert g["epoch"] == w["epoch"], e
        assert g["labels"] == w["labels"], e
        assert g["degree"] == w["degree"], e
        assert g["neighbors"] == w["neighbors"], e
        assert g["has_edge"] == w["has_edge"], e
    assert got[4][-1]["has_edge"] is not None and got[4][-1]["labels"]
    assert got[4][-1]["epoch"] == -(-len(STREAM) // CHUNK) - 1   # pipelined
    # one resolve a position and batch, each over its 2 shards' tables
    assert {n for n, _ in resolves} == {2, 8}
    view = runs[4].query()
    resolves.clear()
    view.degree_batch(labels[:5])
    assert resolves == [(2, torch.device("cpu"))] * 4


def test_has_edge_by_shard_names_the_owner_at_4_positions():
    labels, pairs = labels_and_pairs()
    p = ShardedSummarizer(EngineConfig(**QCFG), mesh=EngineMesh(["cpu"] * 4),
                          n_shards=SHARDS, router_chunk=CHUNK)
    p.process(STREAM)
    p.flush()
    view = p.query()
    live = p.live_edges()
    by_shard = view.has_edge_by_shard(pairs)
    assert by_shard.shape == (SHARDS, len(pairs))
    for i, (u, v) in enumerate(pairs):
        owners = [s for s in range(SHARDS) if by_shard[s, i]]
        if (min(u, v), max(u, v)) in live:
            assert owners == [p.shard_of(u, v)]
        else:
            assert owners == []
