"""PyTorch port: crash recovery of the sharded tier, bitwise.

The recovery bar of ``tests/test_recovery.py`` on the port's
``ShardedSummarizer`` (2 shards, ``router_chunk`` 32, device routing,
pipelined) on the CPU: killed at every chunk boundary and recovered by a
fresh summarizer, it equals the uninterrupted run at the kill point and at
the end in every replica and intern leaf (the stacked archive keys), the
folded hash -> label map, the drain telemetry and ``stats()``, and its
reads are identical (the uninterrupted run equals the JAX package's:
``tests/test_torch_recovery_sharded_jax.py``).  Pinned manifest entries
(``n_shards``, ``router_chunk``, an unguaranteed drain geometry) refuse a
restore, routing does not; a sharded query view taken before a restore is
fenced.  Tolerance: exact.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.checkpoint.summary import ConfigMismatchError  # noqa: E402
from repro_torch.core.engine import EngineConfig  # noqa: E402
from repro_torch.core.engine import ShardedSummarizer  # noqa: E402
from repro_torch.ft import inject  # noqa: E402
from test_torch_recovery import CFG, flat, labels_of, make_stream  # noqa: E402

CHUNK = 32
N = 160                                     # 5 chunks


def port(ckpt_dir=None, **kw):
    kw.setdefault("n_shards", 2)
    kw.setdefault("router_chunk", CHUNK)
    return ShardedSummarizer(EngineConfig(**CFG), device="cpu",
                             checkpoint_dir=ckpt_dir, **kw)


def snapshot(summ) -> tuple:
    """Tree by archive key, host closure (telemetry as a list) and
    ``stats()`` less ``stream_retries``, after a flush."""
    summ.flush()
    host = dict(summ._ckpt_host())
    drain = np.asarray(host.pop("drain_rounds"))
    assert drain.dtype == np.int32
    host["drain_rounds"] = drain.tolist()
    stats = summ.stats()
    stats.pop("stream_retries")
    return flat(summ), host, stats


def assert_same(a, b, tag="") -> None:
    (fa, ha, sa), (fb, hb, sb) = (x if isinstance(x, tuple) else snapshot(x)
                                  for x in (a, b))
    assert sorted(fa) == sorted(fb), tag
    for k in fa:
        assert fa[k].dtype == fb[k].dtype, (tag, k)
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=f"{tag} {k}")
    assert ha == hb, tag
    assert sa == sb, tag


def reads(summ, labels) -> tuple:
    q = summ.query()
    return (q.degree_batch(labels), q.neighbors_batch(labels),
            q.has_edge_batch(list(zip(labels, labels[1:]))))


@pytest.fixture(scope="module")
def port_ref():
    ref = port()
    inject.drive(ref, make_stream(N))
    return ref


def test_sharded_kill_at_every_chunk_boundary_bitwise(tmp_path, port_ref):
    stream = make_stream(N)
    run = port()
    snaps = []
    for off in range(0, N, CHUNK):
        run.process(stream[off:off + CHUNK])
        snaps.append(snapshot(run))
    assert len(snaps) == 5
    want = snapshot(port_ref)
    labels = labels_of(stream)
    want_reads = reads(port_ref, labels)
    for k in range(len(snaps) + 1):
        d = str(tmp_path / f"k{k}")
        with pytest.raises(inject.SimulatedCrash):
            inject.drive(port(d), stream, ckpt_every=2, kill_at_chunk=k)
        rec = port(d)
        rec.recover()
        assert rec.stream_cursor == k * CHUNK
        if k:
            assert_same(rec, snaps[k - 1], f"kill {k}")
        inject.drive(rec, stream, start=rec.stream_cursor)
        assert_same(rec, want, f"kill {k}, continued")
        assert reads(rec, labels) == want_reads, k


def test_query_answers_survive_mid_stream_recovery(tmp_path):
    """Reads of the recovered engine at the kill point equal reads of an
    uninterrupted run over the same prefix."""
    stream = make_stream(N)
    k, cut = 3, 3 * CHUNK
    prefix = port()
    prefix.process(stream[:cut])
    want = reads(prefix, labels_of(stream[:cut]))
    d = str(tmp_path)
    with pytest.raises(inject.SimulatedCrash):
        inject.drive(port(d), stream, ckpt_every=2, kill_at_chunk=k)
    rec = port(d)
    info = rec.recover()
    assert (info["epoch"], info["replayed_chunks"]) == (2, 1)
    assert reads(rec, labels_of(stream[:cut])) == want


def test_restore_refuses_different_n_shards_or_chunk(tmp_path):
    d = str(tmp_path)
    s = port(d)
    s.process(make_stream(64))
    s.save()
    with pytest.raises(ConfigMismatchError, match="n_shards"):
        port(d, n_shards=4).restore()
    with pytest.raises(ConfigMismatchError, match="router_chunk"):
        port(d, router_chunk=64).restore()
    # routing is an execution variant: recorded, not pinned
    host = port(d, routing="host")
    host.restore()
    (fa, ha, _), (fb, hb, _) = snapshot(host), snapshot(s)
    assert_same((fa, ha, None), (fb, hb, None), "restored, host routing")


def test_unguaranteed_drain_geometry_is_pinned(tmp_path):
    d = str(tmp_path)
    s = port(d, lane_cap=8, max_drain_rounds=1)
    assert not s.router_geometry.drain_guaranteed
    s.process(make_stream(64))
    s.save()
    with pytest.raises(ConfigMismatchError, match="drain_geometry"):
        port(d, lane_cap=16, max_drain_rounds=1).restore()
    same = port(d, lane_cap=8, max_drain_rounds=1)
    same.restore()
    assert same.stats()["router_overflows"] == s.stats()["router_overflows"]


def test_stale_sharded_query_view_fenced_after_restore(tmp_path):
    stream = make_stream(N)
    d = str(tmp_path)
    s = port(d)
    s.process(stream)
    s.save()
    lab = labels_of(stream, 1)[0]
    stale = s.query()
    want = stale.degree(lab)
    s.restore()
    for read in (lambda: stale.degree(lab), lambda: stale.neighbors(lab),
                 lambda: stale.has_edge(lab, lab), stale.seen_labels):
        with pytest.raises(RuntimeError,
                           match="predates a checkpoint restore"):
            read()
    assert s.query().degree(lab) == want     # a fresh view works
