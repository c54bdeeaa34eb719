"""PyTorch port: crash recovery of the batched tier, bitwise, against JAX.

The contract of ``repro_torch/checkpoint/summary.py`` (the JAX package's,
``tests/test_recovery.py``): a summarizer killed at ANY chunk boundary and
recovered from its directory — latest valid epoch + journal replay — is
leaf-bitwise equal to the uninterrupted run, at the kill point and after
continuing to the end, and its reads are identical.  Here on the port's
``BatchedSummarizer`` on the CPU, with the JAX package's as the reference
(``trial_backend="xla"``, ``tests/test_recovery.py``'s ``CFG`` and
stream): the port's uninterrupted run equals JAX's; a directory JAX
wrote is recovered by the port and one the port wrote by JAX, each
continuing bitwise to JAX's final state; config mismatches are refused;
a query view taken before a restore is fenced; the retry driver counts
retries and gives up past ``max_failures``.  Tolerance: exact.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpoint import checkpointer as jax_ckpt  # noqa: E402
from repro.core.engine import BatchedSummarizer as JaxBatched  # noqa: E402
from repro.core.engine.state import EngineConfig as JaxConfig  # noqa: E402
from repro.ft import inject as jax_inject  # noqa: E402
from repro.graph.streams import (edges_to_fully_dynamic_stream,  # noqa: E402
                                 sbm_edges)
from repro_torch.checkpoint import checkpointer  # noqa: E402
from repro_torch.checkpoint.summary import ConfigMismatchError  # noqa: E402
from repro_torch.core.engine import (BatchedSummarizer,  # noqa: E402
                                     EngineConfig, ShardedSummarizer)
from repro_torch.ft import inject  # noqa: E402
from repro_torch.ft.resilience import run_stream_with_recovery  # noqa: E402

CFG = dict(n_cap=160, m_cap=1024, d_cap=48, sn_cap=32, c=8, batch=8,
           escape=0.3)


def make_stream(n=56):
    edges = sbm_edges(44, 4, 0.5, 0.05, seed=11)
    return edges_to_fully_dynamic_stream(edges, delete_prob=0.2, seed=11)[:n]


def labels_of(stream, k=10):
    seen = []
    for (u, v, _ins) in stream:
        for lab in (u, v):
            if lab not in seen:
                seen.append(lab)
    return seen[:k]


def flat(summ) -> dict:
    """A summarizer's recovery tree by archive key, as numpy (either
    package)."""
    tree = summ._ckpt_tree()
    if isinstance(summ, (BatchedSummarizer, ShardedSummarizer)):
        return checkpointer._flatten(tree)
    return {k: np.asarray(v) for k, v in jax_ckpt._flatten(tree).items()}


def snapshot(summ) -> tuple:
    """What recovery must reproduce: the tree by archive key, the host
    closure and ``stats()`` less ``stream_retries``."""
    stats = summ.stats()
    stats.pop("stream_retries")
    return flat(summ), summ._ckpt_host(), stats


def assert_same(a, b, tag="") -> None:
    """Two summarizers (or snapshots) equal leaf for leaf, dtypes too."""
    (fa, ha, sa), (fb, hb, sb) = (x if isinstance(x, tuple) else snapshot(x)
                                  for x in (a, b))
    assert sorted(fa) == sorted(fb), tag
    for k in fa:
        assert fa[k].dtype == fb[k].dtype, (tag, k)
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=f"{tag} {k}")
    assert ha == hb, tag
    assert sa == sb, tag


def port(ckpt_dir=None, **kw):
    return BatchedSummarizer(EngineConfig(**CFG), device="cpu",
                             checkpoint_dir=ckpt_dir, **kw)


def jax_batched(ckpt_dir=None):
    return JaxBatched(JaxConfig(**CFG), trial_backend="xla",
                      checkpoint_dir=ckpt_dir)


@pytest.fixture(scope="module")
def jax_ref():
    ref = jax_batched()
    jax_inject.drive(ref, make_stream())
    return ref


@pytest.fixture(scope="module")
def port_ref(jax_ref):
    ref = port()
    inject.drive(ref, make_stream())
    assert_same(ref, jax_ref, "uninterrupted")
    return ref


# --------------------------------------------------------------------------- #
# the bar: kill at EVERY chunk boundary, recover, bitwise-match
# --------------------------------------------------------------------------- #


def test_batched_kill_at_every_chunk_boundary_bitwise(tmp_path, port_ref):
    stream = make_stream()
    run = port()
    snaps = []
    for off in range(0, len(stream), CFG["batch"]):
        run.process(stream[off:off + CFG["batch"]])
        snaps.append(snapshot(run))
    assert len(snaps) == 7
    labels = labels_of(stream)
    want_reads = port_ref.query().degree_batch(labels)
    for k in range(len(snaps) + 1):      # incl. a kill after the last one
        d = str(tmp_path / f"k{k}")
        with pytest.raises(inject.SimulatedCrash):
            inject.drive(port(d), stream, ckpt_every=2, kill_at_chunk=k)
        rec = port(d)
        info = rec.recover()
        assert rec.stream_cursor == k * CFG["batch"], info
        assert info["replayed_chunks"] == (k % 2 if k else 0), info
        if k:
            assert_same(rec, snaps[k - 1], f"kill {k}")
        inject.drive(rec, stream, start=rec.stream_cursor)
        assert_same(rec, port_ref, f"kill {k}, continued")
        assert rec.query().degree_batch(labels) == want_reads


def test_jax_directory_recovered_by_the_port(tmp_path, jax_ref):
    stream = make_stream()
    d = str(tmp_path)
    with pytest.raises(jax_inject.SimulatedCrash):
        jax_inject.drive(jax_batched(d), stream, ckpt_every=2,
                         kill_at_chunk=5)
    rec = port(d)
    info = rec.recover()
    assert (info["epoch"], info["replayed_chunks"]) == (4, 1)
    assert rec.stream_cursor == 5 * CFG["batch"]
    inject.drive(rec, stream, ckpt_every=2, start=rec.stream_cursor)
    assert_same(rec, jax_ref, "JAX's directory, continued by the port")
    # the port's save into JAX's directory restores in JAX
    rec.save()
    back = jax_batched(d)
    assert back.restore()["epoch"] == 7
    assert_same(back, jax_ref, "the port's final save, restored by JAX")


def test_port_checkpoint_restored_by_jax(tmp_path, jax_ref):
    stream = make_stream()
    d = str(tmp_path)
    with pytest.raises(inject.SimulatedCrash):
        inject.drive(port(d), stream, ckpt_every=2, kill_at_chunk=3)
    rec = jax_batched(d)
    info = rec.recover()
    assert (info["epoch"], info["replayed_chunks"]) == (2, 1)
    jax_inject.drive(rec, stream, start=rec.stream_cursor)
    assert_same(rec, jax_ref, "the port's directory, continued by JAX")


def dir_contents(root) -> dict:
    """Every file under ``root`` by relative path: an ``arrays.npz`` by
    its arrays (the zip's own timestamps aside), any other file by its
    bytes."""
    import pathlib
    out = {}
    for path in sorted(pathlib.Path(root).rglob("*")):
        if not path.is_file():
            continue
        rel = str(path.relative_to(root))
        if path.name == "arrays.npz":
            with np.load(path) as z:
                out[rel] = {k: z[k] for k in z.files}
        else:
            out[rel] = path.read_bytes()
    return out


def test_copy_at_a_boundary_is_what_a_kill_there_leaves(tmp_path):
    """``chip_smoke.py``'s phase 13 recovers a copy of an uninterrupted
    run's directory, taken after chunk 3 and before that run's save at
    the boundary, in place of a run killed there: the copy and the kill's
    directory hold the same files, recover to the same info and leaves,
    and continue to the same end."""
    import shutil
    stream = make_stream()
    b = CFG["batch"]
    run, kill = str(tmp_path / "run"), str(tmp_path / "kill")
    copy = str(tmp_path / "copy")
    live = port(run)
    for i in range(3):
        live.process(stream[i * b:(i + 1) * b])
        if i + 1 == 2:
            live.save()
    shutil.copytree(run, copy)
    live.save()                          # the run goes on past the copy
    with pytest.raises(inject.SimulatedCrash):
        inject.drive(port(kill), stream, ckpt_every=2, kill_at_chunk=3)
    got, want = dir_contents(copy), dir_contents(kill)
    assert sorted(got) == sorted(want)
    for rel, value in want.items():
        if isinstance(value, dict):
            assert sorted(got[rel]) == sorted(value), rel
            for key, arr in value.items():
                assert got[rel][key].dtype == arr.dtype, (rel, key)
                np.testing.assert_array_equal(got[rel][key], arr,
                                              err_msg=f"{rel} {key}")
        else:
            assert got[rel] == value, rel
    recs = [port(d) for d in (copy, kill)]
    infos = [r.recover() for r in recs]
    assert infos[0] == infos[1]
    assert (infos[0]["epoch"], infos[0]["replayed_chunks"]) == (2, 1)
    assert_same(recs[0], recs[1], "copy vs kill, recovered")
    for r in recs:
        inject.drive(r, stream, start=r.stream_cursor)
    assert_same(recs[0], recs[1], "copy vs kill, continued")


# --------------------------------------------------------------------------- #
# manifest pins, query fence, retry driver
# --------------------------------------------------------------------------- #


def test_restore_refuses_different_policy_triple(tmp_path):
    d = str(tmp_path)
    s = port(d)
    s.process(make_stream(16))
    s.save()
    other = BatchedSummarizer(EngineConfig(**CFG, commit="threshold"),
                              device="cpu", checkpoint_dir=d)
    with pytest.raises(ConfigMismatchError, match="config"):
        other.restore()


def test_restore_refuses_batched_into_sharded(tmp_path):
    d = str(tmp_path)
    s = port(d)
    s.process(make_stream(16))
    s.save()
    sharded = ShardedSummarizer(EngineConfig(**CFG), device="cpu",
                                n_shards=2, router_chunk=32,
                                checkpoint_dir=d)
    with pytest.raises(ConfigMismatchError, match="tier"):
        sharded.restore()


def test_stale_query_view_fenced_after_restore(tmp_path):
    stream = make_stream()
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


def test_run_stream_with_recovery_counts_retries(tmp_path, port_ref):
    stream = make_stream()

    class Flaky(BatchedSummarizer):
        crashes = [3, 5]                    # shared across rebuilds

        def process(self, changes):
            if self.crashes and self._journal_seq == self.crashes[0]:
                self.crashes.pop(0)
                raise RuntimeError("injected engine fault")
            super().process(changes)

    s = run_stream_with_recovery(
        lambda: Flaky(EngineConfig(**CFG), device="cpu",
                      checkpoint_dir=str(tmp_path)),
        stream, str(tmp_path), ckpt_every=2, sleep=lambda _t: None)
    assert s.stats()["stream_retries"] == 2
    assert_same(s, port_ref, "after two retries")
    # the final save() leaves a resumable epoch at the end of the stream
    rec = port(str(tmp_path))
    info = rec.recover()
    assert rec.stream_cursor == len(stream) and info["replayed_chunks"] == 0
    assert_same(rec, port_ref, "resumed at the end")


def test_retry_loop_gives_up_past_max_failures(tmp_path):
    class Doomed(BatchedSummarizer):
        def process(self, changes):
            raise RuntimeError("always fails")

    slept = []
    with pytest.raises(RuntimeError, match="always fails"):
        run_stream_with_recovery(
            lambda: Doomed(EngineConfig(**CFG), device="cpu",
                           checkpoint_dir=str(tmp_path)),
            make_stream(), str(tmp_path), ckpt_every=2, max_failures=2,
            sleep=slept.append)
    assert slept == [0.05, 0.1]              # bounded exponential backoff


def test_no_checkpoint_dir_means_no_journal(tmp_path, monkeypatch):
    """Without a directory the hooks only count: nothing is written."""
    monkeypatch.chdir(tmp_path)
    s = port()
    s.process(make_stream(24))
    assert (s._journal_seq, s.stream_cursor, s._journal) == (3, 24, None)
    assert list(tmp_path.iterdir()) == []
    with pytest.raises(ValueError, match="no checkpoint directory"):
        s.save()
