"""PyTorch port: every fault case of ``tests/test_recovery.py``, and the
recovering stream driver.

Faults are injected with :mod:`repro_torch.ft.inject` (the JAX package's
file surgery on the same format) into a directory the port's
``BatchedSummarizer`` wrote, crashed at chunk boundary 5 with a checkpoint
every 2 chunks; recovery goes through the public ``recover()``.  Checkpoint
faults: a corrupt newest checkpoint falls back one epoch and the journal
re-earns the gap; all checkpoints corrupt raises; a torn staging directory
is ignored; a dropped payload file is detected.  Journal faults: a torn
tail keeps the valid prefix; a duplicated record is replayed once; a fresh
run resets a stale journal.  Every recovered run, continued, equals the
uninterrupted one leaf for leaf (which ``tests/test_torch_recovery.py``
holds to the JAX package's).  Then ``repro_torch.launch.summarize_stream``
at a small size on the CPU: a sharded run killed mid-stream, recovered,
with identical reads and a bitwise continuation.  Tolerance: exact.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.checkpoint import checkpointer  # noqa: E402
from repro_torch.ft import inject  # noqa: E402
from test_torch_recovery import (CFG, assert_same, make_stream,  # noqa: E402
                                 port, snapshot)


@pytest.fixture(scope="module")
def want():
    ref = port()
    inject.drive(ref, make_stream())
    return snapshot(ref)


def crash_at(d, k=5, ckpt_every=2):
    with pytest.raises(inject.SimulatedCrash):
        inject.drive(port(d), make_stream(), ckpt_every=ckpt_every,
                     kill_at_chunk=k)


def finish(rec):
    inject.drive(rec, make_stream(), start=rec.stream_cursor)
    return rec


# --------------------------------------------------------------------------- #
# checkpoint faults
# --------------------------------------------------------------------------- #


def test_corrupt_newest_checkpoint_falls_back_one_epoch(tmp_path, want):
    d = str(tmp_path)
    crash_at(d)
    newest = inject.latest_checkpoint_step(d)
    assert checkpointer.checkpoint_steps(d) == [2, 4]    # KEEP_EPOCHS
    inject.corrupt_checkpoint_arrays(d, newest)
    rec = port(d)
    info = rec.recover()
    assert info["step"] < newest            # checksum caught it, fell back
    assert info["rejected"] and "integrity" in info["rejected"][0]
    # journal retention reaches back to the surviving epoch, so the replay
    # crosses the gap the corrupt checkpoint left
    assert info["replayed_chunks"] == 3
    assert_same(finish(rec), want, "corrupt newest")


def test_all_checkpoints_corrupt_raises(tmp_path):
    d = str(tmp_path)
    crash_at(d)
    for s in checkpointer.checkpoint_steps(d):
        inject.corrupt_checkpoint_arrays(d, s)
    with pytest.raises(FileNotFoundError, match="no restorable checkpoint"):
        port(d).recover()


def test_torn_staging_directory_is_ignored(tmp_path, want):
    d = str(tmp_path)
    crash_at(d)
    inject.tear_checkpoint_staging(d, inject.latest_checkpoint_step(d))
    rec = port(d)
    info = rec.recover()
    assert not info["rejected"]             # .tmp is invisible, not an error
    assert_same(finish(rec), want, "torn staging")


def test_dropped_payload_file_detected(tmp_path):
    d = str(tmp_path)
    crash_at(d)
    newest = inject.latest_checkpoint_step(d)
    inject.drop_checkpoint_file(d, newest, "host.pkl")
    rec = port(d)
    info = rec.recover()
    assert info["step"] < newest and info["rejected"]


# --------------------------------------------------------------------------- #
# journal faults
# --------------------------------------------------------------------------- #


def test_torn_journal_tail_recovers_valid_prefix(tmp_path, want):
    d = str(tmp_path)
    crash_at(d)                             # 5 chunks journaled, ckpt at 4
    n = inject.journal_record_count(d)
    inject.truncate_journal_tail(d, nbytes=7)
    assert inject.journal_record_count(d) == n - 1
    rec = port(d)
    rec.recover()                           # lost exactly the torn chunk
    assert rec.stream_cursor == (5 - 1) * CFG["batch"]
    assert_same(finish(rec), want, "torn journal")


def test_duplicated_journal_record_deduped(tmp_path, want):
    d = str(tmp_path)
    crash_at(d)
    inject.duplicate_journal_tail(d)
    rec = port(d)
    rec.recover()                           # replayed once, not twice
    assert rec.stream_cursor == 5 * CFG["batch"]
    assert_same(finish(rec), want, "duplicated record")


def test_fresh_run_resets_stale_journal(tmp_path):
    d = str(tmp_path)
    crash_at(d)
    assert inject.journal_record_count(d) > 0
    fresh = port(d)                         # NOT recovered: a new run
    fresh.process(make_stream()[:CFG["batch"]])
    assert inject.journal_record_count(d) == 1


def test_summarize_stream_driver_on_the_cpu(tmp_path, capsys):
    from repro_torch.launch.summarize_stream import main
    d = tmp_path / "ck"
    res = main(["40", "--device", "cpu", "--router-chunk", "32",
                "--checkpoint-dir", str(d)])
    out = capsys.readouterr().out
    assert "query answers identical across recovery" in out
    assert "crash-recover verified: bitwise state match" in out
    assert res["info"]["replayed_chunks"] == 1
    assert res["kill_cursor"] == 3 * 32
    assert res["stats"]["stream_retries"] == 0
    assert checkpointer.latest_valid_step(str(d)) == 2
