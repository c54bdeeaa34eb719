"""PyTorch port: sharded checkpoints crossing between the port and JAX.

The port's ``ShardedSummarizer`` (2 shards, ``router_chunk`` 32, device
routing, pipelined, on the CPU) against the JAX package's
(``trial_backend="xla"``, ``replica_exec="map"``) over
``tests/test_recovery.py``'s stream: the uninterrupted runs are equal in
every replica and intern leaf (the stacked archive keys), the folded hash
-> label map, the drain telemetry and ``stats()``; a directory JAX wrote,
killed at a chunk boundary, is recovered by the port (restore + journal
replay) and continued, and one the port wrote is recovered by JAX, each
landing bitwise on JAX's uninterrupted run; the port's final save
restores in JAX.  Tolerance: exact.
"""
import pytest

torch = pytest.importorskip("torch")

from repro.core.engine import ShardedSummarizer as JaxSharded  # noqa: E402
from repro.core.engine.state import EngineConfig as JaxConfig  # noqa: E402
from repro.ft import inject as jax_inject  # noqa: E402
from repro_torch.ft import inject  # noqa: E402
from test_torch_recovery import CFG, make_stream  # noqa: E402
from test_torch_recovery_sharded import (CHUNK, N, assert_same,  # noqa: E402
                                         port, snapshot)


def jax_sharded(ckpt_dir=None):
    return JaxSharded(JaxConfig(**CFG), n_shards=2, router_chunk=CHUNK,
                      trial_backend="xla", replica_exec="map",
                      checkpoint_dir=ckpt_dir)


@pytest.fixture(scope="module")
def jax_ref():
    ref = jax_sharded()
    jax_inject.drive(ref, make_stream(N))
    return snapshot(ref)


def test_uninterrupted_runs_equal(jax_ref):
    ref = port()
    inject.drive(ref, make_stream(N))
    assert_same(ref, jax_ref, "uninterrupted")


def test_jax_sharded_directory_recovered_by_the_port(tmp_path, jax_ref):
    stream = make_stream(N)
    d = str(tmp_path)
    with pytest.raises(jax_inject.SimulatedCrash):
        jax_inject.drive(jax_sharded(d), stream, ckpt_every=2,
                         kill_at_chunk=3)
    rec = port(d)
    info = rec.recover()
    assert (info["epoch"], info["replayed_chunks"]) == (2, 1)
    inject.drive(rec, stream, start=rec.stream_cursor)
    assert_same(rec, jax_ref, "JAX's directory, continued by the port")
    rec.save()                              # and back: JAX restores it
    back = jax_sharded(d)
    assert back.restore()["epoch"] == 5
    assert_same(back, jax_ref, "the port's final save, restored by JAX")


def test_port_sharded_checkpoint_restored_by_jax(tmp_path, jax_ref):
    stream = make_stream(N)
    d = str(tmp_path)
    with pytest.raises(inject.SimulatedCrash):
        inject.drive(port(d), stream, ckpt_every=2, kill_at_chunk=5)
    rec = jax_sharded(d)
    info = rec.recover()
    assert (info["epoch"], info["replayed_chunks"]) == (4, 1)
    jax_inject.drive(rec, stream, start=rec.stream_cursor)
    assert_same(rec, jax_ref, "the port's directory, continued by JAX")
