"""PyTorch port: ``replica_exec="vmap"``, the stacked replicas stepped as
one batch, against ``"map"`` and the JAX package.

``"vmap"`` against ``"map"`` at 1 and 3 shards, leaf for leaf after every
``process`` call, with no more host reads (the card's syncs); ``step_fn``
on a stacked state of three replicas against three unstacked steps and
JAX's ``make_step`` on each row; ``stack_states`` / ``state_rows`` (rows
are views); and a checkpoint saved under ``"vmap"`` restored under
``"map"`` and by JAX's ``ShardedSummarizer``.  The port's ``"vmap"``
against JAX's ``ShardedSummarizer`` after every call, on the device,
host and key-skewed streams and the non-default triple, is in
``test_torch_router.py``, which has compiled those JAX stages already;
nothing here compiles JAX's vmapped step.  Tolerance: exact.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from repro.core.engine.hashtable import HashTable as JaxTable  # noqa: E402
from repro.core.engine.state import EngineConfig as JaxConfig  # noqa: E402
from repro.core.engine.state import EngineState as JaxState  # noqa: E402
from repro.core.engine.trial import make_step  # noqa: E402
from repro_torch.core.engine import BatchedSummarizer  # noqa: E402
from repro_torch.core.engine import EngineConfig  # noqa: E402
from repro_torch.core.engine import ShardedSummarizer  # noqa: E402
from repro_torch.core.engine.ops import host_read  # noqa: E402
from repro_torch.core.engine.state import (copy_state,  # noqa: E402
                                           stack_states, state_rows,
                                           state_to_numpy)
from repro_torch.core.engine.trial import step_fn  # noqa: E402
from repro_torch.dist import router  # noqa: E402
from repro_torch.ft import inject  # noqa: E402
from test_torch_engine import assert_leaves_equal, jax_leaves  # noqa: E402
from test_torch_recovery import make_stream  # noqa: E402
from test_torch_recovery_sharded import N, assert_same, port  # noqa: E402
from test_torch_recovery_sharded_jax import jax_sharded  # noqa: E402
from test_torch_router import CFG, CHUNK, ba_stream  # noqa: E402


def leaves(p: ShardedSummarizer) -> tuple:
    return router.sharded_state_to_numpy(p._est, p._ist)


def assert_same_leaves(a: tuple, b: tuple, tag: str) -> None:
    assert_leaves_equal(a[0], b[0], f"{tag}: engine")
    assert_leaves_equal(a[1], b[1], f"{tag}: intern")


# --------------------------------------------------------------------------- #
# the port on its own: "vmap" against "map"
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("n_shards", [1, 3])
def test_vmap_equals_map_with_no_more_host_reads(n_shards):
    """Leaf-bitwise after every call; the host reads (the card's syncs)
    of "vmap" at most those of "map" on the same stream, fewer with
    several replicas."""
    stream = ba_stream(5)
    runs, reads = {}, {}
    for mode in ("map", "vmap"):
        p = ShardedSummarizer(EngineConfig(**CFG), device="cpu",
                              n_shards=n_shards, router_chunk=CHUNK,
                              replica_exec=mode)
        host_read.count = 0
        snaps = []
        for off in range(0, len(stream), CHUNK):
            p.process(stream[off:off + CHUNK])
            p.flush()
            snaps.append(leaves(p))
        reads[mode], runs[mode] = host_read.count, (p, snaps)
    (pm, sm), (pv, sv) = runs["map"], runs["vmap"]
    for n, (a, b) in enumerate(zip(sm, sv)):
        assert_same_leaves(b, a, f"call {n}")
    assert pv.stats() == pm.stats()
    assert pv.materialize().decode_edges() == pm.materialize().decode_edges()
    assert reads["vmap"] <= reads["map"], reads
    if n_shards > 1:
        assert reads["vmap"] < reads["map"], reads


def _rows_after(n_batches: int):
    """Three different engine states: one summarizer each, over the first
    ``n_batches`` batches of its own stream."""
    cfg = EngineConfig(**CFG)
    out = []
    for seed in range(3):
        bs = BatchedSummarizer(cfg, device="cpu")
        stream = ba_stream(seed)
        bs.process(stream[:n_batches * cfg.batch])
        out.append(bs)
    return cfg, out


def _jax_state(leaves: dict) -> JaxState:
    return JaxState(**{k: JaxTable(*(jnp.asarray(v[w])
                                     for w in ("k1", "k2", "val")))
                       if isinstance(v, dict) else jnp.asarray(v)
                       for k, v in leaves.items()})


def test_stacked_step_equals_three_steps_and_jax_per_row():
    cfg, summs = _rows_after(3)
    stacked = stack_states([s.state for s in summs])
    b = cfg.batch
    rng = np.random.default_rng(0)
    u = rng.integers(0, 40, (3, b)).astype(np.int32)
    v = (u + rng.integers(1, 40, (3, b))).astype(np.int32) % 40
    ins = rng.random((3, b)) < 0.7
    u[1, b // 2:] = v[1, b // 2:] = -1      # a padded tail in one replica
    u[2] = v[2] = -1                        # a replica with no change
    # a delete of a live edge in row 0, beside inserts of the others
    live = sorted(summs[0].live_edges())[0]
    u[0, 0], v[0, 0], ins[0, 0] = live[0], live[1], False
    jstep = make_step(JaxConfig(**CFG), trial_backend="xla")
    before = [state_to_numpy(copy_state(s.state)) for s in summs]
    step_fn(stacked, u, v, ins, cfg)
    for r, s in enumerate(summs):
        step_fn(s.state, u[r], v[r], ins[r], cfg)
        want = jax_leaves(jstep(_jax_state(before[r]), jnp.asarray(u[r]),
                                jnp.asarray(v[r]), jnp.asarray(ins[r])))
        got = state_to_numpy(state_rows(stacked)[r])
        assert_leaves_equal(got, state_to_numpy(s.state), f"row {r}")
        assert_leaves_equal(got, want, f"row {r} vs JAX")
    assert int(stacked.n_trials[0]) > int(before[0]["n_trials"])


def test_stack_states_and_rows_round_trip_as_views():
    _, summs = _rows_after(2)
    states = [s.state for s in summs]
    stacked = stack_states(states)
    assert stacked.adj.k1.shape == (3, *states[0].adj.k1.shape)
    assert stacked.step_no.shape == (3,)
    rows = state_rows(stacked)
    for r, (row, st) in enumerate(zip(rows, states)):
        assert_leaves_equal(state_to_numpy(row), state_to_numpy(st),
                            f"row {r}")
        assert row.adj.k1.data_ptr() == stacked.adj.k1[r].data_ptr()
        assert row.phi.data_ptr() == stacked.phi[r].data_ptr()
    rows[1].phi += 5                        # a row's write is the stack's
    assert int(stacked.phi[1]) == int(states[1].phi) + 5
    ists = [router.intern_new(EngineConfig(**CFG), "cpu") for _ in range(2)]
    irows = state_rows(stack_states(ists))
    assert len(irows) == 2 and irows[0].l2h.shape == ists[0].l2h.shape


# --------------------------------------------------------------------------- #
# checkpoints across the modes and packages
# --------------------------------------------------------------------------- #


def test_vmap_checkpoint_restores_under_map_and_into_jax(tmp_path):
    d = str(tmp_path)
    ref = port(d, replica_exec="vmap")
    inject.drive(ref, make_stream(N))
    ref.save()
    back = port(replica_exec="map")
    assert back.restore(d)["epoch"] == ref.flush_epoch
    assert_same(back, ref, "vmap's save, restored under map")
    jax_back = jax_sharded(d)
    assert jax_back.restore()["epoch"] == ref.flush_epoch
    assert_same(jax_back, ref, "vmap's save, restored by JAX")
    d2 = str(tmp_path / "jax")             # and JAX's save, under vmap
    jax_back.save(d2)
    again = port(replica_exec="vmap")
    assert again.restore(d2)["epoch"] == ref.flush_epoch
    assert_same(again, ref, "JAX's save, restored under vmap")
    # and on: the restored map replica steps on equal to vmap's
    more = make_stream(N + CHUNK)[N:]
    assert len(more) == CHUNK
    for s in (ref, back, again):
        s.process(more)
    assert_same(back, ref, "continued under map")
    assert_same(again, ref, "continued under vmap")
