"""PyTorch port: the batched engine, leaf-bitwise against the JAX engine.

Both engines start from one state (the JAX ``new_state`` carried over
with ``state_from_numpy``) and take the same fully dynamic SBM stream;
after EVERY batch every ``EngineState`` leaf must be bitwise equal, and
the port must also meet the Tier-A bar on its own: ``phi ==
phi_recomputed()`` and a lossless decode to the live edge set.
Tolerance: exact — every value is an integer, or a float32 compare that
must match bit for bit.

The config is the small one of ``tests/test_differential.py``.  This file
drives the default policy triple; ``test_torch_engine_policies.py`` all
eight triples and ``test_torch_engine_pallas.py`` the JAX engine with its
Pallas probe kernel.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.engine.state import EngineConfig as JaxConfig  # noqa: E402
from repro.core.engine.state import new_state as jax_new_state  # noqa: E402
from repro.core.engine.trial import make_step  # noqa: E402
from repro.graph.streams import (edges_to_fully_dynamic_stream,  # noqa: E402
                                 sbm_edges)
from repro_torch.core.engine import BatchedSummarizer  # noqa: E402
from repro_torch.core.engine.ops import recompute_phi  # noqa: E402
from repro_torch.core.engine.state import (EngineConfig,  # noqa: E402
                                           new_state, state_from_numpy,
                                           state_to_numpy)
from repro_torch.core.summary import host_node_weight, pair_key  # noqa: E402

BASE = dict(n_cap=256, m_cap=2048, d_cap=48, sn_cap=32, c=8, batch=16,
            escape=0.3, proposal="minhash", objective="exact")


def jax_leaves(st) -> dict:
    """A JAX EngineState as numpy leaves (tables as k1/k2/val dicts)."""
    out = {}
    for k, v in st._asdict().items():
        if hasattr(v, "k1"):
            out[k] = {w: np.asarray(getattr(v, w))
                      for w in ("k1", "k2", "val")}
        else:
            out[k] = np.asarray(v)
    return out


def assert_leaves_equal(got: dict, want: dict, tag: str) -> None:
    assert got.keys() == want.keys()
    for k in want:
        if isinstance(want[k], dict):
            for w in ("k1", "k2", "val"):
                np.testing.assert_array_equal(got[k][w], want[k][w],
                                              err_msg=f"{tag}: {k}.{w}")
        else:
            assert got[k].dtype == want[k].dtype, f"{tag}: {k} dtype"
            np.testing.assert_array_equal(got[k], want[k],
                                          err_msg=f"{tag}: {k}")


def sbm_stream(seed: int):
    edges = sbm_edges(40, 4, 0.55, 0.04, seed=seed)
    return edges_to_fully_dynamic_stream(edges, delete_prob=0.15,
                                         seed=seed + 1)


def drive_both(kw: dict, stream, trial_backend: str = "xla",
               max_batches=None):
    """Stream through the JAX step and the port's BatchedSummarizer, with
    the leaf-bitwise and Tier-A checks after every batch; returns the
    port's summarizer."""
    jcfg, tcfg = JaxConfig(**kw), EngineConfig(**kw)
    jst = jax_new_state(jcfg)
    step = make_step(jcfg, trial_backend=trial_backend)
    bs = BatchedSummarizer(tcfg, device="cpu")
    bs.state = state_from_numpy(jax_leaves(jst), "cpu")
    b = tcfg.batch
    live = set()
    for n, off in enumerate(range(0, len(stream), b)):
        if max_batches is not None and n == max_batches:
            break
        chunk = stream[off:off + b]
        bs.process(chunk)
        pad = b - len(chunk)
        u = np.array([bs._ids[x] for (x, _, _) in chunk] + [-1] * pad,
                     np.int32)
        v = np.array([bs._ids[y] for (_, y, _) in chunk] + [-1] * pad,
                     np.int32)
        ins = np.array([i for (_, _, i) in chunk] + [False] * pad, bool)
        jst = step(jst, u, v, ins)
        tag = f"{trial_backend} batch {n}"
        assert_leaves_equal(state_to_numpy(bs.state), jax_leaves(jst), tag)
        for (x, y, i) in chunk:
            e = pair_key(x, y)
            live.add(e) if i else live.discard(e)
        mat = bs.materialize()
        mat_phi = (mat.phi_weighted(lambda x: host_node_weight(
            x, tcfg.weight_levels)) if tcfg.objective == "weighted"
            else mat.phi)
        assert bs.phi == mat_phi == bs.phi_recomputed(), tag
        assert int(recompute_phi(bs.state, tcfg)) == bs.phi, tag
        assert mat.decode_edges() == {pair_key(bs._ids[x], bs._ids[y])
                                      for (x, y) in live}, tag
    return bs


@pytest.mark.parametrize("seed", [0, 1])
def test_default_triple_leaf_bitwise_every_batch(seed):
    bs = drive_both(BASE, sbm_stream(seed))
    s = bs.stats()
    assert s["trials"] > 0 and s["accepted"] > 0    # the trials did work
    assert 0 < bs.phi <= bs.num_edges


def test_new_state_and_converter_round_trip():
    for kw in (BASE, dict(BASE, objective="weighted", weight_levels=3)):
        want = jax_leaves(jax_new_state(JaxConfig(**kw)))
        assert_leaves_equal(state_to_numpy(new_state(EngineConfig(**kw),
                                                     "cpu")), want, "new")
        assert_leaves_equal(state_to_numpy(state_from_numpy(want, "cpu")),
                            want, "round trip")


def test_config_matches_jax():
    for kw in (BASE, dict(BASE, m_cap=1 << 23, objective="weighted")):
        t, j = EngineConfig(**kw), JaxConfig(**kw)
        assert t.manifest() == j.manifest()
        assert t.table_caps() == j.table_caps()
    assert [f.name for f in dataclasses.fields(EngineConfig)] == \
        [f.name for f in dataclasses.fields(JaxConfig)]
    with pytest.raises(ValueError, match="proposal"):
        EngineConfig(proposal="nope")


def test_batched_summarizer_api_on_cpu():
    stream = sbm_stream(2)
    bs = BatchedSummarizer(EngineConfig(**BASE), device="cpu").run(stream)
    assert bs.flush_epoch == -(-len(stream) // BASE["batch"])
    live = set()
    for (x, y, i) in stream:
        live.add(pair_key(x, y)) if i else live.discard(pair_key(x, y))
    assert bs.live_edges() == {pair_key(bs._ids[x], bs._ids[y])
                               for (x, y) in live}
    pressure = bs.table_pressure()
    assert set(pressure) == {"adj", "epos", "eab", "snadj", "snpos"}
    before = state_to_numpy(bs.state)
    assert bs.maybe_compact(threshold=0.0)      # rebuild every table
    after = state_to_numpy(bs.state)
    assert bs.live_edges() == {pair_key(bs._ids[x], bs._ids[y])
                               for (x, y) in live}
    assert bs.phi == bs.phi_recomputed()
    for name in pressure:                       # tombstones are gone
        assert (after[name]["k1"] == -2).sum() == 0
        assert ((after[name]["k1"] >= 0).sum()
                == (before[name]["k1"] >= 0).sum())
    with pytest.raises(RuntimeError, match="capacity"):
        BatchedSummarizer(EngineConfig(**dict(BASE, n_cap=4)),
                          device="cpu").process([(i, i + 1, True)
                                                 for i in range(4)])
