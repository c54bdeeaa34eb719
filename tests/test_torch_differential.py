"""PyTorch port: the Tier-B engine against the port's own Tier-A reference.

The pattern of ``tests/test_differential.py``, with both tiers taken from
the port: one fully dynamic SBM stream drives ``BatchedSummarizer(...,
device="cpu")`` and ``repro_torch.core.reference`` side by side; after
every engine batch both must satisfy ``phi == |P| + |C+| + |C-|`` (the
weighted phi under the weighted objective) and decode losslessly to the
exact live edge set.  Plus the final-phi band, a property over stream
seeds and densities (the port's ``proptest`` shim), and the ``magsdm``
and ``weighted`` policies against their own references, on the JAX
file's streams.  Tolerance: exact (integers).
"""
import pytest

pytest.importorskip("torch")

from conftest import ground_truth_edges  # noqa: E402
from repro_torch.core.engine import BatchedSummarizer  # noqa: E402
from repro_torch.core.engine.state import EngineConfig  # noqa: E402
from repro_torch.core.reference import (DynamicSummary, MoSSoMags,  # noqa: E402
                                        WeightedDynamicSummary,
                                        host_node_weight)
from repro_torch.core.summary import pair_key  # noqa: E402
from repro_torch.graph.streams import (edges_to_fully_dynamic_stream,  # noqa: E402
                                       sbm_edges)
from repro_torch.testing.proptest import given, settings  # noqa: E402
from repro_torch.testing.proptest import strategies as st  # noqa: E402


def _cfg(**kw):
    base = dict(n_cap=256, m_cap=2048, d_cap=48, sn_cap=32, c=8, batch=16,
                escape=0.3)
    base.update(kw)
    return EngineConfig(**base)


def _drive(cfg, stream, ref, on_change, ref_phi, eng_phi):
    """Both tiers over the stream; after every engine batch each tier's
    live phi equals its materialized and its recomputed phi, and both
    decode to the live edge set.  Returns the engine and that set."""
    bs = BatchedSummarizer(cfg, device="cpu")
    live = set()
    for off in range(0, len(stream), cfg.batch):
        chunk = stream[off:off + cfg.batch]
        bs.process(chunk)
        for (u, v, ins) in chunk:
            on_change(u, v, ins)
            (live.add if ins else live.discard)(pair_key(u, v))
        tag = f"off={off}"
        ref_mat = ref.materialize()
        assert ref.phi == ref_phi(ref_mat) == ref.phi_recomputed(), tag
        eng_mat = bs.materialize()
        assert bs.phi == eng_phi(eng_mat) == bs.phi_recomputed(), tag
        assert ref_mat.decode_edges() == live, tag
        assert eng_mat.decode_edges() == {
            pair_key(bs._ids[u], bs._ids[v]) for (u, v) in live}, tag
    assert live == ground_truth_edges(stream)
    return bs, live


def _plain_ref():
    ref = DynamicSummary()
    return ref, lambda u, v, ins: (ref.insert if ins else ref.delete)(u, v)


@pytest.mark.parametrize("seed", [0, 1])
def test_differential_tier_a_vs_tier_b_batchwise(seed):
    edges = sbm_edges(40, 4, 0.55, 0.04, seed=seed)
    stream = edges_to_fully_dynamic_stream(edges, delete_prob=0.15,
                                           seed=seed + 1)
    ref, on_change = _plain_ref()
    bs, live = _drive(_cfg(), stream, ref, on_change, lambda m: m.phi,
                      lambda m: m.phi)
    # both tiers end bounded by |E| (phi <= |E| under the optimal encoding)
    assert ref.phi <= len(live) and bs.phi <= len(live)
    assert bs.stats()["accepted"] > 0       # the engine moved nodes


def test_differential_final_phi_within_band():
    """Tier-B phi lands at or below the trivial encoding that Tier A keeps
    without moves: the trial engine may only improve on it."""
    edges = sbm_edges(48, 4, 0.6, 0.03, seed=5)
    stream = edges_to_fully_dynamic_stream(edges, delete_prob=0.1, seed=6)
    bs = BatchedSummarizer(_cfg(c=12), device="cpu").run(stream)
    ref, on_change = _plain_ref()
    for (u, v, ins) in stream:
        on_change(u, v, ins)
    n_live = len(ground_truth_edges(stream))
    assert 0 < bs.phi <= n_live
    assert ref.phi == n_live    # no moves: the reference stays trivial
    assert bs.phi < ref.phi


@settings(max_examples=4, deadline=None)
@given(st.integers(0, 9999), st.integers(2, 4))
def test_engine_matches_reference_batchwise_property(seed, deg):
    """For any stream seed and density, both tiers meet the Tier-A bar
    after every batch (one config for every example)."""
    edges = sbm_edges(28, deg, 0.5, 0.06, seed=seed)
    stream = edges_to_fully_dynamic_stream(edges, delete_prob=0.2,
                                           seed=seed + 1)
    ref, on_change = _plain_ref()
    _drive(_cfg(n_cap=128, m_cap=1024, batch=8, c=6), stream, ref, on_change,
           lambda m: m.phi, lambda m: m.phi)


def test_magsdm_engine_matches_reference_batchwise():
    """``proposal="magsdm"`` against its own host reference (``MoSSoMags``
    with trials) on one stream, batch by batch."""
    edges = sbm_edges(40, 4, 0.55, 0.04, seed=31)
    stream = edges_to_fully_dynamic_stream(edges, delete_prob=0.15, seed=32)
    algo = MoSSoMags(seed=0, c=24)
    bs, live = _drive(_cfg(proposal="magsdm"), stream, algo.s, algo.process,
                      lambda m: m.phi, lambda m: m.phi)
    assert bs.phi <= len(live) and algo.s.phi <= len(live)
    assert int(bs.state.n_accept) > 0       # the variant moved nodes


def test_weighted_engine_matches_reference_batchwise():
    """``objective="weighted"`` against a ``WeightedDynamicSummary`` that
    weighs caller labels through the engine's intern order, so both tiers
    price a node alike; weights move encodings, never the edge set."""
    levels = 3
    edges = sbm_edges(40, 4, 0.55, 0.04, seed=33)
    stream = edges_to_fully_dynamic_stream(edges, delete_prob=0.15, seed=34)
    interned = {}
    for (u, v, _) in stream:            # the engine's first-appearance ids
        for x in (u, v):
            interned.setdefault(x, len(interned))
    ref = WeightedDynamicSummary(
        weight_levels=levels,
        node_weight=lambda lab: host_node_weight(interned[lab], levels))
    _drive(_cfg(objective="weighted", weight_levels=levels), stream, ref,
           lambda u, v, ins: (ref.insert if ins else ref.delete)(u, v),
           lambda m: m.phi_weighted(ref._w),
           lambda m: m.phi_weighted(lambda d: host_node_weight(d, levels)))
