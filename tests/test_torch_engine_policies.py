"""PyTorch port: every policy triple, leaf-bitwise against JAX.

All 2 x 2 x 2 proposal x objective x commit triples (minhash / magsdm,
exact / weighted with ``weight_levels=3``, saving / threshold with
``commit_margin=1``), each driven as ``test_torch_engine.py`` drives the
default triple: every ``EngineState`` leaf bitwise equal to JAX's
``make_step`` after every batch, plus the port's own Tier-A bar.
Tolerance: exact.  Each triple costs one compile of the JAX step (~10 s
on a CPU, whatever the stream), so the six triples that were not pinned
before run a shorter stream, denser in deletes (94 changes, 14 of them
deletes); the default triple and Mags-DM / weighted / threshold keep the
full ``sbm_stream(0)`` (142 changes, 19 deletes).
"""
import itertools

import pytest

pytest.importorskip("torch")

from repro.graph.streams import (edges_to_fully_dynamic_stream,  # noqa: E402
                                 sbm_edges)
from test_torch_engine import BASE, drive_both, sbm_stream  # noqa: E402

TRIPLES = list(itertools.product(("minhash", "magsdm"), ("exact", "weighted"),
                                 ("saving", "threshold")))
FULL_STREAM = {("minhash", "exact", "saving"),
               ("magsdm", "weighted", "threshold")}


def short_stream():
    """A 32-node SBM graph as a fully dynamic stream."""
    return edges_to_fully_dynamic_stream(sbm_edges(32, 4, 0.55, 0.04, seed=0),
                                         delete_prob=0.15, seed=1)


@pytest.mark.parametrize("triple", TRIPLES, ids="-".join)
def test_policy_triple_leaf_bitwise_every_batch(triple):
    proposal, objective, commit = triple
    kw = dict(BASE, proposal=proposal, objective=objective, commit=commit,
              commit_margin=1 if commit == "threshold" else 0,
              weight_levels=3 if objective == "weighted" else 0)
    stream = sbm_stream(0) if triple in FULL_STREAM else short_stream()
    bs = drive_both(kw, stream)
    assert bs.stats()["accepted"] > 0
    assert ("weab" in bs.table_pressure()) == (objective == "weighted")
