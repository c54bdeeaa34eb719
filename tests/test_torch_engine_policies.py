"""PyTorch port: a non-default policy triple, leaf-bitwise against JAX.

Mags-DM proposal, weighted objective (``weight_levels=3``) and the
threshold commit rule, driven as ``test_torch_engine.py`` drives the
default triple: every ``EngineState`` leaf bitwise equal after every
batch, plus the port's own Tier-A bar.  Tolerance: exact.
"""
import pytest

pytest.importorskip("torch")

from test_torch_engine import BASE, drive_both, sbm_stream  # noqa: E402

NON_DEFAULT = dict(BASE, proposal="magsdm", objective="weighted",
                   commit="threshold", commit_margin=1, weight_levels=3)


def test_magsdm_weighted_threshold_leaf_bitwise_every_batch():
    bs = drive_both(NON_DEFAULT, sbm_stream(0))
    assert bs.stats()["accepted"] > 0
    assert "weab" in bs.table_pressure()
