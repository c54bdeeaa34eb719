"""PyTorch port against the JAX engine with its Pallas probe kernel.

``make_step(trial_backend="pallas")`` runs every batched probe of the JAX
step through the Pallas kernel (interpret mode on the CPU).  Two batches
of the SBM stream, every ``EngineState`` leaf bitwise equal after each,
plus the port's own Tier-A bar.  Tolerance: exact.
"""
import pytest

pytest.importorskip("torch")

from test_torch_engine import BASE, drive_both, sbm_stream  # noqa: E402


def test_two_batches_leaf_bitwise_vs_pallas_backend():
    bs = drive_both(BASE, sbm_stream(0), trial_backend="pallas",
                    max_batches=2)
    assert bs.flush_epoch == 2
