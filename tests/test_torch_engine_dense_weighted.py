"""PyTorch port: the dense step under the weighted objective, leaf-bitwise
against JAX's dense step and the port's branching step.

The four proposal x commit triples of ``objective="weighted"``
(``weight_levels=3``), driven as ``test_torch_engine_dense.py`` drives
the exact objective's: one engine and three stacked replicas, every
``EngineState`` leaf equal after every batch, at most one host read a
dense step.  A file of its own so that the two halves of the policy
matrix, each compiling JAX's dense step once a triple, run side by side.
Tolerance: exact.
"""
import pytest

pytest.importorskip("torch")

from test_torch_engine_dense import drive_dense  # noqa: E402
from test_torch_engine_policies import TRIPLES  # noqa: E402


@pytest.mark.parametrize("triple",
                         [t for t in TRIPLES if t[1] == "weighted"],
                         ids="-".join)
def test_dense_step_leaf_bitwise_every_batch_weighted(triple):
    drive_dense(triple)
