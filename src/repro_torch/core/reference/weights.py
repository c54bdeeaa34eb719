"""Host mirror of the engine's hashed node weights (weighted objective).

``host_node_weight`` lives in :mod:`repro_torch.core.summary` (one
definition); this module keeps the JAX package's import path
``repro.core.reference.weights``.  The engine hashes dense engine ids, not
caller labels: a label-space reference maps labels through the
front-end's intern order before weighing them against device state.
"""
from repro_torch.core.summary import host_node_weight

__all__ = ["host_node_weight"]
