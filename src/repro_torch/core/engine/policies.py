"""Swappable Alg.-1 policies: proposal / objective / commit rule.

Port of ``repro/core/engine/policies.py``: three registries keyed by the
``EngineConfig`` fields, with the same signatures:

* ``PROPOSALS[cfg.proposal]`` — ``(st, y, tp, tp_minh, seed, cfg) ->
  (cand_target, cand_ok)``.
* ``OBJECTIVES[cfg.objective]`` — ``(st, y, target, is_fresh, cfg) ->
  (dphi, nbrs, nvalid)``; ``is_fresh`` is a host bool in the port.
* ``COMMIT_RULES[cfg.commit]`` — ``(dphi, cfg) -> bool tensor``.

Policy bodies read the state only; every gather whose index comes from a
table value goes through ``ops.take`` (JAX's clamping gather).  They run
over a stacked state (``ops``): ``y`` and ``seed`` are ``[R]``, the TP
samples ``[R, c]``, and each result is ``[R]``, one per replica.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.engine.ops import (at, delta_phi_move,
                                         delta_phi_move_weighted, rnd_below,
                                         take)
from repro_torch.core.engine.state import (COMMIT_RULES as COMMIT_RULE_NAMES,
                                           NO_CLUSTER, EngineConfig,
                                           EngineState)
from repro_torch.core.engine.state import OBJECTIVES as OBJECTIVE_NAMES
from repro_torch.core.engine.state import PROPOSALS as PROPOSAL_NAMES


def _first_argmax(x: torch.Tensor) -> torch.Tensor:
    """Index of the first maximum along the last axis (``jnp.argmax``)."""
    return torch.argmax(x.to(torch.int32), dim=-1)


def propose_minhash(st: EngineState, y: torch.Tensor, tp: torch.Tensor,
                    tp_minh: torch.Tensor, seed: torch.Tensor,
                    cfg: EngineConfig,
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The paper's sampler: CP(y) = TP(u) ∩ R(y) via min-hash cluster
    equality, uniform pick among the matches (Alg. 1 step 4)."""
    a = at(st.n2s, y)
    my = at(st.minh, y)[:, None]
    cp_mask = (tp_minh == my) & (my != NO_CLUSTER)
    n_cp = cp_mask.sum(dim=-1).to(torch.int32)
    pick = rnd_below(seed, 4, n_cp)
    # index of the pick-th True in cp_mask
    csum = torch.cumsum(cp_mask.to(torch.int32), dim=-1) - 1
    z = at(tp, _first_argmax((csum == pick[:, None]) & cp_mask))
    cand_target = take(st.n2s, z)
    return cand_target, (n_cp > 0) & (cand_target != a)


def propose_magsdm(st: EngineState, y: torch.Tensor, tp: torch.Tensor,
                   tp_minh: torch.Tensor, seed: torch.Tensor,
                   cfg: EngineConfig,
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mags-DM-style dense-neighborhood grouping: the modal supernode among
    the TP samples, not a uniform pick from a min-hash cluster."""
    a = at(st.n2s, y)
    nsid = take(st.n2s, tp)
    cnt = (nsid[..., None, :] == nsid[..., :, None]).sum(dim=-1).to(
        torch.int32)
    elig = nsid != a[:, None]
    cand_target = at(nsid, _first_argmax(torch.where(elig, cnt, -1)))
    return cand_target, elig.any(dim=-1) & (cand_target != a)


def commit_saving(dphi: torch.Tensor, cfg: EngineConfig) -> torch.Tensor:
    """Move-if-saved (the paper's rule): accept iff dphi <= 0."""
    return dphi <= 0


def commit_threshold(dphi: torch.Tensor, cfg: EngineConfig) -> torch.Tensor:
    """Accept iff dphi <= cfg.commit_margin."""
    return dphi <= cfg.commit_margin


PROPOSALS = {
    "minhash": propose_minhash,
    "magsdm": propose_magsdm,
}

OBJECTIVES = {
    "exact": delta_phi_move,
    "weighted": delta_phi_move_weighted,
}

COMMIT_RULES = {
    "saving": commit_saving,
    "threshold": commit_threshold,
}

assert tuple(PROPOSALS) == PROPOSAL_NAMES
assert tuple(OBJECTIVES) == OBJECTIVE_NAMES
assert tuple(COMMIT_RULES) == COMMIT_RULE_NAMES
