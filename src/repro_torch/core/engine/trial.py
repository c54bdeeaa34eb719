"""The batched MoSSo step in eager torch.

Port of ``repro/core/engine/trial.py::step_fn``: one step applies B stream
changes, then runs Alg. 1's trial group for every endpoint in stream
order (``u0, v0, u1, v1, ...``), each seeded from ``step_no``, and
advances ``step_no`` by one.  The state after a step is bitwise the JAX
step's.

**Where JAX predicates, the port branches.**  The JAX step is cond-free
predicated data flow (``pwhen`` regions).  The PRNG is counter-based and
stateless, so running a region only when its predicate holds gives the
same bits, and the port decides on the host:

* the change regions (``do_ins``/``do_del``): the change batch is host
  data, so they branch with no sync;
* the trial predicate (group validity and the TN filter): one sync per
  step for all trials of the step (below);
* ``plan``'s ``ok`` (capacity and semantic guards): one sync per live
  trial;
* ``commit``: one sync per planned trial, then the commit tail runs with
  host-known predicates (``apply_move`` reads its trip count and each
  ``pair_count_add`` its 0 <-> nonzero transition, one sync each);
* masked, with no sync: ``ensure_node``'s ``need``, ``delete_edge``'s
  min-hash fix-ups, the free-stack push of ``apply_move``.

**TP sampling for the whole step at once.**  A trial group's preamble
(TP samples, their min-hashes, the group's validity and each trial's TN
filter) reads only ``deg``, ``adj``, ``minh`` and whether ``n2s`` is set,
and no trial changes those: a move writes ``n2s`` of a seen node to
another valid sid, and touches no degree, adjacency or min-hash.  So the
preambles of all ``2B`` groups are computed in one pass over ``2B x c``
lanes, with one probe launch, before the first trial runs; the values
are the ones each group would read in turn.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.engine import policies
from repro_torch.core.engine.hashtable import M32, ht_lookup_batch, mul_u32
from repro_torch.core.engine.ops import (_sc, alloc_sid, apply_move,
                                         delete_edge, host_read, insert_edge,
                                         rnd_below, rnd_u01, rnd_u32, take)
from repro_torch.core.engine.state import EngineConfig, EngineState


def _one_trial(st: EngineState, y: torch.Tensor, tp: torch.Tensor,
               tp_minh: torch.Tensor, seed: torch.Tensor,
               cfg: EngineConfig) -> bool:
    """Steps 3-5 of Alg. 1 for one testing node y whose trial predicate
    holds; returns ``cap_ok`` (False counts as a skip)."""
    propose = policies.PROPOSALS[cfg.proposal]
    objective = policies.OBJECTIVES[cfg.objective]
    accept = policies.COMMIT_RULES[cfg.commit]

    # plan: candidate selection (proposal policy; counters 4.. are
    # reserved for the proposal's own draws)
    a = st.n2s[y]
    # float32 compare against the float32 escape, as in JAX
    esc = rnd_u01(seed, 3) <= float(np.float32(cfg.escape))
    cand_target, cand_ok = propose(st, y, tp, tp_minh, seed, cfg)
    top = st.free_top.reshape(1)
    fresh_sid = st.free[(top - 1).clamp(min=0)]
    target = torch.where(esc, fresh_sid, cand_target)
    cap_ok = ((st.deg[y] <= cfg.d_cap)
              & (st.sndeg[a] <= cfg.sn_cap)
              & (esc | (take(st.sndeg, cand_target) <= cfg.sn_cap))
              & (~esc | (top > 0)))
    sem_ok = torch.where(esc, st.ssize[a] > 1, cand_ok)
    ok, cap_ok, esc = host_read(torch.cat([cap_ok & sem_ok, cap_ok, esc]))
    if not ok:
        return cap_ok

    # eval_phi: dphi of the candidate move
    dphi, nbrs, nvalid = objective(st, y, target.clamp(min=0), esc, cfg)
    if not host_read(accept(dphi, cfg))[0]:
        return True

    # the commit tail
    alloc_sid(st, ok=esc)
    apply_move(st, y, target, dphi, nbrs, nvalid, cfg)
    st.n_accept = _sc(st.n_accept + 1)
    return True


def _trial_phase(st: EngineState, nodes: torch.Tensor,
                 cfg: EngineConfig) -> None:
    """Steps 1-5 of Alg. 1 for every input node (int32[2B], -1 = pad)."""
    dev = st.device
    n_groups, c = nodes.shape[0], cfg.c
    gidx = torch.arange(n_groups, dtype=torch.int64, device=dev)
    seeds = rnd_u32(st.step_no, mul_u32(gidx, 2654435761))[:, None]
    u_s = nodes.clamp(min=0)
    du = st.deg[u_s]
    valid = (nodes >= 0) & (st.n2s[u_s] >= 0) & (du > 0)

    # 1. TP(u): c uniform neighbor samples per group
    ks = torch.arange(c, dtype=torch.int64, device=dev)
    ridx = rnd_below(seeds, ks * 8 + 1, du[:, None])
    tp = ht_lookup_batch(st.adj, u_s[:, None].expand(n_groups, c), ridx,
                         default=0).reshape(n_groups, c)
    tp_minh = take(st.minh, tp)
    # 2. TN filter: testing prob 1/deg(w)
    tseed = rnd_u32(seeds, ks + 100)
    keep = rnd_u01(tseed, 2) * take(st.deg, tp).to(torch.float32) <= 1.0
    pred = host_read(valid[:, None] & keep)

    n_trials = n_skipped = 0
    for g in range(n_groups):
        for k in range(c):
            if pred[g][k]:
                n_trials += 1
                n_skipped += not _one_trial(st, tp[g, k:k + 1], tp[g],
                                            tp_minh[g], tseed[g, k:k + 1],
                                            cfg)
    st.n_trials = _sc(st.n_trials + n_trials)
    st.n_skipped = _sc(st.n_skipped + n_skipped)


def step_fn(st: EngineState, u, v, ins, cfg: EngineConfig) -> EngineState:
    """One engine step over a padded batch of changes, in place.

    ``u``/``v`` are int32[B] host arrays (``-1`` = padding) and ``ins``
    bool[B].  Batch semantics: all changes apply first, then trial groups
    run for every endpoint in stream order.
    """
    u = np.asarray(u, np.int32).reshape(-1)
    v = np.asarray(v, np.int32).reshape(-1)
    ins = np.asarray(ins, bool).reshape(-1)
    uv = torch.from_numpy(np.stack([u, v], axis=1)).to(st.device)
    for j in np.flatnonzero(u >= 0):
        change = insert_edge if ins[j] else delete_edge
        change(st, uv[j, 0:1], uv[j, 1:2], cfg)
    _trial_phase(st, uv.reshape(-1), cfg)
    st.step_no = (st.step_no + 1) & M32
    return st
