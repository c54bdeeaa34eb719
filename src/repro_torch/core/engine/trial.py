"""The batched MoSSo step in eager torch.

Port of ``repro/core/engine/trial.py::step_fn``: one step applies B stream
changes, then runs Alg. 1's trial group for every endpoint in stream
order (``u0, v0, u1, v1, ...``), each seeded from ``step_no``, and
advances ``step_no`` by one.  The state after a step is bitwise the JAX
step's.

**One step, R replicas.**  :func:`step_fn` steps a stacked state
(``state.py``): R independent replicas, each with its own ``[B]`` change
batch, as the JAX package's ``jax.vmap`` of its step does; one engine is
R = 1.  Change ``j`` of every replica applies together, and so does
every replica's ``i``-th live trial (below).  Replicas share no state,
so running them side by side changes no replica's bits: each one's
changes and trials still run in its own stream order.

**Where JAX predicates, the port branches.**  The JAX step is cond-free
predicated data flow (``pwhen`` regions).  The PRNG is counter-based and
stateless, so running a region only when its predicate holds gives the
same bits, and the port decides on the host, for all R replicas at once,
and masks the region to the replicas where it holds (``ops.pred``):

* the change regions (``do_ins``/``do_del``): the change batch is host
  data, so they branch with no sync;
* the trial predicate (group validity and the TN filter): one sync per
  step for all trials of the step and every replica (below);
* ``plan``'s ``ok`` (capacity and semantic guards): one sync per trial
  step;
* ``commit``: one sync per planned trial step, then the commit tail runs
  with host-known predicates (``apply_move`` reads its trip counts and
  each ``pair_count_add`` its 0 <-> nonzero transitions, one sync each);
* masked, with no sync: ``ensure_node``'s ``need``, ``delete_edge``'s
  min-hash fix-ups, the free-stack push of ``apply_move``.

**The dense step: JAX's masked data flow.**  ``step_fn(..., dense=True)``
(:func:`make_step`'s ``dense``) is the lowering JAX's
``_pregion(dense=True)`` names: both change regions of every change run
under their masks, and every live-order trial runs ``plan``,
``eval_phi`` (a masked trial scores the move ``a -> a``, JAX's
``tgt_s``) and the commit tail under ``live``/``ok``/``commit`` masks,
``apply_move`` over a fixed number of neighbour slots and each
``pair_count_add`` with its four slot-list updates masked.  The step
reads the host at most once, for its trip counts (:class:`Trips`), and
not at all when the caller gives them, so it runs on ``meta`` tensors
(the dry-run's mosso cell).  Masked work costs launches: every trial step
runs the commit tail, where the branching step runs it at the
acceptance rate.

**Trials in live order.**  JAX's vmapped step runs trial ``(g, k)`` of
every replica in lock step, each region iff any replica's trial there is
live.  The TN filter keeps a sample with probability 1/deg, so live
trials are sparse and rarely share a slot across replicas; the port
instead runs replica ``r``'s ``i``-th live trial beside every other
replica's ``i``-th, each with its own ``(g, k)`` seed and samples, and a
replica with fewer live trials is masked out.  The branch points of a
step fall from the sum of the replicas' live trials to the largest.

**TP sampling for the whole step at once.**  A trial group's preamble
(TP samples, their min-hashes, the group's validity and each trial's TN
filter) reads only ``deg``, ``adj``, ``minh`` and whether ``n2s`` is set,
and no trial changes those: a move writes ``n2s`` of a seen node to
another valid sid, and touches no degree, adjacency or min-hash.  So the
preambles of all ``2B`` groups of every replica are computed in one pass
over ``[R, 2B, c]`` lanes, with one probe launch, before the first trial
runs; the values are the ones each group would read in turn.
"""
from __future__ import annotations

from functools import lru_cache
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.engine import policies
from repro_torch.core.engine.hashtable import M32, ht_lookup_batch, mul_u32
from repro_torch.core.engine.ops import (Pred, _masked, alloc_sid,
                                         apply_move, at, delete_edge,
                                         host_read, insert_edge, pred,
                                         rnd_below, rnd_u01, rnd_u32, take)
from repro_torch.core.engine.state import (EngineConfig, EngineState,
                                           stacked_view)


def _plan(st: EngineState, y: torch.Tensor, tp: torch.Tensor,
          tp_minh: torch.Tensor, seed: torch.Tensor, live: Pred,
          cfg: EngineConfig):
    """Candidate selection of one trial of every replica (JAX's ``plan``):
    ``(a, esc, target, ok, cap_ok)``, ``ok`` False where ``live`` is."""
    propose = policies.PROPOSALS[cfg.proposal]
    # counters 4.. are reserved for the proposal's own draws
    a = at(st.n2s, y)
    # float32 compare against the float32 escape, as in JAX
    esc = rnd_u01(seed, 3) <= float(np.float32(cfg.escape))
    cand_target, cand_ok = propose(st, y, tp, tp_minh, seed, cfg)
    top = st.free_top
    fresh_sid = at(st.free, (top - 1).clamp(min=0))
    target = torch.where(esc, fresh_sid, cand_target)
    cap_ok = ((at(st.deg, y) <= cfg.d_cap)
              & (at(st.sndeg, a) <= cfg.sn_cap)
              & (esc | (take(st.sndeg, cand_target) <= cfg.sn_cap))
              & (~esc | (top > 0)))
    ok = _masked(live, cap_ok & torch.where(esc, at(st.ssize, a) > 1,
                                            cand_ok), False)
    return a, esc, target, ok, cap_ok


def _trial_step(st: EngineState, y: torch.Tensor, tp: torch.Tensor,
                tp_minh: torch.Tensor, seed: torch.Tensor, live: Pred,
                cfg: EngineConfig) -> Tuple[List[bool], torch.Tensor]:
    """Steps 3-5 of Alg. 1 for one trial of every replica where ``live``
    holds: testing node ``y[r]`` with its group's TP samples ``tp[r]``
    and seed ``seed[r]``.  Returns ``cap_ok`` on the host and on the
    device (False counts as a skip)."""
    objective = policies.OBJECTIVES[cfg.objective]
    accept = policies.COMMIT_RULES[cfg.commit]

    _, esc, target, ok, cap_ok = _plan(st, y, tp, tp_minh, seed, live, cfg)
    n = y.shape[0]
    flags = host_read(torch.cat([ok, cap_ok, esc]))
    ok_h, cap_h, esc_h = flags[:n], flags[n:2 * n], flags[2 * n:]
    plan = pred(ok_h, ok)
    if plan is False:
        return cap_h, cap_ok

    # eval_phi: dphi of the candidate move
    fresh = pred([e for e, o in zip(esc_h, ok_h) if o], esc)
    dphi, nbrs, nvalid = objective(st, y, target.clamp(min=0), fresh, cfg)
    commit = _masked(plan, accept(dphi, cfg), False)
    commit_h = host_read(commit)
    moved = pred(commit_h, commit)
    if moved is False:
        return cap_h, cap_ok

    # the commit tail
    alloc_sid(st, ok=pred([c and e for c, e in zip(commit_h, esc_h)],
                          lambda: commit & esc))
    apply_move(st, y, target, dphi, nbrs, nvalid, cfg, ok=moved)
    st.n_accept += _masked(moved, 1)
    return cap_h, cap_ok


def _dense_trial_step(st: EngineState, y: torch.Tensor, tp: torch.Tensor,
                      tp_minh: torch.Tensor, seed: torch.Tensor,
                      live: torch.Tensor, cfg: EngineConfig,
                      slots: int) -> torch.Tensor:
    """:func:`_trial_step` as masked data flow (JAX's ``_one_trial`` with
    its ``pwhen`` regions run unconditionally): plan, ``eval_phi`` and the
    commit tail run for every replica under ``live``/``ok``/``commit``,
    with no read.  Returns the skip mask (``live & ~cap_ok``)."""
    objective = policies.OBJECTIVES[cfg.objective]
    accept = policies.COMMIT_RULES[cfg.commit]

    a, esc, target, ok, cap_ok = _plan(st, y, tp, tp_minh, seed, live, cfg)
    # a masked trial scores the move a -> a, so every gather stays in
    # bounds (JAX's eval_phi)
    dphi, nbrs, nvalid = objective(
        st, y, torch.where(ok, target, a).clamp(min=0), esc, cfg)
    commit = ok & accept(dphi, cfg)
    alloc_sid(st, ok=commit & esc)
    apply_move(st, y, target, dphi, nbrs, nvalid, cfg, ok=commit,
               trips=slots)
    st.n_accept += commit.to(torch.int32)
    return live & ~cap_ok


class Trips(NamedTuple):
    """Trip counts of the dense step's loops, each ``None`` for the
    step's own: ``changes`` applied of the batch (all of them);
    ``trials``, live trials a replica; ``slots``, ``apply_move``'s
    neighbour slots.  With ``trials`` unset the step makes its one host
    read, of the largest live-trial count over the replicas and of the
    largest degree a move of this step can carry (which sets ``slots``
    unless given); with ``trials`` given it reads nothing and ``slots``
    defaults to ``d_cap``.  A count at or above what the data needs runs
    masked no-ops beyond it and keeps the bits; one below stops early and
    does not: the dry-run's convention of one trip a loop,
    :data:`ONE_TRIP`."""
    changes: Optional[int] = None
    trials: Optional[int] = None
    slots: Optional[int] = None


ONE_TRIP = Trips(1, 1, 1)


def _trial_phase(st: EngineState, nodes: torch.Tensor, cfg: EngineConfig,
                 dense: bool = False, trips: Trips = Trips()) -> None:
    """Steps 1-5 of Alg. 1 for every input node of every replica
    (``int32[R, 2B]``, -1 = pad)."""
    dev = st.device
    n_rep, n_groups = nodes.shape
    c = cfg.c
    gidx = torch.arange(n_groups, dtype=torch.int64, device=dev)
    seeds = rnd_u32(st.step_no[:, None], mul_u32(gidx, 2654435761))
    u_s = nodes.clamp(min=0)
    du = at(st.deg, u_s)
    valid = (nodes >= 0) & (at(st.n2s, u_s) >= 0) & (du > 0)

    # 1. TP(u): c uniform neighbor samples per group
    ks = torch.arange(c, dtype=torch.int64, device=dev)
    ridx = rnd_below(seeds[..., None], ks * 8 + 1, du[..., None])
    tp = ht_lookup_batch(st.adj, u_s[..., None], ridx, default=0)
    tp_minh = take(st.minh, tp)
    # 2. TN filter: testing prob 1/deg(w)
    tseed = rnd_u32(seeds[..., None], ks + 100)
    deg_tp = take(st.deg, tp)
    keep = rnd_u01(tseed, 2) * deg_tp.to(torch.float32) <= 1.0
    live = (valid[..., None] & keep).reshape(n_rep, n_groups * c)
    n_live = live.sum(dim=-1)
    st.n_trials += n_live
    if dense:
        n_steps, slots = trips.trials, trips.slots
        if n_steps is None:
            # the one read: the most live trials of a replica, and the
            # most neighbour slots a move of this step can take (a move
            # needs deg(y) <= d_cap, and no trial changes a degree)
            movable = live & (deg_tp <= cfg.d_cap).reshape(n_rep, -1)
            n_steps, most = host_read(torch.stack([
                n_live.max(), torch.where(movable, deg_tp.reshape(
                    n_rep, -1), 0).max().to(n_live.dtype)]))
            slots = most if slots is None else slots
        n_steps = min(n_steps, n_groups * c)
        slots = cfg.d_cap if slots is None else slots
    else:
        counts = host_read(n_live)
        n_steps = max(counts)
    if not n_steps:
        return

    # each replica's live trials in stream order, (g, k) = divmod(pos, c)
    pos = torch.sort((~live).to(torch.uint8), dim=-1,
                     stable=True).indices[:, :n_steps]
    grp = (pos // c)[..., None].expand(n_rep, n_steps, c)
    ys = tp.reshape(n_rep, -1).gather(-1, pos)
    tps = tp.gather(1, grp)
    tp_minhs = tp_minh.gather(1, grp)
    tseeds = tseed.reshape(n_rep, -1).gather(-1, pos)
    on = torch.arange(n_steps, device=dev) < n_live[:, None]

    if dense:
        skipped = torch.zeros_like(st.n_skipped)
        for i in range(n_steps):
            skipped += _dense_trial_step(st, ys[:, i], tps[:, i],
                                         tp_minhs[:, i], tseeds[:, i],
                                         on[:, i], cfg, slots)
        st.n_skipped += skipped
        return

    skipped = [0] * n_rep
    skipped_dev = None
    for i in range(n_steps):
        on_h = [i < k for k in counts]
        on_i = pred(on_h, lambda: on[:, i])
        cap_h, cap_ok = _trial_step(st, ys[:, i], tps[:, i], tp_minhs[:, i],
                                    tseeds[:, i], on_i, cfg)
        skip = [o and not c for o, c in zip(on_h, cap_h)]
        if any(skip):
            skipped = [k + s for k, s in zip(skipped, skip)]
            m = _masked(on_i, ~cap_ok, False).to(torch.int32)
            skipped_dev = m if skipped_dev is None else skipped_dev + m
    if any(skipped):
        # one count for every replica needs no device tensor
        st.n_skipped += (skipped[0] if len(set(skipped)) == 1
                         else skipped_dev)


def _changes(u, v, ins, n_rep: int, device) -> torch.Tensor:
    """The batch as ``int32[R, B, 3]`` ``(u, v, ins)`` on ``device``, from
    host arrays or from tensors (which stay where they are until the
    copy)."""
    if all(isinstance(x, torch.Tensor) for x in (u, v, ins)):
        return torch.stack([x.reshape(n_rep, -1).to(device=device,
                                                    dtype=torch.int32)
                            for x in (u, v, ins)], -1)
    cols = [np.asarray(x).astype(np.int32).reshape(n_rep, -1)
            for x in (u, v, ins)]
    return torch.from_numpy(np.stack(cols, -1)).to(device)


def step_fn(st: EngineState, u, v, ins, cfg: EngineConfig,
            dense: bool = False, trips: Optional[Trips] = None,
            ) -> EngineState:
    """One engine step over a padded batch of changes, in place.

    ``st`` is one engine's state, with ``u``/``v`` int32[B] (``-1`` =
    padding) and ``ins`` bool[B], or a stacked state of R replicas with
    ``[R, B]`` arrays, replica ``r`` stepping on row ``r``.  Batch
    semantics: all changes apply first, then trial groups run for every
    endpoint in stream order.

    ``dense=False`` branches on the host at each decision point (the
    module docstring); the changes are host arrays.  ``dense=True`` is
    JAX's cond-free lowering: every change region and every trial phase
    runs under its mask, and the step reads the host at most once (the
    largest live-trial count, unless ``trips.trials`` gives it); the
    changes may be tensors on any device, ``meta`` included.  Both give
    the same bits.
    """
    if trips is not None and not dense:
        raise ValueError("trips sets the dense step's loops: pass "
                         "dense=True")
    trips = trips or Trips()
    if st.phi.dim() == 0:
        st = stacked_view(st)
    n_rep = st.phi.shape[0]
    if dense:
        uvi = _changes(u, v, ins, n_rep, st.device)
        n_ch = uvi.shape[1]
        if trips.changes is not None:
            n_ch = min(n_ch, trips.changes)
        for j in range(n_ch):
            valid = uvi[:, j, 0] >= 0
            flag = uvi[:, j, 2] != 0
            insert_edge(st, uvi[:, j, 0], uvi[:, j, 1], cfg, valid & flag,
                        dense=True)
            delete_edge(st, uvi[:, j, 0], uvi[:, j, 1], cfg, valid & ~flag,
                        dense=True)
    else:
        u = np.asarray(u, np.int32).reshape(n_rep, -1)
        v = np.asarray(v, np.int32).reshape(n_rep, -1)
        ins = np.asarray(ins, bool).reshape(n_rep, -1)
        uvi = _changes(u, v, ins, n_rep, st.device)
        do_ins, do_del = (u >= 0) & ins, (u >= 0) & ~ins
        for j in range(u.shape[1]):
            for change, do, flag in ((insert_edge, do_ins, 1),
                                     (delete_edge, do_del, 0)):
                ok = pred(do[:, j], lambda: (uvi[:, j, 0] >= 0)
                          & (uvi[:, j, 2] == flag))
                if ok is not False:
                    change(st, uvi[:, j, 0], uvi[:, j, 1], cfg, ok)
    _trial_phase(st, uvi[..., :2].reshape(n_rep, -1), cfg, dense, trips)
    st.step_no.copy_((st.step_no + 1) & M32)
    return st


TRIAL_BACKENDS = ("cuda", "plain")


def probe_backend(device: torch.device) -> str:
    """The probe route a device's state takes: the CUDA kernel or its
    plain version (a checkpoint's manifest records it, unpinned)."""
    return "cuda" if device.type == "cuda" else "plain"


@lru_cache(maxsize=None)
def _make_step(cfg: EngineConfig, dense: bool, trial_backend: Optional[str]):
    def stepped(st, u, v, ins, trips: Optional[Trips] = None):
        got = probe_backend(st.device)
        if trial_backend is not None and got != trial_backend:
            raise ValueError(f"this step probes by {trial_backend!r}; a "
                             f"state on {st.device} probes by {got!r}")
        return step_fn(st, u, v, ins, cfg, dense, trips)
    return stepped


def make_step(cfg: EngineConfig, dense: bool = False,
              trial_backend: Optional[str] = None):
    """The engine step for a fixed config and lowering, as JAX's
    ``make_step``: ``step(st, u, v, ins, trips=None)``, memoized on
    ``(cfg, dense, trial_backend)``.  The probe route follows the state's
    device (``"cuda"``: the probe kernel; ``"plain"``: its plain version,
    on the CPU or on ``meta``); a ``trial_backend`` given pins it, and a
    state elsewhere raises."""
    if trial_backend is not None and trial_backend not in TRIAL_BACKENDS:
        raise ValueError(f"trial backend must be one of {TRIAL_BACKENDS}: "
                         f"{trial_backend!r}")
    return _make_step(cfg, dense, trial_backend)
