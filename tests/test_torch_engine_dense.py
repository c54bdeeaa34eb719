"""PyTorch port: the dense step, JAX's cond-free lowering of Alg. 1.

``step_fn(..., dense=True)`` runs every change region and every trial
phase under its mask and reads the host at most once a step.  Held here:

* for every proposal x objective x commit triple (the weighted objective's
  four in ``test_torch_engine_dense_weighted.py``), one engine and a
  stacked state of three replicas, each over its own fully dynamic SBM
  stream: after EVERY batch every ``EngineState`` leaf (telemetry and the
  ``step_no`` cursor included) equals JAX's ``make_step(cfg,
  dense=True)`` on that stream and the port's branching step
  (``dense=False``) from the same state; the dense step made at most one
  host read a step;
* the default triple's stacked replicas against JAX's ``jax.vmap`` of its
  dense step, with the trip counts passed (no host read at all);
* every triple's dense step on ``meta`` tensors, the port's counterpart
  of JAX's ``test_policy_matrix_compiles_cond_free``;
* ``make_step``'s probe routes.

The config is small (``d_cap`` 8, ``c`` 2, batch 8, three batches of a
16-node stream with deletes): the dense step runs
``apply_move``'s neighbour slots for every trial, masked, which costs the
CPU's plain probe about 20x the branching step.  Each triple compiles JAX's
dense step once (~11 s on a CPU).  Tolerance: exact.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.core.engine.state import EngineConfig as JaxConfig  # noqa: E402
from repro.core.engine.state import new_state as jax_new_state  # noqa: E402
from repro.core.engine.trial import make_step as jax_make_step  # noqa: E402
from repro.core.engine.trial import step_fn as jax_step_fn  # noqa: E402
from repro.graph.streams import (edges_to_fully_dynamic_stream,  # noqa: E402
                                 sbm_edges)
from repro_torch.core.engine.ops import host_read  # noqa: E402
from repro_torch.core.engine.state import (EngineConfig,  # noqa: E402
                                           new_state, stack_states,
                                           state_from_numpy, state_to_numpy)
from repro_torch.core.engine.trial import (ONE_TRIP, Trips,  # noqa: E402
                                           make_step, step_fn)
from test_torch_engine import assert_leaves_equal, jax_leaves  # noqa: E402
from test_torch_engine_policies import TRIPLES  # noqa: E402

CFG = dict(n_cap=128, m_cap=512, d_cap=8, sn_cap=16, c=2, batch=8,
           escape=0.3)
N_CHANGES = 24
SEEDS = (1, 2, 4)      # 5, 3 and 4 deletes among the first 24 changes
ROWS = len(SEEDS)


def triple_cfg(triple) -> dict:
    proposal, objective, commit = triple
    return dict(CFG, proposal=proposal, objective=objective, commit=commit,
                commit_margin=1 if commit == "threshold" else 0,
                weight_levels=3 if objective == "weighted" else 0)


def batches(seed: int, b: int) -> list:
    """A 16-node SBM graph's fully dynamic stream (half its edges deleted
    later), cut to ``N_CHANGES``, as padded ``(u, v, ins)`` engine-id
    batches (ids by first encounter, as ``BatchedSummarizer`` interns)."""
    stream = edges_to_fully_dynamic_stream(
        sbm_edges(16, 2, 0.5, 0.05, seed=seed), delete_prob=0.5,
        seed=seed + 1)[:N_CHANGES]
    ids = {}
    out = []
    for off in range(0, len(stream), b):
        chunk = stream[off:off + b]
        pad = b - len(chunk)
        u = [ids.setdefault(x, len(ids)) for (x, _, _) in chunk]
        v = [ids.setdefault(y, len(ids)) for (_, y, _) in chunk]
        out.append((np.array(u + [-1] * pad, np.int32),
                    np.array(v + [-1] * pad, np.int32),
                    np.array([i for (_, _, i) in chunk] + [False] * pad)))
    return out


def row(leaves: dict, r: int) -> dict:
    """Replica ``r``'s leaves of stacked numpy leaves."""
    return {k: ({w: x[r] for w, x in v.items()} if isinstance(v, dict)
                else v[r]) for k, v in leaves.items()}


def dense_step(st, u, v, ins, cfg, trips=None) -> int:
    """The port's dense step; returns the host reads it made."""
    before = host_read.count
    step_fn(st, u, v, ins, cfg, dense=True, trips=trips)
    return host_read.count - before


def drive_dense(triple) -> None:
    """One engine and R = 3 replicas through the dense step, the
    branching step and JAX's dense step, leaf-bitwise after every
    batch."""
    kw = triple_cfg(triple)
    jcfg, tcfg = JaxConfig(**kw), EngineConfig(**kw)
    jstep = jax_make_step(jcfg, dense=True)
    start = jax_leaves(jax_new_state(jcfg))
    streams = [batches(seed, tcfg.batch) for seed in SEEDS]
    n = min(len(s) for s in streams)

    # one engine: row 0's stream
    dense, branch = (state_from_numpy(start, "cpu") for _ in range(2))
    jst = jax_new_state(jcfg)
    # R = 3: each replica its own stream
    stacked = stack_states([state_from_numpy(start, "cpu")
                            for _ in range(ROWS)])
    stacked_branch = stack_states([state_from_numpy(start, "cpu")
                                   for _ in range(ROWS)])
    jrows = [jax_new_state(jcfg) for _ in range(ROWS)]
    for i in range(n):
        tag = f"{'-'.join(triple)} batch {i}"
        u, v, ins = streams[0][i]
        assert dense_step(dense, u, v, ins, tcfg) <= 1, tag
        step_fn(branch, u, v, ins, tcfg)
        jst = jstep(jst, u, v, ins)
        want = jax_leaves(jst)
        assert_leaves_equal(state_to_numpy(dense), want, f"{tag}: one")
        assert_leaves_equal(state_to_numpy(branch), want, f"{tag}: branch")

        us, vs, inss = (np.stack([s[i][k] for s in streams])
                        for k in range(3))
        assert dense_step(stacked, us, vs, inss, tcfg) <= 1, tag
        step_fn(stacked_branch, us, vs, inss, tcfg)
        jrows = [jstep(j, us[r], vs[r], inss[r]) for r, j in enumerate(jrows)]
        got = state_to_numpy(stacked)
        got_branch = state_to_numpy(stacked_branch)
        for r, j in enumerate(jrows):
            assert_leaves_equal(row(got, r), jax_leaves(j), f"{tag}: row {r}")
            assert_leaves_equal(row(got_branch, r), jax_leaves(j),
                                f"{tag}: branch row {r}")
    assert int(dense.n_accept) > 0 and int(stacked.n_accept.sum()) > 0


@pytest.mark.parametrize("triple", [t for t in TRIPLES if t[1] == "exact"],
                         ids="-".join)
def test_dense_step_leaf_bitwise_every_batch(triple):
    drive_dense(triple)


def test_stacked_dense_step_equals_jax_vmap_with_trips_given():
    """R = 3 against JAX's ``jax.vmap`` of its dense step (the router's
    "vmap" lowering), with the trip counts passed, so the step reads
    nothing: the most live trials of a replica (JAX's ``n_trials`` rise
    over the batch) and every neighbour slot."""
    kw = triple_cfg(("minhash", "exact", "saving"))
    jcfg, tcfg = JaxConfig(**kw), EngineConfig(**kw)
    vstep = jax.jit(jax.vmap(
        lambda s, a, b, c: jax_step_fn(s, a, b, c, jcfg, True)))
    start = jax_new_state(jcfg)
    jst = jax.tree.map(lambda *x: jnp.stack(x), *[start] * ROWS)
    st = state_from_numpy(jax_leaves(jst), "cpu")
    streams = [batches(seed, tcfg.batch) for seed in SEEDS]
    for i in range(min(len(s) for s in streams)):
        us, vs, inss = (np.stack([s[i][k] for s in streams])
                        for k in range(3))
        trials = np.asarray(jst.n_trials)
        jst = vstep(jst, us, vs, inss)
        trips = Trips(trials=int((np.asarray(jst.n_trials) - trials).max()),
                      slots=tcfg.d_cap)
        assert dense_step(st, torch.from_numpy(us), torch.from_numpy(vs),
                          torch.from_numpy(inss), tcfg, trips) == 0
        assert_leaves_equal(state_to_numpy(st), jax_leaves(jst),
                            f"vmap batch {i}")
    assert int(st.n_accept.sum()) > 0


@pytest.mark.parametrize("triple", TRIPLES, ids="-".join)
def test_dense_step_runs_on_meta(triple):
    """Every triple's dense step on ``meta`` tensors at ``ONE_TRIP``: no
    host read, no data-dependent shape, the probe through its fake
    implementation; one engine and a stacked state."""
    cfg = EngineConfig(**triple_cfg(triple))
    b = cfg.batch
    for rows in (None, ROWS):
        shape = (b,) if rows is None else (rows, b)
        st = new_state(cfg, "meta")
        if rows is not None:
            st = stack_states([st] * rows)
        ids = torch.empty(shape, dtype=torch.int32, device="meta")
        ins = torch.empty(shape, dtype=torch.bool, device="meta")
        assert dense_step(st, ids, ids, ins, cfg, ONE_TRIP) == 0
        assert st.phi.device.type == "meta"
    with pytest.raises(RuntimeError):
        # no trip count given: the one read has no value on meta
        step_fn(st, ids, ids, ins, cfg, dense=True)


def test_make_step_routes():
    """``make_step`` is memoized like JAX's, follows the state's device
    unless a route is pinned, refuses JAX's backend names, and ``trips``
    belongs to the dense step."""
    cfg = EngineConfig(**CFG)
    assert make_step(cfg) is make_step(cfg, False, None)
    u, v, ins = batches(0, cfg.batch)[0]
    a, b = new_state(cfg, "cpu"), new_state(cfg, "cpu")
    make_step(cfg, True, "plain")(a, u, v, ins)
    step_fn(b, u, v, ins, cfg)
    assert_leaves_equal(state_to_numpy(a), state_to_numpy(b), "plain")
    with pytest.raises(ValueError, match="probes by 'cuda'"):
        make_step(cfg, True, "cuda")(a, u, v, ins)
    with pytest.raises(ValueError, match="trial backend"):
        make_step(cfg, trial_backend="pallas")
    with pytest.raises(ValueError, match="dense=True"):
        step_fn(a, u, v, ins, cfg, trips=ONE_TRIP)
