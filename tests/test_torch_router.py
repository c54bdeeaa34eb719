"""PyTorch port: the sharded tier, leaf-bitwise against the JAX package.

``repro_torch``'s router (shard keys, geometry, the route stage's drain
loop, interning) and ``ShardedSummarizer`` against ``repro.dist.router``
and ``repro.core.engine.ShardedSummarizer`` on one device: the same
stream, the same ``process`` calls, and after EVERY call the stacked
``EngineState`` and ``InternState`` leaves bitwise equal (through
``sharded_state_to_numpy``) and ``flush_epoch`` equal; at the end
``stats()``, ``materialize()`` part by part,
``phi == phi_recomputed()`` and ``live_edges()`` against the stream's live
set.  The JAX side runs ``trial_backend="xla"`` (leaf-bitwise equal to
``"pallas"`` by its own contract) and ``replica_exec="map"``.  Tolerance:
exact.  One engine configuration and chunk geometry serve every routing
case, so the JAX package compiles its engine stage once.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.engine import ShardedSummarizer as JaxSharded  # noqa: E402
from repro.core.engine.state import EngineConfig as JaxConfig  # noqa: E402
from repro.dist import labelhash as jax_lh  # noqa: E402
from repro.dist import router as jax_router  # noqa: E402
from repro.launch.mesh import make_engine_mesh  # noqa: E402
from repro_torch.core.engine import EngineConfig  # noqa: E402
from repro_torch.core.engine import ShardedSummarizer  # noqa: E402
from repro_torch.core.summary import pair_key  # noqa: E402
from repro_torch.dist import labelhash, router  # noqa: E402
from repro_torch.graph.streams import (  # noqa: E402
    barabasi_albert_edges, edges_to_fully_dynamic_stream)
from test_torch_engine import assert_leaves_equal, jax_leaves  # noqa: E402

CFG = dict(n_cap=128, m_cap=1024, d_cap=32, sn_cap=24, c=8, batch=16,
           escape=0.3, proposal="minhash", objective="exact",
           commit="saving")
SHARDS = 3
CHUNK = 32


def ba_stream(seed: int = 0, nodes: int = 40):
    return edges_to_fully_dynamic_stream(
        barabasi_albert_edges(nodes, 3, seed), delete_prob=0.15,
        seed=seed + 1)


def skew_stream(n_leaves: int = 40, delete_every: int = 3):
    """A star around a hub whose hash undercuts every leaf's: every change
    routes to the hub's shard and the other shards receive nothing."""
    leaves = [f"x{i:03d}" for i in range(n_leaves)]
    lo = min(labelhash.hash_label(x) for x in leaves)
    hub = next(h for h in (f"hub{j}" for j in range(100_000))
               if labelhash.hash_label(h) < lo)
    return ([(hub, x, True) for x in leaves]
            + [(hub, x, False) for x in leaves[::delete_every]])


def live_set(stream):
    live = set()
    for (u, v, ins) in stream:
        live.add(pair_key(u, v)) if ins else live.discard(pair_key(u, v))
    return live


def assert_replicas_equal(p: ShardedSummarizer, j, tag: str) -> None:
    """Port replicas vs the JAX package's stacked state, leaf for leaf."""
    est, ist = router.sharded_state_to_numpy(p._est, p._ist)
    assert_leaves_equal(est, jax_leaves(j.state), f"{tag}: engine")
    assert_leaves_equal(ist, jax_leaves(j.intern), f"{tag}: intern")


def assert_outputs_equal(p: ShardedSummarizer, j, live, tag: str) -> None:
    """``stats()``, ``materialize()`` part by part, the phi fold and the
    live edge set, after the last call."""
    assert p.stats() == j.stats(), tag
    got, ref = p.materialize().validate(), j.materialize().validate()
    assert len(got.shards) == len(ref.shards)
    for a, b in zip(got.shards, ref.shards):
        assert (a.supernodes, a.superedges, a.c_plus, a.c_minus) == \
            (b.supernodes, b.superedges, b.c_plus, b.c_minus), tag
    assert got.decode_edges() == live, tag
    assert p.phi == p.phi_recomputed() == j.phi, tag
    if p.cfg.objective == "exact":      # else phi is the weighted fold
        assert got.phi == p.phi, tag
    assert p.shard_phis() == j.shard_phis(), tag
    assert p.live_edges() == live, tag


def drive(stream, call: int, cfg_kw=CFG, replica_exec=None, **skw):
    """One stream through both summarizers in ``call``-sized ``process``
    calls, replicas compared after every call; returns both.
    ``replica_exec`` is the port's (JAX runs ``"map"``)."""
    j = JaxSharded(JaxConfig(**cfg_kw), n_shards=SHARDS, trial_backend="xla",
                   replica_exec="map", **skw)
    p = ShardedSummarizer(EngineConfig(**cfg_kw), device="cpu",
                          n_shards=SHARDS, replica_exec=replica_exec, **skw)
    assert (p.lane_cap, p.max_drain_rounds, p.sync_free, p.pipeline) == \
        (j.lane_cap, j.max_drain_rounds, j.sync_free, j.pipeline)
    assert_replicas_equal(p, j, "new")
    for n, off in enumerate(range(0, len(stream), call)):
        chunk = stream[off:off + call]
        j.process(chunk)
        p.process(chunk)
        assert p.flush_epoch == j.flush_epoch, n
        assert_replicas_equal(p, j, f"call {n}")
    assert_outputs_equal(p, j, live_set(stream), "end")
    assert_replicas_equal(p, j, "flushed")
    return p, j


# --------------------------------------------------------------------------- #
# the router's pieces
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("n_shards", [1, 2, 3, 7, router.MAX_SHARDS - 1])
def test_shard_key_equals_jax(n_shards):
    rng = np.random.default_rng(n_shards)
    w = rng.integers(0, 1 << 31, (4, 512), dtype=np.int64).astype(np.int32)
    w[:, :16] = w[:, 16:32]                 # equal hi words: lo decides
    w[:, 32:40] = -1                        # padding words
    got = router.shard_key(*torch.from_numpy(w), n_shards)
    want = np.asarray(jax_router.shard_key(*w, n_shards))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    ok = slice(40, None)
    comb = np.minimum(jax_lh.combine(w[0, ok], w[1, ok]),
                      jax_lh.combine(w[2, ok], w[3, ok]))
    np.testing.assert_array_equal(got.numpy()[ok], comb % n_shards)
    assert router.MAX_SHARDS == jax_router.MAX_SHARDS


def test_router_geometry_and_lane_cap_equal_jax_at_one_device():
    mesh = make_engine_mesh(1)
    for n_shards in (1, 2, 3, 4, 24):
        for chunk in (32, 64, 1024):
            for lane_cap in (None, 1, 2, 16, 5000):
                for mdr in (None, 1, 2, 100):
                    lc = lane_cap
                    if lane_cap is None:
                        lc = router.default_lane_cap(chunk, 1, n_shards, 16)
                        assert lc == jax_router.default_lane_cap(
                            chunk, 1, n_shards, 16)
                    got = router.router_geometry(1, n_shards, chunk, lc, mdr)
                    want = jax_router.router_geometry(mesh, n_shards, chunk,
                                                      lc, mdr)
                    assert tuple(got) == tuple(want)
                    assert got._fields == want._fields
    assert router.default_lane_cap(1024, 1, 4, 256) == 1024
    for bad in (dict(chunk=7, n_shards=router.MAX_SHARDS),
                dict(chunk=8, n_shards=2, lane_cap=0)):
        with pytest.raises(ValueError):
            router.router_geometry(1, bad["n_shards"], bad["chunk"],
                                   bad.get("lane_cap", 4))


@pytest.mark.parametrize("geometry", [(32, 32, None), (32, 2, None),
                                      (64, 16, 2), (64, 1, 3)],
                         ids=["static", "drain", "bounded", "bounded_lane1"])
def test_route_stage_equals_jax(geometry):
    chunk, lane_cap, mdr = geometry
    stream = (skew_stream(24) + ba_stream(3))[:chunk - 5]
    p = ShardedSummarizer(EngineConfig(**CFG), device="cpu",
                          n_shards=SHARDS, router_chunk=chunk)
    words = p._pack_chunk(stream, pad_to=chunk)
    route, geom = router.make_route_step(SHARDS, chunk, lane_cap, mdr)
    jroute, jgeom = jax_router.make_route_step(make_engine_mesh(1), SHARDS,
                                               chunk, lane_cap, mdr)
    assert tuple(geom) == tuple(jgeom)
    buckets, counts, delivered, rounds = route(
        *torch.from_numpy(np.stack(words)))
    *jb, jcounts, jdelivered, jrounds = jroute(*words)
    for k in range(5):
        np.testing.assert_array_equal(buckets[..., k].numpy(),
                                      np.asarray(jb[k]), err_msg=str(k))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
    assert (delivered, rounds) == (int(np.asarray(jdelivered)[0]),
                                   int(np.asarray(jrounds)[0]))
    assert rounds >= 1 and (delivered < len(stream)) == (geometry[2] is not
                                                          None)


def test_intern_changes_equals_jax_with_repeats_and_a_drop():
    """Novel keys that repeat within a call, keys known from an earlier
    call, padding lanes, and a node-capacity drop (``n_cap`` 6 for 9
    keys): nids and every ``InternState`` leaf equal after each call."""
    jcfg = JaxConfig(**dict(CFG, n_cap=6))
    jist = jax_router.intern_new(jcfg)
    ist = router.intern_new(EngineConfig(**dict(CFG, n_cap=6)), "cpu")
    labels = [f"k{i}" for i in range(9)]
    calls = [[(0, 1), (1, 2), (0, 2), (2, 3), (-1, -1), (3, 0)],
             [(3, 4), (4, 0), (5, 4), (6, 5), (4, 7), (8, 8), (1, 7)]]
    for n, pairs in enumerate(calls):
        uh, ul = labelhash.hash_words([labels[max(a, 0)] for a, _ in pairs])
        vh, vl = labelhash.hash_words([labels[max(b, 0)] for _, b in pairs])
        pad = np.array([a < 0 for a, _ in pairs])
        uh[pad] = vh[pad] = -1
        jist, ju, jv = jax_router.intern_changes(jist, uh, ul, vh, vl,
                                                 jcfg.n_cap)
        u, v = router.intern_changes(ist, *(torch.from_numpy(w) for w in
                                            (uh, ul, vh, vl)), 6)
        np.testing.assert_array_equal(u, np.asarray(ju), err_msg=str(n))
        np.testing.assert_array_equal(v, np.asarray(jv), err_msg=str(n))
        assert_leaves_equal(
            {"h2l": {w: getattr(ist.h2l, w).numpy()
                     for w in ("k1", "k2", "val")},
             "l2h": ist.l2h.numpy(), "n_nodes": ist.n_nodes.numpy(),
             "n_dropped": ist.n_dropped.numpy()}, jax_leaves(jist),
            f"call {n}")
    assert int(ist.n_nodes) == 6 and int(ist.n_dropped) > 1


def test_converters_round_trip_and_initial_replicas_equal_jax():
    j = JaxSharded(JaxConfig(**dict(CFG, seed=7)), n_shards=4,
                   trial_backend="xla", replica_exec="map")
    est, ist = jax_leaves(j.state), jax_leaves(j.intern)
    ests, ists = router.sharded_state_from_numpy(est, ist, "cpu")
    got_e, got_i = router.sharded_state_to_numpy(ests, ists)
    assert_leaves_equal(got_e, est, "round trip engine")
    assert_leaves_equal(got_i, ist, "round trip intern")
    p = ShardedSummarizer(EngineConfig(**dict(CFG, seed=7)), device="cpu",
                          n_shards=4)
    new_e, new_i = router.sharded_state_to_numpy(p._est, p._ist)
    assert_leaves_equal(new_e, est, "new engine")      # step_no decorrelated
    assert_leaves_equal(new_i, ist, "new intern")
    assert router.intern_cap(EngineConfig(n_cap=1 << 20)) == 1 << 22
    assert router.drain_telemetry_restore(
        np.array([3]), 1, "cpu").tolist() == [3]


# --------------------------------------------------------------------------- #
# ShardedSummarizer, port against JAX after every process call
# --------------------------------------------------------------------------- #

CASES = {
    "device": (ba_stream(0), CHUNK, dict(routing="device",
                                         router_chunk=CHUNK)),
    "host": (ba_stream(0), CHUNK, dict(routing="host", router_chunk=CHUNK)),
    "skew_lane_cap_2": (skew_stream(40), CHUNK,
                        dict(routing="device", router_chunk=CHUNK,
                             lane_cap=2)),
    # acc_cap 32 as in the cases above: one JAX engine-stage compile
    "bounded_drain": (skew_stream(40) + ba_stream(1), 2 * CHUNK,
                      dict(routing="device", router_chunk=2 * CHUNK,
                           lane_cap=16, max_drain_rounds=2)),
    "no_pipeline": (ba_stream(2), CHUNK, dict(routing="device",
                                              router_chunk=CHUNK,
                                              pipeline=False)),
    "chunk_sync": (ba_stream(2), CHUNK, dict(routing="device",
                                             router_chunk=CHUNK,
                                             chunk_sync=True)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_leaf_bitwise_every_call(case):
    stream, call, skw = CASES[case]
    p, j = drive(stream, call, **skw)
    st = p.stats()
    assert st["trials"] > 0 and st["accepted"] > 0
    assert st["router_host_dict_ops"] == 0
    if case == "device":
        assert p.router_geometry.static_no_overflow
        assert st["router_pipelined"] and st["router_syncs"] == 0
    if case == "skew_lane_cap_2":
        assert st["router_drain_rounds"] >= 2 and st["router_overflows"] == 0
        # every change goes to the hub's shard; the others receive nothing
        # and still advance their PRNG cursor every engine round
        hub = stream[0][0]
        owner = p.shard_of(hub, stream[0][1])
        steps = [int(s.step_no) - router.shard_step_no(0, r)
                 for r, s in enumerate(p.states)]
        trials = [int(s.n_trials) for s in p.states]
        assert len(set(steps)) == 1 and steps[0] >= 2, steps
        assert [t > 0 for t in trials] == [r == owner
                                           for r in range(SHARDS)], trials
    if case == "bounded_drain":
        assert st["router_overflows"] > 0 and st["router_syncs"] > 0
        assert not st["router_sync_free"]
    if case == "no_pipeline":
        assert not st["router_pipelined"] and st["router_sync_free"]
    if case == "chunk_sync":
        assert st["router_syncs"] == -(-len(stream) // call)


def test_non_default_triple_leaf_bitwise_every_call():
    """Mags-DM, the weighted objective and the threshold commit through
    the router: it keys on label hashes only, whatever the triple."""
    kw = dict(CFG, proposal="magsdm", objective="weighted",
              commit="threshold", commit_margin=1, weight_levels=3)
    p, _ = drive(ba_stream(4), CHUNK, cfg_kw=kw, routing="device",
                 router_chunk=CHUNK, lane_cap=4)
    assert p.stats()["router_drain_rounds"] > 0


@pytest.mark.parametrize("case", ["device", "skew_lane_cap_2", "host"])
def test_vmap_leaf_bitwise_every_call(case):
    """The port's ``replica_exec="vmap"`` (the stacked replicas stepped as
    one batch) against JAX's ``"map"``, here so that it reuses this
    file's JAX compiles; JAX's own tests hold its ``"map"`` leaf-bitwise
    to its ``"vmap"``.  Under key skew only the hub's shard has trials,
    and every replica's PRNG cursor still advances in lock step."""
    stream, call, skw = CASES[case]
    p, _ = drive(stream, call, replica_exec="vmap", **skw)
    assert p.replica_exec == "vmap"
    st = p.stats()
    assert st["trials"] > 0 and st["accepted"] > 0
    if case == "skew_lane_cap_2":
        owner = p.shard_of(stream[0][0], stream[0][1])
        steps = [int(s.step_no) - router.shard_step_no(0, r)
                 for r, s in enumerate(p.states)]
        trials = [int(s.n_trials) for s in p.states]
        assert len(set(steps)) == 1 and steps[0] >= 2, steps
        assert [t > 0 for t in trials] == [r == owner
                                           for r in range(SHARDS)], trials


def test_vmap_non_default_triple_leaf_bitwise_every_call():
    kw = dict(CFG, proposal="magsdm", objective="weighted",
              commit="threshold", commit_margin=1, weight_levels=3)
    p, _ = drive(ba_stream(4), CHUNK, cfg_kw=kw, replica_exec="vmap",
                 routing="device", router_chunk=CHUNK, lane_cap=4)
    assert p.stats()["accepted"] > 0


# --------------------------------------------------------------------------- #
# the port on its own: capacity, collisions, labels, arguments
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("routing", ["device", "host"])
def test_node_capacity_drop_raises_at_next_sync(routing):
    p = ShardedSummarizer(EngineConfig(**dict(CFG, n_cap=8)), device="cpu",
                          n_shards=2, routing=routing, router_chunk=CHUNK)
    p.process(ba_stream(5)[:CHUNK])       # streaming itself does not raise
    with pytest.raises(RuntimeError, match="node capacity exceeded"):
        p.stats()


def test_label_hash_collision_raises():
    p = ShardedSummarizer(EngineConfig(**CFG), device="cpu", n_shards=2,
                          router_chunk=CHUNK)
    h = labelhash.hash_label("a")
    p.process([("a", "b", True)])
    p._label_buf.append((["evil-twin"], np.array([h >> 31], np.int32),
                         np.array([h & labelhash.MASK31], np.int32)))
    with pytest.raises(RuntimeError, match="hash collision"):
        p.stats()


def test_arbitrary_hashable_labels_round_trip():
    # any hashable streams; live_edges/materialize need orderable labels
    stream = [((f"n{u}", u % 3), (f"n{v}", v % 3), ins)
              for (u, v, ins) in ba_stream(6)]
    p = ShardedSummarizer(EngineConfig(**CFG), device="cpu", n_shards=2,
                          router_chunk=CHUNK).run(stream)
    live = live_set(stream)
    assert p.live_edges() == live
    assert p.materialize().decode_edges() == live
    u, v, _ = stream[0]
    assert p.shard_of(u, v) == min(labelhash.hash_label(u),
                                   labelhash.hash_label(v)) % 2
    with pytest.raises(LookupError, match="has not been streamed"):
        p.shard_of("never-a", "never-b")


def test_arguments_and_device_policy(monkeypatch):
    cfg = EngineConfig(**CFG)
    assert ShardedSummarizer(cfg, device="cpu",
                             replica_exec="vmap").replica_exec == "vmap"
    # the default follows the device, as JAX's follows the backend
    assert router.check_replica_exec(None, torch.device("cuda")) == "vmap"
    assert router.check_replica_exec(None, "cpu") == "map"
    with pytest.raises(ValueError, match="replica_exec"):
        ShardedSummarizer(cfg, device="cpu", replica_exec="pmap")
    with pytest.raises(ValueError, match="routing"):
        ShardedSummarizer(cfg, device="cpu", routing="nope")
    p = ShardedSummarizer(cfg, device="cpu")
    assert p.n_shards == 1 and p.replica_exec == "map"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ShardedSummarizer(cfg)
