"""PyTorch port: the sharded tier over a mesh of positions, bitwise.

The port's route stage and ``ShardedSummarizer`` at
``EngineMesh(["cpu"] * 8)`` against the JAX package's on a mesh of eight
fake host devices (``XLA_FLAGS=--xla_force_host_platform_device_count=8``,
in one subprocess per module: ``torch_mesh_jax.run_jax_8``), ``n_shards``
8 and 16: the route stage's buckets, counts, ``delivered`` and
``rounds``; the summarizer's host states after every ``process`` call
(flushed), in both ``replica_exec`` modes, device and host routing,
pipelined or not, on a balanced stream, JAX's hub stream at ``lane_cap``
2 (several drain rounds) and a lowered ``max_drain_rounds`` that spills
to the host path; then ``stats()``, ``shard_phis()``, ``live_edges()``
and the merged decode.  JAX runs ``trial_backend="xla"`` and its CPU
default ``replica_exec="map"`` (leaf-bitwise equal to ``"vmap"`` by its
own contract).  In this process, without JAX: the port at 1, 2, 4 and 8
positions bitwise to each other, JAX's ``ValueError``s, the host-read and
probe counters by position, and the parent's counts at one position
pinned.  Tolerance: exact.
"""
from collections import Counter

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.engine import EngineConfig  # noqa: E402
from repro_torch.core.engine import ShardedSummarizer  # noqa: E402
from repro_torch.core.engine.ops import host_read  # noqa: E402
from repro_torch.core.engine.ops import reset_host_reads  # noqa: E402
from repro_torch.device import current_position  # noqa: E402
from repro_torch.dist import router  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.launch.mesh import EngineMesh  # noqa: E402
from test_torch_router import CFG, ba_stream, live_set  # noqa: E402
from test_torch_router import skew_stream  # noqa: E402
from torch_mesh_jax import assert_trees_equal, run_jax_8  # noqa: E402

MESH_CFG = dict(CFG, batch=8)
CALL = 32                       # process call = router chunk
STREAMS = {"ba": ba_stream(0)[:96], "hub": skew_stream(40),
           "spill": skew_stream(24) + ba_stream(1)[:40]}
# (stream, summarizer kwargs) of the JAX runs; every one has acc_cap 32
# at 8 devices, so JAX compiles one engine stage for them all
RUNS = {"device": ("ba", dict(routing="device")),
        "host": ("ba", dict(routing="host")),
        "hub": ("hub", dict(routing="device", lane_cap=2)),
        "spill": ("spill", dict(routing="device", lane_cap=2,
                                max_drain_rounds=4))}
# (n_shards, chunk, lane_cap, max_drain_rounds, stream) of the route stage
ROUTES = [(16, 32, 4, None, "ba"), (16, 32, 2, None, "hub"),
          (16, 32, 2, 4, "spill"), (8, 64, 8, None, "ba"),
          (8, 64, 2, None, "hub"), (8, 64, 2, 3, "spill")]

JAX_CODE = """
from repro.core.engine import ShardedSummarizer
from repro.core.engine.state import EngineConfig
from repro.dist import router as jr
from repro.launch.mesh import make_engine_mesh

mesh = make_engine_mesh(8)
cfg = EngineConfig(**IN["cfg"])
OUT["geometry"] = {
    key: tuple(jr.router_geometry(mesh, *key))
    for key in IN["geometries"]}
OUT["routes"] = {}
for key, words in IN["routes"].items():
    n_shards, chunk, lane_cap, mdr, _ = key
    route, geom = jr.make_route_step(mesh, n_shards, chunk, lane_cap, mdr)
    *buckets, counts, delivered, rounds = route(*words)
    OUT["routes"][key] = (np.stack([np.asarray(b) for b in buckets], -1),
                          np.asarray(counts), np.asarray(delivered),
                          np.asarray(rounds), tuple(geom))
OUT["runs"] = {}
for name, (stream, kw) in IN["runs"].items():
    s = ShardedSummarizer(cfg, n_shards=16, router_chunk=IN["call"],
                          trial_backend="xla", replica_exec="map", **kw)
    assert s.router_geometry is None or s.router_geometry.n_dev == 8
    snaps = []
    for off in range(0, len(stream), IN["call"]):
        s.process(stream[off:off + IN["call"]])
        snaps.append(flushed(s))
    out = s.materialize()
    OUT["runs"][name] = dict(
        snaps=snaps, stats=s.stats(), phis=s.shard_phis(),
        live=s.live_edges(), decoded=out.decode_edges(),
        geometry=(s.lane_cap, s.max_drain_rounds, s.sync_free,
                  s.pipeline, s.router_chunk))
errors = {}
for what, make in (
        ("n_shards", lambda: ShardedSummarizer(cfg, mesh=mesh,
                                               n_shards=12)),
        ("chunk", lambda: jr.router_geometry(mesh, 16, 60, 4)),
        ("route_chunk", lambda: jr.make_route_step(mesh, 16, 60, 4))):
    try:
        make()
    except ValueError as e:
        errors[what] = str(e)
OUT["errors"] = errors
"""

GEOMETRIES = [(n_shards, chunk, lane_cap, mdr)
              for n_shards in (8, 16, 24) for chunk in (32, 64, 1024)
              for lane_cap in (1, 2, 8, 5000) for mdr in (None, 1, 3, 100)]


def mesh(n: int) -> EngineMesh:
    return EngineMesh(["cpu"] * n)


def packed(stream, chunk: int) -> np.ndarray:
    """The ``int32[5, chunk]`` hash words of a chunk, as the summarizer
    packs them."""
    p = ShardedSummarizer(EngineConfig(**MESH_CFG), device="cpu",
                          n_shards=1, router_chunk=chunk)
    return np.stack(p._pack_chunk(stream[:chunk], pad_to=chunk))


@pytest.fixture(scope="module")
def jax8(tmp_path_factory):
    routes = {key: tuple(packed(STREAMS[key[4]], key[1]))
              for key in ROUTES}
    return run_jax_8(JAX_CODE, dict(
        cfg=MESH_CFG, call=CALL, geometries=GEOMETRIES, routes=routes,
        runs={name: (STREAMS[s], kw) for name, (s, kw) in RUNS.items()}),
        tmp_path_factory.mktemp("jax8"))


def summarizer(n_dev: int = 8, n_shards: int = 16, **kw):
    return ShardedSummarizer(EngineConfig(**MESH_CFG), mesh=mesh(n_dev),
                             n_shards=n_shards, router_chunk=CALL, **kw)


def flushed(p):
    p.flush()
    return router.sharded_state_to_numpy(p._est, p._ist)


def drive(p, stream):
    """Every ``process`` call's flushed host state."""
    snaps = []
    for off in range(0, len(stream), CALL):
        p.process(stream[off:off + CALL])
        snaps.append(flushed(p))
    return snaps


# --------------------------------------------------------------------------- #
# the route stage and its geometry against JAX at 8 devices
# --------------------------------------------------------------------------- #


def test_router_geometry_equals_jax_at_8_devices(jax8):
    for key in GEOMETRIES:
        assert tuple(router.router_geometry(8, *key)) == \
            jax8["geometry"][key], key


@pytest.mark.parametrize("key", ROUTES, ids=[
    f"s{k[0]}-c{k[1]}-lane{k[2]}-mdr{k[3]}-{k[4]}" for k in ROUTES])
def test_route_stage_equals_jax_at_8_devices(jax8, key):
    n_shards, chunk, lane_cap, mdr, name = key
    words = torch.from_numpy(packed(STREAMS[name], chunk))
    route, geom = router.make_route_step(8, n_shards, chunk, lane_cap, mdr)
    n_in = chunk // 8
    buckets, counts, delivered, rounds = route(
        [words[:, d * n_in:(d + 1) * n_in].contiguous() for d in range(8)])
    want_b, want_c, want_d, want_r, want_geom = jax8["routes"][key]
    assert tuple(geom) == want_geom
    assert len(buckets) == len(counts) == 8
    np.testing.assert_array_equal(torch.cat(buckets).numpy(), want_b)
    np.testing.assert_array_equal(torch.cat(counts).numpy(), want_c)
    assert [delivered] * 8 == want_d.tolist()
    assert [rounds] * 8 == want_r.tolist()
    if name == "hub":
        assert rounds >= 2 and delivered == chunk
    if name == "spill":
        assert delivered < min(chunk, len(STREAMS[name]))


# --------------------------------------------------------------------------- #
# ShardedSummarizer at 8 positions against JAX at 8 devices
# --------------------------------------------------------------------------- #

# (JAX run, port kwargs): both layouts, both routings, pipelined or not
VARIANTS = {
    "device-map": ("device", dict(replica_exec="map")),
    "device-vmap": ("device", dict(replica_exec="vmap")),
    "device-vmap-no-pipeline": ("device", dict(replica_exec="vmap",
                                               pipeline=False)),
    "host-map": ("host", dict(replica_exec="map")),
    "host-vmap": ("host", dict(replica_exec="vmap")),
    "hub-map": ("hub", dict(replica_exec="map")),
    "hub-vmap": ("hub", dict(replica_exec="vmap")),
    "spill-map": ("spill", dict(replica_exec="map")),
    "spill-vmap": ("spill", dict(replica_exec="vmap")),
}


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_sharded_at_8_positions_equals_jax_every_call(jax8, variant):
    run, kw = VARIANTS[variant]
    stream_name, run_kw = RUNS[run]
    stream = STREAMS[stream_name]
    ref = jax8["runs"][run]
    p = summarizer(**run_kw, **kw)
    assert p.router_geometry is None or p.router_geometry.n_dev == 8
    lane_cap, mdr, sync_free, pipeline, chunk = ref["geometry"]
    assert (p.lane_cap, p.max_drain_rounds, p.sync_free, p.router_chunk) \
        == (lane_cap, mdr, sync_free, chunk)
    assert p.pipeline == (pipeline and kw.get("pipeline", True))
    for n, (got, want) in enumerate(zip(drive(p, stream), ref["snaps"])):
        assert_trees_equal(got, want, f"{variant} call {n}")
    assert len(ref["snaps"]) == -(-len(stream) // CALL)
    stats = p.stats()
    assert stats == dict(ref["stats"], router_pipelined=p.pipeline)
    assert p.shard_phis() == ref["phis"]
    live = live_set(stream)
    assert p.live_edges() == ref["live"] == live
    assert p.materialize().validate().decode_edges() == ref["decoded"]
    assert stats["router_host_dict_ops"] == 0 and stats["trials"] > 0
    if run == "hub":
        assert stats["router_drain_rounds"] >= 2
        assert stats["router_overflows"] == 0
    if run == "spill":
        assert stats["router_overflows"] > 0 and stats["router_syncs"] > 0


def test_value_errors_equal_jax(jax8):
    errors = jax8["errors"]
    with pytest.raises(ValueError) as e:
        summarizer(n_shards=12)
    assert str(e.value) == errors["n_shards"]
    with pytest.raises(ValueError) as e:
        router.router_geometry(8, 16, 60, 4)
    assert str(e.value) == errors["chunk"]
    with pytest.raises(ValueError) as e:
        router.make_route_step(8, 16, 60, 4)
    assert str(e.value) == errors["route_chunk"]
    # the summarizer rounds its chunk up to a multiple of the positions
    assert ShardedSummarizer(EngineConfig(**MESH_CFG), mesh=mesh(8),
                             n_shards=16, router_chunk=60).router_chunk == 64
    with pytest.raises(ValueError, match="not both"):
        ShardedSummarizer(EngineConfig(**MESH_CFG), mesh=mesh(2),
                          device="cpu", n_shards=2)
    with pytest.raises(ValueError, match="not present"):
        EngineMesh(["cpu", f"cuda:{torch.cuda.device_count()}"])
    three = summarizer(n_dev=1, n_shards=3)
    with pytest.raises(ValueError, match="split over"):
        router.sharded_blocks_from_numpy(
            *router.sharded_state_to_numpy(three._est, three._ist),
            [torch.device("cpu")] * 2)


# --------------------------------------------------------------------------- #
# in this process: topologies, counters, the parent's counts
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("stream_name,kw", [
    ("ba", dict(replica_exec="vmap")),
    ("hub", dict(replica_exec="map", lane_cap=2))],
    ids=["device-vmap", "hub-map"])
def test_positions_1_2_4_8_bitwise_to_each_other(stream_name, kw):
    """The same replicas whatever the number of positions: placement,
    lanes and drain rounds move, the buckets and the bits do not."""
    stream = STREAMS[stream_name]
    runs = {n: summarizer(n_dev=n, **kw) for n in (1, 2, 4, 8)}
    snaps = {n: drive(p, stream) for n, p in runs.items()}
    for n in (2, 4, 8):
        for c, (got, want) in enumerate(zip(snaps[n], snaps[1])):
            assert_trees_equal(got, want, f"{n} positions, call {c}")
    stats = {n: p.stats() for n, p in runs.items()}
    for n in (2, 4, 8):
        for k in ("phi", "num_edges", "trials", "accepted", "skipped"):
            assert stats[n][k] == stats[1][k], (n, k)
        assert runs[n].live_edges() == live_set(stream)
        assert len(runs[n]._est) == n
        assert {t.device for e in runs[n]._est
                for t in (e.n2s, e.adj.k1)} == {torch.device("cpu")}


class Counts:
    """Host reads, probe dispatcher calls and their kernel jobs (each
    call is one launch on the card, up to 48 jobs), in total and by
    position, counted while installed."""

    def __init__(self, monkeypatch):
        self.calls, self.jobs = Counter(), Counter()
        inner = kops.ht_probe_many

        def counting(jobs):
            pos = current_position()
            self.calls[pos] += 1
            self.jobs[pos] += sum(j[0].shape[0] if j[0].dim() == 2
                                  else 1 for j in jobs)
            return inner(jobs)
        monkeypatch.setattr(kops, "ht_probe_many", counting)
        reset_host_reads()

    def read(self) -> dict:
        return dict(reads=host_read.count,
                    reads_by_position=dict(host_read.by_position),
                    calls=dict(self.calls), jobs=dict(self.jobs))


@pytest.mark.parametrize("routing", ["device", "host"])
def test_counters_by_position_add_up_to_the_totals(monkeypatch, routing):
    """Every position's host reads and probe calls are counted under it;
    the route stage's reads (JAX's ``pmin``) under no position; a second
    run of the same stream counts the same."""
    stream = STREAMS["hub"]
    got = []
    for _ in range(2):
        counts = Counts(monkeypatch)
        p = summarizer(n_dev=4, n_shards=8, replica_exec="vmap",
                       routing=routing, lane_cap=2)
        snaps = drive(p, stream)
        got.append((counts.read(), snaps, p.stats()["router_drain_rounds"]))
    (first, a, drained), (second, b, _) = got
    assert first == second
    for c, (x, y) in enumerate(zip(a, b)):
        assert_trees_equal(x, y, f"second run, call {c}")
    by_pos = first["reads_by_position"]
    assert sum(by_pos.values()) == first["reads"]
    assert set(first["calls"]) == set(first["jobs"]) == {0, 1, 2, 3}
    assert all(by_pos[d] > 0 for d in range(4))
    if routing == "device":
        assert drained >= 2 and by_pos.get(None, 0) > 0
    else:
        assert None not in by_pos and None not in first["calls"]


# the parent's counts at one position (n_shards 3, batch 16), measured on
# the tree before the mesh: host reads, probe dispatcher calls, jobs
PARENT_RUNS = {
    "device-vmap": (ba_stream(0), dict(router_chunk=32, replica_exec="vmap"),
                    (1058, 2294, 9723)),
    "skew-map": (skew_stream(40), dict(router_chunk=32, lane_cap=2,
                                       replica_exec="map"),
                 (1406, 2404, 2882)),
}
# (chunk, lane_cap, max_drain_rounds): host reads, delivered, rounds
PARENT_ROUTES = {(32, 32, None): (0, 32, 1), (32, 2, None): (14, 32, 14),
                 (64, 16, 2): (2, 43, 2), (64, 1, 3): (3, 3, 3)}


@pytest.mark.parametrize("case", list(PARENT_RUNS))
def test_one_position_keeps_the_parents_reads_and_launches(monkeypatch,
                                                           case):
    stream, kw, (reads, calls, jobs) = PARENT_RUNS[case]
    counts = Counts(monkeypatch)
    p = ShardedSummarizer(EngineConfig(**CFG), device="cpu", n_shards=3,
                          **kw)
    assert len(p.devices) == 1
    p.process(stream)
    p.flush()
    got = counts.read()
    assert (got["reads"], sum(got["calls"].values()),
            sum(got["jobs"].values())) == (reads, calls, jobs)


def test_one_position_route_stage_keeps_the_parents_reads():
    stream = (skew_stream(24) + ba_stream(3))
    for (chunk, lane_cap, mdr), want in PARENT_ROUTES.items():
        words = ShardedSummarizer(
            EngineConfig(**CFG), device="cpu", n_shards=3,
            router_chunk=chunk)._pack_chunk(stream[:chunk - 5], pad_to=chunk)
        route, _ = router.make_route_step(1, 3, chunk, lane_cap, mdr)
        host_read.count = 0
        _, _, delivered, rounds = route([torch.from_numpy(np.stack(words))])
        assert (host_read.count, delivered, rounds) == want
