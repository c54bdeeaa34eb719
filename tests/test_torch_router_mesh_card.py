"""The sharded tier's mesh on the card against the CPU.

Every test here needs a CUDA device and skips without one; the file
imports no JAX, so it runs on a machine with the card:

    PYTHONPATH=src python -m pytest -q tests/test_torch_router_mesh_card.py

The route stage at 2 and 4 positions on the card (the first distinct
cards where the host has enough, else one card at every position: the
exchange is then a copy on one device) against the same positions on the
CPU; ``ShardedSummarizer`` at 4 positions on the card against 4 on the
CPU after every ``process`` call; and, on a host with two or more cards,
a probe launch on ``cuda:1`` while ``cuda:0`` is current, bitwise to the
plain version.  Tolerance: exact.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.engine import EngineConfig  # noqa: E402
from repro_torch.core.engine import ShardedSummarizer  # noqa: E402
from repro_torch.dist import labelhash, router  # noqa: E402
from repro_torch.graph.streams import (  # noqa: E402
    barabasi_albert_edges, edges_to_fully_dynamic_stream)
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.ht_probe import ht_probe_many_plain  # noqa: E402
from repro_torch.launch.mesh import EngineMesh  # noqa: E402

pytestmark = pytest.mark.cuda

CFG = dict(n_cap=128, m_cap=1024, d_cap=32, sn_cap=24, c=8, batch=8,
           escape=0.3)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def card_positions(n: int):
    count = torch.cuda.device_count()
    if count >= n:
        return [f"cuda:{i}" for i in range(n)]
    return ["cuda:0"] * n


def stream():
    edges = barabasi_albert_edges(40, 3, 0)
    leaves = [f"x{i:03d}" for i in range(24)]
    lo = min(labelhash.hash_label(x) for x in leaves)
    hub = next(h for h in (f"hub{j}" for j in range(100_000))
               if labelhash.hash_label(h) < lo)
    return ([(hub, x, True) for x in leaves]
            + edges_to_fully_dynamic_stream(edges, delete_prob=0.15,
                                            seed=1)[:72])


@pytest.mark.parametrize("n_dev", [2, 4])
@pytest.mark.parametrize("lane_cap,mdr", [(16, None), (2, None), (2, 3)],
                         ids=["balanced", "drain", "bounded"])
def test_route_stage_on_the_card_equals_the_cpu(card, n_dev, lane_cap, mdr):
    chunk, n_shards = 64, 8
    p = ShardedSummarizer(EngineConfig(**CFG), device="cpu", n_shards=1,
                          router_chunk=chunk)
    words = torch.from_numpy(np.stack(
        p._pack_chunk(stream()[:chunk], pad_to=chunk)))
    n_in = chunk // n_dev
    route, _ = router.make_route_step(n_dev, n_shards, chunk, lane_cap, mdr)
    out = {}
    for name, devs in (("card", card_positions(n_dev)),
                       ("cpu", ["cpu"] * n_dev)):
        buckets, counts, delivered, rounds = route(
            [words[:, d * n_in:(d + 1) * n_in].contiguous().to(dev)
             for d, dev in enumerate(devs)])
        assert [b.device for b in buckets] == [torch.device(d) for d in devs]
        out[name] = (torch.cat([b.cpu() for b in buckets]),
                     torch.cat([c.cpu() for c in counts]), delivered, rounds)
    assert torch.equal(out["card"][0], out["cpu"][0])
    assert torch.equal(out["card"][1], out["cpu"][1])
    assert out["card"][2:] == out["cpu"][2:]


def test_sharded_at_4_positions_on_the_card_equals_the_cpu(card):
    changes = stream()
    runs = {name: ShardedSummarizer(EngineConfig(**CFG),
                                    mesh=EngineMesh(devs), n_shards=8,
                                    router_chunk=32, lane_cap=2)
            for name, devs in (("card", card_positions(4)),
                               ("cpu", ["cpu"] * 4))}
    assert runs["card"].replica_exec == "vmap"
    ops.reset_counts()
    for off in range(0, len(changes), 32):
        snaps = []
        for p in runs.values():
            p.process(changes[off:off + 32])
            p.flush()
            snaps.append(router.sharded_state_to_numpy(p._est, p._ist))
        for part_a, part_b in zip(*snaps):
            for k, v in part_b.items():
                if isinstance(v, dict):
                    for w in v:
                        np.testing.assert_array_equal(part_a[k][w], v[w])
                else:
                    np.testing.assert_array_equal(part_a[k], v)
    assert runs["card"].stats() == dict(runs["cpu"].stats(),
                                        router_pipelined=True)
    assert ops.ht_probe.launches > 0
    assert set(ops.ht_probe.by_position) == {0, 1, 2, 3}


def test_probe_on_a_second_card_while_the_first_is_current(card):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    rng = np.random.default_rng(0)
    cap, lanes = 1 << 12, 300
    k1, k2 = (torch.from_numpy(rng.integers(0, 1 << 30, cap, dtype=np.int64)
                               .astype(np.int32)) for _ in range(2))
    k1[rng.random(cap) < 0.5] = -1          # EMPTY slots
    val = torch.arange(cap, dtype=torch.int32)
    q1 = torch.cat([k1[k1 >= 0][:lanes // 2],
                    torch.randint(0, 1 << 30, (lanes // 2,),
                                  dtype=torch.int32)])
    q2 = torch.cat([k2[k1 >= 0][:lanes // 2],
                    torch.randint(0, 1 << 30, (lanes // 2,),
                                  dtype=torch.int32)])
    job = (k1, k2, val, q1, q2, False, "find")
    want = ht_probe_many_plain([job])[0]
    torch.cuda.set_device(0)
    got = ops.ht_probe_many([tuple(t.to("cuda:1") if torch.is_tensor(t)
                                   else t for t in job)])[0]
    assert torch.cuda.current_device() == 0
    for g, w in zip(got, want):
        assert g.device == torch.device("cuda", 1)
        assert torch.equal(g.cpu(), w)
