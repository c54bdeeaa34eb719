"""PyTorch port: the Tier-A reference (``repro_torch.core.reference``) and
the ``proptest`` shim against the JAX package's copies.

Both packages' reference modules are plain Python, so the bar is exact:
the same stream and seed give the same phi, edge count, run statistics,
node-to-supernode map, materialized summary (supernodes, superedges, C+,
C-) and decode, at the stream's midpoint and at its end; the min-hash
clusters, the neighbor sampler, the query oracle and the shim's examples
draw the same values.  Streams come from each package's own
``graph/streams.py``, which must agree too.
"""
import dataclasses
import random

import pytest

pytest.importorskip("torch")

from repro.core import reference as jref  # noqa: E402
from repro.core.summary import ShardedSummaryOutput as JSharded  # noqa: E402
from repro.graph import streams as jstreams  # noqa: E402
from repro.testing import proptest as jshim  # noqa: E402
from repro_torch.core import reference as tref  # noqa: E402
from repro_torch.core.summary import ShardedSummaryOutput as TSharded  # noqa: E402,E501
from repro_torch.graph import streams as tstreams  # noqa: E402
from repro_torch.testing import proptest as tshim  # noqa: E402

STREAMS = {
    "sbm": lambda s: s.edges_to_fully_dynamic_stream(
        s.sbm_edges(64, 4, 0.5, 0.03, seed=3), delete_prob=0.15, seed=5),
    "ba": lambda s: s.edges_to_fully_dynamic_stream(
        s.barabasi_albert_edges(56, 3, seed=4), delete_prob=0.15, seed=6),
}


def _stream(name):
    want = STREAMS[name](jstreams)
    assert STREAMS[name](tstreams) == want
    return want


def _output(out) -> tuple:
    """A materialized summary as plain data (the two packages' dataclasses
    are different classes)."""
    return ({sid: frozenset(m) for sid, m in out.supernodes.items()},
            set(out.superedges), set(out.c_plus), set(out.c_minus))


def _assert_same(got, want, tag: str) -> None:
    assert got.s.phi == want.s.phi, tag
    assert got.s.num_edges == want.s.num_edges, tag
    assert dataclasses.asdict(got.stats) == dataclasses.asdict(want.stats), tag
    assert got.s.n2s == want.s.n2s, tag
    g, w = got.s.materialize(), want.s.materialize()
    assert _output(g) == _output(w), tag
    assert g.phi == w.phi, tag
    weigh = getattr(got.s, "_w", None)
    assert got.s.phi == (g.phi_weighted(weigh) if weigh else g.phi), tag
    assert g.decode_edges() == w.decode_edges(), tag


def _make(pkg, algo: str, weighted: bool, seed: int = 7):
    a = pkg.ALGORITHMS[algo](seed=seed)
    if weighted:
        a.s = pkg.WeightedDynamicSummary(weight_levels=3)
    return a


@pytest.mark.parametrize("stream", sorted(STREAMS))
@pytest.mark.parametrize("algo,weighted", [
    ("greedy", False), ("mcmc", False), ("simple", False), ("mosso", False),
    ("mags", False), ("mosso", True)])
def test_algorithms_equal_jax_reference(stream, algo, weighted):
    """Every ``ALGORITHMS`` entry (and ``MoSSo`` over the weighted state
    machine) run by both packages on one stream: equal at the midpoint and
    at the end, with ``phi_history`` recorded every 16 changes."""
    changes = _stream(stream)
    got, want = _make(tref, algo, weighted), _make(jref, algo, weighted)
    half = len(changes) // 2
    for part, tag in ((changes[:half], "midpoint"), (changes[half:], "end")):
        got.run(part, record_every=16)
        want.run(part, record_every=16)
        _assert_same(got, want, f"{algo} weighted={weighted} {tag}")
    assert got.stats.trials > 0 and got.stats.changes == len(changes)
    if weighted:
        assert got.s.phi == got.s.phi_recomputed()


def test_minhash_and_sampler_draws_equal():
    """``MinHashClusters`` (hashes, clusters, same-cluster answers under
    inserts and deletes) and ``get_random_neighbors`` (draws from one
    seeded ``random.Random``) equal the JAX package's."""
    changes = _stream("sbm")
    summaries = (tref.DynamicSummary(), jref.DynamicSummary())
    clusters = (tref.MinHashClusters(seed=11), jref.MinHashClusters(seed=11))
    for (u, v, ins) in changes:
        for s, mh in zip(summaries, clusters):
            if ins:
                s.insert(u, v)
                mh.on_insert(s, u, v)
            else:
                s.delete(u, v)
                mh.on_delete(s, u, v)
    nodes = sorted(summaries[1].n2s)
    t, j = clusters
    assert [t.hash_node(u) for u in range(200)] == \
        [j.hash_node(u) for u in range(200)]
    assert t.minh == j.minh
    assert [t.same_cluster(u, v) for u in nodes for v in nodes[:8]] == \
        [j.same_cluster(u, v) for u in nodes for v in nodes[:8]]
    # move some nodes so that neighborhoods span P and C+ / C-
    for s in summaries:
        for y, target in ((nodes[1], s.n2s[nodes[0]]),
                          (nodes[3], s.n2s[nodes[2]])):
            s.move(y, target)
    draws = []
    for s, sampler in ((summaries[0], tref.get_random_neighbors),
                       (summaries[1], jref.get_random_neighbors)):
        rng = random.Random(5)
        draws.append([sampler(s, u, 9, rng) for u in nodes])
    assert draws[0] == draws[1]
    assert any(draws[0])


def _summary_algo(pkg):
    a = pkg.MoSSo(seed=3, c=24)
    a.run(STREAMS["sbm"](jstreams))
    return a


@pytest.mark.parametrize("sharded", [False, True])
def test_query_oracle_answers_equal(sharded):
    """``SummaryQueryOracle`` neighbors / degree / has_edge over a
    ``SummaryOutput`` and over a two-part ``ShardedSummaryOutput`` (the
    stream's edges split by parity of ``u + v``, supernode ids offset per
    part) equal the JAX package's answers and the decode."""
    outs = []
    for pkg, sharded_cls in ((tref, TSharded), (jref, JSharded)):
        if not sharded:
            outs.append(_summary_algo(pkg).s.materialize())
            continue
        parts = []
        for parity in (0, 1):
            a = pkg.MoSSo(seed=3 + parity, c=24)
            a.run([c for c in STREAMS["sbm"](jstreams)
                   if (c[0] + c[1]) % 2 == parity])
            out = a.s.materialize()
            off = 10_000 * parity
            parts.append(type(out)(
                supernodes={sid + off: set(m)
                            for sid, m in out.supernodes.items()},
                superedges={(x + off, y + off) for (x, y) in out.superedges},
                c_plus=set(out.c_plus), c_minus=set(out.c_minus)))
        outs.append(sharded_cls(parts).validate())
    t_oracle, j_oracle = (pkg.SummaryQueryOracle(out)
                          for pkg, out in zip((tref, jref), outs))
    edges = (outs[1].decode_edges() if not sharded else
             set().union(*(p.decode_edges() for p in outs[1].shards)))
    nodes = sorted({u for e in edges for u in e})
    for oracle in (t_oracle, j_oracle):       # a label in no part
        with pytest.raises(LookupError, match="no summary part"):
            oracle.degree(999)
    for u in nodes:
        assert t_oracle.neighbors(u) == j_oracle.neighbors(u)
        assert t_oracle.degree(u) == j_oracle.degree(u)
        assert t_oracle.neighbors(u) == {
            y if x == u else x for (x, y) in edges if u in (x, y)}
    for u in nodes[:20]:
        for v in nodes:
            assert t_oracle.has_edge(u, v) == j_oracle.has_edge(u, v) == (
                (min(u, v), max(u, v)) in edges)


def _shim_examples(shim) -> list:
    seen = []
    st = shim.strategies

    @shim.settings(max_examples=12)
    @shim.given(st.integers(-5, 500), st.floats(0.0, 1.0), st.booleans(),
                st.sampled_from(["a", "b", "c"]),
                st.tuples(st.integers(0, 9), st.booleans()),
                st.lists(st.integers(0, 3), min_size=1, max_size=6),
                st.integers(0, 9).map(lambda x: x * x), st.randoms())
    def prop(a, b, c, d, e, f, g, rng):
        seen.append((a, b, c, d, e, f, g, rng.random()))

    prop()
    return seen


def test_proptest_shim_draws_the_same_examples():
    """The port's ``proptest`` copy draws the JAX package's examples for a
    property of one name, strategy by strategy, and annotates a failing
    example the same way."""
    got, want = _shim_examples(tshim), _shim_examples(jshim)
    assert got == want and len(got) == 12

    def failing(shim):
        @shim.given(shim.strategies.integers(0, 100))
        def prop(x):
            assert x < 0
        with pytest.raises(AssertionError) as err:
            prop()
        return str(err.value)

    assert failing(tshim) == failing(jshim)
    assert "property falsified on example 0/" in failing(tshim)
