"""PyTorch port: the single-engine query path against the JAX one.

The same stream goes through the JAX ``BatchedSummarizer`` and the port's
(on the CPU); their states must be leaf-bitwise equal, and the two
``SummaryQuery`` views must give identical answers to ``neighbors``,
``degree`` and ``has_edge`` — which must also equal the stream's live
edge set.  Plus the view's contracts: ``LookupError`` on unseen labels,
and a pinned view keeps answering its epoch after more ``process()``
calls (the port's engine updates its tensors in place).
"""
import random

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core.engine import BatchedSummarizer as JaxSummarizer  # noqa: E402
from repro.core.engine.state import EngineConfig as JaxConfig  # noqa: E402
from repro_torch.core.engine import BatchedSummarizer  # noqa: E402
from repro_torch.core.engine.state import (EngineConfig,  # noqa: E402
                                           state_to_numpy)
from repro_torch.serve.query import _pad_pow2  # noqa: E402
from test_torch_engine import (BASE, assert_leaves_equal,  # noqa: E402
                               jax_leaves, sbm_stream)


def _adjacency(stream):
    live = set()
    for (u, v, ins) in stream:
        e = (min(u, v), max(u, v))
        live.add(e) if ins else live.discard(e)
    adj = {}
    for (u, v) in live:
        adj.setdefault(u, set()).add(v)
        adj.setdefault(v, set()).add(u)
    return live, adj


@pytest.fixture(scope="module")
def both():
    stream = sbm_stream(3)
    half = len(stream) // 2
    jax_bs = JaxSummarizer(JaxConfig(**BASE), trial_backend="xla")
    port = BatchedSummarizer(EngineConfig(**BASE), device="cpu")
    jax_bs.process(stream[:half])
    port.process(stream[:half])
    return stream, half, jax_bs, port


def test_answers_identical_to_jax_and_to_the_edge_set(both):
    stream, half, jax_bs, port = both
    assert_leaves_equal(state_to_numpy(port.state),
                        jax_leaves(jax_bs.state), "after half the stream")
    jv, tv = jax_bs.query(), port.query()
    assert tv.epoch == jv.epoch == port.flush_epoch
    labels = tv.seen_labels()
    assert labels == jv.seen_labels()
    live, adj = _adjacency(stream[:half])
    rng = random.Random(0)
    pairs = sorted(live)[::2] + [(rng.choice(labels), rng.choice(labels))
                                 for _ in range(60)] + [(labels[0],
                                                         labels[0])]
    got = (tv.neighbors_batch(labels), tv.degree_batch(labels),
           tv.has_edge_batch(pairs))
    want = (jv.neighbors_batch(labels), jv.degree_batch(labels),
            jv.has_edge_batch(pairs))
    assert got == want
    assert got[0] == [adj.get(x, set()) for x in labels]
    assert got[1] == [len(adj.get(x, ())) for x in labels]
    assert got[2] == [(min(a, b), max(a, b)) in live for (a, b) in pairs]
    assert tv.neighbors(labels[1]) == jv.neighbors(labels[1])
    assert tv.degree(labels[1]) == jv.degree(labels[1])
    assert tv.has_edge(*pairs[0]) is True


def test_unseen_labels_raise_lookup_error(both):
    stream, half, _, port = both
    view = port.query()
    later = {x for (u, v, _) in stream[half:] for x in (u, v)}
    later -= set(view.seen_labels())
    with pytest.raises(LookupError):
        view.degree("never-streamed")
    with pytest.raises(LookupError):
        view.neighbors_batch([view.seen_labels()[0], 10 ** 9])
    with pytest.raises(LookupError):
        view.has_edge(view.seen_labels()[0], -7)
    if later:       # streamed after the snapshot: unseen by this view
        fresh = BatchedSummarizer(EngineConfig(**BASE), device="cpu")
        fresh.process(stream[:half])
        pinned = fresh.query()
        fresh.process(stream[half:])
        with pytest.raises(LookupError):
            pinned.degree(next(iter(later)))


def test_pinned_view_keeps_its_epoch_after_more_process_calls():
    stream = sbm_stream(4)
    third = len(stream) // 3
    bs = BatchedSummarizer(EngineConfig(**BASE), device="cpu")
    bs.process(stream[:third])
    view = bs.query()
    labels = view.seen_labels()
    before = (view.neighbors_batch(labels), view.degree_batch(labels))
    bs.process(stream[third:])               # in-place engine updates
    live, adj = _adjacency(stream[:third])
    after = (view.neighbors_batch(labels), view.degree_batch(labels))
    assert after == before
    assert after[0] == [adj.get(x, set()) for x in labels]
    assert after[1] == [len(adj.get(x, ())) for x in labels]
    assert view.epoch < bs.flush_epoch
    now, adj_now = bs.query(), _adjacency(stream)[1]
    assert now.degree_batch(labels) == [len(adj_now.get(x, ()))
                                        for x in labels]


def test_pad_pow2():
    a = np.arange(3, dtype=np.int32)
    assert _pad_pow2(a, -1).tolist() == [0, 1, 2] + [-1] * 5
    assert len(_pad_pow2(np.arange(9, dtype=np.int32), -1)) == 16
    assert len(_pad_pow2(np.zeros(0, np.int32), -1)) == 8
