"""The intern kernel against its plain version on the card.

Every test here needs a CUDA device and skips without one; the file
imports no JAX, so it runs on a machine with the card:

    PYTHONPATH=src python -m pytest -q tests/test_torch_intern_card.py

Stacked blocks of intern states, built by interning (so every table is
one the router makes), then one more call: hits only, misses only,
repeats within the call, padding, tombstones planted in the chains, a
drop at a small ``n_cap``, tiny tables whose chains wrap, and the words
as strided columns of the router's ``[R, L, 5]`` buckets.  Then the hard
cases of ``repro_torch.testing.tables`` (the kernel's groups and its
ordered fallback): keys sharing a start, spills into other groups' first
free slots, starts before planted tombstones, chains wrapping past
``cap - 1``, the room running out with repeats of dropped keys, a row
longer than the kernel's shared-memory segment, and tables that run out
of free slots or have none.  Every id and every leaf equal, bitwise; one
launch a call.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.engine.hashtable import EMPTY, TOMB  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.intern import intern_plain  # noqa: E402
from repro_torch.testing import tables  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _state(rows, cap, n_cap):
    return ((torch.full((rows, cap), EMPTY, dtype=torch.int32),
             torch.full((rows, cap), EMPTY, dtype=torch.int32),
             torch.zeros((rows, cap), dtype=torch.int32)),
            torch.full((rows, n_cap, 2), -1, dtype=torch.int32),
            torch.zeros(rows, dtype=torch.int32),
            torch.zeros(rows, dtype=torch.int32))


def _buckets(rng, rows, lanes, pool, pad=0.1):
    """``[rows, lanes, 5]`` buckets of changes between keys of ``pool``
    (``[n, 2]`` words), a share of them padding."""
    idx = rng.integers(0, len(pool), (rows, lanes, 2))
    b = np.concatenate([pool[idx[..., 0]], pool[idx[..., 1]],
                        rng.integers(0, 2, (rows, lanes, 1))], -1)
    b[rng.random((rows, lanes)) < pad, :4] = -1
    return torch.from_numpy(b.astype(np.int32))


def _pool(rng, n):
    return rng.integers(0, 1 << 31, (n, 2)).astype(np.int32)


def _call(state, buckets, n_cap, device):
    table, l2h, nn, nd = state
    if device is not None:
        table = tuple(t.to(device) for t in table)
        l2h, nn, nd, buckets = (t.to(device) for t in (l2h, nn, nd, buckets))
    words = tuple(buckets[..., k] for k in range(4))
    u, v = ops.intern(table, l2h, nn, nd, words, n_cap)
    return (u.cpu(), v.cpu()), (tuple(t.cpu() for t in table), l2h.cpu(),
                                nn.cpu(), nd.cpu())


def _equal(a, b, what):
    fa = [*a[0], *a[1][0], *a[1][1:]]
    fb = [*b[0], *b[1][0], *b[1][1:]]
    for n, (x, y) in enumerate(zip(fa, fb)):
        assert x.dtype == y.dtype and torch.equal(x, y), (what, n)


def _clone(state):
    table, l2h, nn, nd = state
    return tuple(t.clone() for t in table), l2h.clone(), nn.clone(), nd.clone()


@pytest.mark.parametrize("rows,cap,n_cap,lanes", [
    (4, 1 << 12, 1000, 1024), (3, 32, 6, 8), (1, 8, 2, 16),
    (4, 1 << 14, 300, 2048)], ids=["wide", "smoke", "tiny", "drops"])
def test_kernel_equals_plain_over_calls(card, rows, cap, n_cap, lanes):
    rng = np.random.default_rng(cap + lanes)
    pool = _pool(rng, max(4, n_cap * 2))
    state = _state(rows, cap, n_cap)
    for call in range(4):
        buckets = _buckets(rng, rows, lanes, pool)
        if call == 2:              # tombstones planted in every row
            k1 = state[0][0]
            dead = torch.from_numpy(rng.integers(0, cap, (rows, 3)))
            live = k1.gather(1, dead) >= 0
            for t in state[0][:2]:
                t.scatter_(1, dead, torch.where(live, TOMB, t.gather(1, dead)))
        before = ops.intern.launches
        got = _call(_clone(state), buckets, n_cap, card)
        assert ops.intern.launches - before == 1
        want = _call(state, buckets, n_cap, None)
        _equal(got, want, f"call {call}")
        state = want[1]
    assert int(state[2].max()) > 0


def test_hits_only_and_strided_words(card):
    """A second call of the same buckets: every key a hit at entry."""
    rng = np.random.default_rng(7)
    pool = _pool(rng, 500)
    state = _state(4, 1 << 12, 1000)
    buckets = _buckets(rng, 4, 1024, pool, pad=0.0)
    state = _call(state, buckets, 1000, None)[1]
    nodes = state[2].clone()
    got = _call(_clone(state), buckets, 1000, card)
    want = _call(state, buckets, 1000, None)
    _equal(got, want, "hits")
    assert torch.equal(want[1][2], nodes)     # nothing new interned


def test_plain_refuses_card_tensors(card):
    state = _state(1, 8, 2)
    table = tuple(t.to(card) for t in state[0])
    words = [torch.zeros((1, 4), dtype=torch.int32, device=card)] * 4
    with pytest.raises(ValueError, match="CPU tensors"):
        intern_plain(table, *(t.to(card) for t in state[1:]), words, 2)


def test_empty_block_counts_no_launch(card):
    """A block of no lanes, or of no rows, returns empty ids and launches
    nothing, so the launch count does not move."""
    for rows, lanes in ((2, 0), (0, 4)):
        table, l2h, nn, nd = _state(rows, 8, 2)
        table = tuple(t.to(card) for t in table)
        l2h, nn, nd = (t.to(card) for t in (l2h, nn, nd))
        words = [torch.zeros((rows, lanes), dtype=torch.int32,
                             device=card)] * 4
        before = ops.intern.launches
        u, v = ops.intern(table, l2h, nn, nd, words, 2)
        assert u.shape == v.shape == (rows, lanes)
        assert ops.intern.launches == before


def _from_numpy(st):
    return (tuple(torch.from_numpy(st[k].copy()) for k in ("k1", "k2",
                                                            "val")),
            *(torch.from_numpy(st[k].copy()) for k in ("l2h", "n_nodes",
                                                       "n_dropped")))


@pytest.mark.parametrize("kind", tables.INTERN_KINDS)
def test_hard_cases(card, kind):
    """Each hard bucket kind on 4 rows of 2^14-slot tables holding 2,048
    keys (256 of them deleted): 1,024 changes a row, 3,000 for ``long``
    (two segments); ``room`` at an ``n_cap`` 100 above ``n_nodes``."""
    rng = np.random.default_rng(tables.INTERN_KINDS.index(kind))
    cap, n_cap = 1 << 14, 2048 + (100 if kind == "room" else 4096)
    st = tables.intern_table(4, cap, n_cap, 2048, rng, n_tomb=256)
    lanes = 3000 if kind == "long" else 1024
    buckets = torch.from_numpy(tables.intern_buckets(kind, 4, lanes, cap,
                                                     rng, k1=st["k1"]))
    state = _from_numpy(st)
    before = ops.intern.launches
    got = _call(_clone(state), buckets, n_cap, card)
    assert ops.intern.launches - before == 1
    want = _call(state, buckets, n_cap, None)
    _equal(got, want, kind)
    if kind == "room":
        assert int(want[1][3].sum()) > 0          # drops


@pytest.mark.parametrize("n_empty,n_tomb", [(2, 2), (0, 0), (0, 3)],
                         ids=["runs_out", "full", "tombs_only"])
def test_out_of_free_slots(card, n_empty, n_tomb):
    """Tables of 32 slots that run out of free slots mid-call, have none
    (the insert goes at the start, over a live key) or only TOMBs."""
    rng = np.random.default_rng(50 + n_empty + n_tomb)
    st = tables.intern_table(3, 32, 64, 0, rng, n_tomb=n_tomb,
                             n_empty=n_empty)
    buckets = torch.from_numpy(tables.intern_buckets("room", 3, 12, 32,
                                                     rng, pad=0.1))
    state = _from_numpy(st)
    got = _call(_clone(state), buckets, 64, card)
    want = _call(state, buckets, 64, None)
    _equal(got, want, "out of free slots")
