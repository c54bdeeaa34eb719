"""PyTorch port: the graph ops and the CSR segment-reduce kernel's plain
version, against the JAX package.

The JAX side is its pure-jnp oracle (``repro.kernels.ref``, or its ops
with ``use_pallas=False``), never the Pallas kernel: the kernel no longer
traces on the installed jax.  Inputs are made with numpy from a seed and
handed to both packages.  Tolerances: sums rtol = atol = 1e-5 (another
summation order), min/max and integer results exact.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import csr_segment  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

# (n, e, F); the later ones are the widths the kernel's launch plan tells
# apart: F 1 and 3 (narrow rows, scalar loads), 100 (a wide row of 25
# 16-byte vectors), 130 (8-byte vectors over 3 slots a lane)
SHAPES = [(64, 256, 32), (130, 1000, 70), (300, 2000, 128), (17, 50, 8),
          (300, 2000, 1), (300, 2000, 3), (200, 3000, 100), (300, 2000, 130)]


def _graph(n, e, f, seed):
    rng = np.random.default_rng(seed)
    s = rng.integers(0, n, e).astype(np.int32)
    r = rng.integers(0, n, e).astype(np.int32)
    x = rng.normal(size=(n, f)).astype(np.float32)
    return s, r, x


def _check(got, want, reduce):
    got, want = np.asarray(got), np.asarray(want)
    if reduce == "sum":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n,e,f", SHAPES)
@pytest.mark.parametrize("reduce", ["sum", "min", "max"])
def test_segment_reduce_matches_jax_ref(n, e, f, reduce):
    s, r, x = _graph(n, e, f, n + e)
    want = jref.segment_reduce_ref(jnp.array(s), jnp.array(r), jnp.array(x),
                                   n, reduce)
    ts, tr, tx = map(torch.from_numpy, (s, r, x))
    _check(ops.segment_reduce(ts, tr, tx, n, reduce), want, reduce)
    _check(ref.segment_reduce_ref(ts, tr, tx, n, reduce), want, reduce)


@pytest.mark.parametrize("reduce", ["sum", "min", "max"])
def test_segment_reduce_with_a_hub_row_matches_jax_ref(reduce):
    """One row of 1,200 edges (more than 1,024) among short and empty
    rows."""
    s, r, x = _graph(80, 1600, 12, 31)
    r[:1200] = 9
    r[(r > 20) & (r < 30)] = 31                       # empty rows
    want = jref.segment_reduce_ref(*map(jnp.array, (s, r, x)), 80, reduce)
    ts, tr, tx = map(torch.from_numpy, (s, r, x))
    _check(ops.segment_reduce(ts, tr, tx, 80, reduce), want, reduce)


# (F, x's address) -> (vec, lanes, slots, chunks)
PLANS = [
    ((602, 0), (2, 32, 10, 1)),      # minibatch_lg: 8-byte vectors
    ((602, 4), (1, 32, 10, 2)),      # a row slice: 4-byte, 2 grid columns
    ((128, 0), (4, 32, 1, 1)),       # the request's layers
    ((128, 8), (2, 32, 2, 1)),       # 8-byte aligned only
    ((100, 0), (4, 32, 1, 1)),       # ogb_products: 25 lanes of 32
    ((1433, 0), (1, 32, 12, 4)),     # full_graph_sm: 4 grid columns
    ((1432, 0), (4, 32, 4, 3)),      # 16-byte: at most 20 floats a lane
    ((1434, 0), (2, 32, 8, 3)),
    ((130, 0), (2, 32, 3, 1)),
    ((32, 0), (4, 8, 1, 1)),         # molecule: 4 edges at once
    ((1, 0), (1, 1, 1, 1)),          # minhash: 32 edges at once
    ((3, 0), (1, 4, 1, 1)),          # odd F: 8 edges at once
    ((64, 0), (4, 16, 1, 1)),
]


@pytest.mark.parametrize("args,want", PLANS)
def test_launch_plan_pins_its_choices(args, want):
    """The widest load F and the address allow, narrow rows up to 16
    vectors, and the fewest slots (at most 20 floats a lane) that cover
    a wide row in the fewest grid columns."""
    assert tuple(csr_segment.launch_plan(*args)) == want


@pytest.mark.parametrize("reduce", ["min", "max"])
def test_segment_reduce_keeps_inf_inputs(reduce):
    """Empty rows are zeroed by their edge count, so a ±inf input that
    survives a nonempty min/max stays (``test_kernels.py``'s case)."""
    n = 130
    s = np.array([0, 1, 2, 3], np.int32)
    r = np.array([0, 0, 1, 2], np.int32)
    x = np.zeros((n, 2), np.float32)
    x[:4] = [[np.inf, -np.inf], [3.0, 4.0], [-np.inf, np.inf], [1.0, -1.0]]
    want = np.zeros((n, 2), np.float32)
    want[0] = [3.0, -np.inf] if reduce == "min" else [np.inf, 4.0]
    want[1] = [-np.inf, np.inf]
    want[2] = [1.0, -1.0]
    got_jax = jref.segment_reduce_ref(jnp.array(s), jnp.array(r),
                                      jnp.array(x), n, reduce)
    np.testing.assert_array_equal(np.asarray(got_jax), want)
    ts, tr, tx = map(torch.from_numpy, (s, r, x))
    np.testing.assert_array_equal(
        ops.segment_reduce(ts, tr, tx, n, reduce).numpy(), want)
    np.testing.assert_array_equal(
        ref.segment_reduce_ref(ts, tr, tx, n, reduce).numpy(), want)


@pytest.mark.parametrize("masked", [False, True])
def test_build_csr_is_a_stable_sort_by_receiver(masked):
    rng = np.random.default_rng(3)
    n, e = 50, 400
    r = rng.integers(-2, n + 3, e).astype(np.int32)   # some out of range
    mask = rng.random(e) < 0.7 if masked else np.ones(e, bool)
    order, row_off = csr_segment.build_csr(
        torch.from_numpy(r), n, torch.from_numpy(mask) if masked else None)
    kept = np.flatnonzero(mask)
    want_order = kept[np.argsort(r[kept], kind="stable")]
    want_off = np.searchsorted(r[want_order], np.arange(n + 1))
    assert row_off.dtype == torch.int32 and row_off.shape == (n + 1,)
    np.testing.assert_array_equal(row_off.numpy(), want_off)
    lo, hi = want_off[0], want_off[-1]
    # rows 0..n-1 hold exactly the in-range edges, in input order per row
    np.testing.assert_array_equal(order.numpy()[lo:hi], want_order[lo:hi])
    assert np.all(r[order.numpy()[lo:hi]] >= 0)


def test_segment_reduce_drops_masked_and_out_of_range_edges():
    s, r, x = _graph(40, 300, 6, 9)
    r[::7] = 45                                       # out of range
    mask = np.random.default_rng(9).random(300) < 0.6
    keep = mask & (r < 40)
    want = jref.segment_reduce_ref(jnp.array(s[keep]), jnp.array(r[keep]),
                                   jnp.array(x), 40, "sum")
    ts, tr, tx = map(torch.from_numpy, (s, r, x))
    got = ops.segment_reduce_csr(
        ops.csr_layout(ts, tr, 40, torch.from_numpy(mask)), tx, "sum")
    _check(got, want, "sum")


def _dense_adjacency(s, r, n_out, n_src, keep):
    """``A[r, s]`` counts the kept edges r <- s (numpy, float64)."""
    a = np.zeros((n_out, n_src))
    np.add.at(a, (r[keep], s[keep]), 1.0)
    return a


@pytest.mark.parametrize("form", ["nodes", "edge ids"])
def test_segment_sum_backward_matches_dense(form):
    """The segment sum's gradient is ``A^T g`` for the kept edges: the
    transposed layout's segment sum, with masked edges, receivers out of
    range (both dropped) and empty rows on both sides.  ``edge ids`` is
    ``_agg``'s form: the senders are the edges themselves."""
    n, e, f = 50, 160, 7
    s, r, x = _graph(n, e, f, 21)
    r[::9] = -3                                       # out of range, low
    r[4::11] = n + 2                                  # out of range, high
    r[r == 5] = 6                                     # an empty row
    mask = np.random.default_rng(21).random(e) < 0.7
    if form == "edge ids":
        s = np.arange(e, dtype=np.int32)
        x = np.random.default_rng(22).normal(size=(e, f)).astype(np.float32)
    keep = mask & (r >= 0) & (r < n)
    g = np.random.default_rng(23).normal(size=(n, f)).astype(np.float32)
    layout = ops.csr_layout(torch.from_numpy(s), torch.from_numpy(r), n,
                            torch.from_numpy(mask))
    tx = torch.from_numpy(x).requires_grad_(True)
    out = ops.segment_reduce_csr(layout, tx, "sum")
    a = _dense_adjacency(s, r, n, x.shape[0], keep)
    np.testing.assert_allclose(out.detach().numpy(), a @ x, rtol=1e-5,
                               atol=1e-5)
    ops.reset_counts()
    torch.sum(out * torch.from_numpy(g)).backward()
    np.testing.assert_allclose(tx.grad.numpy(), a.T @ g, rtol=1e-5,
                               atol=1e-5)
    assert not tx.grad[np.flatnonzero(~np.isin(np.arange(x.shape[0]),
                                               s[keep]))].any()
    assert ops.segment_reduce.launches == 0           # the plain version
    # the transposed layout is built once per layout and kept
    assert layout.transposed(x.shape[0]) is layout.transposed(x.shape[0])


def test_segment_sum_backward_with_no_rows():
    """A layout with no rows keeps none of its edges: a zero gradient."""
    s, r, x = _graph(10, 40, 3, 27)
    layout = ops.csr_layout(*map(torch.from_numpy, (s, r)), 0)
    tx = torch.from_numpy(x).requires_grad_(True)
    out = ops.segment_reduce_csr(layout, tx, "sum")
    assert out.shape == (0, 3)
    torch.sum(out).backward()
    assert tx.grad.shape == tx.shape and not tx.grad.any()


def test_segment_sum_backward_skips_inputs_needing_no_grad():
    s, r, x = _graph(30, 90, 4, 24)
    layout = ops.csr_layout(*map(torch.from_numpy, (s, r)), 30)
    w = torch.ones(4, requires_grad=True)
    out = ops.segment_reduce_csr(layout, torch.from_numpy(x), "sum")
    assert not out.requires_grad                       # no backward node
    torch.sum(out * w).backward()
    np.testing.assert_allclose(w.grad.numpy(), out.detach().sum(0).numpy())
    assert layout._transposed == {}                    # never built


@pytest.mark.parametrize("reduce", ["min", "max"])
def test_min_max_refuse_autograd(reduce):
    s, r, x = _graph(20, 60, 3, 25)
    layout = ops.csr_layout(*map(torch.from_numpy, (s, r)), 20)
    tx = torch.from_numpy(x).requires_grad_(True)
    with pytest.raises(NotImplementedError, match="no backward"):
        ops.segment_reduce_csr(layout, tx, reduce)
    with torch.no_grad():
        _check(ops.segment_reduce_csr(layout, tx, reduce),
               jref.segment_reduce_ref(*map(jnp.array, (s, r, x)), 20,
                                       reduce), reduce)


@pytest.mark.parametrize("rows,dim,bags", [(200, 16, 32), (1000, 64, 100)])
@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_embedding_bag_matches_jax_ref(rows, dim, bags, mode):
    rng = np.random.default_rng(rows)
    table = rng.normal(size=(rows, dim)).astype(np.float32)
    lens = rng.integers(0, 7, bags)                   # empty bags too
    offsets = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    idx = rng.integers(0, rows, int(offsets[-1])).astype(np.int32)
    want = jref.embedding_bag_ref(jnp.array(table), jnp.array(idx),
                                  jnp.array(offsets), mode)
    args = map(torch.from_numpy, (table, idx, offsets))
    _check(ops.embedding_bag(*args, mode), want, "sum")
    _check(ref.embedding_bag_ref(*map(torch.from_numpy,
                                      (table, idx, offsets)), mode),
           want, "sum")


@pytest.mark.parametrize("seed", [0, 11, 0xDEADBEEF])
def test_minhash_signature_matches_jax_ref(seed):
    rng = np.random.default_rng(5)
    s = rng.integers(0, 100, 600).astype(np.int32)
    r = rng.integers(0, 120, 600).astype(np.int32)    # rows 100+ isolated
    want = np.asarray(jref.minhash_signature_ref(jnp.array(s), jnp.array(r),
                                                 130, seed))
    ts, tr = torch.from_numpy(s), torch.from_numpy(r)
    for got in (ops.minhash_signature(ts, tr, 130, seed),
                ref.minhash_signature_ref(ts, tr, 130, seed)):
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
    # the uint32 mix itself, bit for bit
    x = rng.integers(0, 2 ** 31 - 1, 4096).astype(np.int32)
    np.testing.assert_array_equal(
        ref._mixhash(torch.from_numpy(x), seed).numpy(),
        np.asarray(jref._mixhash(jnp.array(x).astype(jnp.uint32),
                                 jnp.uint32(seed))).astype(np.int64))


def test_minhash_saturates_like_xla():
    """A float32 hash that rounds to 2^31 converts to 2^31 - 1, as XLA's
    saturating convert gives it."""
    f = torch.tensor([2.0 ** 31, 5.0, -(2.0 ** 31)], dtype=torch.float32)
    assert ref.to_int32_saturating(f).tolist() == [2 ** 31 - 1, 5,
                                                   -(2 ** 31)]


def test_spmm_matches_dense_spmm_ref():
    s, r, x = _graph(90, 700, 24, 4)
    want = jref.dense_spmm_ref(jnp.array(s), jnp.array(r), jnp.array(x))
    ts, tr, tx = map(torch.from_numpy, (s, r, x))
    _check(ops.spmm(ts, tr, tx), want, "sum")
    _check(ref.dense_spmm_ref(ts, tr, tx), want, "sum")


def _summary_terms():
    """``test_kernels.py``'s SBM graph summarized by the host reference."""
    from repro.core.reference import MoSSo
    from repro.graph.streams import edges_to_insertion_stream, sbm_edges
    edges = sbm_edges(40, 4, 0.7, 0.03, seed=11)
    algo = MoSSo(seed=2, c=30)
    algo.run(edges_to_insertion_stream(edges, seed=3))
    out = algo.s.materialize()
    n = max(max(e) for e in edges) + 1
    sup_ids = {sid: i for i, sid in enumerate(sorted(out.supernodes))}
    n2s = np.zeros(n, np.int32)
    for sid, mem in out.supernodes.items():
        for u in mem:
            n2s[u] = sup_ids[sid]
    self_loop = np.zeros(len(sup_ids), bool)
    p_src, p_dst = [], []
    for (a, b) in out.superedges:
        if a == b:
            self_loop[sup_ids[a]] = True
        else:
            p_src += [sup_ids[a], sup_ids[b]]
            p_dst += [sup_ids[b], sup_ids[a]]

    def dirpairs(pairs):
        s, d = [], []
        for (u, v) in pairs:
            s += [u, v]
            d += [v, u]
        return np.array(s, np.int32), np.array(d, np.int32)

    x = np.random.default_rng(0).normal(size=(n, 24)).astype(np.float32)
    args = (x, n2s, len(sup_ids), np.array(p_src, np.int32),
            np.array(p_dst, np.int32), *dirpairs(out.c_plus),
            *dirpairs(out.c_minus), self_loop)
    return args, dirpairs(list(edges))


def test_summary_spmm_matches_jax_and_dense():
    args, (es, ed) = _summary_terms()
    jargs = [a if isinstance(a, int) else jnp.array(a) for a in args]
    want = np.asarray(jops.summary_spmm(*jargs))
    targs = [a if isinstance(a, int) else torch.from_numpy(a) for a in args]
    np.testing.assert_allclose(ops.summary_spmm(*targs).numpy(), want,
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(ref.summary_spmm_ref(*targs).numpy(), want,
                               rtol=1e-4, atol=1e-4)
    dense = ref.dense_spmm_ref(torch.from_numpy(es), torch.from_numpy(ed),
                               targs[0])
    np.testing.assert_allclose(dense.numpy(), want, rtol=1e-4, atol=1e-4)


def test_wrappers_count_no_launch_on_the_cpu():
    ops.reset_counts()
    s, r, x = _graph(20, 60, 4, 1)
    ops.segment_reduce(*map(torch.from_numpy, (s, r, x)), 20)
    assert ops.segment_reduce.launches == 0
    with pytest.raises(ValueError):
        ops.segment_reduce_csr(ops.Csr(torch.zeros(1, dtype=torch.int32),
                                       torch.zeros(2, dtype=torch.int32)),
                               torch.zeros(1, 2, device="meta"))
