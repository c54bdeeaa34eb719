"""The CSR segment-reduce kernel against its plain version on the card.

Every test here needs a CUDA device and skips without one; the file
imports no JAX, so it runs on a machine with the card:

    PYTHONPATH=src python -m pytest -q tests/test_torch_csr_card.py

Each case covers one route of the kernel's launch plan
(``kernels/csr_segment.py::launch_plan``): narrow rows (F 1, 3, 32),
wide rows of 16-byte (F 100), 8-byte (F 130, 602) and 4-byte vectors (a
row slice of a larger tensor at odd F), with empty rows, out-of-range
senders, ±inf for min/max and a hub row.  Tolerances: sum rtol = atol =
1e-5 (another summation order), min/max bitwise, the same ±inf pattern;
the hub row's sum as stated in its test.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import csr_segment, ops  # noqa: E402


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _graph(n, e, f, seed, n_src=None):
    rng = np.random.default_rng(seed)
    s = rng.integers(0, n_src or n, e).astype(np.int32)
    r = rng.integers(0, n, e).astype(np.int32)
    x = rng.normal(size=(n_src or n, f)).astype(np.float32)
    return s, r, x


def _layout(s, r, n, card, mask=None):
    return ops.csr_layout(torch.from_numpy(s).to(card),
                          torch.from_numpy(r).to(card), n,
                          None if mask is None else
                          torch.from_numpy(mask).to(card))


def _close(got, want, reduce):
    got, want = got.cpu(), want.cpu()
    if reduce == "sum":
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    else:
        assert torch.equal(got, want)
    assert torch.equal(torch.isfinite(got), torch.isfinite(want))


def _with_inf(x, reduce):
    """±inf in a few rows for min/max (a sum would make NaN of them)."""
    if reduce != "sum":
        x = x.copy()
        x[:8:2, :3] = np.inf
        x[1:8:2, :3] = -np.inf
    return x


@pytest.mark.cuda
@pytest.mark.parametrize("f", [1, 3, 32, 35, 100, 130, 602, 1433])
@pytest.mark.parametrize("reduce", csr_segment.REDUCES)
def test_kernel_matches_plain_at_each_route(card, f, reduce):
    """Each width the plan tells apart, with empty rows (e < n) and
    senders out of range, which the kernel clamps into [0, n_src)."""
    n, e = 700, 600
    s, r, x = _graph(n, e, f, f)
    s[::13] = -4
    s[5::17] = n + 9
    x = _with_inf(x, reduce)
    layout = _layout(s, r, n, card)
    clamped = ops.Csr(layout.senders.clamp(0, n - 1).contiguous(),
                      layout.row_off)
    tx = torch.from_numpy(x).to(card)
    got = csr_segment.csr_segment_cuda(*layout, tx, reduce)
    want = csr_segment.csr_segment_plain(*clamped, tx, reduce)
    torch.cuda.synchronize()
    _close(got, want, reduce)
    assert int((layout.degree() == 0).sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("f", [3, 130, 602])
@pytest.mark.parametrize("reduce", csr_segment.REDUCES)
def test_kernel_takes_a_misaligned_row_slice(card, f, reduce):
    """x a contiguous row slice of a larger tensor, one row in: 12
    bytes past a 16-byte boundary at F 3, 8 at F 130 and 602, so the
    plan takes 4- or 8-byte loads."""
    s, r, x = _graph(300, 1000, f, 40 + f)
    big = torch.from_numpy(
        np.concatenate([np.ones((1, f), np.float32),
                        _with_inf(x, reduce)])).to(card)
    tx = big[1:]
    assert tx.is_contiguous() and tx.data_ptr() % 16 != 0
    layout = _layout(s, r, 300, card)
    got = csr_segment.csr_segment_cuda(*layout, tx, reduce)
    _close(got, csr_segment.csr_segment_plain(*layout, tx, reduce), reduce)


@pytest.mark.cuda
@pytest.mark.parametrize("f", [1, 32, 128, 602])
@pytest.mark.parametrize("reduce", csr_segment.REDUCES)
def test_kernel_with_a_hub_row(card, f, reduce):
    """One row of 3,000 edges among rows of one or none.  Its sum is held
    to the float64 sum within (L - 1) 2^-24 sum|x| for L edges, the
    bound of float32 summation in any order (the kernel's groups and the
    plain version's atomics add in other orders, and the error grows with
    the row's length); every other row as in the other tests."""
    n, e = 400, 3400
    s, r, x = _graph(n, e, f, 60 + f)
    r[:3000] = 17
    x = _with_inf(x, reduce)
    layout = _layout(s, r, n, card)
    tx = torch.from_numpy(x).to(card)
    got = csr_segment.csr_segment_cuda(*layout, tx, reduce)
    want = csr_segment.csr_segment_plain(*layout, tx, reduce)
    torch.cuda.synchronize()
    hub = 17
    if reduce != "sum":
        _close(got, want, reduce)
        return
    rest = torch.arange(n, device=card) != hub
    _close(got[rest], want[rest], reduce)
    lo, hi = int(layout.row_off[hub]), int(layout.row_off[hub + 1])
    rows = tx[layout.senders[lo:hi].long()].double()
    tol = (hi - lo - 1) * 2.0 ** -24 * rows.abs().sum(0)
    assert bool(((got[hub].double() - rows.sum(0)).abs() <= tol).all())


@pytest.mark.cuda
@pytest.mark.parametrize("f", [1, 32, 100, 602])
def test_two_launches_give_the_same_bits(card, f):
    s, r, x = _graph(2000, 9000, f, 80 + f)
    r[:2500] = 3                                      # a hub row too
    layout = _layout(s, r, 2000, card)
    tx = torch.from_numpy(x).to(card)
    for reduce in csr_segment.REDUCES:
        a = csr_segment.csr_segment_cuda(*layout, tx, reduce)
        b = csr_segment.csr_segment_cuda(*layout, tx, reduce)
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_on_the_card(card):
    """The CSR kernel against its plain version on the card: sum within
    1e-5, min/max exact, with empty rows and ±inf inputs."""
    s, r, x = _graph(300, 2000, 130, 7)
    x[5, :3] = [np.inf, -np.inf, np.inf]
    layout = _layout(s, r, 300, card)
    tx = torch.from_numpy(x).to(card)
    for reduce in csr_segment.REDUCES:
        got = csr_segment.csr_segment_cuda(*layout, tx, reduce)
        want = csr_segment.csr_segment_plain(*layout, tx, reduce)
        torch.cuda.synchronize()
        _close(got, want, reduce)


@pytest.mark.cuda
def test_cuda_backward_matches_plain_autograd_on_the_card(card):
    """The segment sum's backward through the kernel against torch's own
    autograd of the plain version, on the card: within 1e-5, with masked
    edges and empty rows."""
    s, r, x = _graph(300, 2000, 130, 26)
    r[r < 20] = 20                                    # empty rows
    mask = np.random.default_rng(26).random(2000) < 0.8
    layout = _layout(s, r, 300, card, mask)
    g = torch.randn(300, 130, device=card)
    grads = []
    for fn in (lambda t: ops.segment_reduce_csr(layout, t, "sum"),
               lambda t: csr_segment.csr_segment_plain(*layout, t, "sum")):
        tx = torch.from_numpy(x).to(card).requires_grad_(True)
        torch.sum(fn(tx) * g).backward()
        grads.append(tx.grad)
    torch.cuda.synchronize()
    _close(grads[0], grads[1], "sum")
