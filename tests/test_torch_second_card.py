"""The kernels that raise their shared memory, on a second card of one
process.

CUDA keeps a kernel's ``cudaFuncAttributeMaxDynamicSharedMemorySize``
per device, so a launcher must set it once on every device it launches
on, not once a process.  Each attention variant (SIMT at 76,800 bytes of
shared memory, ``mma.sync``, ``wgmma``, ``mla``) and the CSR kernel's
wide-row ring launch here on ``cuda:0`` and then on ``cuda:1``, each
against the plain version on its own card.  Every test needs two CUDA
devices and skips otherwise; the file imports no JAX:

    PYTHONPATH=src python -m pytest -q tests/test_torch_second_card.py

Tolerances: attention float32 rtol = atol = 2e-3, bfloat16 3e-2 (as
``chip_smoke.py`` phase 9); the CSR sum 1e-5.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import csr_segment, ops  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention_cuda, flash_attention_plain, kernel_variant)

pytestmark = pytest.mark.cuda

CARDS = ("cuda:0", "cuda:1")

# (variant, dtype, B, H, Hkv, T, D, Dv)
ATTENTION = [
    ("simt", torch.float32, 1, 4, 2, 128, 128, 128),
    ("mma", torch.bfloat16, 1, 4, 2, 128, 32, 32),
    ("wgmma", torch.bfloat16, 1, 4, 2, 256, 128, 128),
    ("mla", torch.bfloat16, 1, 4, 1, 256, 288, 256),
]


@pytest.fixture
def two_cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")


@pytest.mark.parametrize("case", ATTENTION, ids=lambda c: c[0])
def test_attention_variant_on_the_second_card(two_cards, case):
    variant, dtype, b, h, hkv, t, d, dv = case
    assert kernel_variant(dtype, d, dv) == variant
    tol = 2e-3 if dtype == torch.float32 else 3e-2
    gen = torch.Generator().manual_seed(0)
    q = torch.randn(b, h, t, d, generator=gen)
    k = torch.randn(b, hkv, t, d, generator=gen)
    v = torch.randn(b, hkv, t, dv, generator=gen)
    for card in CARDS:
        tq, tk, tv = (x.to(card, dtype) for x in (q, k, v))
        got = flash_attention_cuda(tq, tk, tv, causal=True)
        want = flash_attention_plain(tq, tk, tv, causal=True)
        assert got.device == torch.device(card)
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol, msg=f"{variant} on {card}")


def test_csr_wide_ring_on_the_second_card(two_cards):
    """A wide row (F 602: 8-byte vectors through the ``cp.async`` ring)
    on each card."""
    n, e, f = 700, 600, 602
    rng = np.random.default_rng(0)
    s = rng.integers(0, n, e).astype(np.int32)
    r = rng.integers(0, n, e).astype(np.int32)
    x = rng.normal(size=(n, f)).astype(np.float32)
    assert csr_segment.launch_plan(f, 16).lanes == 32
    for card in CARDS:
        layout = ops.csr_layout(torch.from_numpy(s).to(card),
                                torch.from_numpy(r).to(card), n)
        tx = torch.from_numpy(x).to(card)
        got = csr_segment.csr_segment_cuda(*layout, tx, "sum")
        want = csr_segment.csr_segment_plain(*layout, tx, "sum")
        assert got.device == torch.device(card)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5,
                                   msg=f"csr on {card}")
