"""The rebuild kernel against the sequential fold on the card.

Every test here needs a CUDA device and skips without one; the file
imports no JAX, so it runs on a machine with the card:

    PYTHONPATH=src python -m pytest -q tests/test_torch_rebuild_card.py

Tables from ``repro_torch.testing.tables`` (built by linear-probe inserts,
then tombstoned), held to ``ht_rebuild_plain`` bit for bit: a 2^20-slot
prehashed table whose keys home into narrow windows (runs over 32 slots,
runs across the kernel's tile ends, a run past a tile's halo, a run that
wraps past the last slot), runs of over 1,024 slots, random tables of one
tile and of several at 70%, full tables (no EMPTY slot) of one tile and of
several, and a table with a key behind an EMPTY slot of its chain, which
the wrapper refuses.
One launch a call.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.engine.hashtable import EMPTY, _probe_start  # noqa
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.ht_rebuild import (HALO, TILE,  # noqa: E402
                                            ht_rebuild_plain)
from repro_torch.testing import tables  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _check(card, k1, k2, val, prehashed):
    table = [torch.from_numpy(np.ascontiguousarray(a)) for a in (k1, k2, val)]
    before = ops.ht_rebuild.launches
    got = ops.ht_rebuild(*(t.to(card) for t in table), prehashed=prehashed)
    assert ops.ht_rebuild.launches - before == 1
    want = ht_rebuild_plain(*table, prehashed=prehashed)
    for g, w, name in zip(got, want, ("k1", "k2", "val")):
        assert torch.equal(g.cpu(), w), name


def test_clustered_table(card):
    tile, halo = TILE, HALO
    rng = np.random.default_rng(0)
    cap = 1 << 20
    k1, k2, val = tables.clustered_table(
        cap, 0.6, tables.rebuild_clusters(cap, tile, halo, rng), rng)
    seen = tables.describe_runs(k1, tile, halo)
    assert seen["over_32"] and seen["cross_tile"] and seen["past_halo"]
    assert seen["wraps"]
    _check(card, k1, k2, val, True)


@pytest.mark.parametrize("cap", [8, 32, 2048, 8192])
@pytest.mark.parametrize("prehashed", [False, True])
def test_random_and_full_tables(card, cap, prehashed):
    """70% live with a tenth of them deleted, then full (no EMPTY slot)
    with and without tombstones."""
    rng = np.random.default_rng(cap + prehashed)
    for n, n_tomb in ((int(cap * 0.7), cap // 10), (cap, 0), (cap, 2)):
        hi = rng.integers(0, (1 << 31) - 1 if prehashed else 1 << 20, n)
        lo = rng.permutation(1 << 20)[:n]
        k1, k2, _ = tables.round_build(cap, hi.astype(np.int32),
                                       lo.astype(np.int32),
                                       tables.homes(hi, lo, cap, prehashed))
        val = rng.integers(-2 ** 31, 2 ** 31, cap).astype(np.int32)
        tables.tombstone(k1, k2, val, n_tomb, rng)
        _check(card, k1, k2, val, prehashed)


@pytest.mark.parametrize("cap,clusters", [
    (8192, [(100, 8, 1100)]), (2048, [(1000, 8, 1300)]),
    (8192, [(2040, 8, 1500)])], ids=["in_tile", "one_tile_wraps",
                                      "past_halo"])
def test_runs_over_a_thousand_slots(card, cap, clusters):
    """A run of over 1,024 slots inside a tile, one that wraps in a table
    of one tile, and one that crosses a tile end past the halo."""
    rng = np.random.default_rng(cap + len(clusters[0]))
    k1, k2, val = tables.clustered_table(cap, 0.3, clusters, rng)
    assert tables.describe_runs(k1, TILE, HALO)["longest"] > 1024
    _check(card, k1, k2, val, True)


def test_broken_chain_raises(card):
    cap = 1 << 12
    k1 = torch.full((cap,), EMPTY, dtype=torch.int32)
    k2 = torch.full((cap,), EMPTY, dtype=torch.int32)
    home = int(_probe_start(torch.tensor([7]), torch.tensor([9]), cap, False))
    k1[(home + 2) % cap], k2[(home + 2) % cap] = 7, 9
    with pytest.raises(ValueError, match="EMPTY slot"):
        ops.ht_rebuild(k1.to(card), k2.to(card),
                       torch.zeros(cap, dtype=torch.int32, device=card))
