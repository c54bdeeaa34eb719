"""The intern and rebuild kernels' algorithms on the CPU, as numpy models.

There is no card here, so ``csrc/intern.cu`` and ``csrc/ht_rebuild.cu``
never run in these tests.  What does run is a model of each kernel's
decomposition, step for step, held bit for bit to the plain version
(the oracle the card tests and ``chip_smoke.py`` hold the kernels to):

* the intern: a pre-lookup of every lane against the table at entry,
  then segments of ``seg`` endpoints, each compacted in lane order, walked
  again in the table as it stands (a hit is an earlier segment's insert;
  else f, the chain's first EMPTY or TOMB slot), deduplicated by first
  occurrence, ranked by a prefix sum and cut at the room (every
  occurrence of a later key a drop); keys sharing an f, or with none, are
  contended and placed by one walker in rank order (taking a free slot
  from an uncontended key of higher rank makes that key contended); the
  rest take their f; a table that runs out of free slots hands the rest
  of the row to the ordered walk;
* the rebuild: tiles of ``tile`` slots reading ``halo`` slots past their
  end; a run belongs to the tile that holds its first slot, replayed in
  the fold's order with a bitmap of the run's taken offsets (first free
  offset at or after the home's); a run that ends past its tile's halo,
  and a table with no EMPTY slot, take the walk in the new table; every
  slot is written by exactly one tile.

The cases come from ``repro_torch.testing.tables``: keys sharing a start,
spills into other groups' starts, starts before planted tombstones, starts
that wrap past ``cap - 1``, the room running out mid-call with repeats of
dropped keys, rows of several segments, tables that run out of free
slots or have none; rebuild tables with runs over 32 slots, runs across
tile ends, a run past the halo, a wrapped run, full tables.  Each test
also checks that its case reached the path it is there for.  Small caps:
the file runs in seconds.  Tolerance: exact.
"""
import heapq
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.engine.hashtable import (EMPTY, TOMB,  # noqa: E402
                                               _probe_start)
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.ht_rebuild import ht_rebuild_plain  # noqa: E402
from repro_torch.kernels.intern import intern_plain  # noqa: E402
from repro_torch.testing import tables as T  # noqa: E402

NEED = -2            # an output lane a segment must resolve
NONE = -1            # no free slot on the chain


def _constant(source: str, name: str) -> int:
    text = (_build.CSRC / source).read_text()
    m = re.search(rf"constexpr int {name} = (\d+);", text)
    assert m, name
    return int(m.group(1))


SEG = _constant("intern.cu", "kSeg")
TILE = _constant("ht_rebuild.cu", "kTile")
HALO = _constant("ht_rebuild.cu", "kHalo")


# --------------------------------------------------------------------- #
# the intern kernel's decomposition
# --------------------------------------------------------------------- #


def _walk(k1, k2, val, h1, h2, cap):
    """A chain from the prehashed start: (id or None, first free or
    NONE)."""
    x = ((h1 & 0xFFFFFFFF) ^ (h2 & 0xFFFFFFFF)) & (cap - 1)
    free = NONE
    for _ in range(cap):
        c = int(k1[x])
        if free == NONE and c in (EMPTY, TOMB):
            free = x
        if c == EMPTY:
            break
        if c == h1 and int(k2[x]) == h2:
            return int(val[x]), free
        x = (x + 1) & (cap - 1)
    return None, free


def _intern_row(k1, k2, val, l2h, nn, nd, words, n_cap, seg, stats):
    cap = k1.size
    uh, ul, vh, vl = (w.astype(np.int64) for w in words)
    n_lanes = 2 * uh.size

    def key(j):
        i = j >> 1
        return (int(vh[i]), int(vl[i])) if j & 1 else (int(uh[i]),
                                                       int(ul[i]))

    out = np.full(n_lanes, -1, np.int64)
    for j in range(n_lanes):          # 1. the pre-lookup
        if uh[j >> 1] >= 0 and vh[j >> 1] >= 0:
            got, _ = _walk(k1, k2, val, *key(j), cap)
            out[j] = NEED if got is None else got
    serial_from = n_lanes
    for j0 in range(0, n_lanes, seg):
        lanes = [j for j in range(j0, min(j0 + seg, n_lanes))
                 if out[j] == NEED]                  # 2. compaction
        if not lanes:
            continue
        stats["segments"] += 1
        n = len(lanes)
        keys = [key(j) for j in lanes]
        ids, f, rep = [None] * n, [NONE] * n, [None] * n
        first = {}
        for e, (a, b) in enumerate(keys):            # 3. walk; 4. dedup
            got, f[e] = _walk(k1, k2, val, a, b, cap)
            if got is not None:
                ids[e], rep[e] = got, -1
                stats["found_live"] += 1
            else:
                rep[e] = first.setdefault((a, b), e)
        rank, by_rank = {}, []
        for e in range(n):                           # 5. ranks
            if rep[e] == e:
                rank[e] = len(rank)
        room = max(n_cap - nn, 0)
        n_ins = min(len(rank), room)
        drops = 0
        for e in range(n):
            if rep[e] != -1:
                q = rank[rep[e]]
                ids[e] = nn + q if q < n_ins else -1
                drops += q >= n_ins
        by_rank = [e for e in range(n) if rep[e] == e and rank[e] < n_ins]
        groups, contended = {}, set()                # 6. groups
        for q, e in enumerate(by_rank):
            if f[e] == NONE:
                contended.add(q)
            else:
                groups.setdefault(f[e], []).append(e)
        owner = {}
        for x, es in groups.items():
            if len(es) > 1:
                contended.update(rank[e] for e in es)
            else:
                owner[x] = es[0]
        stats["contended"] += len(contended)
        heap = sorted(contended)
        stop = n_ins
        while heap:                                  # 7. one walker
            q = heapq.heappop(heap)
            e = by_rank[q]
            x, placed = f[e], False
            if x != NONE:
                for _ in range(cap):
                    if int(k1[x]) in (EMPTY, TOMB):
                        o = owner.get(x)
                        if o is None or rank[o] > q:
                            if o is not None:
                                del owner[x]
                                contended.add(rank[o])
                                heapq.heappush(heap, rank[o])
                                stats["displaced"] += 1
                            k1[x], k2[x], val[x] = *keys[e], nn + q
                            placed = True
                            break
                    x = (x + 1) & (cap - 1)
            if not placed:
                stop = q
                break
        cut = lanes[by_rank[stop]] if stop < n_ins else n_lanes
        for e, j in enumerate(lanes):                # 8. writes
            if j < cut:
                out[j] = ids[e]
            if rep[e] == e and rank[e] < stop:
                q = rank[e]
                l2h[nn + q] = keys[e]
                if q not in contended:
                    k1[f[e]], k2[f[e]], val[f[e]] = *keys[e], nn + q
        stats["inserted"] += stop
        nn += stop
        if stop < n_ins:
            serial_from = cut
            stats["out_of_slots"] += 1
            break
        nd += drops
        stats["dropped"] += drops
    for j in range(serial_from, n_lanes):            # the ordered walk
        if out[j] != NEED:
            continue
        a, b = key(j)
        got, free = _walk(k1, k2, val, a, b, cap)
        if got is None and nn < n_cap:
            x = free if free != NONE else ((a & 0xFFFFFFFF)
                                           ^ (b & 0xFFFFFFFF)) & (cap - 1)
            k1[x], k2[x], val[x] = a, b, nn
            l2h[nn] = (a, b)
            got, nn = nn, nn + 1
        elif got is None:
            nd += 1
            got = -1
        out[j] = got
    u, v = out[0::2].copy(), out[1::2].copy()
    bad = (u < 0) | (v < 0)
    u[bad] = v[bad] = -1
    return u, v, nn, nd


def intern_model(state, buckets, n_cap, seg=SEG):
    """The kernel's decomposition on numpy copies of a stacked state:
    ``(u, v, state, stats)``."""
    st = {k: np.array(v, copy=True) for k, v in state.items()}
    stats = dict.fromkeys(("segments", "found_live", "contended",
                           "displaced", "inserted", "dropped",
                           "out_of_slots"), 0)
    us, vs = [], []
    for r in range(st["k1"].shape[0]):
        u, v, nn, nd = _intern_row(
            st["k1"][r], st["k2"][r], st["val"][r], st["l2h"][r],
            int(st["n_nodes"][r]), int(st["n_dropped"][r]),
            [buckets[r, :, k] for k in range(4)], n_cap, seg, stats)
        st["n_nodes"][r], st["n_dropped"][r] = nn, nd
        us.append(u)
        vs.append(v)
    return (np.stack(us).astype(np.int32), np.stack(vs).astype(np.int32),
            st, stats)


def intern_oracle(state, buckets, n_cap):
    st = {k: torch.from_numpy(np.array(v, copy=True))
          for k, v in state.items()}
    b = torch.from_numpy(buckets)
    u, v = intern_plain((st["k1"], st["k2"], st["val"]), st["l2h"],
                        st["n_nodes"], st["n_dropped"],
                        tuple(b[..., k] for k in range(4)), n_cap)
    return u.numpy(), v.numpy(), {k: t.numpy() for k, t in st.items()}


def _same_intern(state, buckets, n_cap, seg=SEG):
    u, v, st, stats = intern_model(state, buckets, n_cap, seg)
    pu, pv, pst = intern_oracle(state, buckets, n_cap)
    np.testing.assert_array_equal(u, pu)
    np.testing.assert_array_equal(v, pv)
    for k in pst:
        np.testing.assert_array_equal(st[k], pst[k], err_msg=k)
    return stats


@pytest.mark.parametrize("kind", T.INTERN_KINDS)
@pytest.mark.parametrize("seg", [64, SEG])
def test_intern_model_equals_plain(kind, seg):
    """Every hard case at cap 2^10 (128 keys held, 32 of them deleted),
    3 rows, in segments of 64 endpoints and of the kernel's ``kSeg``."""
    rng = np.random.default_rng(T.INTERN_KINDS.index(kind) + seg)
    cap = 1 << 10
    n_cap = 128 + 20 if kind == "room" else 512   # room: 20 new keys a row
    lanes = 300 if kind == "long" else 96
    state = T.intern_table(3, cap, n_cap, 128, rng, n_tomb=32)
    buckets = T.intern_buckets(kind, 3, lanes, cap, rng, k1=state["k1"])
    stats = _same_intern(state, buckets, n_cap, seg)
    if kind in ("shared_start", "spills", "wrap"):
        assert stats["contended"] > 0
    if kind == "room":
        assert stats["dropped"] > 0 and stats["inserted"] == 3 * 20
    if kind == "long" and seg == 64:
        assert stats["segments"] > 3 * 5 and stats["found_live"] > 0


def test_intern_model_spills_displace_uncontended_keys():
    """A contended group's walk takes the f of an uncontended key of
    higher rank (which then walks too): spill patterns on an empty
    table, many seeds."""
    displaced = 0
    for seed in range(8):
        rng = np.random.default_rng(100 + seed)
        state = T.intern_table(2, 1 << 8, 512, 0, rng)
        buckets = T.intern_buckets("spills", 2, 64, 1 << 8, rng, pad=0.0)
        displaced += _same_intern(state, buckets, 512)["displaced"]
    assert displaced > 0


@pytest.mark.parametrize("n_empty,n_tomb", [(2, 2), (0, 0), (0, 3)],
                         ids=["runs_out", "full", "tombs_only"])
def test_intern_model_out_of_free_slots(n_empty, n_tomb):
    """Tables that run out of free slots mid-call (2 EMPTY and 2 TOMB
    slots), that have none (every insert goes at its start, over a live
    key), and whose only free slots are TOMBs: the lanes from the first
    key with no slot take the ordered walk."""
    rng = np.random.default_rng(7 + n_empty + n_tomb)
    cap = 32
    state = T.intern_table(2, cap, 64, 0, rng, n_tomb=n_tomb,
                           n_empty=n_empty)
    buckets = T.intern_buckets("room", 2, 12, cap, rng, pad=0.1)
    stats = _same_intern(state, buckets, 64)
    assert stats["out_of_slots"] == 2


def test_intern_model_invalid_changes_and_hits():
    """Padding with one word -1, keys held at entry, a second call of the
    same buckets (every key found)."""
    rng = np.random.default_rng(11)
    cap = 1 << 9
    state = T.intern_table(2, cap, 256, 64, rng, n_tomb=8)
    buckets = T.intern_buckets("room", 2, 80, cap, rng, pad=0.2)
    buckets[:, ::7, 2] = -1                  # v's hi word only
    _same_intern(state, buckets, 256)
    _, _, after = intern_oracle(state, buckets, 256)
    stats = _same_intern(after, buckets, 256)
    assert stats["inserted"] == 0


# --------------------------------------------------------------------- #
# the rebuild kernel's decomposition
# --------------------------------------------------------------------- #


class Broken(ValueError):
    pass


def _replay_bitmap(ok1, ok2, p, n, s, cap, wmod, prehashed, src):
    """One run from the window: offsets in the fold's order, each key at
    the first untaken offset at or after its home's."""
    split = cap - s if s + n > cap else n
    taken = np.zeros(n, bool)
    for i in list(range(split, n)) + list(range(split)):
        wp = (p + i) % wmod
        if ok1[wp] < 0:
            continue
        home = int(_probe_start(torch.tensor([int(ok1[wp])]),
                                torch.tensor([int(ok2[wp])]), cap,
                                prehashed))
        h = (home - s) % cap
        if h > i:
            raise Broken(f"slot {(s + i) % cap}")
        o = h + int(np.flatnonzero(~taken[h:])[0])
        taken[o] = True
        src[(p + o) % wmod] = wp


def _replay_walk(k1, k2, val, s, n, cap, prehashed, nk1, nk2, nval,
                 written):
    """The slow path: the run's slots cleared, then the fold's walk in the
    new table."""
    for i in range(n):
        x = (s + i) % cap
        nk1[x], nk2[x], nval[x] = EMPTY, EMPTY, 0
        written[x] += 1
    split = cap - s if s + n > cap else n
    for i in list(range(split, n)) + list(range(split)):
        p = (s + i) % cap
        if k1[p] < 0:
            continue
        x = int(_probe_start(torch.tensor([int(k1[p])]),
                             torch.tensor([int(k2[p])]), cap, prehashed))
        if n != cap and (x - s) % cap > i:
            raise Broken(f"slot {p}")
        while nk1[x] != EMPTY and (nk1[x], nk2[x]) != (k1[p], k2[p]):
            x = (x + 1) % cap
        nk1[x], nk2[x], nval[x] = k1[p], k2[p], val[p]


def rebuild_model(k1, k2, val, prehashed, tile=TILE, halo=HALO):
    """The kernel's tiles on numpy arrays: ``(nk1, nk2, nval, stats)``;
    raises :class:`Broken` where the kernel sets its status word.  Checks
    that every slot is written by exactly one tile."""
    cap = k1.size
    one = cap <= tile
    t_len = cap if one else tile
    win = cap if one else tile + halo
    nk1 = np.full(cap, 7, np.int32)     # garbage: every slot is written
    nk2 = np.full(cap, 7, np.int32)
    nval = np.full(cap, 7, np.int32)
    written = np.zeros(cap, np.int64)
    stats = dict.fromkeys(("bitmap_runs", "over_32", "into_halo",
                           "past_halo", "full"), 0)
    for t0 in range(0, cap, t_len):
        # window position p (from -1) at index p + 1
        ok1 = np.array([k1[(t0 + p) % cap] for p in range(-1, win)])
        empty = ok1 == EMPTY
        prev_empty = lambda p: empty[((p - 1) % cap if one else p - 1) + 1]
        lo = 0 if one else next((p for p in range(t_len)
                                 if empty[p + 1] or prev_empty(p)), t_len)
        last_empty = max((p for p in range(-1, t_len) if empty[p + 1]),
                         default=-2)
        end = next((p for p in range(t_len, win) if empty[p + 1]), None)
        hi, long_run = t_len, False
        if not one and not empty[t_len] and last_empty > -2:
            if end is not None:
                hi = end
                stats["into_halo"] += 1
            else:
                hi, long_run = last_empty + 1, True
                stats["past_halo"] += 1
        full = False
        if last_empty == -2 and end is None and (one or t0 == 0):
            full = not any(k1[x] == EMPTY for x in range(win, cap - 1))
            stats["full"] += full
            if full:                 # the walk takes the whole table
                lo = hi = t_len
        ok2 = np.zeros(win, np.int64)
        oval = np.zeros(win, np.int64)
        src = np.full(win, -1)
        for p in range(lo, hi):
            if ok1[p + 1] >= 0:
                x = (t0 + p) % cap
                ok2[p], oval[p] = k2[x], val[x]
        ok1 = ok1[1:]
        if not full:
            for p in range(lo, hi if long_run else t_len):
                if empty[p + 1] or not prev_empty(p):
                    continue
                n = 1
                while n < win and not empty[((p + n) % cap if one
                                             else p + n) + 1]:
                    n += 1
                stats["bitmap_runs"] += 1
                stats["over_32"] += n > 32
                _replay_bitmap(ok1, ok2, p, n, (t0 + p) % cap, cap,
                               cap if one else win, prehashed, src)
        if long_run or full:
            s0 = 0 if full else (t0 + hi) % cap
            n = cap if full else win - hi
            while not full and k1[(s0 + n) % cap] != EMPTY:
                n += 1
            _replay_walk(k1, k2, val, s0, n, cap, prehashed, nk1, nk2, nval,
                         written)
        for p in range(lo, hi):
            x = (t0 + p) % cap
            q = src[p]
            nk1[x] = EMPTY if q < 0 else ok1[q]
            nk2[x] = EMPTY if q < 0 else ok2[q]
            nval[x] = 0 if q < 0 else oval[q]
            written[x] += 1
    assert (written == 1).all(), np.flatnonzero(written != 1)[:10]
    return nk1, nk2, nval, stats


def _same_rebuild(k1, k2, val, prehashed, **kw):
    nk1, nk2, nval, stats = rebuild_model(k1, k2, val, prehashed, **kw)
    want = ht_rebuild_plain(*(torch.from_numpy(a.copy())
                              for a in (k1, k2, val)), prehashed=prehashed)
    for got, w, name in zip((nk1, nk2, nval), want, ("k1", "k2", "val")):
        np.testing.assert_array_equal(got, w.numpy(), err_msg=name)
    return stats


def test_rebuild_model_clustered_small_tiles():
    """A 4,096-slot table at 50% load with tiles of 256 slots and a halo
    of 64 (the kernel's shapes cut by 8): runs over 32 slots, runs into
    the halo, a run past it (the walk), a run wrapping past slot 4,095."""
    rng = np.random.default_rng(3)
    cap, tile, halo = 1 << 12, 256, 64
    k1, k2, val = T.clustered_table(
        cap, 0.5, T.rebuild_clusters(cap, tile, halo, rng), rng)
    seen = T.describe_runs(k1, tile, halo)
    assert seen["over_32"] and seen["cross_tile"] and seen["past_halo"]
    assert seen["wraps"]
    stats = _same_rebuild(k1, k2, val, True, tile=tile, halo=halo)
    assert stats["over_32"] and stats["into_halo"] and stats["past_halo"]


def test_rebuild_model_kernel_tiles():
    """The kernel's own tile and halo on a 2^16-slot clustered table at
    60% load."""
    rng = np.random.default_rng(4)
    cap = 1 << 16
    k1, k2, val = T.clustered_table(
        cap, 0.6, T.rebuild_clusters(cap, TILE, HALO, rng), rng)
    stats = _same_rebuild(k1, k2, val, True)
    assert stats["over_32"] and stats["into_halo"] and stats["past_halo"]


@pytest.mark.parametrize("cap", [8, 16, 32, 256])
@pytest.mark.parametrize("prehashed", [False, True])
def test_rebuild_model_one_tile_and_full(cap, prehashed):
    """Tables of one tile (the window the whole table, runs wrapping):
    random keys at 70% with tombstones, and full tables with and without
    tombstones (one run from slot 0, which takes the walk); then the same
    as a table of several tiles of ``cap / 4`` slots."""
    rng = np.random.default_rng(cap + prehashed)
    n = int(cap * 0.7)
    hi = rng.integers(0, (1 << 31) - 1 if prehashed else 1 << 20, n)
    lo = rng.permutation(1 << 20)[:n]
    k1, k2, _ = T.round_build(cap, hi.astype(np.int32),
                              lo.astype(np.int32),
                              T.homes(hi, lo, cap, prehashed))
    val = rng.integers(-2 ** 31, 2 ** 31, cap).astype(np.int32)
    T.tombstone(k1, k2, val, cap // 10, rng)
    _same_rebuild(k1, k2, val, prehashed, tile=cap, halo=0)
    _same_rebuild(k1, k2, val, prehashed, tile=cap // 4, halo=cap // 8)
    for n_tomb in (0, 2):
        hi = rng.integers(0, (1 << 31) - 1 if prehashed else 1 << 20, cap)
        lo = rng.permutation(1 << 20)[:cap]
        k1, k2, _ = T.round_build(cap, hi.astype(np.int32),
                                  lo.astype(np.int32),
                                  T.homes(hi, lo, cap, prehashed))
        T.tombstone(k1, k2, val, n_tomb, rng)
        stats = _same_rebuild(k1, k2, val, prehashed, tile=cap, halo=0)
        assert stats["full"] == 1
        stats = _same_rebuild(k1, k2, val, prehashed, tile=cap // 4,
                              halo=cap // 8)
        assert stats["full"] == 1


def test_rebuild_model_refuses_a_broken_chain():
    """A live key behind an EMPTY slot of its chain: the model raises
    where the kernel sets kBroken."""
    cap = 64
    k1 = np.full(cap, EMPTY, np.int32)
    k2 = np.full(cap, EMPTY, np.int32)
    home = int(_probe_start(torch.tensor([7]), torch.tensor([9]), cap,
                            False))
    k1[(home + 2) % cap], k2[(home + 2) % cap] = 7, 9
    with pytest.raises(Broken):
        rebuild_model(k1, k2, np.zeros(cap, np.int32), False, tile=16,
                      halo=8)


def test_kernel_constants_are_the_models():
    """The models read ``kSeg``, ``kTile`` and ``kHalo`` from the kernel
    sources; ``kernels/ht_rebuild.py`` repeats the tile and halo for the
    tests and ``chip_smoke.py``; the shapes the kernels rely on hold."""
    from repro_torch.kernels import ht_rebuild
    assert (TILE, HALO) == (ht_rebuild.TILE, ht_rebuild.HALO)
    assert SEG % 1024 == 0
    assert TILE & (TILE - 1) == 0 and HALO < TILE
    assert TILE + HALO < 1 << 15          # src positions are int16
    text = Path(_build.CSRC / "intern.cu").read_text()
    assert "constexpr int kBlock = 1024;" in text
