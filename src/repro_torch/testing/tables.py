"""Adversarial tables and intern buckets for the intern and rebuild kernels.

The CPU tests (``tests/test_torch_kernel_designs.py``), the card tests
(``tests/test_torch_intern_card.py``, ``tests/test_torch_rebuild_card.py``)
and ``chip_smoke.py`` (phases 15(a) and 22(a)) draw their hard cases here,
from numpy generators, so that each runs the same shapes of trouble:

* intern buckets whose keys share a prehashed start, groups whose spills
  reach another group's first free slot, starts just before planted
  tombstones, starts near ``cap - 1`` (chains that wrap), pools drawn with
  repeats (the room running out mid-call, repeats of dropped keys; a row
  longer than the kernel's shared-memory segment);
* intern tables built by linear-probe inserts, with tombstones, nearly
  full and full (no EMPTY and no TOMB slot);
* rebuild tables whose keys home into narrow windows: runs longer than 32
  slots, runs across tile ends, a run longer than the halo, a run that
  wraps past slot ``cap - 1``.

Every table is one that inserts and deletes make: each live key sits
behind a chain with no EMPTY slot from its home (built in rounds, each
pending key trying its next slot, one winner a slot).  Keys are numpy
int32; a crafted key ``(hi, hi ^ start)`` has the prehashed start
``start`` and ``hi >= 2^30``, so it never equals a key of the
bulk-built tables of ``chip_smoke.py`` (whose ``k2`` stays below 2^20).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.engine.hashtable import EMPTY, TOMB, _probe_start

Words = Tuple[np.ndarray, np.ndarray]

# intern bucket kinds (see intern_buckets)
INTERN_KINDS = ("shared_start", "spills", "tombs", "wrap", "room", "long")
SHARED_KEYS = 64                  # keys on one start a row (shared_start)
# (offset from the base start, keys) of one spill pattern: each group's
# keys spill past the next group's start
SPILL_PATTERN = ((0, 6), (2, 1), (3, 3), (8, 1), (9, 2), (12, 5), (20, 1))
SPILL_BASES = 8                   # spill patterns a row


def crafted_keys(starts: np.ndarray, salt0: int = 0) -> Words:
    """Distinct prehashed keys ``(hi, hi ^ start)``, one a start, ``hi``
    in ``[2^30, 2^31)`` from the salts ``salt0, salt0 + 1, ...``."""
    starts = np.asarray(starts, np.int64)
    salts = salt0 + np.arange(starts.size, dtype=np.int64)
    hi = (1 << 30) | ((salts * 2654435761) & ((1 << 30) - 1))
    lo = hi ^ starts.reshape(-1)
    return (hi.astype(np.int32).reshape(starts.shape),
            lo.astype(np.int32).reshape(starts.shape))


def homes(k1: np.ndarray, k2: np.ndarray, cap: int,
          prehashed: bool) -> np.ndarray:
    """The hashtable's home slot of each key (int64)."""
    return _probe_start(torch.from_numpy(np.ascontiguousarray(k1)),
                        torch.from_numpy(np.ascontiguousarray(k2)), cap,
                        prehashed).numpy()


def round_build(cap: int, k1: np.ndarray, k2: np.ndarray,
                home: np.ndarray) -> Tuple[np.ndarray, np.ndarray,
                                           np.ndarray]:
    """A linear-probe table of distinct keys: ``(tk1, tk2, slot)`` with
    ``slot[i]`` key i's slot.  In rounds, each pending key tries its next
    slot and the first pending key of the lowest index wins a free one, so
    every key sits behind slots that were taken when it passed them."""
    tk1 = np.full(cap, EMPTY, np.int32)
    tk2 = np.full(cap, EMPTY, np.int32)
    slot = np.full(k1.size, -1, np.int64)
    pending = np.arange(k1.size)
    off = np.zeros(k1.size, np.int64)
    while pending.size:
        at = (home[pending] + off[pending]) & (cap - 1)
        free = tk1[at] == EMPTY
        cand, where = pending[free], at[free]
        where, first = np.unique(where, return_index=True)
        won = cand[first]
        tk1[where], tk2[where], slot[won] = k1[won], k2[won], where
        keep = slot[pending] < 0
        pending = pending[keep]
        off[pending] += 1
    return tk1, tk2, slot


def tombstone(k1: np.ndarray, k2: np.ndarray, val: np.ndarray, n: int,
              rng: np.random.Generator) -> np.ndarray:
    """Delete ``n`` random live keys as ``ht_delete`` does (TOMB, TOMB, 0
    at the slot), in place; returns the slots."""
    live = np.flatnonzero(k1 >= 0)
    dead = rng.choice(live, size=min(n, live.size), replace=False)
    k1[dead], k2[dead], val[dead] = TOMB, TOMB, 0
    return dead


# --------------------------------------------------------------------- #
# intern
# --------------------------------------------------------------------- #


def intern_table(rows: int, cap: int, n_cap: int, n_keys: int,
                 rng: np.random.Generator, n_tomb: int = 0,
                 n_empty: Optional[int] = None) -> Dict[str, np.ndarray]:
    """A stacked block of ``rows`` intern states (numpy leaves ``k1``,
    ``k2``, ``val``, ``l2h``, ``n_nodes``, ``n_dropped``): ``n_keys``
    crafted keys at random starts with ids ``0 .. n_keys - 1`` (``l2h``
    rows to match), then ``n_tomb`` of them deleted.  ``n_empty`` (None:
    whatever is left) leaves only that many EMPTY slots: the rest of the
    table is filled with more live keys (ids too), so that a call soon
    runs out of free slots."""
    out = dict(k1=np.full((rows, cap), EMPTY, np.int32),
               k2=np.full((rows, cap), EMPTY, np.int32),
               val=np.zeros((rows, cap), np.int32),
               l2h=np.full((rows, n_cap, 2), -1, np.int32),
               n_nodes=np.zeros(rows, np.int32),
               n_dropped=np.zeros(rows, np.int32))
    for r in range(rows):
        n = n_keys if n_empty is None else cap - n_empty
        if n > n_cap:
            raise ValueError(f"{n} keys need n_cap >= {n}: {n_cap}")
        hi, lo = crafted_keys(rng.integers(0, cap, n), (1 << 28) + r * cap)
        tk1, tk2, slot = round_build(cap, hi, lo,
                                     homes(hi, lo, cap, True))
        out["k1"][r], out["k2"][r] = tk1, tk2
        out["val"][r, slot] = np.arange(n, dtype=np.int32)
        out["l2h"][r, :n] = np.stack([hi, lo], 1)
        out["n_nodes"][r] = n
        tombstone(out["k1"][r], out["k2"][r], out["val"][r], n_tomb, rng)
    return out


def _pool_buckets(hi: np.ndarray, lo: np.ndarray, pick: np.ndarray,
                  rng: np.random.Generator, pad: float) -> np.ndarray:
    """``int32[rows, lanes, 5]`` buckets whose endpoint e of a row (u of
    change e // 2 for even e) is pool key ``pick[row, e]``; a ``pad``
    share of the changes are padding (-1 words), as the router pads."""
    rows, n_end = pick.shape
    r = np.arange(rows)[:, None]
    eh, el = hi[r, pick], lo[r, pick]
    b = np.stack([eh[:, 0::2], el[:, 0::2], eh[:, 1::2], el[:, 1::2],
                  rng.integers(0, 2, (rows, n_end // 2))], -1)
    b[rng.random((rows, n_end // 2)) < pad, :4] = -1
    return np.ascontiguousarray(b.astype(np.int32))


def intern_buckets(kind: str, rows: int, lanes: int, cap: int,
                   rng: np.random.Generator,
                   k1: Optional[np.ndarray] = None,
                   pad: float = 0.05) -> np.ndarray:
    """``int32[rows, lanes, 5]`` buckets of one hard case (``INTERN_KINDS``)
    for intern tables of ``cap`` slots (``k1``, ``[rows, cap]``, for
    ``"tombs"``): every key novel unless drawn again from its row's pool.

    * ``"shared_start"``: ``SHARED_KEYS`` keys of a row on one start;
    * ``"spills"``: ``SPILL_BASES`` copies of ``SPILL_PATTERN`` a row,
      groups whose keys run past the next group's start;
    * ``"tombs"``: half the keys start 0-3 slots before a TOMB of the
      row's table, so their first free slot is a TOMB;
    * ``"wrap"``: 64 keys a row start in the last 32 slots, so groups
      spill past slot ``cap - 1`` to slot 0;
    * ``"room"``: a pool of ``lanes // 2 + 1`` keys a row drawn with
      repeats (with a small ``n_cap``: drops and repeats of dropped keys);
    * ``"long"``: a pool of ``lanes`` keys drawn with repeats (for rows
      longer than one segment: later segments meet earlier inserts).
    """
    n_end = 2 * lanes
    pool = n_end
    if kind == "room":
        pool = lanes // 2 + 1
    elif kind == "long":
        pool = lanes
    starts = rng.integers(0, cap, (rows, pool))
    for r in range(rows):
        if kind == "shared_start":
            starts[r, :min(SHARED_KEYS, pool)] = rng.integers(0, cap)
        elif kind == "spills":
            at = 0
            for base in rng.integers(0, cap, SPILL_BASES):
                for off, n in SPILL_PATTERN:
                    stop = min(at + n, pool)
                    starts[r, at:stop] = (base + off) % cap
                    at = stop
        elif kind == "tombs":
            if k1 is None:
                raise ValueError("tombs needs the table's k1")
            dead = np.flatnonzero(k1[r] == TOMB)
            if dead.size:
                half = pool // 2
                starts[r, :half] = (rng.choice(dead, half)
                                    - rng.integers(0, 4, half)) % cap
        elif kind == "wrap":
            n = min(64, pool)
            starts[r, :n] = cap - 1 - rng.integers(0, min(32, cap), n)
        elif kind not in ("room", "long"):
            raise ValueError(f"unknown intern bucket kind {kind!r}")
    hi, lo = crafted_keys(starts)
    if kind in ("room", "long"):
        pick = rng.integers(0, pool, (rows, n_end))
    else:
        pick = np.stack([rng.permutation(pool) for _ in range(rows)])
    return _pool_buckets(hi, lo, pick, rng, pad)


# --------------------------------------------------------------------- #
# rebuild
# --------------------------------------------------------------------- #


def clustered_table(cap: int, load: float, clusters: List[Tuple[int, int,
                                                                int]],
                    rng: np.random.Generator, tomb: float = 0.1,
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """A prehashed table ``(k1, k2, val)`` of ``cap`` slots: ``clusters``
    ``(first home, width, keys)`` of keys homed in ``[first, first +
    width)`` (mod cap), inserted first, then random keys up to ``load``
    of the slots live, then a ``tomb`` share of the live keys deleted.
    Values are random int32."""
    starts = [np.asarray(first + rng.integers(0, width, n), np.int64) % cap
              for first, width, n in clusters]
    n_fill = max(0, int(cap * load) - sum(s.size for s in starts))
    starts.append(rng.integers(0, cap, n_fill))
    hi, lo = crafted_keys(np.concatenate(starts))
    k1, k2, slot = round_build(cap, hi, lo, homes(hi, lo, cap, True))
    val = np.zeros(cap, np.int32)
    val[slot] = rng.integers(-2 ** 31, 2 ** 31, slot.size, dtype=np.int64)
    tombstone(k1, k2, val, int(tomb * slot.size), rng)
    return k1, k2, val


def runs(k1: np.ndarray) -> List[Tuple[int, int]]:
    """The maximal runs of non-EMPTY slots, ``(first slot, length)``; the
    run that wraps past slot ``cap - 1`` starts at its first slot before
    the wrap; a table with no EMPTY slot is one run from slot 0."""
    cap = k1.size
    filled = k1 != EMPTY
    if filled.all():
        return [(0, cap)]
    shift = int(np.argmin(filled))          # an EMPTY slot first
    f = np.roll(filled, -shift)
    begin = np.flatnonzero(f & ~np.roll(f, 1))
    end = np.flatnonzero(f & ~np.roll(f, -1))
    return [(int((b + shift) % cap), int(e - b + 1))
            for b, e in zip(begin, end)]


def rebuild_clusters(cap: int, tile: int, halo: int,
                     rng: np.random.Generator) -> List[Tuple[int, int,
                                                             int]]:
    """The clusters of a hard rebuild table of ``cap`` slots for a kernel
    of ``tile``-slot tiles with a ``halo``: narrow windows of 40 keys
    (runs over 32 slots), a window of 48 keys just before each of up to 64
    tile ends (runs across them), a window of ``halo + halo // 2`` keys
    homed just before a tile end (a run past that tile's halo) and 48
    keys homed in the last 8 slots (a run that wraps past slot
    ``cap - 1``)."""
    n_tiles = cap // tile
    out = [(int(x), 4, 40) for x in rng.integers(0, cap - 64,
                                                 max(1, cap // 8192))]
    ends = rng.choice(np.arange(1, n_tiles), min(64, n_tiles - 1),
                      replace=False) if n_tiles > 1 else []
    out += [(int(e) * tile - 8, 6, 48) for e in ends]
    past = int(rng.integers(1, n_tiles)) if n_tiles > 1 else 0
    out.append((past * tile - halo // 4, 8, halo + halo // 2))
    out.append((cap - 8, 8, 48))
    return out


def describe_runs(k1: np.ndarray, tile: int, halo: int) -> Dict[str, int]:
    """What a rebuild table holds for a kernel of ``tile``-slot tiles with
    a ``halo``: its runs, the longest, runs over 32 slots, runs that
    cross a tile end, runs that end past their tile's halo, and whether a
    run wraps past slot ``cap - 1``."""
    cap = k1.size
    rs = runs(k1)
    return dict(runs=len(rs), longest=max((n for _, n in rs), default=0),
                over_32=sum(n > 32 for _, n in rs),
                cross_tile=sum((s % tile) + n > tile for s, n in rs
                               if cap > tile),
                past_halo=sum((s % tile) + n > tile + halo for s, n in rs
                              if cap > tile),
                wraps=int(any(s + n > cap for s, n in rs)))
