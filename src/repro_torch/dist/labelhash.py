"""Stable 62-bit label hashing for the sharded dispatch path (host side).

A copy of ``repro/dist/labelhash.py`` (numpy only; the port imports
nothing of the JAX package).  The hashes are the placement and the
intern-table keys, so they are bit for bit the JAX package's.

Every label maps to a 62-bit hash, carried on the device as two
non-negative ``int32`` words ``(hi, lo)``: the key shape of the engine's
open-addressing tables, so a shard interns the words directly into its
dense local id space.  The host's per-chunk work is one vectorized numpy
pass (integer labels) or one pure-function pass (any other hashable);
the reverse map that ``decode``/``shard_of`` need is folded lazily at
sync points.

Hash functions (both fixed forever: they define placement):

* integer labels: the splitmix64 finalizer over the two's-complement
  uint64, vectorized with numpy on whole chunks;
* any other hashable: blake2b-8 over a stable byte encoding (str/bytes
  verbatim with a type tag, anything else over ``repr``).

A collision of two labels would merge them into one node; the lazy
reverse-map fold checks for it and raises.
"""
from __future__ import annotations

import hashlib
from typing import Sequence, Tuple

import numpy as np

MASK31 = 0x7FFFFFFF          # each on-device hash word is a 31-bit int32
MASK62 = (1 << 62) - 1
MASK64 = (1 << 64) - 1
_U64 = np.uint64


def _splitmix64(z: np.ndarray) -> np.ndarray:
    """splitmix64 finalizer, vectorized over uint64 (wraps mod 2**64)."""
    z = (z + _U64(0x9E3779B97F4A7C15))
    z = (z ^ (z >> _U64(30))) * _U64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> _U64(27))) * _U64(0x94D049BB133111EB)
    return z ^ (z >> _U64(31))


def _splitmix64_int(x: int) -> int:
    """Scalar splitmix64 in Python ints — bit-identical to the numpy path
    (which wraps mod 2**64), without numpy's scalar-overflow warnings."""
    z = (x + 0x9E3779B97F4A7C15) & MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & MASK64
    return z ^ (z >> 31)


def _hash_bytes(data: bytes) -> int:
    return int.from_bytes(
        hashlib.blake2b(data, digest_size=8).digest(), "little")


def _fuse62(z: int) -> int:
    """Fold a 64-bit hash into the packed 62-bit `(hi << 31 | lo)` form."""
    return ((z >> 33) << 31 | (z & MASK31)) & MASK62


def hash_label(label: object) -> int:
    """The 62-bit hash of one label (`hi << 31 | lo`), as a Python int.

    Numeric labels that compare equal as dict keys must hash equal (the
    pre-hash gid dict keyed on label equality): bools and integral floats
    canonicalize to int before hashing.  Exotic numeric types (Decimal,
    Fraction) fall to the ``repr`` path and do NOT join that equivalence.
    """
    if isinstance(label, (bool, np.bool_)):
        # bool subclasses int for dict keys; keep that equivalence here
        label = int(label)
    elif isinstance(label, (float, np.floating)):
        f = float(label)
        if f.is_integer() and -(1 << 63) <= f < (1 << 64):
            label = int(f)       # 1.0 and 1 are one dict key -> one node
        else:
            # non-integral: own type tag (1.5 must not collide with the
            # string "1.5"), repr for stability across float widths
            return _fuse62(_hash_bytes(b"f\x00" + repr(f).encode("ascii")))
    if isinstance(label, (int, np.integer)) and -(1 << 63) <= label < (1 << 64):
        # covers the full uint64-representable range so the vectorized
        # path (int64 or uint64 arrays) can never disagree with this one
        z = _splitmix64_int(int(label) & MASK64)
    elif isinstance(label, str):
        z = _hash_bytes(b"s\x00" + label.encode("utf-8"))
    elif isinstance(label, bytes):
        z = _hash_bytes(b"b\x00" + label)
    else:
        # stable within a run; ``repr`` stability across runs is the
        # caller's contract for exotic label types
        z = _hash_bytes(b"r\x00" + repr(label).encode("utf-8"))
    return _fuse62(int(z))


def hash_words(labels: Sequence[object]) -> Tuple[np.ndarray, np.ndarray]:
    """Hash a chunk of labels into device words ``(hi, lo)``, int32 each.

    Integer labels take the vectorized numpy path — zero Python-object
    work per element; anything else falls back to :func:`hash_label` per
    element (pure function, still no dict/counter mutation).
    """
    try:
        arr = np.asarray(labels)
    except (ValueError, TypeError):   # ragged label tuples etc.
        arr = np.empty(0, object)
    # tuple labels coerce to a 2-D int array — ndim guards against that
    if arr.ndim != 1 or arr.dtype.kind not in "iub":
        comb = np.fromiter((hash_label(x) for x in labels), np.int64,
                           len(labels))
        return ((comb >> 31).astype(np.int32),
                (comb & MASK31).astype(np.int32))
    z = _splitmix64(arr.astype(np.int64).astype(_U64))
    hi = ((z >> _U64(33)) & _U64(MASK31)).astype(np.int32)
    lo = (z & _U64(MASK31)).astype(np.int32)
    return hi, lo


def combine(hi: np.ndarray, lo: np.ndarray) -> np.ndarray:
    """Fuse device words back into the 62-bit host form (int64)."""
    return (hi.astype(np.int64) << 31) | lo.astype(np.int64)
