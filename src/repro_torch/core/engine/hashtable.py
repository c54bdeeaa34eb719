"""Open-addressing hash tables in preallocated torch tensors.

Port of ``repro/core/engine/hashtable.py``: ``int32`` key pairs, linear
probing, tombstone deletion, ``k1 == EMPTY`` marks a free slot and
``k1 == TOMB`` a deleted one.  The probe sequence is the table layout, so
every probe here is bitwise the one of the JAX package.

**In-place writes.**  JAX updates a table functionally and XLA makes the
update in place inside ``jit``; eager torch would copy the whole table on
every write (384 MiB for a 2^25-slot table).  Every mutating op here
therefore writes its slot in place (indexing assignment) and returns the
same table object.  A masked write (``ok`` a bool tensor that is False)
writes the slot's old contents back, as in JAX; ``ok=False`` as a Python
bool skips the write.

**Probes.**  Every probe, batched or scalar, goes through
``repro_torch.kernels.ops.ht_probe_many``: the CUDA kernel for tables on
the card, its plain torch version for tables on the CPU.  A scalar probe
is a one-lane batch (``mode="find"`` for :func:`ht_find`,
``mode="insert"`` for :func:`_find_insert_slot`), which is bitwise the
same by the kernel's contract and needs no host sync per probe step.
:func:`probe_many` probes several tables in one launch; ``ht_set`` and
``ht_delete`` come in halves (:func:`set_job`/:func:`set_write`,
:func:`delete_job`/:func:`delete_write`) so that a caller can probe two
tables at once and then write both.  A probe sees every write made before
it, so only probes with no write to their table between them may share a
launch.

**uint32 arithmetic.**  Torch's CPU build has no ``>>`` or ``+`` for
``uint32``, so the hash words live in ``int64`` tensors holding values in
``[0, 2^32)``; every product is split so that it stays below 2^63.

Scalars in this layer are one-lane tensors (shape ``[1]``): indexing with
a 0-dim tensor would read the index back to the host.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple, Union

import numpy as np
import torch

EMPTY = -1
TOMB = -2
M32 = 0xFFFFFFFF

Lane = Union[int, torch.Tensor]


def u32(x: Lane) -> Lane:
    """The uint32 bit pattern of an integer (tensor), as int64."""
    if isinstance(x, int):
        return x & M32
    return x.to(torch.int64) & M32


def mul_u32(a: Lane, c: int) -> Lane:
    """``(a * c) mod 2^32`` for ``a`` in ``[0, 2^32)`` and a constant ``c``,
    with every intermediate below 2^49."""
    c &= M32
    lo, hi = c & 0xFFFF, c >> 16
    return (a * lo + (((a * hi) & 0xFFFF) << 16)) & M32


@dataclasses.dataclass
class HashTable:
    k1: torch.Tensor   # int32[cap]
    k2: torch.Tensor   # int32[cap]
    val: torch.Tensor  # int32[cap]

    @property
    def capacity(self) -> int:
        return self.k1.shape[0]


def ht_new(capacity: int, device) -> HashTable:
    if capacity & (capacity - 1):
        raise ValueError(f"capacity must be a power of two: {capacity}")
    return HashTable(
        k1=torch.full((capacity,), EMPTY, dtype=torch.int32, device=device),
        k2=torch.full((capacity,), EMPTY, dtype=torch.int32, device=device),
        val=torch.zeros((capacity,), dtype=torch.int32, device=device),
    )


def _hash(k1: torch.Tensor, k2: torch.Tensor, cap: int) -> torch.Tensor:
    """Two-word integer mix (fmix32-style) onto [0, cap), as int64."""
    h = mul_u32(u32(k1), 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = (h + mul_u32(u32(k2), 0xC2B2AE35)) & M32
    h = h ^ (h >> 16)
    h = mul_u32(h, 0x27D4EB2F)
    h = h ^ (h >> 15)
    return h & (cap - 1)


def _probe_start(k1: torch.Tensor, k2: torch.Tensor, cap: int,
                 prehashed: bool) -> torch.Tensor:
    """First probe slot for a key (int64).  ``prehashed`` folds the words
    directly (tables keyed by full-entropy hashes); a table must be probed
    with one consistent setting."""
    if prehashed:
        return (u32(k1) ^ u32(k2)) & (cap - 1)
    return _hash(k1, k2, cap)


def _lanes(x: torch.Tensor) -> torch.Tensor:
    """Query words as a contiguous int32 tensor of lanes (``x`` itself
    when it already is one)."""
    if x.dtype == torch.int32 and x.dim() == 1 and x.is_contiguous():
        return x
    return x.reshape(-1).to(torch.int32).contiguous()


# one probe of a table: (table, k1, k2, prehashed, mode)
TableProbe = Tuple[HashTable, torch.Tensor, torch.Tensor, bool, str]
Probed = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def probe_many(probes: Sequence[TableProbe]) -> List[Probed]:
    """One probe launch for several ``(table, k1, k2, prehashed, mode)``
    probes: ``(slot, found, val)`` per probe and lane, ``val`` read at the
    key's find-chain end (garbage when ``~found``)."""
    # the kernels layer imports this module for the probe-sequence
    # helpers, so the dependency cannot be top-level
    from repro_torch.kernels import ops as kops
    return kops.ht_probe_many([
        (ht.k1, ht.k2, ht.val, _lanes(k1), _lanes(k2), prehashed, mode)
        for ht, k1, k2, prehashed, mode in probes])


def ht_find(ht: HashTable,
            k1: torch.Tensor, k2: torch.Tensor, prehashed: bool = False,
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(slot, found) per lane: probes until the key or an EMPTY slot is
    hit.  One probe launch, whether the keys are one lane or a batch."""
    slot, found, _ = probe_many([(ht, k1, k2, prehashed, "find")])[0]
    return slot, found


def ht_lookup(ht: HashTable,
              k1: torch.Tensor, k2: torch.Tensor, default: int = 0,
              ) -> torch.Tensor:
    """Read-only lookups (``default`` where absent), one probe launch."""
    _, found, val = probe_many([(ht, k1, k2, False, "find")])[0]
    return torch.where(found, val, default)


# a scalar probe is a one-lane batch, so the batched names are the same ops
ht_find_batch = ht_find
ht_lookup_batch = ht_lookup


def _find_insert_slot(ht: HashTable, k1: torch.Tensor, k2: torch.Tensor,
                      prehashed: bool = False,
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Slot for an upsert (the key's slot if present, else the first
    EMPTY/TOMB slot), found, and the value at the key's chain end."""
    return probe_many([(ht, k1, k2, prehashed, "insert")])[0]


def _put(x: torch.Tensor, idx: torch.Tensor, v, ok) -> None:
    """``x[idx] = v`` in place under ``ok`` (masked: the old value back)."""
    if ok is True:
        x[idx] = v
    elif ok is not False:
        x[idx] = torch.where(ok, v, x[idx])


def set_job(ht: HashTable, k1: torch.Tensor, k2: torch.Tensor,
            prehashed: bool = False) -> TableProbe:
    """The probe half of :func:`ht_set`: the upsert probe of the key."""
    return ht, _lanes(k1), _lanes(k2), prehashed, "insert"


def set_write(job: TableProbe, probed: Probed, v, ok=True) -> HashTable:
    """The write half of :func:`ht_set`, from its probe's result."""
    ht, k1, k2 = job[:3]
    _put(ht.k1, probed[0], k1, ok)
    _put(ht.k2, probed[0], k2, ok)
    _put(ht.val, probed[0], v, ok)
    return ht


def ht_set(ht: HashTable,
           k1: torch.Tensor, k2: torch.Tensor, v, prehashed: bool = False,
           ok=True) -> HashTable:
    """Upsert key -> v (in place; masked write-back when ``~ok``)."""
    if ok is False:
        return ht
    job = set_job(ht, k1, k2, prehashed)
    return set_write(job, probe_many([job])[0], v, ok)


def ht_add(ht: HashTable, k1: torch.Tensor, k2: torch.Tensor, delta,
           remove_if_zero: bool = False, ok=True,
           ) -> Tuple[HashTable, torch.Tensor]:
    """val[key] += delta (inserting at 0 if absent); returns (table, new).

    With ``remove_if_zero`` the entry is tombstoned when it reaches 0.
    ``new`` is the would-be value either way; the table is only written
    under ``ok``.
    """
    k1, k2 = _lanes(k1), _lanes(k2)
    slot, found, val = _find_insert_slot(ht, k1, k2)
    new = torch.where(found, val, 0) + delta
    if ok is False:
        return ht, new
    if remove_if_zero:
        dead = new == 0
        _put(ht.k1, slot, torch.where(dead, TOMB, k1), ok)
        _put(ht.k2, slot, torch.where(dead, TOMB, k2), ok)
        _put(ht.val, slot, torch.where(dead, 0, new), ok)
    else:
        _put(ht.k1, slot, k1, ok)
        _put(ht.k2, slot, k2, ok)
        _put(ht.val, slot, new, ok)
    return ht, new


def delete_job(ht: HashTable, k1: torch.Tensor, k2: torch.Tensor,
               ) -> TableProbe:
    """The probe half of :func:`ht_delete`: the find probe of the key."""
    return ht, _lanes(k1), _lanes(k2), False, "find"


def delete_write(job: TableProbe, probed: Probed, ok=True) -> HashTable:
    """The write half of :func:`ht_delete`, from its probe's result."""
    ht = job[0]
    slot, found, _ = probed
    if ok is not True:
        found = found & ok
    ht.k1[slot] = torch.where(found, TOMB, ht.k1[slot])
    ht.k2[slot] = torch.where(found, TOMB, ht.k2[slot])
    ht.val[slot] = torch.where(found, 0, ht.val[slot])
    return ht


def ht_delete(ht: HashTable,
              k1: torch.Tensor, k2: torch.Tensor, ok=True) -> HashTable:
    """Tombstone the key if present (no-op otherwise or when ``~ok``)."""
    if ok is False:
        return ht
    job = delete_job(ht, k1, k2)
    return delete_write(job, probe_many([job])[0], ok)


def ht_live_mask(ht: HashTable) -> torch.Tensor:
    return ht.k1 >= 0


def ht_load(ht: HashTable) -> float:
    """Fraction of live slots (host-side maintenance signal)."""
    return float(ht_live_mask(ht).float().mean())


def ht_rebuild(ht: HashTable, prehashed: bool = False) -> HashTable:
    """Compaction: rehash live entries, in slot order, into a fresh table.

    The same upserts as the JAX ``ht_rebuild`` fold, so the layout is
    bitwise the same.  Runs on the host: the order of the inserts is the
    layout, so it is one sequential pass (a maintenance step between
    batches, not on the step's path).  ``prehashed`` must match how the
    table is probed.
    """
    cap = ht.capacity
    k1 = ht.k1.cpu().numpy()
    k2 = ht.k2.cpu().numpy()
    val = ht.val.cpu().numpy()
    live = np.flatnonzero(k1 >= 0)
    start = _probe_start(torch.from_numpy(k1[live]),
                         torch.from_numpy(k2[live]), cap, prehashed).tolist()
    n1 = np.full(cap, EMPTY, np.int32)
    n2 = np.full(cap, EMPTY, np.int32)
    nv = np.zeros(cap, np.int32)
    for s, i in zip(start, live.tolist()):
        a, b = int(k1[i]), int(k2[i])
        j = 0
        # a fresh table holds no tombstones and only distinct live keys:
        # the upsert slot is the first EMPTY slot or the key's own
        while j < cap:
            x = (s + j) & (cap - 1)
            if n1[x] == EMPTY or (n1[x] == a and n2[x] == b):
                break
            j += 1
        x = (s + j) & (cap - 1)
        n1[x], n2[x], nv[x] = a, b, val[i]
    dev = ht.k1.device
    return HashTable(k1=torch.from_numpy(n1).to(dev),
                     k2=torch.from_numpy(n2).to(dev),
                     val=torch.from_numpy(nv).to(dev))
