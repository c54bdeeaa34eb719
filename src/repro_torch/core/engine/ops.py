"""Primitive state transitions of the batched engine, in torch.

Port of ``repro/core/engine/ops.py``: ``insert_edge`` / ``delete_edge``
(one stream change), ``delta_phi_move`` (closed-form objective change of a
move), ``apply_move`` (commit an accepted move) and ``recompute_phi``.
The encoding (P / C+ / C-) stays a derived view of ``(E_AB, sizes)``.

**Stacked.**  Every op takes a stacked state (``state.py``): each leaf
has a leading replica axis ``[R, ...]``, a node id, sid or per-replica
scalar is an ``[R]`` tensor (row ``r``'s for replica ``r``), and a batch
of lanes ``[R, L]``.  Replica ``r``'s op reads and writes row ``r`` only,
so R replicas step as one batch and one engine steps at R = 1
(:func:`~repro_torch.core.engine.state.stacked_view`).  Gathers and
scatters go through :func:`at` / :func:`take` / ``hashtable._put``,
which index row by row.

**In place.**  Every op writes the state's tensors in place, scalars
included, and returns the same state object.

**Predication.**  Where the JAX op takes an ``ok`` predicate, this one
takes ``True`` or ``False``, which the caller decided on the host (False
skips the op), or a bool ``[R]`` tensor, which masks the writes per
replica as in JAX (:func:`pred` makes one of the three from a host
copy).  The PRNG is counter-based and stateless, so skipping a
masked-off op leaves every other value bitwise the same.  Where an op
needs a value on the host to branch on (``pair_count_add``'s 0 <->
nonzero transitions, the trip count of ``apply_move``), it reads all R
replicas' values at once through :func:`host_read`, which counts the
syncs, and runs the branch masked to the replicas that take it.

**Shared probe launches.**  Where JAX probes two tables one after the
other with no write to either between the probes (the slot-list pairs of
``_sn_*`` and ``_adj_*``), both probes go into one launch
(:func:`~repro_torch.core.engine.hashtable.probe_many`) and the writes
follow in JAX's order per table; two probes of one table with nothing
written between them are one batch of concatenated keys.  A probe of the
R rows of a stacked table is one launch of R jobs.
"""
from __future__ import annotations

from collections import Counter
from typing import Callable, Sequence, Tuple, Union

import torch

from repro_torch.core.engine.hashtable import (M32, HashTable, Lane,
                                               TableProbe, _put,
                                               delete_job, delete_write,
                                               ht_add, ht_lookup,
                                               ht_lookup_batch, indexed,
                                               mul_u32, probe_many, set_job,
                                               set_write, u32)
from repro_torch.core.engine.state import NO_CLUSTER, EngineConfig, EngineState
from repro_torch.device import current_position

I32_MAX = 0x7FFFFFFF

# a per-replica predicate: decided on the host for every row, or a mask
Pred = Union[bool, torch.Tensor]

# --------------------------------------------------------------------------- #
# host reads, gathers, predicates
# --------------------------------------------------------------------------- #


def host_read(x: torch.Tensor) -> list:
    """``x.tolist()``, counted in ``host_read.count`` (and in
    ``host_read.by_position`` under the current mesh position): on the
    card every call is one device -> host sync."""
    host_read.count += 1
    host_read.by_position[current_position()] += 1
    return x.tolist()


def reset_host_reads() -> None:
    """Set ``host_read.count`` and its counts by position to 0."""
    host_read.count = 0
    host_read.by_position = Counter()


reset_host_reads()


def pred(flags: Sequence[bool],
         mask: Union[torch.Tensor, Callable[[], torch.Tensor]]) -> Pred:
    """The predicate whose host copy is ``flags`` (one per replica):
    ``True`` when it holds in every row, ``False`` in none, else the
    device ``mask`` (or what the callable makes)."""
    if all(flags):
        return True
    if not any(flags):
        return False
    return mask() if callable(mask) else mask


def at(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """``x[i]``, row by row for a stacked ``x`` (``i``'s leading axis is
    the row); a negative index counts from the end."""
    if x.dim() == 1:
        return x[i]
    t, key = indexed(x, i)
    return t[key]


def take(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """:func:`at` with JAX's gather semantics: a negative index counts
    from the end and an index still out of range is clamped.  Torch
    raises instead (a device-side assert on the card), so every gather
    whose index comes from table data goes through here."""
    n = x.shape[-1]
    return at(x, torch.where(i < 0, i + n, i).clamp(0, n - 1))


def _masked(ok: Pred, x, off=0):
    return x if ok is True else torch.where(ok, x, off)


def _add_at(x: torch.Tensor, i: torch.Tensor, d, ok: Pred = True) -> None:
    """``x[i] += d`` in place under ``ok``."""
    if ok is not False:
        _put(x, i, at(x, i) + _masked(ok, d), True)


# --------------------------------------------------------------------------- #
# small math helpers
# --------------------------------------------------------------------------- #


def cost(e: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Optimal per-pair encoding cost min(E, T-E+1), 0 when E==0 (int32)."""
    return torch.where(e <= 0, 0, torch.minimum(e, t - e + 1)).to(torch.int32)


def tri(n: torch.Tensor) -> torch.Tensor:
    return (n * (n - 1)) // 2


def t_of(sa: torch.Tensor, sb: torch.Tensor, same: torch.Tensor,
         ) -> torch.Tensor:
    return torch.where(same, tri(sa), sa * sb)


def mixhash(x: torch.Tensor) -> torch.Tensor:
    """Node hash for min-hash clustering (non-negative int32, never the
    ``NO_CLUSTER`` sentinel)."""
    h = mul_u32(u32(x), 0x9E3779B9)
    h = h ^ (h >> 16)
    h = mul_u32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = (h & 0x7FFFFFFF).to(torch.int32)
    return torch.where(h == NO_CLUSTER, 0x7FFFFFFE, h)


def rnd_u32(seed: Lane, ctr: Lane) -> Lane:
    """Counter-based splitmix32 PRNG; a uint32 value held in int64."""
    x = (u32(seed) + mul_u32(u32(ctr), 0x9E3779B9)) & M32
    x = mul_u32(x ^ (x >> 16), 0x21F0AAAD)
    x = mul_u32(x ^ (x >> 15), 0x735A2D97)
    return x ^ (x >> 15)


def rnd_u01(seed: Lane, ctr: Lane) -> torch.Tensor:
    """float32 in [0, 1]: the uint32 draw rounded to float32, over 2^32."""
    return rnd_u32(seed, ctr).to(torch.float32) / 4294967296.0


def _mulhi_u32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """High 32 bits of the 64-bit product a*b (uint32 values in int64),
    from 16-bit halves so that no product reaches 2^63."""
    a0, a1 = a & 0xFFFF, a >> 16
    b0, b1 = b & 0xFFFF, b >> 16
    lo = a0 * b0
    mid1 = a1 * b0 + (lo >> 16)
    mid2 = a0 * b1 + (mid1 & 0xFFFF)
    return a1 * b1 + (mid1 >> 16) + (mid2 >> 16)


def rnd_below(seed: Lane, ctr: Lane, n: torch.Tensor) -> torch.Tensor:
    """Uniform int32 in [0, max(n,1)) via Lemire's multiply-shift."""
    return _mulhi_u32(rnd_u32(seed, ctr),
                      u32(n.clamp(min=1))).to(torch.int32)


def canon(a: torch.Tensor, b: torch.Tensor,
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    return torch.minimum(a, b), torch.maximum(a, b)


# --------------------------------------------------------------------------- #
# weighted-objective quantities
# --------------------------------------------------------------------------- #


def node_weight(u: torch.Tensor, cfg: EngineConfig) -> torch.Tensor:
    """w(u) = 1 + (hash(u) % weight_levels); all-ones when levels <= 1.
    ``core.summary.host_node_weight`` is the bit-exact host mirror."""
    if cfg.weight_levels <= 1:
        return torch.ones_like(u, dtype=torch.int32)
    h = rnd_u32(u, 0x5EED)
    return (1 + h % cfg.weight_levels).to(torch.int32)


def wtri(sw: torch.Tensor, sq: torch.Tensor) -> torch.Tensor:
    """TW of a self-pair, (SW^2 - SQ) / 2; ``tri(s)`` under uniform
    weights."""
    return (sw * sw - sq) // 2


def wt_of(st: EngineState, a: torch.Tensor, b: torch.Tensor,
          same: torch.Tensor) -> torch.Tensor:
    """TW_AB from the per-supernode weight sums (weighted objective)."""
    sa = at(st.wsum, a)
    return torch.where(same, wtri(sa, at(st.wsq, a)), sa * at(st.wsum, b))


# --------------------------------------------------------------------------- #
# two tables, one probe launch
# --------------------------------------------------------------------------- #


def _lookup_both(ta: HashTable, ka1, ka2, tb: HashTable, kb1, kb2,
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``ht_lookup`` of a key in each of two tables, one probe launch."""
    pa, pb = probe_many([(ta, ka1, ka2, False, "find"),
                         (tb, kb1, kb2, False, "find")])
    return torch.where(pa[1], pa[2], 0), torch.where(pb[1], pb[2], 0)


def _set_both(ja: TableProbe, va, jb: TableProbe, vb, ok) -> None:
    """``ht_set`` in each of two tables (``set_job``s), one probe launch."""
    pa, pb = probe_many([ja, jb])
    set_write(ja, pa, va, ok)
    set_write(jb, pb, vb, ok)


def _delete_both(ja: TableProbe, jb: TableProbe, ok) -> None:
    """``ht_delete`` in each of two tables (``delete_job``s), one probe
    launch."""
    pa, pb = probe_many([ja, jb])
    delete_write(ja, pa, ok)
    delete_write(jb, pb, ok)


# --------------------------------------------------------------------------- #
# supernode-pair count + SN adjacency maintenance
# --------------------------------------------------------------------------- #


def _sn_insert(st: EngineState, x: torch.Tensor, y: torch.Tensor,
               ok: Pred) -> EngineState:
    """Append y to SN(x)'s slot list."""
    if ok is False:
        return st
    i = at(st.sndeg, x)
    _set_both(set_job(st.snadj, x, i), y, set_job(st.snpos, x, y), i, ok)
    _add_at(st.sndeg, x, 1, ok)
    return st


def _sn_remove(st: EngineState, x: torch.Tensor, y: torch.Tensor,
               ok: Pred) -> EngineState:
    """Swap-delete y from SN(x)'s slot list."""
    if ok is False:
        return st
    last = at(st.sndeg, x) - 1
    i, w = _lookup_both(st.snpos, x, y, st.snadj, x, last)
    _set_both(set_job(st.snadj, x, i), w, set_job(st.snpos, x, w), i, ok)
    _delete_both(delete_job(st.snadj, x, last), delete_job(st.snpos, x, y),
                 ok)
    _add_at(st.sndeg, x, -1, ok)
    return st


def pair_count_add(st: EngineState, a: torch.Tensor, b: torch.Tensor,
                   delta: int, ok: Pred = True) -> EngineState:
    """E_AB += delta, maintaining the SN slot lists on 0<->nonzero edges.

    Every replica's transitions are read on the host in one sync, and the
    slot-list updates run when one happens, masked to the replicas where
    it did; JAX runs them masked on every call.
    """
    if ok is False:
        return st
    ca, cb = canon(a, b)
    _, new = ht_add(st.eab, ca, cb, delta, remove_if_zero=True, ok=ok)
    old = new - delta
    created = (old == 0) & (new != 0)
    removed = (new == 0) & (old != 0)
    if ok is not True:
        created, removed = created & ok, removed & ok
    same = ca == cb
    n = same.shape[0]
    flags = host_read(torch.cat([created, removed, same]))
    cr, rm, sm = flags[:n], flags[n:2 * n], flags[2 * n:]
    if any(cr):
        _sn_insert(st, ca, cb, pred(cr, created))
        _sn_insert(st, cb, ca, pred([c and not s for c, s in zip(cr, sm)],
                                    lambda: created & ~same))
    if any(rm):
        _sn_remove(st, ca, cb, pred(rm, removed))
        _sn_remove(st, cb, ca, pred([r and not s for r, s in zip(rm, sm)],
                                    lambda: removed & ~same))
    return st


def pair_weight_add(st: EngineState, a: torch.Tensor, b: torch.Tensor,
                    delta, ok=True) -> EngineState:
    """W_AB += delta (weighted objective only; no SN side effects)."""
    ca, cb = canon(a, b)
    ht_add(st.weab, ca, cb, delta, remove_if_zero=True, ok=ok)
    return st


# --------------------------------------------------------------------------- #
# nodes and edges
# --------------------------------------------------------------------------- #


def ensure_node(st: EngineState, u: torch.Tensor, cfg: EngineConfig,
                ok: Pred = True) -> EngineState:
    """Allocate a singleton supernode for u if unseen (masked writes)."""
    if ok is False:
        return st
    need = at(st.n2s, u) < 0
    if ok is not True:
        need = need & ok
    top = st.free_top - 1
    sid = at(st.free, top.clamp(min=0))
    _put(st.n2s, u, sid, need)
    _put(st.ssize, sid, 1, need)
    st.free_top.copy_(torch.where(need, top, st.free_top))
    if cfg.objective == "weighted":
        w = node_weight(u, cfg)
        _put(st.wsum, sid, w, need)
        _put(st.wsq, sid, w * w, need)
    return st


def _adj_append(st: EngineState, u: torch.Tensor, v: torch.Tensor,
                ok: Pred) -> EngineState:
    i = at(st.deg, u)
    _set_both(set_job(st.adj, u, i), v, set_job(st.epos, u, v), i, ok)
    _add_at(st.deg, u, 1, ok)
    return st


def _adj_remove(st: EngineState, u: torch.Tensor, v: torch.Tensor,
                ok: Pred) -> EngineState:
    last = at(st.deg, u) - 1
    i, w = _lookup_both(st.epos, u, v, st.adj, u, last)
    _set_both(set_job(st.adj, u, i), w, set_job(st.epos, u, w), i, ok)
    _delete_both(delete_job(st.adj, u, last), delete_job(st.epos, u, v), ok)
    _add_at(st.deg, u, -1, ok)
    return st


def _slots(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int32, device=device)


def neighbor_slots(st: EngineState, y: torch.Tensor, d_cap: int,
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """First min(deg, d_cap) neighbors of y, ``[R, d_cap]`` (fixed-shape
    gather)."""
    idx = _slots(d_cap, st.device)
    valid = idx < at(st.deg, y)[:, None]
    nbrs = ht_lookup_batch(st.adj, y[:, None], idx, default=-1)
    return torch.where(valid, nbrs, -1), valid


def _minh_recompute(st: EngineState, u: torch.Tensor, d_cap: int,
                    ) -> torch.Tensor:
    """minh(u) = min hash over (up to d_cap) current neighbors."""
    nbrs, valid = neighbor_slots(st, u, d_cap)
    hs = torch.where(valid, mixhash(nbrs), NO_CLUSTER)
    return hs.min(dim=-1).values


def _phi_add(st: EngineState, d: torch.Tensor, ok: Pred) -> None:
    st.phi += _masked(ok, d)


def insert_edge(st: EngineState, u: torch.Tensor, v: torch.Tensor,
                cfg: EngineConfig, ok: Pred = True) -> EngineState:
    if ok is False:
        return st
    if ok is not True:
        u, v = torch.where(ok, u, 0), torch.where(ok, v, 0)
    ensure_node(st, u, cfg, ok)
    ensure_node(st, v, cfg, ok)
    a, b = at(st.n2s, u), at(st.n2s, v)
    ca, cb = canon(a, b)
    if cfg.objective == "weighted":
        wuv = node_weight(u, cfg) * node_weight(v, cfg)
        w = ht_lookup(st.weab, ca, cb)
        tw = wt_of(st, a, b, a == b)
        _phi_add(st, cost(w + wuv, tw) - cost(w, tw), ok)
        pair_weight_add(st, a, b, wuv, ok)
    else:
        e = ht_lookup(st.eab, ca, cb)
        t = t_of(at(st.ssize, a), at(st.ssize, b), a == b)
        _phi_add(st, cost(e + 1, t) - cost(e, t), ok)
    pair_count_add(st, a, b, 1, ok)
    _adj_append(st, u, v, ok)
    _adj_append(st, v, u, ok)
    # min with INT32_MAX is the identity, so a masked call leaves minh alone
    _put(st.minh, u, torch.minimum(at(st.minh, u),
                                   _masked(ok, mixhash(v), I32_MAX)), True)
    _put(st.minh, v, torch.minimum(at(st.minh, v),
                                   _masked(ok, mixhash(u), I32_MAX)), True)
    st.num_edges += _masked(ok, 1)
    return st


def delete_edge(st: EngineState, u: torch.Tensor, v: torch.Tensor,
                cfg: EngineConfig, ok: Pred = True) -> EngineState:
    if ok is False:
        return st
    if ok is not True:
        u, v = torch.where(ok, u, 0), torch.where(ok, v, 0)
    a, b = at(st.n2s, u), at(st.n2s, v)
    ca, cb = canon(a, b)
    if cfg.objective == "weighted":
        wuv = node_weight(u, cfg) * node_weight(v, cfg)
        w = ht_lookup(st.weab, ca, cb)
        tw = wt_of(st, a, b, a == b)
        _phi_add(st, cost(w - wuv, tw) - cost(w, tw), ok)
        pair_weight_add(st, a, b, -wuv, ok)
    else:
        e = ht_lookup(st.eab, ca, cb)
        t = t_of(at(st.ssize, a), at(st.ssize, b), a == b)
        _phi_add(st, cost(e - 1, t) - cost(e, t), ok)
    pair_count_add(st, a, b, -1, ok)
    _adj_remove(st, u, v, ok)
    _adj_remove(st, v, u, ok)
    st.num_edges -= _masked(ok, 1)
    for x, other in ((u, v), (v, u)):
        upd = at(st.minh, x) == mixhash(other)
        if ok is not True:
            upd = upd & ok
        _put(st.minh, x, _minh_recompute(st, x, cfg.d_cap), upd)
    return st


# --------------------------------------------------------------------------- #
# moves
# --------------------------------------------------------------------------- #


def _first_occurrence(x: torch.Tensor) -> torch.Tensor:
    """Mask of first occurrences (dedupe) along the last axis of a small
    int tensor."""
    eq = x[..., None, :] == x[..., :, None]
    return ~torch.tril(eq, diagonal=-1).any(dim=-1)


def _sn_list(st: EngineState, x: torch.Tensor, n: torch.Tensor,
             sn_cap: int) -> torch.Tensor:
    """The first ``n`` entries of SN(x)'s slot list, -1 beyond
    (``[R, sn_cap]``)."""
    sl = _slots(sn_cap, st.device)
    nbr = ht_lookup_batch(st.snadj, x[:, None], sl, default=-1)
    return torch.where(sl < n[:, None], nbr, -1)


def _unless(fresh: Pred, x: torch.Tensor, fill=0) -> torch.Tensor:
    """``x`` where the move's target is not a fresh singleton, ``fill``
    where it is."""
    if fresh is False:
        return x
    if fresh is True:
        return torch.full_like(x, fill)
    return torch.where(fresh.reshape(fresh.shape + (1,) * (x.dim() - 1)),
                       fill, x)


def _move_lists(st: EngineState, y: torch.Tensor, a: torch.Tensor,
                target: torch.Tensor, is_fresh: Pred, cfg: EngineConfig):
    """The candidate pairs of a move: y's neighbors (slots, validity and
    sids) and the deduped supernodes X it touches, with their mask."""
    nbrs, nvalid = neighbor_slots(st, y, cfg.d_cap)
    nsid = torch.where(nvalid, at(st.n2s, nbrs.clamp(min=0)), -1)
    sn_a = _sn_list(st, a, at(st.sndeg, a), cfg.sn_cap)
    if is_fresh is True:
        sn_b = torch.full_like(sn_a, -1)
    else:
        sn_b = _unless(is_fresh, _sn_list(st, target, at(st.sndeg, target),
                                          cfg.sn_cap), -1)
    xs = torch.cat([nsid, sn_a, sn_b], dim=-1)           # [R, L]
    is_ab = (xs == a[:, None]) | (xs == target[:, None])
    ok = (xs >= 0) & _first_occurrence(xs) & ~is_ab
    return nbrs, nvalid, nsid, xs, ok


def _pair_values(table, a: torch.Tensor, target: torch.Tensor,
                 xs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Values of the (A,X) and (B,X) pairs of every X, one probe of
    ``2 * L`` lanes a replica."""
    a, target = a[:, None], target[:, None]
    lo = torch.cat([torch.minimum(a, xs), torch.minimum(target, xs)], -1)
    hi = torch.cat([torch.maximum(a, xs), torch.maximum(target, xs)], -1)
    v = ht_lookup_batch(table, lo, hi)
    n = xs.shape[-1]
    return v[:, :n], v[:, n:]


def _special_pairs(table, a: torch.Tensor, target: torch.Tensor,
                   is_fresh: Pred):
    """Values of the (A,A), (B,B) and (A,B) pairs, one 3-lane probe a
    replica; the last two are 0 for a fresh B."""
    pa, pb = canon(a, target)
    v = ht_lookup_batch(table, torch.stack([a, target, pa], -1),
                        torch.stack([a, target, pb], -1))
    return v[:, 0], _unless(is_fresh, v[:, 1]), _unless(is_fresh, v[:, 2])


def _col(x: torch.Tensor) -> torch.Tensor:
    return x[:, None]


def delta_phi_move(st: EngineState, y: torch.Tensor, target: torch.Tensor,
                   is_fresh: Pred, cfg: EngineConfig,
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dphi, nbrs, nvalid): closed-form phi change of moving y -> target.

    ``is_fresh`` (host-decided, or a per-replica mask) marks an escape to
    a brand-new singleton.  Caller guarantees deg(y) <= d_cap and sndeg <=
    sn_cap where the result is used.
    """
    a = at(st.n2s, y)
    sa = at(st.ssize, a)
    sb = _unless(is_fresh, at(st.ssize, target))
    nbrs, nvalid, nsid, xs, ok = _move_lists(st, y, a, target, is_fresh, cfg)

    # h[X] = |N(y) ∩ X|
    h = (xs[..., :, None] == nsid[..., None, :]).sum(dim=-1).to(torch.int32)
    sx = at(st.ssize, xs.clamp(min=0))
    e_ax, e_bx = _pair_values(st.eab, a, target, xs)
    d_gen = (cost(e_ax - h, _col(sa - 1) * sx) - cost(e_ax, _col(sa) * sx)
             + cost(e_bx + h, _col(sb + 1) * sx) - cost(e_bx, _col(sb) * sx))
    d = torch.where(ok, d_gen, 0).sum(dim=-1).to(torch.int32)

    # special pairs (A,A), (B,B), (A,B)
    h_a = (nsid == _col(a)).sum(dim=-1).to(torch.int32)
    h_b = (nsid == _col(target)).sum(dim=-1).to(torch.int32)
    e_aa, e_bb, e_ab = _special_pairs(st.eab, a, target, is_fresh)
    d = d + cost(e_aa - h_a, tri(sa - 1)) - cost(e_aa, tri(sa))
    d = d + cost(e_bb + h_b, tri(sb + 1)) - cost(e_bb, tri(sb))
    d = d + (cost(e_ab - h_b + h_a, (sa - 1) * (sb + 1)) - cost(e_ab, sa * sb))
    return d, nbrs, nvalid


def delta_phi_move_weighted(st: EngineState, y: torch.Tensor,
                            target: torch.Tensor, is_fresh: Pred,
                            cfg: EngineConfig,
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """Weighted-objective :func:`delta_phi_move`: (E, T, sizes) replaced
    by (W, TW, weight sums)."""
    a = at(st.n2s, y)
    wy = node_weight(y, cfg)
    swa, sqa = at(st.wsum, a), at(st.wsq, a)
    swb = _unless(is_fresh, at(st.wsum, target))
    sqb = _unless(is_fresh, at(st.wsq, target))
    nbrs, nvalid, nsid, xs, ok = _move_lists(st, y, a, target, is_fresh, cfg)
    nw = torch.where(nvalid, node_weight(nbrs.clamp(min=0), cfg), 0)

    # hw[X] = w(y) * sum of w(nbr) over N(y) ∩ X  (weighted h[X])
    hw = _col(wy) * torch.where(xs[..., :, None] == nsid[..., None, :],
                                nw[..., None, :], 0).sum(dim=-1).to(
                                    torch.int32)
    swx = at(st.wsum, xs.clamp(min=0))
    w_ax, w_bx = _pair_values(st.weab, a, target, xs)
    d_gen = (cost(w_ax - hw, _col(swa - wy) * swx) - cost(w_ax, _col(swa) * swx)
             + cost(w_bx + hw, _col(swb + wy) * swx)
             - cost(w_bx, _col(swb) * swx))
    d = torch.where(ok, d_gen, 0).sum(dim=-1).to(torch.int32)

    # special pairs (A,A), (B,B), (A,B)
    hw_a = wy * torch.where(nsid == _col(a), nw, 0).sum(dim=-1).to(
        torch.int32)
    hw_b = wy * torch.where(nsid == _col(target), nw, 0).sum(dim=-1).to(
        torch.int32)
    w_aa, w_bb, w_ab = _special_pairs(st.weab, a, target, is_fresh)
    d = d + (cost(w_aa - hw_a, wtri(swa - wy, sqa - wy * wy))
             - cost(w_aa, wtri(swa, sqa)))
    d = d + (cost(w_bb + hw_b, wtri(swb + wy, sqb + wy * wy))
             - cost(w_bb, wtri(swb, sqb)))
    d = d + (cost(w_ab - hw_b + hw_a, (swa - wy) * (swb + wy))
             - cost(w_ab, swa * swb))
    return d, nbrs, nvalid


def apply_move(st: EngineState, y: torch.Tensor, target: torch.Tensor,
               dphi: torch.Tensor, nbrs: torch.Tensor, nvalid: torch.Tensor,
               cfg: EngineConfig, ok: Pred = True) -> EngineState:
    """Commit the move (target sid already allocated by the caller) in
    the replicas where ``ok`` holds.

    ``nvalid`` is a prefix mask (slot < deg): every replica's trip count
    is read in one sync, and neighbor slot ``i`` runs for the replicas
    with more than ``i`` neighbors, as many times as the largest count.
    """
    if ok is False:
        return st
    a = at(st.n2s, y)
    weighted = cfg.objective == "weighted"
    wy = node_weight(y, cfg)
    n_upd = _masked(ok, nvalid.sum(dim=-1))
    counts = host_read(n_upd)
    for i in range(max(counts)):
        w_ok = pred([i < n for n in counts], lambda: i < n_upd)
        w = nbrs[:, i]
        sw = at(st.n2s, w)
        pair_count_add(st, a, sw, -1, w_ok)
        pair_count_add(st, target, sw, 1, w_ok)
        if weighted:
            wyv = wy * node_weight(w, cfg)
            pair_weight_add(st, a, sw, -wyv, w_ok)
            pair_weight_add(st, target, sw, wyv, w_ok)
    _add_at(st.ssize, a, -1, ok)
    _add_at(st.ssize, target, 1, ok)
    _put(st.n2s, y, target, ok)
    _phi_add(st, dphi, ok)
    if weighted:
        _add_at(st.wsum, a, -wy, ok)
        _add_at(st.wsum, target, wy, ok)
        _add_at(st.wsq, a, -wy * wy, ok)
        _add_at(st.wsq, target, wy * wy, ok)

    # a emptied -> push it back on the free stack (masked write otherwise)
    push = at(st.ssize, a) == 0
    if ok is not True:
        push = push & ok
    slot = st.free_top.clamp(max=st.free.shape[-1] - 1)
    _put(st.free, slot, a, push)
    st.free_top += push.to(torch.int32)
    return st


def alloc_sid(st: EngineState, ok: Pred = True,
              ) -> Tuple[EngineState, torch.Tensor]:
    sid = at(st.free, (st.free_top - 1).clamp(min=0))
    if ok is not False:
        st.free_top -= _masked(ok, 1)
    return st, sid


# --------------------------------------------------------------------------- #
# audits (host/test use)
# --------------------------------------------------------------------------- #


def recompute_phi(st: EngineState,
                  cfg: EngineConfig | None = None) -> torch.Tensor:
    """Fold the optimal-encoding cost over all live pair entries (int32;
    one per replica for a stacked state)."""
    if cfg is not None and cfg.objective == "weighted":
        tab = st.weab
        a, b = tab.k1.clamp(min=0), tab.k2.clamp(min=0)
        t = wt_of(st, a, b, a == b)
    else:
        tab = st.eab
        a, b = tab.k1.clamp(min=0), tab.k2.clamp(min=0)
        t = t_of(at(st.ssize, a), at(st.ssize, b), a == b)
    return torch.where(tab.k1 >= 0, cost(tab.val, t), 0).sum(
        dim=-1).to(torch.int32)
