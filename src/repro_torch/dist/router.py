"""Stream router and node interning of the sharded tier, in torch.

Port of ``repro/dist/router.py`` for one device (``n_dev = 1``): the
``n_shards`` engine replicas of a :class:`~repro_torch.core.engine.api.
ShardedSummarizer` all live on one card, as in the JAX package's
``n_shards > n_devices`` layout, and the ``all_to_all`` of the route
stage is the identity.  Placement, interning, the drain loop and the
engine-round schedule are the JAX package's, so the replica states are
leaf-bitwise equal to its ``ShardedSummarizer``'s.

**Stage 1, route** (:func:`make_route_step`, no state): shard keys
``min(h(u), h(v)) % n_shards`` over the two 31-bit label-hash words, the
stable per-shard rank, the capacity bound of ``lane_cap`` changes per
shard and round, and the drain loop: each round routes the pending stream
prefix up to the first overflowing *position* and appends its changes at
each shard's bucket watermark, so the buckets hold each shard's changes in
stream order.  Eager torch runs the loop on the host: a round that can
overflow reads its ``first`` position back (:func:`~repro_torch.core.
engine.ops.host_read`); with ``lane_cap`` equal to the chunk
(``static_no_overflow``) the one round reads nothing.

**Stage 2, engine** (:func:`make_engine_step`): every replica interns its
whole bucket first (:func:`intern_buckets`: first come, first served in
delivery order, ``u`` before ``v``), then all replicas run ``max_s
ceil(count_s / batch)`` engine rounds, padding-only rounds included, so
that every replica's PRNG cursor advances in lockstep.  The route stage's
extra drain rounds are folded into the carried telemetry
(``telem += rounds - 1``).

**Replica layout.**  The replicas are one stacked
:class:`~repro_torch.core.engine.state.EngineState` and one stacked
:class:`InternState`, every leaf with a leading ``[R, ...]`` axis: the
JAX package's layout, which :func:`sharded_state_from_numpy` /
:func:`sharded_state_to_numpy` load and save without a copy per row.
``replica_exec`` picks how the engine rounds step it, as in the JAX
package, and both modes are leaf-bitwise equal:

* ``"vmap"`` steps the stacked state once per round
  (:func:`~repro_torch.core.engine.trial.step_fn` over ``[R, B]``
  changes): each probe is one launch of R jobs and each branch point of
  the step one host read for all R replicas.  The default on a CUDA
  device, as JAX's on an accelerator backend.
* ``"map"`` steps each replica's row in turn (R = 1 views): the
  reference that ``"vmap"`` is held to, and the default on the CPU, as
  JAX's on its CPU backend, so that the port and the JAX package run the
  same layout there by default.  It is not the faster layout on the CPU:
  ``"vmap"`` takes fewer host reads there too.

Interning works on the rows of the stacked intern state, which the
router writes in place.

**Interning.**  One probe launch resolves the ``2 R`` pre-lookups of a
chunk (u and v of every replica, prehashed, against the tables at chunk
entry), and one host read brings back the buckets, the pre-lookups and
the counters.  The host then walks the endpoints that were not found, in
order: the first occurrence of a key takes the next id and is inserted
(one insert-mode probe launch and the writes, no sync), a repeat within
the call gets the id just given.  The insert order is the table layout,
so ``h2l`` matches JAX's slot for slot.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.engine.hashtable import (M32, HashTable, ht_new,
                                               ht_set, probe_many, u32)
from repro_torch.core.engine.ops import host_read
from repro_torch.core.engine.state import (EngineConfig, EngineState,
                                           _table_words, copy_state,
                                           state_from_numpy, state_rows,
                                           state_to_numpy)
from repro_torch.core.engine.trial import step_fn

INVALID = -1

# the shard key is (h_hi * 2**31 + h_lo) % n_shards composed from
# residues; (n-1)**2 + (n-1) must stay below 2**31, as in the JAX package
MAX_SHARDS = 1 << 15

# the JAX package's replica layouts (see the module docstring)
REPLICA_EXEC_MODES = ("vmap", "map")


def default_replica_exec(device) -> str:
    """``"vmap"`` on a CUDA device and ``"map"`` on the CPU, as the JAX
    package picks by backend (the module docstring)."""
    return "vmap" if torch.device(device).type == "cuda" else "map"


def check_replica_exec(replica_exec: Optional[str], device="cpu") -> str:
    """The replica layout to use on ``device``: ``replica_exec``, or the
    device's default when it is None."""
    if replica_exec is None:
        replica_exec = default_replica_exec(device)
    if replica_exec not in REPLICA_EXEC_MODES:
        raise ValueError(f"replica_exec must be one of "
                         f"{REPLICA_EXEC_MODES}: {replica_exec}")
    return replica_exec


# --------------------------------------------------------------------------- #
# (h_hi, h_lo) -> local-nid interning
# --------------------------------------------------------------------------- #


@dataclasses.dataclass
class InternState:
    """One shard's node intern table: 62-bit label hashes, as two
    non-negative ``int32`` words, to the shard's dense local ids
    ``[0, n_cap)``, assigned first come, first served in delivery order."""

    h2l: HashTable          # (h_hi, h_lo) -> local nid, probed prehashed
    l2h: torch.Tensor       # int32[n_cap, 2]: local nid -> (h_hi, h_lo)
    n_nodes: torch.Tensor   # int32: next fresh nid == number interned
    n_dropped: torch.Tensor  # int32: endpoint interns dropped at capacity


def intern_cap(cfg: EngineConfig) -> int:
    """Intern-table slots: the next power of two >= 4 n_cap (~25% load)."""
    cap = 1
    while cap < 4 * cfg.n_cap:
        cap <<= 1
    return cap


def intern_new(cfg: EngineConfig, device) -> InternState:
    i32 = dict(dtype=torch.int32, device=device)
    return InternState(h2l=ht_new(intern_cap(cfg), device),
                       l2h=torch.full((cfg.n_cap, 2), -1, **i32),
                       n_nodes=torch.tensor(0, **i32),
                       n_dropped=torch.tensor(0, **i32))


def drain_telemetry_new(n_dev: int, device) -> torch.Tensor:
    """Fresh drain-round telemetry carry (``int32[n_dev]``)."""
    return torch.zeros((n_dev,), dtype=torch.int32, device=device)


def drain_telemetry_restore(saved, n_dev: int, device) -> torch.Tensor:
    """A saved (device-uniform) drain-round vector re-broadcast onto
    ``n_dev`` devices."""
    count = int(np.max(np.asarray(saved))) if np.size(saved) else 0
    return torch.full((n_dev,), count, dtype=torch.int32, device=device)


def _insert(ist: InternState, hi: torch.Tensor, lo: torch.Tensor,
            nid: int) -> None:
    """Intern one absent key (one-lane device tensors) as ``nid``, which
    must equal ``ist.n_nodes``: the upsert probe, the writes and the
    counter, all queued on the device with no sync."""
    ht_set(ist.h2l, hi, lo, ist.n_nodes.reshape(1), prehashed=True)
    ist.l2h[nid, 0:1] = hi
    ist.l2h[nid, 1:2] = lo
    ist.n_nodes += 1


def intern_buckets(ists: Sequence[InternState], buckets: torch.Tensor,
                   n_cap: int,
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Intern replica ``r``'s change sequence ``buckets[r]`` (``int32[R, L,
    5]`` rows ``(uh, ul, vh, vl, ins)``, ``-1`` padded) into ``ists[r]``.

    Returns ``(u, v, host)``: the local ids ``int32[R, L]`` (``-1`` for
    padding and for a change with a dropped endpoint, whose ``u`` stays
    interned) and the buckets as read back to the host.  ``n_dropped``
    counts every dropped endpoint intern, repeats included.  Bitwise the
    JAX package's ``intern_changes`` of each row; one probe launch for
    the ``2 R`` pre-lookups, one host read, and one insert probe per new
    key.
    """
    uh, ul, vh, vl, _ = buckets.unbind(-1)
    valid = (uh >= 0) & (vh >= 0)
    # invalid lanes probe key (0, 0), as in JAX
    h1u, h2u, h1v, h2v = (torch.where(valid, w, 0) for w in (uh, ul, vh, vl))
    jobs = []
    for r, ist in enumerate(ists):
        jobs.append((ist.h2l, h1u[r], h2u[r], True, "find"))
        jobs.append((ist.h2l, h1v[r], h2v[r], True, "find"))
    probed = probe_many(jobs)
    n_rep, n_lanes = uh.shape
    flat = np.asarray(host_read(torch.cat(
        [buckets.reshape(-1)]
        + [p[1].to(torch.int32) for p in probed] + [p[2] for p in probed]
        + [torch.stack([i.n_nodes, i.n_dropped]) for i in ists])), np.int32)
    n_b, n_f = buckets.numel(), 2 * n_rep * n_lanes
    host = flat[:n_b].reshape(buckets.shape)
    found = flat[n_b:n_b + n_f].reshape(2 * n_rep, n_lanes)
    val = flat[n_b + n_f:n_b + 2 * n_f].reshape(2 * n_rep, n_lanes)
    counts = flat[n_b + 2 * n_f:].reshape(n_rep, 2)

    u_out = np.full((n_rep, n_lanes), INVALID, np.int32)
    v_out = np.full((n_rep, n_lanes), INVALID, np.int32)
    for r, ist in enumerate(ists):
        n_nodes, n_dropped = (int(x) for x in counts[r])
        fresh: Dict[Tuple[int, int], int] = {}   # keys inserted by this call
        words = (h1u[r], h2u[r], h1v[r], h2v[r])
        for i in np.flatnonzero((host[r, :, 0] >= 0) & (host[r, :, 2] >= 0)):
            nids = []
            for side in (0, 1):
                j = 2 * r + side
                if found[j, i]:
                    nids.append(int(val[j, i]))
                    continue
                key = tuple(int(w) for w in host[r, i, 2 * side:2 * side + 2])
                nid = fresh.get(key)
                if nid is None:
                    if n_nodes < n_cap:
                        nid = fresh[key] = n_nodes
                        _insert(ist, words[2 * side][i:i + 1],
                                words[2 * side + 1][i:i + 1], nid)
                        n_nodes += 1
                    else:
                        n_dropped += 1
                        nid = INVALID
                nids.append(nid)
            if nids[0] >= 0 and nids[1] >= 0:
                u_out[r, i], v_out[r, i] = nids
        if n_dropped != counts[r, 1]:
            ist.n_dropped += n_dropped - int(counts[r, 1])
    return u_out, v_out, host


def intern_changes(ist: InternState, uh, ul, vh, vl, n_cap: int,
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Intern one hashed change sequence in order (``int32[L]`` device
    tensors): ``(u_nid, v_nid)`` on the host, in place on ``ist``."""
    buckets = torch.stack([uh, ul, vh, vl, torch.zeros_like(uh)], -1)
    u, v, _ = intern_buckets([ist], buckets[None], n_cap)
    return u[0], v[0]


# --------------------------------------------------------------------------- #
# shard keys from hash words
# --------------------------------------------------------------------------- #


def shard_key(uh: torch.Tensor, ul: torch.Tensor, vh: torch.Tensor,
              vl: torch.Tensor, n_shards: int) -> torch.Tensor:
    """Canonical-pair shard key ``min(h(u), h(v)) % n_shards`` (int32).

    The min is lexicographic over the two words and the modulus composes
    over uint32 residues, ``((hi % n) * (2^31 % n) + lo % n) % n``, held
    in int64 (the CPU build has no uint32 arithmetic)."""
    u_le = (uh < vh) | ((uh == vh) & (ul <= vl))
    mh = u32(torch.where(u_le, uh, vh))
    ml = u32(torch.where(u_le, ul, vl))
    two31 = (1 << 31) % n_shards
    return (((mh % n_shards) * two31 + ml % n_shards)
            % n_shards).to(torch.int32)


# --------------------------------------------------------------------------- #
# host-routed (bucketed) step: the differential reference and overflow path
# --------------------------------------------------------------------------- #


def _step_rounds(est: EngineState, u: np.ndarray, v: np.ndarray,
                 ins: np.ndarray, rounds: int, cfg: EngineConfig,
                 replica_exec: str) -> None:
    """``rounds`` engine steps of every replica of the stacked ``est``,
    round-major; ``u``/``v``/``ins`` are ``[R, >= rounds * batch]`` host
    arrays.  ``"vmap"`` steps the stacked state once a round, ``"map"``
    each replica's row in turn."""
    b = cfg.batch
    rows = state_rows(est) if replica_exec == "map" else None
    for r in range(rounds):
        sl = slice(r * b, (r + 1) * b)
        if rows is None:
            step_fn(est, u[:, sl], v[:, sl], ins[:, sl] != 0, cfg)
            continue
        for s, row in enumerate(rows):
            step_fn(row, u[s, sl], v[s, sl], ins[s, sl] != 0, cfg)


def make_bucketed_step(cfg: EngineConfig, replica_exec: str):
    """The step over host-bucketed ``[n_shards, batch]`` hash-word rounds:
    ``(est, ists, uh, ul, vh, vl, ins)`` with the stacked engine state,
    the intern rows and numpy arrays, states updated in place.  Each
    replica interns its round, then steps once."""

    def bucketed(est, ists, uh, ul, vh, vl, ins) -> None:
        host = np.stack([uh, ul, vh, vl, ins], -1).astype(np.int32)
        buckets = torch.from_numpy(host).to(est.device)
        u, v, _ = intern_buckets(ists, buckets, cfg.n_cap)
        _step_rounds(est, u, v, np.asarray(ins), 1, cfg, replica_exec)

    return bucketed


# --------------------------------------------------------------------------- #
# stage 1: route — shard keys + drain rounds (state-independent)
# --------------------------------------------------------------------------- #


class RouterGeometry(NamedTuple):
    """Resolved static geometry of the router (the JAX package's fields).

    ``static_no_overflow``: ``lane_cap == n_in``, one round always
    delivers the chunk.  ``drain_guaranteed``: ``max_drain_rounds`` rounds
    always deliver it (``full_drain_rounds = ceil(chunk / lane_cap)``), so
    the caller never reads the watermark."""

    n_dev: int                 # devices
    n_loc: int                 # shard replicas per device
    n_in: int                  # stream positions per source device
    lane_cap: int              # slots per (source, shard) lane per round
    max_drain_rounds: int      # bound on exchange rounds
    full_drain_rounds: int     # rounds that provably deliver a full chunk
    acc_cap: int               # per-shard receive-bucket capacity
    static_no_overflow: bool   # lane_cap == n_in: one round, no watermark
    drain_guaranteed: bool     # max_drain_rounds >= full_drain_rounds


def router_geometry(n_dev: int, n_shards: int, chunk: int, lane_cap: int,
                    max_drain_rounds: Optional[int] = None) -> RouterGeometry:
    """Resolve the router's knobs for ``n_dev`` devices and a chunk."""
    if chunk % n_dev != 0:
        raise ValueError(f"chunk={chunk} must be divisible by n_dev={n_dev}")
    if n_shards % n_dev != 0:
        raise ValueError(
            f"n_shards={n_shards} must be a multiple of n_dev={n_dev}")
    if n_shards >= MAX_SHARDS:
        raise ValueError(
            f"n_shards={n_shards} must be < {MAX_SHARDS} (the shard key "
            f"composes 31-bit hash words over uint32 residues)")
    n_loc = n_shards // n_dev
    n_in = chunk // n_dev
    lane_cap = min(int(lane_cap), n_in)
    if lane_cap < 1:
        raise ValueError(f"lane_cap must be >= 1, got {lane_cap}")
    static_no_overflow = lane_cap == n_in
    # each non-final drain round delivers >= lane_cap changes
    full_drain = 1 if static_no_overflow else -(-chunk // lane_cap)
    if max_drain_rounds is None:
        max_drain_rounds = full_drain
    max_drain_rounds = max(1, min(int(max_drain_rounds), full_drain))
    acc_cap = min(chunk, max_drain_rounds * n_dev * lane_cap)
    return RouterGeometry(
        n_dev=n_dev, n_loc=n_loc, n_in=n_in, lane_cap=lane_cap,
        max_drain_rounds=max_drain_rounds, full_drain_rounds=full_drain,
        acc_cap=acc_cap, static_no_overflow=static_no_overflow,
        drain_guaranteed=max_drain_rounds >= full_drain)


def make_route_step(n_shards: int, chunk: int, lane_cap: int,
                    max_drain_rounds: Optional[int] = None):
    """The state-independent routing stage on one device.

    Returns ``(route, geometry)``; ``route(uh, ul, vh, vl, ins)`` takes
    flat ``int32[chunk]`` hash-word change tensors (``-1`` padded) and
    returns ``(buckets, counts, delivered, rounds)``: ``buckets`` is
    ``int32[n_shards, acc_cap, 5]``, each shard's ``(uh, ul, vh, vl, ins)``
    rows in stream order, ``-1`` padded (the JAX package returns the five
    columns as separate arrays); ``counts`` is ``int32[n_shards]``;
    ``delivered`` is the first stream position not routed when
    ``max_drain_rounds`` ran out (``chunk`` when all was delivered) and
    ``rounds`` the number of rounds run, both host ints.
    """
    geom = router_geometry(1, n_shards, chunk, lane_cap, max_drain_rounds)
    lane_cap, acc_cap = geom.lane_cap, geom.acc_cap

    def route(uh, ul, vh, vl, ins):
        dev = uh.device
        i64 = dict(dtype=torch.int64, device=dev)
        valid = (uh >= 0) & (vh >= 0)
        dest = torch.where(valid, shard_key(uh, ul, vh, vl, n_shards),
                           n_shards).to(torch.int64)
        pos = torch.arange(chunk, **i64)
        payload = torch.stack([uh, ul, vh, vl, ins.to(torch.int32)], -1)
        sid = torch.arange(n_shards, **i64)
        rows = sid[:, None]
        # one spare lane row and bucket column take the dropped writes
        # (JAX's scatter mode="drop")
        acc = torch.full((n_shards, acc_cap + 1, 5), -1, dtype=torch.int32,
                         device=dev)
        counts = torch.zeros(n_shards, **i64)
        delivered = rounds = 0
        while delivered < chunk and rounds < geom.max_drain_rounds:
            pending = valid & (pos >= delivered)
            # stable rank of each pending change within its shard's lane
            onehot = (dest[:, None] == sid) & pending[:, None]
            cum = onehot.to(torch.int64).cumsum(0)
            lane = dest.clamp(0, n_shards - 1)[:, None]
            rank = cum.gather(1, lane)[:, 0] - 1
            if geom.static_no_overflow:
                first = chunk
            else:
                over = pending & (rank >= lane_cap)
                first = host_read(torch.where(over, pos, chunk).min()
                                  .reshape(1))[0]
            keep = pending & (rank < lane_cap) & (pos < first)
            # the lanes [n_shards, lane_cap]; with one device the
            # all_to_all hands every lane to this device unchanged
            send = torch.full((n_shards + 1, lane_cap, 5), -1,
                              dtype=torch.int32, device=dev)
            send[torch.where(keep, dest, n_shards),
                 torch.where(keep, rank, 0)] = payload
            recv = send[:n_shards]
            # stable compaction, appended at each shard's watermark
            rvalid = recv[..., 0] >= 0
            cpos = rvalid.to(torch.int64).cumsum(1) - 1
            acc[rows, torch.where(rvalid, counts[:, None] + cpos,
                                  acc_cap)] = recv
            counts += rvalid.sum(1)
            delivered, rounds = first, rounds + 1
        return (acc[:, :acc_cap].contiguous(), counts.to(torch.int32),
                delivered, rounds)

    return route, geom


# --------------------------------------------------------------------------- #
# stage 2: engine — intern the routed buckets, run lockstep engine rounds
# --------------------------------------------------------------------------- #


def make_engine_step(cfg: EngineConfig, n_shards: int, acc_cap: int,
                     replica_exec: str):
    """The state-carrying engine stage for routed buckets:
    ``(est, ists, telem, buckets, rounds)`` with the stacked engine state
    and the intern rows, in place.  Interns each shard's
    ``int32[n_shards, acc_cap, 5]`` bucket, then runs ``max_s
    ceil(count_s / batch)`` engine rounds on every replica, and adds the
    route stage's extra drain rounds to ``telem``."""
    b = cfg.batch

    def engine(est, ists, telem, buckets, rounds: int) -> None:
        if tuple(buckets.shape) != (n_shards, acc_cap, 5):
            raise ValueError(f"buckets must be [{n_shards}, {acc_cap}, 5]: "
                             f"{tuple(buckets.shape)}")
        u, v, host = intern_buckets(ists, buckets, cfg.n_cap)
        counts = (host[..., 0] >= 0).sum(1)
        erounds = int((-(-counts // b)).max())
        # one spare round of padding, so a round's slice never runs short
        pad = np.full((n_shards, b), INVALID, np.int32)
        _step_rounds(est, np.concatenate([u, pad], 1),
                     np.concatenate([v, pad], 1),
                     np.concatenate([host[..., 4], np.zeros_like(pad)], 1),
                     erounds, cfg, replica_exec)
        telem += rounds - 1

    return engine


def default_lane_cap(chunk: int, n_dev: int, n_shards: int,
                     batch: int) -> int:
    """4x headroom over the balanced lane, floored at one engine batch and
    capped at the source slice."""
    balanced = -(-chunk // (n_dev * n_shards))
    return min(max(batch, 4 * balanced), chunk // n_dev)


# --------------------------------------------------------------------------- #
# the JAX package's stacked layout
# --------------------------------------------------------------------------- #


def sharded_state_from_numpy(est: Mapping[str, object],
                             ist: Mapping[str, object], device,
                             ) -> Tuple[EngineState, InternState]:
    """The stacked replicas of a JAX ``ShardedSummarizer``: ``est`` and
    ``ist`` map the ``EngineState`` / ``InternState`` field names to numpy
    ``[R, ...]`` leaves (a table leaf as a mapping or an object with
    ``k1``/``k2``/``val``).  One copy a leaf, none a row."""
    def t(x):
        return torch.from_numpy(np.array(x, np.int32)).to(device)
    return state_from_numpy(est, device), InternState(
        h2l=HashTable(*(t(w) for w in _table_words(ist["h2l"]))),
        l2h=t(ist["l2h"]), n_nodes=t(ist["n_nodes"]),
        n_dropped=t(ist["n_dropped"]))


def sharded_state_to_numpy(est: EngineState, ist: InternState,
                           ) -> Tuple[Dict[str, object], Dict[str, object]]:
    """Stacked numpy leaves with the JAX package's types (int32, ``step_no``
    uint32, tables as ``k1``/``k2``/``val`` dicts), copies on the host:
    the inverse of :func:`sharded_state_from_numpy`."""
    return (state_to_numpy(copy_state(est, "cpu")),
            state_to_numpy(copy_state(ist, "cpu")))


def shard_step_no(seed: int, shard: int) -> int:
    """Replica ``shard``'s initial PRNG cursor, ``seed + shard * 2654435761
    (mod 2^32)``: decorrelated trial streams."""
    return (u32(seed) + shard * 2654435761) & M32
