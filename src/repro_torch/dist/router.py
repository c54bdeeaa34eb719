"""Stream router and node interning of the sharded tier, in torch.

Port of ``repro/dist/router.py``: the ``n_shards`` engine replicas of a
:class:`~repro_torch.core.engine.api.ShardedSummarizer` lie on the
``n_dev`` positions of a 1-D mesh (:class:`~repro_torch.launch.mesh.
EngineMesh`), ``n_loc = n_shards // n_dev`` of them stacked on each
position's device; shard ``s`` lives at position ``s // n_loc``, row ``s
% n_loc``, as in the JAX package's ``shard_map`` layout.  Placement,
interning, the drain loop and the engine-round schedule are the JAX
package's, so the replica states are leaf-bitwise equal to its
``ShardedSummarizer``'s at any number of positions.

**Positions.**  A position is what a device is in the JAX package's
mesh.  One host process drives every position, as one host drives JAX's
``shard_map``; a device may stand at several positions (``["cuda:0"] *
4`` on one card, ``["cpu"] * 8`` in the CPU tests: the counterpart of
JAX's ``--xla_force_host_platform_device_count``).  The engine stage
steps the positions in turn (:func:`for_positions`), each under its
device; the positions share no state, so the bits do not depend on the
order.  JAX's devices run at once; the port's step is bound by its host
reads, so four cards stepped in turn take longer than one card holding
all four positions (``PERF.md``).

**Stage 1, route** (:func:`make_route_step`, no state): position ``d``
holds stream positions ``[d n_in, (d+1) n_in)`` of the chunk.  Shard keys
``min(h(u), h(v)) % n_shards`` over the two 31-bit label-hash words, the
stable rank of each change within its (source position, destination
shard) lane, the capacity bound of ``lane_cap`` changes per lane and
round, and the drain loop: each round routes the pending stream prefix up
to the first overflowing *position* of any source (JAX's ``pmin``: one
host read of every position's first, on the host's clock), scatters it
into ``[n_dev, n_loc, lane_cap]`` lanes, and **exchanges** them: source
``d``'s lanes for position ``j`` are copied to ``j``'s device (a peer
copy between distinct cards, none where the device repeats), where ``j``
flattens them source-major, which is stream order, and appends them at
each shard's bucket watermark.  With ``lane_cap`` equal to ``n_in``
(``static_no_overflow``) the one round reads nothing.

**Stage 2, engine** (:func:`make_engine_step`): every replica interns its
whole bucket first (:func:`intern_buckets`: first come, first served in
delivery order, ``u`` before ``v``), then all replicas run ``max_s
ceil(count_s / batch)`` engine rounds (JAX's ``pmax``, from the buckets
the interning read), padding-only rounds included, so that every
replica's PRNG cursor advances in lockstep.  The route stage's extra drain
rounds are added to the carried telemetry (``int32[n_dev]``, one entry a
position: ``telem += rounds - 1``).

**Replica layout.**  Each position's replicas are one stacked
:class:`~repro_torch.core.engine.state.EngineState` and one stacked
:class:`InternState`, every leaf with a leading ``[n_loc, ...]`` axis:
the JAX package's layout, which :func:`sharded_state_from_numpy` /
:func:`sharded_blocks_from_numpy` / :func:`sharded_state_to_numpy` load
and save in shard order.  ``replica_exec`` picks how the engine rounds
step a position's stack, as in the JAX package, and both modes are
leaf-bitwise equal:

* ``"vmap"`` steps the stacked state once per round
  (:func:`~repro_torch.core.engine.trial.step_fn` over ``[n_loc, B]``
  changes): each probe is one launch of ``n_loc`` jobs and each branch
  point of the step one host read for the position's replicas.  The
  default on a CUDA device, as JAX's on an accelerator backend.
* ``"map"`` steps each replica's row in turn (R = 1 views): the
  reference that ``"vmap"`` is held to, and the default on the CPU, as
  JAX's on its CPU backend, so that the port and the JAX package run the
  same layout there by default.  It is not the faster layout on the CPU:
  ``"vmap"`` takes fewer host reads there too.

Interning works on the rows of the stacked intern state, which the
router writes in place.

**Interning.**  One probe launch a position resolves the ``2 n_loc``
pre-lookups of a chunk (u and v of every replica, prehashed, against the
tables at chunk entry), and one host read brings back the buckets, the
pre-lookups and the counters.  The host then walks the endpoints that
were not found, in order: the first occurrence of a key takes the next id
and is inserted (one insert-mode probe launch and the writes, no sync), a
repeat within the call gets the id just given.  The insert order is the
table layout, so ``h2l`` matches JAX's slot for slot.
"""
from __future__ import annotations

import dataclasses
from typing import (Callable, Dict, List, Mapping, NamedTuple, Optional,
                    Sequence, Tuple)

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
from repro_torch.device import at_position

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


def for_positions(fn: Callable[[int], object],
                  devices: Sequence[torch.device]) -> List[object]:
    """``[fn(d) for d in range(n_dev)]``, in turn, each call under
    position ``d`` (its device current, the counters counting under
    ``d``: :func:`repro_torch.device.at_position`)."""
    out = []
    for d, dev in enumerate(devices):
        with at_position(d, dev):
            out.append(fn(d))
    return out


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
    """Fresh drain-round telemetry carry (``int32[n_dev]``, one entry a
    position, held on ``device``)."""
    return torch.zeros((n_dev,), dtype=torch.int32, device=device)


def drain_telemetry_restore(saved, n_dev: int, device) -> torch.Tensor:
    """A saved (position-uniform) drain-round vector, saved at any number
    of positions, re-broadcast onto ``n_dev`` positions."""
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
    ``(ests, ists, uh, ul, vh, vl, ins)`` with each
    position's stacked engine state (``ests[d]``, ``n_loc`` rows), its
    intern rows (``ists[d]``) and numpy arrays, states updated in place.
    Each position copies its shards' rows to its device, interns its round
    and steps once (:func:`for_positions`)."""

    def bucketed(ests, ists, uh, ul, vh, vl, ins) -> None:
        host = np.stack([uh, ul, vh, vl, ins], -1).astype(np.int32)
        ins = np.asarray(ins)
        n_loc = len(ists[0])

        def position(d: int) -> None:
            rows = slice(d * n_loc, (d + 1) * n_loc)
            buckets = torch.from_numpy(host[rows]).to(ests[d].device)
            u, v, _ = intern_buckets(ists[d], buckets, cfg.n_cap)
            _step_rounds(ests[d], u, v, ins[rows], 1, cfg, replica_exec)

        for_positions(position, [e.device for e in ests])

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


def make_route_step(n_dev: int, n_shards: int, chunk: int, lane_cap: int,
                    max_drain_rounds: Optional[int] = None):
    """The state-independent routing stage over ``n_dev`` positions.

    Returns ``(route, geometry)``.  ``route(words)`` takes one
    ``int32[5, n_in]`` tensor a position, on its device: the rows
    ``(uh, ul, vh, vl, ins)`` of its slice of the ``-1``-padded chunk.  It
    returns ``(buckets, counts, delivered, rounds)``: ``buckets[d]`` is
    ``int32[n_loc, acc_cap, 5]`` on position ``d``'s device, the ``(uh,
    ul, vh, vl, ins)`` rows of its shards in stream order, ``-1`` padded
    (the JAX package returns the five columns of all ``n_shards`` shards
    as separate arrays); ``counts[d]`` is its shards' ``int32[n_loc]``
    delivered counts; ``delivered`` is the first stream position not
    routed when ``max_drain_rounds`` ran out (``chunk`` when all was
    delivered; JAX's is the same value at every device) and ``rounds``
    the number of rounds run, both host ints.
    """
    geom = router_geometry(n_dev, n_shards, chunk, lane_cap,
                           max_drain_rounds)
    n_loc, n_in = geom.n_loc, geom.n_in
    lane_cap, acc_cap = geom.lane_cap, geom.acc_cap

    def route(words: Sequence[torch.Tensor]):
        if len(words) != n_dev or any(
                tuple(w.shape) != (5, n_in) for w in words):
            raise ValueError(f"route takes {n_dev} position slices of "
                             f"[5, {n_in}]: "
                             f"{[tuple(w.shape) for w in words]}")
        devs = [w.device for w in words]
        sid = [torch.arange(n_shards, dtype=torch.int64, device=dev)
               for dev in devs]
        rows = [s[:n_loc, None] for s in sid]   # each position's shards
        dest, pos, payload, valid, acc, counts = [], [], [], [], [], []
        for d, (w, dev) in enumerate(zip(words, devs)):
            uh, ul, vh, vl, ins = w.unbind(0)
            ok = (uh >= 0) & (vh >= 0)
            valid.append(ok)
            dest.append(torch.where(ok, shard_key(uh, ul, vh, vl, n_shards),
                                    n_shards).to(torch.int64))
            pos.append(torch.arange(d * n_in, (d + 1) * n_in,
                                    dtype=torch.int64, device=dev))
            payload.append(torch.stack([uh, ul, vh, vl,
                                        ins.to(torch.int32)], -1))
            # one spare bucket column takes the dropped writes (JAX's
            # scatter mode="drop")
            acc.append(torch.full((n_loc, acc_cap + 1, 5), -1,
                                  dtype=torch.int32, device=dev))
            counts.append(torch.zeros(n_loc, dtype=torch.int64, device=dev))
        delivered = rounds = 0
        while delivered < chunk and rounds < geom.max_drain_rounds:
            ranks, firsts = [], []
            for d in range(n_dev):
                pending = valid[d] & (pos[d] >= delivered)
                # stable rank of each pending change within its lane
                onehot = (dest[d][:, None] == sid[d]) & pending[:, None]
                cum = onehot.to(torch.int64).cumsum(0)
                lane = dest[d].clamp(0, n_shards - 1)[:, None]
                rank = cum.gather(1, lane)[:, 0] - 1
                ranks.append((pending, rank))
                if not geom.static_no_overflow:
                    over = pending & (rank >= lane_cap)
                    firsts.append(torch.where(over, pos[d], chunk).min()
                                  .reshape(1).to(devs[0], non_blocking=True))
            # JAX's pmin: every position's first overflow, in one read
            first = (chunk if geom.static_no_overflow else min(host_read(
                firsts[0] if n_dev == 1 else torch.cat(firsts))))
            sends = []
            for d, (pending, rank) in enumerate(ranks):
                keep = pending & (rank < lane_cap) & (pos[d] < first)
                # the lanes [n_shards, lane_cap] in shard order, so that
                # position j's are rows [j n_loc, (j+1) n_loc); one spare
                # row for the changes not kept
                send = torch.full((n_shards + 1, lane_cap, 5), -1,
                                  dtype=torch.int32, device=devs[d])
                send[torch.where(keep, dest[d], n_shards),
                     torch.where(keep, rank, 0)] = payload[d]
                sends.append(send)
            for j, dev in enumerate(devs):
                # the exchange: source d's lanes for position j, copied to
                # j's device (JAX's all_to_all), laid side by side
                # source-major; one position keeps its lanes as they are
                parts = [sends[d][j * n_loc:(j + 1) * n_loc]
                         .to(dev, non_blocking=True) for d in range(n_dev)]
                recv = parts[0] if n_dev == 1 else torch.cat(parts, 1)
                # stable compaction, appended at each shard's watermark
                rvalid = recv[..., 0] >= 0
                cpos = rvalid.to(torch.int64).cumsum(1) - 1
                acc[j][rows[j],
                       torch.where(rvalid, counts[j][:, None] + cpos,
                                   acc_cap)] = recv
                counts[j] += rvalid.sum(1)
            delivered, rounds = first, rounds + 1
        return ([a[:, :acc_cap].contiguous() for a in acc],
                [c.to(torch.int32) for c in counts], delivered, rounds)

    return route, geom


# --------------------------------------------------------------------------- #
# stage 2: engine — intern the routed buckets, run lockstep engine rounds
# --------------------------------------------------------------------------- #


def make_engine_step(cfg: EngineConfig, n_shards: int, acc_cap: int,
                     replica_exec: str):
    """The state-carrying engine stage for routed buckets:
    ``(ests, ists, telem, buckets, rounds)`` with each
    position's stacked engine state and intern rows, in place.  Every
    position interns its ``int32[n_loc, acc_cap, 5]`` buckets, then every
    replica runs ``max_s ceil(count_s / batch)`` engine rounds, the
    maximum over all ``n_shards`` shards (JAX's ``pmax``); the positions
    run in turn (:func:`for_positions`).
    Adds the route stage's extra drain rounds to ``telem``."""
    b = cfg.batch

    def engine(ests, ists, telem, buckets, rounds: int) -> None:
        n_loc = n_shards // len(buckets)
        for blk in buckets:
            if tuple(blk.shape) != (n_loc, acc_cap, 5):
                raise ValueError(f"buckets must be [{n_loc}, {acc_cap}, 5] "
                                 f"a position: {tuple(blk.shape)}")
        devices = [blk.device for blk in buckets]
        interned = for_positions(
            lambda d: intern_buckets(ists[d], buckets[d], cfg.n_cap),
            devices)
        counts = np.concatenate([(host[..., 0] >= 0).sum(1)
                                 for _, _, host in interned])
        erounds = int((-(-counts // b)).max())
        # one spare round of padding, so a round's slice never runs short
        pad = np.full((n_loc, b), INVALID, np.int32)

        def step(d: int) -> None:
            u, v, host = interned[d]
            _step_rounds(ests[d], np.concatenate([u, pad], 1),
                         np.concatenate([v, pad], 1),
                         np.concatenate([host[..., 4], np.zeros_like(pad)],
                                        1), erounds, cfg, replica_exec)

        for_positions(step, devices)
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


def _leaf_rows(tree: Mapping[str, object], rows: slice) -> dict:
    """The rows ``rows`` of every numpy leaf of a stacked tree (a table
    leaf as a ``k1``/``k2``/``val`` dict)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping) or hasattr(v, "k1"):
            out[k] = {w: np.asarray(x)[rows]
                      for w, x in zip(("k1", "k2", "val"), _table_words(v))}
        else:
            out[k] = np.asarray(v)[rows]
    return out


def sharded_blocks_from_numpy(est: Mapping[str, object],
                              ist: Mapping[str, object],
                              devices: Sequence[torch.device],
                              ) -> Tuple[List[EngineState],
                                         List[InternState]]:
    """:func:`sharded_state_from_numpy` split over the positions of a
    mesh: position ``d`` gets the stacked rows ``[d n_loc, (d+1) n_loc)``
    on ``devices[d]``, whatever number of positions wrote the leaves."""
    n_rows = len(np.asarray(est["phi"]))
    if n_rows % len(devices):
        raise ValueError(f"{n_rows} replicas do not split over "
                         f"{len(devices)} positions")
    n_loc = n_rows // len(devices)
    blocks = [sharded_state_from_numpy(
        _leaf_rows(est, slice(d * n_loc, (d + 1) * n_loc)),
        _leaf_rows(ist, slice(d * n_loc, (d + 1) * n_loc)), dev)
        for d, dev in enumerate(devices)]
    return [e for e, _ in blocks], [i for _, i in blocks]


def _concat_leaves(parts: Sequence[Dict[str, object]]) -> Dict[str, object]:
    """Numpy leaf trees of consecutive row blocks as one tree."""
    if len(parts) == 1:
        return parts[0]
    return {k: ({w: np.concatenate([p[k][w] for p in parts])
                 for w in ("k1", "k2", "val")}
                if isinstance(v, dict)
                else np.concatenate([p[k] for p in parts]))
            for k, v in parts[0].items()}


def sharded_state_to_numpy(ests: Sequence[EngineState],
                           ists: Sequence[InternState],
                           ) -> Tuple[Dict[str, object], Dict[str, object]]:
    """Stacked numpy leaves with the JAX package's types (int32, ``step_no``
    uint32, tables as ``k1``/``k2``/``val`` dicts), copies on the host:
    the inverse of :func:`sharded_blocks_from_numpy`.  ``ests`` and
    ``ists`` are the stacked blocks of a mesh's positions (``[est]`` for
    one), gathered in shard order."""
    return (_concat_leaves([state_to_numpy(copy_state(e, "cpu"))
                            for e in ests]),
            _concat_leaves([state_to_numpy(copy_state(i, "cpu"))
                            for i in ists]))


def shard_step_no(seed: int, shard: int) -> int:
    """Replica ``shard``'s initial PRNG cursor, ``seed + shard * 2654435761
    (mod 2^32)``: decorrelated trial streams."""
    return (u32(seed) + shard * 2654435761) & M32
