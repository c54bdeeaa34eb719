"""Host-side front-ends around the batched engine.

Port of ``repro/core/engine/api.py``: :class:`BatchedSummarizer` (one
engine), :class:`ShardedSummarizer` (``n_shards`` engine replicas over
the positions of an engine mesh, edge-partitioned by label hash) and the
state-level exports
(:func:`state_live_edges`, :func:`state_materialize`,
:func:`state_phi_recomputed`), and both tiers' crash consistency: epoch
checkpoints and the write-ahead chunk journal (``checkpoint_dir``,
``save``/``restore``/``recover``, :mod:`repro_torch.checkpoint`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from repro_torch.checkpoint import summary as ckpt
from repro_torch.checkpoint.journal import ChunkJournal
from repro_torch.core.engine.hashtable import TOMB, HashTable, ht_rebuild
from repro_torch.core.engine.state import (EngineConfig, EngineState,
                                           copy_state, new_state,
                                           stack_states, state_from_numpy,
                                           state_rows, state_to_numpy)
from repro_torch.core.engine.trial import step_fn
from repro_torch.core.summary import (ShardedSummaryOutput, SummaryOutput,
                                      encoding_cost, host_node_weight,
                                      is_superedge, pair_key)
from repro_torch.device import resolve_device
from repro_torch.dist import labelhash, router
from repro_torch.launch.mesh import EngineMesh, make_engine_mesh

Change = Tuple[int, int, bool]


# --------------------------------------------------------------------------- #
# state-level exports (engine-id space, on the host)
# --------------------------------------------------------------------------- #


def _words(t: dict) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    return t["k1"], t["k2"], t["val"]


def _table_arrays(state: EngineState, name: str) -> dict:
    t = getattr(state, name)
    return {w: getattr(t, w).cpu().numpy() for w in ("k1", "k2", "val")}


def _live_edges(arrays: dict) -> Set[Tuple[int, int]]:
    k1, k2, _ = _words(arrays["epos"])
    live = k1 >= 0
    return {(int(a), int(b)) for a, b in zip(k1[live], k2[live]) if a < b}


def state_live_edges(state: EngineState) -> Set[Tuple[int, int]]:
    """Export the live edge set from the slot-position table."""
    return _live_edges({"epos": _table_arrays(state, "epos")})


def _pairs(ma: Set[int], mb: Set[int], same: bool):
    if same:
        mem = sorted(ma)
        for i, u in enumerate(mem):
            for v in mem[i + 1:]:
                yield (u, v)
    else:
        for u in sorted(ma):
            for v in sorted(mb):
                yield (u, v) if u < v else (v, u)


def state_materialize(state: EngineState,
                      cfg: EngineConfig | None = None) -> SummaryOutput:
    """Derive (G*, P, C+, C-) from counts + membership (optimal encoding).

    Lossless under every objective; pass ``cfg`` so a weighted state
    picks each pair's mode by ``is_superedge(W, TW)``.  Asserts that the
    counts agree with the live edge set.
    """
    weighted = cfg is not None and cfg.objective == "weighted"
    arrays = state_to_numpy(state)
    n2s, ssize = arrays["n2s"], arrays["ssize"]
    members: Dict[int, Set[int]] = {}
    for u in np.flatnonzero(n2s >= 0):
        members.setdefault(int(n2s[u]), set()).add(int(u))
    for sid, mem in members.items():
        assert len(mem) == ssize[sid], f"ssize drift at sid {sid}"

    k1, k2, val = _words(arrays["eab"])
    live = k1 >= 0
    edges = _live_edges(arrays)

    if weighted:
        wk1, wk2, wval = _words(arrays["weab"])
        wlive = wk1 >= 0
        wmap = {(int(a), int(b)): int(w)
                for a, b, w in zip(wk1[wlive], wk2[wlive], wval[wlive])}

        def w_of(u: int) -> int:
            return host_node_weight(u, cfg.weight_levels)

    superedges: Set[Tuple[int, int]] = set()
    c_plus: Set[Tuple[int, int]] = set()
    c_minus: Set[Tuple[int, int]] = set()
    for a, b, e in zip(k1[live], k2[live], val[live]):
        a, b, e = int(a), int(b), int(e)
        sa, sb = len(members[a]), len(members[b])
        t = sa * (sa - 1) // 2 if a == b else sa * sb
        pair_edges = list(_pairs(members[a], members[b], a == b))
        actual = [pq for pq in pair_edges if pq in edges]
        assert len(actual) == e, \
            f"eab drift at pair {(a, b)}: {len(actual)} != {e}"
        if weighted:
            wab = wmap.get((a, b), 0)
            w_actual = sum(w_of(p) * w_of(q) for (p, q) in actual)
            assert w_actual == wab, \
                f"weab drift at pair {(a, b)}: {w_actual} != {wab}"
            tw = sum(w_of(p) * w_of(q) for (p, q) in pair_edges)
            mode_super = is_superedge(wab, tw)
        else:
            mode_super = is_superedge(e, t)
        if mode_super:
            superedges.add(pair_key(a, b))
            c_minus.update(pq for pq in pair_edges if pq not in edges)
        else:
            c_plus.update(actual)
    return SummaryOutput(supernodes=members, superedges=superedges,
                         c_plus=c_plus, c_minus=c_minus)


def state_phi_recomputed(state: EngineState,
                         cfg: EngineConfig | None = None) -> int:
    """Refold phi from the live pair table on the host (weighted fold
    when ``cfg`` selects the weighted objective)."""
    weighted = cfg is not None and cfg.objective == "weighted"
    name = "weab" if weighted else "eab"
    k1, k2, val = _words(_table_arrays(state, name))
    if weighted:
        wsum, wsq = state.wsum.cpu().numpy(), state.wsq.cpu().numpy()
    else:
        ssize = state.ssize.cpu().numpy()
    live = k1 >= 0
    tot = 0
    for a, b, e in zip(k1[live], k2[live], val[live]):
        a, b = int(a), int(b)
        if weighted:
            t = ((int(wsum[a]) ** 2 - int(wsq[a])) // 2 if a == b
                 else int(wsum[a]) * int(wsum[b]))
        else:
            sa, sb = int(ssize[a]), int(ssize[b])
            t = sa * (sa - 1) // 2 if a == b else sa * sb
        tot += encoding_cost(int(e), t)
    return tot


# --------------------------------------------------------------------------- #
# crash consistency (shared by both front-ends)
# --------------------------------------------------------------------------- #


def _probe_backend(device: torch.device) -> str:
    """The probe route a device's state takes: the CUDA kernel or its
    plain version (recorded in a checkpoint's manifest, not pinned)."""
    return "cuda" if device.type == "cuda" else "plain"


def _numpy_tree(leaves: dict) -> dict:
    """Numpy leaves from ``state_to_numpy`` / ``sharded_state_to_numpy``
    with each table as a ``HashTable`` node, so that it flattens to the
    JAX package's archive keys (``adj/.k1``, ...)."""
    return {k: HashTable(**v) if isinstance(v, dict) else v
            for k, v in leaves.items()}


def _like_tree(st, stack: Optional[int] = None) -> dict:
    """Shapes and dtypes of a state's leaves as meta tensors (no copy,
    no memory), with a leading ``[stack]`` axis when given: the restore's
    ``like`` tree."""
    def meta(t: torch.Tensor) -> torch.Tensor:
        shape = tuple(t.shape) if stack is None else (stack, *t.shape)
        return torch.empty(shape, dtype=t.dtype, device="meta")
    out = {}
    for f in dataclasses.fields(st):
        v = getattr(st, f.name)
        out[f.name] = (HashTable(meta(v.k1), meta(v.k2), meta(v.val))
                       if isinstance(v, HashTable) else meta(v))
    return out


class _CrashConsistency:
    """Epoch checkpoints + write-ahead chunk journal for a summarizer.

    Port of the JAX package's mixin.  Both front-ends dispatch the stream
    in fixed-size chunks (``dispatch_chunk``), and chunk boundaries fully
    determine padding and the engine-round/PRNG schedule — so a run is
    reconstructible bitwise from (checkpoint at epoch E) + (the exact
    chunk slices dispatched after E):

    * with ``checkpoint_dir`` set, every chunk is durably journaled
      (:class:`~repro_torch.checkpoint.journal.ChunkJournal`) **before**
      it is dispatched; without it the hook only counts (no I/O, no sync,
      no device work);
    * ``save()`` writes the full recovery closure at a flushed epoch and
      compacts the journal; ``restore()`` loads the newest checkpoint
      that passes its checksums (refusing config mismatches);
    * ``recover()`` = restore + deterministic journal-tail replay.

    ``stream_cursor`` counts stream changes applied so far — a driver
    resumes feeding from there after ``recover()``.  ``_incarnation``
    bumps on every restore so pinned query views fail loudly instead of
    resolving labels against a state they were not snapshotted from.
    """

    def _init_crash_consistency(self, checkpoint_dir: Optional[str]) -> None:
        self._ckpt_dir = checkpoint_dir
        self._journal = None        # lazily opened ChunkJournal
        self._journal_seq = 0       # chunks dispatched (journal record seq)
        self._cursor = 0            # stream changes applied
        self._replaying = False     # recovery replay: don't re-journal
        self._recovered = False     # this instance resumed an old directory
        self.stream_retries = 0     # recoveries performed by a retry driver
        self._incarnation = 0       # bumps per restore; query views pin it

    @property
    def stream_cursor(self) -> int:
        """Stream changes applied (journaled-and-dispatched) so far."""
        return self._cursor

    def _journal_chunk(self, chunk) -> None:
        """WAL append for one dispatch chunk; seq advances regardless of
        whether journaling is enabled so save/restore counters line up."""
        seq = self._journal_seq
        self._journal_seq += 1
        if self._ckpt_dir is None or self._replaying:
            return
        if self._journal is None:
            self._journal = ChunkJournal(ckpt.journal_path(self._ckpt_dir))
            if seq == 0 and not self._recovered:
                self._journal.reset()   # fresh stream into an old directory
        self._journal.append(seq, chunk)

    def _replay_chunk(self, changes) -> None:
        """Re-dispatch one journaled chunk during recovery (no re-append):
        each record is one original dispatch slice, so replaying it as its
        own ``process`` call reproduces the original padding and
        engine-round schedule exactly."""
        self._replaying = True
        try:
            self.process(changes)
        finally:
            self._replaying = False

    def _require_ckpt_dir(self, ckpt_dir: Optional[str]) -> str:
        d = ckpt_dir or self._ckpt_dir
        if d is None:
            raise ValueError(
                "no checkpoint directory: pass one explicitly or construct "
                "the summarizer with checkpoint_dir=...")
        return d

    def save(self, ckpt_dir: Optional[str] = None) -> str:
        """Checkpoint the full recovery closure at a flushed epoch."""
        return ckpt.save_summarizer(self, self._require_ckpt_dir(ckpt_dir))

    def restore(self, ckpt_dir: Optional[str] = None,
                step: Optional[int] = None) -> dict:
        """Load the newest verifiable checkpoint (or ``step``) into this
        summarizer; raises on config mismatch, falls back across corrupt
        epochs."""
        return ckpt.restore_summarizer(self, self._require_ckpt_dir(ckpt_dir),
                                       step=step)

    def recover(self, ckpt_dir: Optional[str] = None) -> dict:
        """Crash recovery: restore last valid epoch + replay journal tail."""
        return ckpt.recover_summarizer(self, self._require_ckpt_dir(ckpt_dir))


# --------------------------------------------------------------------------- #
# single-engine front-end
# --------------------------------------------------------------------------- #


class BatchedSummarizer(_CrashConsistency):
    """Feed a fully dynamic graph stream through the engine step.

    **Id space.** ``process``/``run`` intern arbitrary hashable labels
    (host-side, encounter order) into the engine's dense ``[0, n_cap)``
    ids; outputs stay in engine ids (map through ``self._ids`` /
    ``self._rev``).

    **Device.** The state lives on ``device`` (default ``"cuda"``); the
    table probes run the CUDA kernel there.  With no CUDA device visible
    the constructor raises unless ``device="cpu"`` is passed.

    **Crash consistency.**  With ``checkpoint_dir`` every ``batch`` slice
    is journaled before it is interned and stepped; ``save()`` /
    ``restore()`` / ``recover()`` as in :class:`_CrashConsistency`, in
    the JAX package's on-disk format.
    """

    def __init__(self, cfg: EngineConfig | None = None, *, device="cuda",
                 checkpoint_dir: Optional[str] = None, **overrides) -> None:
        if cfg is None:
            cfg = EngineConfig(**overrides)
        elif overrides:
            cfg = dataclasses.replace(cfg, **overrides)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.state: EngineState = new_state(cfg, self.device)
        self._ids: Dict[object, int] = {}
        self._rev: List[object] = []
        self._epoch = 0             # engine steps applied so far
        self._init_crash_consistency(checkpoint_dir)

    # ------------------------------------------------------------------ ids
    def _nid(self, label: object) -> int:
        i = self._ids.get(label)
        if i is None:
            i = len(self._rev)
            if i >= self.cfg.n_cap:
                raise RuntimeError(f"node capacity exceeded: n_cap="
                                   f"{self.cfg.n_cap}")
            self._ids[label] = i
            self._rev.append(label)
        return i

    # --------------------------------------------------------------- stream
    @property
    def dispatch_chunk(self) -> int:
        """Stream slice size per journaled dispatch (= ``cfg.batch``)."""
        return self.cfg.batch

    def process(self, changes: Sequence[Change]) -> None:
        b = self.cfg.batch
        changes = list(changes)
        # each batch slice is journaled, then interned and stepped on its
        # own, so a journal replay of the same slices reproduces the
        # interning order, padding and PRNG schedule exactly
        for off in range(0, len(changes), b):
            sl = changes[off:off + b]
            self._journal_chunk(sl)
            buf = [(self._nid(u), self._nid(v), ins) for (u, v, ins) in sl]
            pad = b - len(buf)
            u = np.array([c[0] for c in buf] + [-1] * pad, np.int32)
            v = np.array([c[1] for c in buf] + [-1] * pad, np.int32)
            ins = np.array([c[2] for c in buf] + [False] * pad, bool)
            step_fn(self.state, u, v, ins, self.cfg)
            self._epoch += 1
            self._cursor += len(sl)

    def run(self, stream: Iterable[Change]) -> "BatchedSummarizer":
        self.process(list(stream))
        return self

    def flush(self) -> None:
        """Barrier: waits for the device to finish the queued steps."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ---------------------------------------------------------------- reads
    @property
    def flush_epoch(self) -> int:
        """Engine steps applied to ``state`` so far."""
        return self._epoch

    def query(self):
        """Snapshot read view (``neighbors``/``degree``/``has_edge`` in
        caller-label space, :mod:`repro_torch.serve.query`).  The view
        holds a copy of the state: the engine updates in place."""
        from repro_torch.serve.query import SummaryQuery
        return SummaryQuery(self)

    # ------------------------------------------------------------ maintenance
    def _tables(self) -> Tuple[str, ...]:
        tables = ("adj", "epos", "eab", "snadj", "snpos")
        if self.cfg.objective == "weighted":
            tables += ("weab",)
        return tables

    def table_pressure(self) -> Dict[str, float]:
        """live+tombstone slot fraction per table (probe-chain health)."""
        out = {}
        for name in self._tables():
            k1 = getattr(self.state, name).k1
            out[name] = float(((k1 >= 0) | (k1 == TOMB)).float().mean())
        return out

    def maybe_compact(self, threshold: float = 0.7) -> bool:
        """Rebuild tables whose occupied fraction (live + tombstones)
        crosses ``threshold``, on the state's device (on the card, the
        rebuild kernel; nothing is copied to the host)."""
        dirty = [n for n, p in self.table_pressure().items() if p > threshold]
        for name in dirty:
            setattr(self.state, name, ht_rebuild(getattr(self.state, name)))
        return bool(dirty)

    # ---------------------------------------------------------------- stats
    @property
    def phi(self) -> int:
        return int(self.state.phi)

    @property
    def num_edges(self) -> int:
        return int(self.state.num_edges)

    def compression_ratio(self) -> float:
        e = self.num_edges
        return float(self.phi) / e if e else 0.0

    def stats(self) -> dict:
        s = self.state
        return dict(phi=int(s.phi), num_edges=int(s.num_edges),
                    trials=int(s.n_trials), accepted=int(s.n_accept),
                    skipped=int(s.n_skipped),
                    stream_retries=self.stream_retries)

    # ----------------------------------------------------- recovery closure
    def _ckpt_tree(self) -> dict:
        """The state as host numpy copies (the engine writes in place; on
        the CPU ``.numpy()`` alone would share the live memory)."""
        return {"est": _numpy_tree(state_to_numpy(
            copy_state(self.state, "cpu")))}

    def _ckpt_like(self) -> dict:
        return {"est": _like_tree(self.state)}

    def _ckpt_host(self) -> dict:
        return {"ids": dict(self._ids), "rev": list(self._rev)}

    def _ckpt_manifest(self) -> dict:
        return {"tier": "batched", "config": self.cfg.manifest(),
                "trial_backend": _probe_backend(self.device)}

    @staticmethod
    def _ckpt_pins() -> tuple:
        # the probe route is a bitwise-identical execution variant:
        # recorded, not pinned
        return ("tier", "config")

    def _ckpt_apply(self, tree: dict, host: dict, extra: dict) -> None:
        # fresh tensors: a live query view may still hold the old ones
        self.state = state_from_numpy(tree["est"], self.device)
        self._ids = dict(host["ids"])
        self._rev = list(host["rev"])
        self._epoch = int(extra["epoch"])
        self._journal_seq = int(extra["journal_seq"])
        self._cursor = int(extra["cursor"])
        self._recovered = True
        self._incarnation += 1

    # ------------------------------------------------------------ materialize
    def live_edges(self) -> Set[Tuple[int, int]]:
        return state_live_edges(self.state)

    def materialize(self) -> SummaryOutput:
        return state_materialize(self.state, self.cfg)

    def phi_recomputed(self) -> int:
        return state_phi_recomputed(self.state, self.cfg)


# --------------------------------------------------------------------------- #
# sharded front-end
# --------------------------------------------------------------------------- #


def _relabel_output(out: SummaryOutput, rev: Sequence[object],
                    sid_offset: int) -> SummaryOutput:
    """Map a shard's engine-id output back to caller labels, with supernode
    ids offset into a globally unique range."""
    return SummaryOutput(
        supernodes={sid_offset + sid: {rev[u] for u in mem}
                    for sid, mem in out.supernodes.items()},
        superedges={(sid_offset + a, sid_offset + b)
                    for (a, b) in out.superedges},
        c_plus={pair_key(rev[a], rev[b]) for (a, b) in out.c_plus},
        c_minus={pair_key(rev[a], rev[b]) for (a, b) in out.c_minus},
    )


def _dropped(blocks) -> int:
    """Dropped endpoint interns over all replicas: one read a block (a
    position's stacked ``InternState``)."""
    return sum(int(i.n_dropped.sum()) for i in blocks)


def _mesh(mesh: Optional[EngineMesh], device, n_shards: Optional[int],
          ) -> EngineMesh:
    """The summarizer's engine mesh: ``mesh``, or one made from ``device``
    as the JAX package makes its default (the first ``gcd(n_shards,
    device_count)`` cards, all of them without ``n_shards``) on
    ``"cuda"``; a mesh of one position on an indexed CUDA device or the
    CPU."""
    if mesh is not None:
        if device is not None:
            raise ValueError("pass mesh= or device=, not both")
        return mesh
    dev = resolve_device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        if n_shards is None:
            return make_engine_mesh()
        return make_engine_mesh(math.gcd(int(n_shards),
                                         torch.cuda.device_count()))
    return EngineMesh([dev])


class ShardedSummarizer(_CrashConsistency):
    """Edge-partitioned summarization: ``n_shards`` engine replicas over
    the ``n_dev`` positions of an engine mesh.

    Port of the JAX package's ``ShardedSummarizer``.  Every change is
    routed to the shard owning its canonical pair, ``min(h(u), h(v)) %
    n_shards`` over the stable 62-bit label hash ``h``
    (:mod:`repro_torch.dist.labelhash`), so each replica summarizes a
    disjoint edge partition losslessly in its own ``n_cap``-bounded id
    space.  The merged output is the union of parts
    (:class:`ShardedSummaryOutput`); ``phi`` is the sum of shard phis.
    Replica states are leaf-bitwise the JAX package's after every
    ``process`` call (:func:`~repro_torch.dist.router.
    sharded_state_to_numpy` gives its stacked layout).

    **Id spaces.**  Caller labels (any hashable); 62-bit label hashes,
    two 31-bit words on the device; per-shard local ids assigned on the
    device in delivery order by the intern tables of
    :mod:`repro_torch.dist.router`.  The hash -> label map is folded
    lazily at sync points from a per-chunk label buffer; a 62-bit
    collision raises there.

    **Routing** (``routing=``): ``"device"`` (default) routes each chunk
    on the device (shard keys, capacity-bounded lanes, the drain loop)
    and then runs the engine stage; with the default ``max_drain_rounds``
    delivery is guaranteed and dispatch reads no watermark
    (``sync_free``), and chunk k+1 is routed before chunk k's engine
    stage runs (``pipeline``; one CUDA stream, so nothing overlaps, but
    ``flush_epoch`` trails ``process`` by one routed chunk as in JAX).  A
    lowered ``max_drain_rounds`` or ``chunk_sync=True`` reads the
    watermark per chunk (``router_syncs``) and replays an undelivered
    suffix through the host path (``router_overflows``).  ``"host"``
    buckets on the host: the differential reference.

    **Mesh** (``mesh=``, an :class:`~repro_torch.launch.mesh.EngineMesh`):
    ``n_loc = n_shards // n_dev`` replicas at each position, shard ``s``
    at position ``s // n_loc`` (``n_shards % n_dev`` raises), as JAX's
    ``shard_map`` lays them over its devices.  One process drives every
    position, as one host drives JAX's mesh; a device may stand at
    several positions (``EngineMesh(["cuda:0"] * 4)`` on one card,
    ``["cpu"] * 8`` for JAX's eight fake host devices).  Without
    ``mesh``, ``device="cuda"`` (the default) takes JAX's default mesh:
    the first ``gcd(n_shards, device_count)`` cards, or every card and
    one shard each without ``n_shards``; an indexed device (``"cuda:1"``)
    or ``"cpu"`` is a mesh of one position.  ``router_chunk`` is rounded
    up to a multiple of ``n_dev``.  The route stage exchanges the lanes
    between positions (peer copies between distinct cards) and the engine
    stage steps the positions in turn.  The step is bound by the host
    (about 20 host reads a change), so on a host of several cards the
    default mesh takes longer a change than ``device="cuda:0"``, which
    steps every replica as one stack (``PERF.md`` §6): the mesh buys
    room, each card holding only its positions' replicas, not speed.

    **Replicas** (``replica_exec=``): each position's replicas are one
    stacked state (every leaf ``[n_loc, ...]``; ``states`` and
    ``interns`` are the rows of all positions in shard order, views that
    show every write), stepped as one batch a round (``"vmap"``, the
    default on a CUDA device) or row by row (``"map"``, the default on the
    CPU); both are leaf-bitwise equal (:mod:`repro_torch.dist.router`).

    **Capacity.**  A shard past ``n_cap`` drops the endpoint intern and
    skips the change; the next sync point (``phi``/``stats``/
    ``materialize``/...) raises ``RuntimeError``.

    **Device.**  Each position's replicas live on its device; every table
    probe, the intern pre-lookups and inserts included, runs the probe
    kernel there.  With no CUDA device visible the constructor raises
    unless ``device="cpu"`` (or a mesh of CPU positions) is passed.

    **Crash consistency.**  With ``checkpoint_dir`` every ``router_chunk``
    slice is journaled before it is routed; ``save()`` flushes the
    pipeline and writes the replicas, the interns, the drain telemetry and
    the folded hash -> label map in the JAX package's stacked layout
    (all ``n_shards`` rows in shard order) and on-disk format
    (:class:`_CrashConsistency`).  The manifest records ``n_devices``
    without pinning it: a checkpoint written at 8 positions restores at
    1 and the reverse, here and in the JAX package.
    """

    def __init__(self, cfg: EngineConfig | None = None, *,
                 mesh: Optional[EngineMesh] = None, device=None,
                 n_shards: Optional[int] = None, routing: str = "device",
                 router_chunk: int = 1024, lane_cap: Optional[int] = None,
                 max_drain_rounds: Optional[int] = None,
                 chunk_sync: bool = False, pipeline: bool = True,
                 replica_exec: Optional[str] = None,
                 checkpoint_dir: Optional[str] = None, **overrides) -> None:
        if cfg is None:
            cfg = EngineConfig(**overrides)
        elif overrides:
            cfg = dataclasses.replace(cfg, **overrides)
        self.cfg = cfg
        self.mesh = _mesh(mesh, device, n_shards)
        self.devices: List[torch.device] = [
            resolve_device(d) for d in self.mesh.devices]
        self.device = self.devices[0]
        self.replica_exec = router.check_replica_exec(replica_exec,
                                                      self.device)
        n_dev = len(self.devices)
        self.n_shards = n_dev if n_shards is None else int(n_shards)
        if self.n_shards % n_dev != 0:
            raise ValueError(
                f"n_shards={self.n_shards} must be a multiple of the mesh "
                f"device count {n_dev}")
        if self.n_shards >= router.MAX_SHARDS:
            raise ValueError(
                f"n_shards={self.n_shards} must be < {router.MAX_SHARDS} "
                f"(shard keys compose 31-bit hash words over uint32 "
                f"residues)")
        if routing not in ("device", "host"):
            raise ValueError(f"routing must be 'device' or 'host': {routing}")
        self.routing = routing
        # rounded up so that the chunk splits evenly over the positions
        self.router_chunk = -(-int(router_chunk) // n_dev) * n_dev
        self.lane_cap = (router.default_lane_cap(
            self.router_chunk, n_dev, self.n_shards, cfg.batch)
            if lane_cap is None
            else min(int(lane_cap), self.router_chunk // n_dev))
        self.router_overflows = 0   # changes spilled to the host path
        self.router_syncs = 0       # per-chunk watermark fetches
        self.chunk_sync = bool(chunk_sync)
        self._drain_rounds = router.drain_telemetry_new(n_dev, self.device)
        self._bucketed = router.make_bucketed_step(cfg, self.replica_exec)
        if routing == "device":
            self._route, self.router_geometry = router.make_route_step(
                n_dev, self.n_shards, self.router_chunk, self.lane_cap,
                max_drain_rounds)
            self._engine = router.make_engine_step(
                cfg, self.n_shards, self.router_geometry.acc_cap,
                self.replica_exec)
            self.lane_cap = self.router_geometry.lane_cap
            self.max_drain_rounds = self.router_geometry.max_drain_rounds
            self.sync_free = (self.router_geometry.drain_guaranteed
                              and not self.chunk_sync)
        else:
            self._route = self._engine = None
            self.router_geometry = None
            self.max_drain_rounds = None
            self.sync_free = False
        self.pipeline = bool(pipeline) and self.sync_free
        self._pending = None        # routed chunk awaiting its engine stage
        self._epoch = 0             # engine stages applied to the replicas
        self._init_crash_consistency(checkpoint_dir)

        n_loc = self.n_shards // n_dev
        ests, ists = [], []
        for d, dev in enumerate(self.devices):
            est = stack_states([new_state(cfg, dev)] * n_loc)
            est.step_no.copy_(torch.tensor(
                [router.shard_step_no(cfg.seed, s)
                 for s in range(d * n_loc, (d + 1) * n_loc)],
                dtype=torch.int64))
            ests.append(est)
            ists.append(stack_states([router.intern_new(cfg, dev)] * n_loc))
        self._set_replicas(ests, ists)

        self._h2label: Dict[int, object] = {}  # 62-bit hash -> caller label
        self._label_buf: List = []   # (labels, hi, lo) pending lazy fold
        self._label_head = None      # compacted (labels, hashes), hash-sorted
        self._host_dict_ops = 0      # label-map mutations inside dispatch
        self._in_dispatch = False
        self._host_cache = None

    def _set_replicas(self, ests: Sequence[EngineState],
                      ists: Sequence["router.InternState"]) -> None:
        """Hold each position's stacked replicas (``_est[d]``,
        ``_ist[d]``) and their rows in shard order (``states`` and
        ``interns``: views, which every write of the engine shows)."""
        self._est, self._ist = list(ests), list(ists)
        self._intern_rows = [state_rows(i) for i in self._ist]
        self.states: List[EngineState] = [
            row for est in self._est for row in state_rows(est)]
        self.interns: List[router.InternState] = [
            row for rows in self._intern_rows for row in rows]

    # ------------------------------------------------------------------ ids
    def _pack_chunk(self, chunk: Sequence[Change], pad_to: int = 0):
        """Hash one chunk of labeled changes into device words (numpy
        ``int32``); the labels are buffered for the lazy reverse-map fold."""
        m = len(chunk)
        us = [c[0] for c in chunk]
        vs = [c[1] for c in chunk]
        uh, ul = labelhash.hash_words(us)
        vh, vl = labelhash.hash_words(vs)
        fl = np.fromiter((c[2] for c in chunk), np.int32, m)
        self._label_buf.append((us, uh, ul))
        self._label_buf.append((vs, vh, vl))
        if pad_to > m:
            def pad(a, fill):
                return np.concatenate(
                    [a, np.full(pad_to - m, fill, a.dtype)])
            uh, ul, vh, vl = (pad(a, -1) for a in (uh, ul, vh, vl))
            fl = pad(fl, 0)
        return uh, ul, vh, vl, fl

    @staticmethod
    def _collision(a, b, h) -> RuntimeError:
        return RuntimeError(
            f"62-bit label-hash collision: {a!r} and {b!r} both hash to "
            f"{int(h):#x}; rename one label (collision odds are ~n^2/2^63 "
            f"— this is loud instead of silently merging the two nodes)")

    def _compact_label_buf(self) -> None:
        """Dedup the pending label buffer by hash (numpy only, no dict),
        merged into a hash-sorted compacted head; a dropped duplicate that
        is a different label raises as a collision."""
        buf = self._label_buf
        if not buf:
            return
        labels = [x for (ls, _, _) in buf for x in ls]
        arr = np.array(labels, dtype=object)
        if arr.ndim != 1:           # e.g. equal-length tuple labels
            arr = np.empty(len(labels), object)
            for i, x in enumerate(labels):
                arr[i] = x
        comb = np.concatenate([labelhash.combine(hi, lo)
                               for (_, hi, lo) in buf])
        uniq, first, inv = np.unique(comb, return_index=True,
                                     return_inverse=True)
        # a non-reflexive label (NaN) must not read as a self-collision
        same = arr == arr[first[inv]]
        for i in np.flatnonzero(~np.asarray(same, bool)):
            j = int(first[inv[int(i)]])
            if arr[int(i)] is not arr[j]:
                raise self._collision(arr[j], arr[int(i)], comb[int(i)])
        keep = arr[first]
        if self._label_head is None:
            self._label_head = (keep, uniq)
        else:
            h_lab, h_hash = self._label_head
            pos = np.searchsorted(h_hash, uniq)
            posc = np.minimum(pos, len(h_hash) - 1)
            known = (pos < len(h_hash)) & (h_hash[posc] == uniq)
            if bool(np.any(known)):
                same2 = keep[known] == h_lab[posc[known]]
                kidx = np.flatnonzero(known)
                for k in np.flatnonzero(~np.asarray(same2, bool)):
                    i = int(kidx[int(k)])
                    if keep[i] is not h_lab[int(posc[i])]:
                        raise self._collision(h_lab[int(posc[i])], keep[i],
                                              uniq[i])
            fresh = ~known
            m_hash = np.concatenate([h_hash, uniq[fresh]])
            order = np.argsort(m_hash)       # disjoint hashes: total order
            self._label_head = (
                np.concatenate([h_lab, keep[fresh]])[order], m_hash[order])
        buf.clear()

    def _fold_labels(self) -> None:
        """Fold buffered/compacted labels into the hash -> label map, at
        sync points only (``router_host_dict_ops`` counts a fold inside
        dispatch); raises on a 62-bit collision between distinct labels."""
        head, buf = self._label_head, self._label_buf
        if head is None and not buf:
            return
        if self._in_dispatch:
            self._host_dict_ops += (
                (len(head[0]) if head is not None else 0)
                + sum(len(e[0]) for e in buf))
        h2l = self._h2label
        entries = ([] if head is None
                   else [(head[0].tolist(), head[1])])
        entries += [(labels, labelhash.combine(hi, lo))
                    for (labels, hi, lo) in buf]
        for labels, comb in entries:
            for label, h in zip(labels, comb.tolist()):
                prev = h2l.setdefault(h, label)
                if prev is not label and prev != label:
                    raise self._collision(prev, label, h)
        self._label_head = None
        buf.clear()

    def host_label_map(self) -> Dict[int, object]:
        """The folded 62-bit hash -> caller label map (a sync point; treat
        the returned dict as read-only)."""
        self._flush_dispatch()
        self._fold_labels()
        return self._h2label

    def shard_of(self, u: object, v: object) -> int:
        """Owner shard of a streamed edge {u, v}; ``LookupError`` for a
        label this summarizer has not seen.  Assigns nothing."""
        self._fold_labels()
        hu, hv = labelhash.hash_label(u), labelhash.hash_label(v)
        for label, h in ((u, hu), (v, hv)):
            if h not in self._h2label:
                raise LookupError(
                    f"shard_of: label {label!r} has not been streamed")
        return min(hu, hv) % self.n_shards

    # --------------------------------------------------------------- stream
    def process(self, changes: Sequence[Change]) -> None:
        """Apply a sequence of changes, ``router_chunk`` at a time.  On the
        pipelined path the last chunk's engine stage is still pending when
        this returns; every state accessor flushes first."""
        changes = list(changes)
        self._in_dispatch = True
        try:
            for off in range(0, len(changes), self.router_chunk):
                chunk = changes[off:off + self.router_chunk]
                self._journal_chunk(chunk)      # durable BEFORE dispatch
                if self.routing == "device":
                    self._process_chunk_device(chunk)
                else:
                    self._process_chunk_host(chunk)
                self._cursor += len(chunk)
        finally:
            self._in_dispatch = False

    @property
    def dispatch_chunk(self) -> int:
        """Stream slice size per journaled dispatch (= ``router_chunk``)."""
        return self.router_chunk

    def _process_chunk_host(self, chunk: Sequence[Change]) -> None:
        """Host routing: bucket hashed changes per shard (stable, stream
        order) and feed padded ``[n_shards, batch]`` rounds."""
        self._flush_dispatch()
        n, b = self.n_shards, self.cfg.batch
        uh, ul, vh, vl, fl = self._pack_chunk(chunk)
        dest = np.minimum(labelhash.combine(uh, ul),
                          labelhash.combine(vh, vl)) % n
        idxs = [np.flatnonzero(dest == s) for s in range(n)]
        rounds = (max((len(i) for i in idxs), default=0) + b - 1) // b
        for r in range(rounds):
            buh = np.full((n, b), -1, np.int32)
            bul = np.full((n, b), -1, np.int32)
            bvh = np.full((n, b), -1, np.int32)
            bvl = np.full((n, b), -1, np.int32)
            bfl = np.zeros((n, b), np.int32)
            for s, idx in enumerate(idxs):
                sel = idx[r * b:(r + 1) * b]
                k = len(sel)
                if k:
                    buh[s, :k], bul[s, :k] = uh[sel], ul[sel]
                    bvh[s, :k], bvl[s, :k] = vh[sel], vl[sel]
                    bfl[s, :k] = fl[sel]
            self._bucketed(self._est, self._intern_rows, buh, bul, bvh, bvl,
                           bfl)
        self._epoch += 1
        self._host_cache = None
        if len(self._label_buf) >= 128:
            self._compact_label_buf()

    def _process_chunk_device(self, chunk: Sequence[Change]) -> None:
        """Device routing: the route stage, then the engine stage of the
        previous routed chunk (pipelined) or of this one."""
        packed = np.stack(self._pack_chunk(chunk, pad_to=self.router_chunk))
        n_in = self.router_chunk // len(self.devices)
        # position d's slice of the chunk, on its device
        words = [torch.from_numpy(np.ascontiguousarray(
            packed[:, d * n_in:(d + 1) * n_in])).to(dev)
            for d, dev in enumerate(self.devices)]
        buckets, _, delivered, rounds = self._route(words)
        routed = (buckets, rounds)
        self._host_cache = None
        if len(self._label_buf) >= 128:
            self._compact_label_buf()
        if self.pipeline:
            prev, self._pending = self._pending, routed
            if prev is not None:
                self._run_engine(prev)
            return
        self._run_engine(routed)
        if self.sync_free:
            return                           # delivery guaranteed
        self.router_syncs += 1               # the per-chunk watermark read
        if delivered < len(chunk):
            self.router_overflows += len(chunk) - delivered
            self._process_chunk_host(chunk[delivered:])

    def _run_engine(self, routed) -> None:
        self._engine(self._est, self._intern_rows, self._drain_rounds,
                     *routed)
        self._epoch += 1

    def _flush_dispatch(self) -> None:
        """Run the engine stage of a still-pending routed chunk."""
        if self._pending is not None:
            prev, self._pending = self._pending, None
            self._run_engine(prev)

    def flush(self) -> None:
        """Barrier: drains the dispatch pipeline and waits for every
        position's device."""
        self._flush_dispatch()
        for dev in dict.fromkeys(self.devices):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

    def run(self, stream: Iterable[Change]) -> "ShardedSummarizer":
        self.process(list(stream))
        return self

    # ---------------------------------------------------------------- reads
    @property
    def flush_epoch(self) -> int:
        """Engine stages applied to the replicas so far; on the pipelined
        path this trails the chunks handed to ``process`` by one."""
        return self._epoch

    def query(self, copy: bool = False):
        """Snapshot read view (``neighbors``/``degree``/``has_edge`` in
        caller-label space, merged across shards; no pipeline flush,
        :mod:`repro_torch.serve.query`).  The view always holds a copy of
        the stacked replicas (one clone), since the engine writes in
        place: ``copy`` is taken for the JAX package's signature and
        changes nothing."""
        from repro_torch.serve.query import ShardedSummaryQuery
        return ShardedSummaryQuery(self, copy=copy)

    # ---------------------------------------------------------------- stats
    def host_states(self) -> List[EngineState]:
        """Copies of every replica's engine state on the CPU, memoized
        until the next ``process`` call (a sync point)."""
        return self._host_fetch()[0]

    def host_interns(self) -> List["router.InternState"]:
        """Copies of every replica's intern state on the CPU."""
        return self._host_fetch()[1]

    def _host_fetch(self):
        self._flush_dispatch()
        if self._host_cache is None:
            self._host_cache = tuple(
                [row for blk in blocks
                 for row in state_rows(copy_state(blk, "cpu"))]
                for blocks in (self._est, self._ist))
        self._check_capacity()
        return self._host_cache

    def _check_capacity(self) -> None:
        self._flush_dispatch()
        if self._host_cache is not None:   # the counters are on the host
            dropped = sum(int(i.n_dropped) for i in self._host_cache[1])
        else:
            dropped = _dropped(self._ist)
        self._raise_if_dropped(dropped)

    def _raise_if_dropped(self, dropped: int) -> None:
        if dropped:
            raise RuntimeError(
                f"node capacity exceeded: {dropped} endpoint interns dropped "
                f"(per-shard n_cap={self.cfg.n_cap}; raise n_cap or n_shards "
                f"— losslessness does not hold for the dropped changes)")

    def _shard_rev(self, shard: int) -> List[object]:
        """nid -> caller label for one shard: the intern table's ``l2h``
        rows through the folded hash -> label map."""
        self._fold_labels()
        ist = self.host_interns()[shard]
        l2h = ist.l2h[:int(ist.n_nodes)].numpy()
        return [self._h2label[int(h)]
                for h in labelhash.combine(l2h[:, 0], l2h[:, 1])]

    def shard_state(self, shard: int) -> EngineState:
        return self.host_states()[shard]

    def _scalars(self, *names: str) -> np.ndarray:
        """``int64[len(names), n_shards]``: state scalars of every replica
        in shard order, one read a position."""
        return np.concatenate(
            [torch.stack([getattr(est, k).to(torch.int64)
                          for k in names]).cpu().numpy()
             for est in self._est], axis=1)

    def shard_phis(self) -> List[int]:
        self._check_capacity()
        return [int(x) for x in self._scalars("phi")[0]]

    @property
    def phi(self) -> int:
        """Sum of shard phis (per-pair encodings never span shards)."""
        return sum(self.shard_phis())

    @property
    def num_edges(self) -> int:
        self._check_capacity()
        return int(self._scalars("num_edges").sum())

    def compression_ratio(self) -> float:
        e = self.num_edges
        return float(self.phi) / e if e else 0.0

    def stats(self) -> dict:
        """Engine counters summed over the replicas plus routing telemetry:
        ``router_overflows`` (changes replayed through the host path),
        ``router_drain_rounds`` (extra drain rounds beyond the first),
        ``router_syncs`` (per-chunk watermark reads), and
        ``router_host_dict_ops`` (label-map mutations inside dispatch).
        A sync point."""
        self._flush_dispatch()
        self._fold_labels()
        phi, ne, tr, ac, sk = self._scalars(
            "phi", "num_edges", "n_trials", "n_accept", "n_skipped").sum(1)
        self._raise_if_dropped(_dropped(self._ist))
        return dict(phi=int(phi), num_edges=int(ne), trials=int(tr),
                    accepted=int(ac), skipped=int(sk),
                    n_shards=self.n_shards, routing=self.routing,
                    router_overflows=self.router_overflows,
                    router_drain_rounds=int(self._drain_rounds.max()),
                    router_syncs=self.router_syncs,
                    router_host_dict_ops=self._host_dict_ops,
                    router_sync_free=self.sync_free,
                    router_pipelined=self.pipeline,
                    # recoveries performed by a retry driver on this live
                    # object; not part of the checkpoint closure
                    stream_retries=self.stream_retries)

    # ----------------------------------------------------- recovery closure
    def _ckpt_tree(self) -> dict:
        """Replicas and interns as host numpy copies in the JAX
        package's stacked ``[n_shards, ...]`` layout, every position's
        rows in shard order."""
        est, ist = router.sharded_state_to_numpy(self._est, self._ist)
        return {"est": _numpy_tree(est), "ist": _numpy_tree(ist)}

    def _ckpt_like(self) -> dict:
        return {"est": _like_tree(self.states[0], stack=self.n_shards),
                "ist": _like_tree(self.interns[0], stack=self.n_shards)}

    def _ckpt_host(self) -> dict:
        # host_label_map() drains the pipeline and folds the lazy label
        # buffer, so the map alone carries label recovery
        return {"h2label": dict(self.host_label_map()),
                "drain_rounds": self._drain_rounds.cpu().numpy().copy(),
                "router_overflows": self.router_overflows,
                "router_syncs": self.router_syncs,
                "host_dict_ops": self._host_dict_ops}

    def _ckpt_manifest(self) -> dict:
        # the drain geometry shapes the PRNG schedule only when delivery is
        # not statically guaranteed; pinned only then
        guaranteed = (bool(self.router_geometry.drain_guaranteed)
                      if self.router_geometry is not None else True)
        return {"tier": "sharded", "config": self.cfg.manifest(),
                "n_shards": self.n_shards,
                "router_chunk": self.router_chunk,
                "drain_geometry": (None if guaranteed else
                                   [self.lane_cap, self.max_drain_rounds]),
                "routing": self.routing,
                "replica_exec": self.replica_exec,
                "trial_backend": _probe_backend(self.device),
                "n_devices": len(self.devices)}

    @staticmethod
    def _ckpt_pins() -> tuple:
        # routing / replica_exec / the probe route / n_devices are
        # bitwise-identical execution variants: recorded, not pinned
        return ("tier", "config", "n_shards", "router_chunk",
                "drain_geometry")

    def _ckpt_apply(self, tree: dict, host: dict, extra: dict) -> None:
        # fresh tensors: a live query view may still hold the old ones;
        # the rows split over the live mesh, whatever mesh wrote them
        self._set_replicas(*router.sharded_blocks_from_numpy(
            tree["est"], tree["ist"], self.devices))
        self._drain_rounds = router.drain_telemetry_restore(
            host["drain_rounds"], len(self.devices), self.device)
        self._h2label = dict(host["h2label"])
        self._label_buf = []
        self._label_head = None
        self.router_overflows = int(host["router_overflows"])
        self.router_syncs = int(host["router_syncs"])
        self._host_dict_ops = int(host["host_dict_ops"])
        self._pending = None
        self._host_cache = None
        self._epoch = int(extra["epoch"])
        self._journal_seq = int(extra["journal_seq"])
        self._cursor = int(extra["cursor"])
        self._recovered = True
        self._incarnation += 1

    # ------------------------------------------------------------ materialize
    def live_edges(self) -> Set[Tuple[object, object]]:
        """Union of per-shard live edges, in caller labels."""
        out: Set[Tuple[object, object]] = set()
        for s, st in enumerate(self.host_states()):
            rev = self._shard_rev(s)
            for (a, b) in state_live_edges(st):
                out.add(pair_key(rev[a], rev[b]))
        return out

    def materialize(self) -> ShardedSummaryOutput:
        """Per-shard lossless summaries in caller labels, supernode ids
        offset into disjoint ranges (``shard * n_cap``)."""
        shards = []
        for s, st in enumerate(self.host_states()):
            out = state_materialize(st, self.cfg)
            shards.append(
                _relabel_output(out, self._shard_rev(s), s * self.cfg.n_cap))
        return ShardedSummaryOutput(shards=shards)

    def phi_recomputed(self) -> int:
        return sum(state_phi_recomputed(st, self.cfg)
                   for st in self.host_states())
