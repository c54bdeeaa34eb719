"""Fixed-shape engine state of the batched MoSSo engine, in torch tensors.

Port of ``repro/core/engine/state.py``: the same ``EngineConfig`` (fields,
validation, ``manifest()``, ``table_caps()``) and the same state leaves,
held in a mutable dataclass of tensors on one device.  Engine ops update
the tensors in place (see ``hashtable.py``).

:func:`state_from_numpy` / :func:`state_to_numpy` map the leaves of a JAX
``EngineState`` (taken as numpy) onto this state and back, leaf for leaf;
the differential tests start both engines from one state with them and
compare after every batch.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, Mapping

import numpy as np
import torch

from repro_torch.core.engine.hashtable import HashTable, ht_new

NO_CLUSTER = 0x7FFFFFFF

PROPOSALS = ("minhash", "magsdm")
OBJECTIVES = ("exact", "weighted")
COMMIT_RULES = ("saving", "threshold")


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Capacity and search parameters of one engine instance.

    The engine consumes dense node ids in ``[0, n_cap)``; the front-end
    interns caller labels.  ``n_cap`` is hard, ``m_cap`` sizes the hash
    tables at ~4x their worst-case live entries, and ``d_cap``/``sn_cap``
    are soft trial bounds: trials past them are skipped and counted in
    ``n_skipped``.  ``proposal``/``objective``/``commit`` select the
    Alg.-1 policy triple (defaults from ``REPRO_PROPOSAL`` /
    ``REPRO_OBJECTIVE``, as in the JAX package); ``weight_levels`` sets
    the weighted objective's node weights ``1 + hash(u) % weight_levels``.
    """

    n_cap: int = 1 << 14          # max distinct nodes
    m_cap: int = 1 << 17          # max live undirected edges
    d_cap: int = 64               # movable-node degree bound
    sn_cap: int = 32              # supernode-adjacency bound for moves
    c: int = 20                   # samples per input node (paper's c)
    escape: float = 0.3           # corrective-escape probability (paper's e)
    batch: int = 32               # changes per engine step
    seed: int = 0
    proposal: str = dataclasses.field(
        default_factory=lambda: os.environ.get("REPRO_PROPOSAL", "minhash"))
    objective: str = dataclasses.field(
        default_factory=lambda: os.environ.get("REPRO_OBJECTIVE", "exact"))
    commit: str = "saving"
    commit_margin: int = 0        # accept iff dphi <= margin ("threshold")
    weight_levels: int = 0        # 0/1 = uniform node weights ("weighted")

    def __post_init__(self):
        if self.proposal not in PROPOSALS:
            raise ValueError(f"unknown proposal {self.proposal!r}; "
                             f"expected one of {PROPOSALS}")
        if self.objective not in OBJECTIVES:
            raise ValueError(f"unknown objective {self.objective!r}; "
                             f"expected one of {OBJECTIVES}")
        if self.commit not in COMMIT_RULES:
            raise ValueError(f"unknown commit rule {self.commit!r}; "
                             f"expected one of {COMMIT_RULES}")

    def manifest(self) -> dict:
        """JSON-able identity of this config (every field)."""
        return dataclasses.asdict(self)

    def table_caps(self) -> dict:
        def pow2(x: int) -> int:
            c = 1
            while c < x:
                c <<= 1
            return c
        return dict(
            adj=pow2(4 * self.m_cap),      # (u, slot) -> v, two directions
            epos=pow2(4 * self.m_cap),     # (u, v) -> slot, two directions
            eab=pow2(2 * self.m_cap),      # canonical pair -> |E_AB|
            snadj=pow2(2 * self.m_cap),    # (sid, slot) -> sid
            snpos=pow2(2 * self.m_cap),    # (sid, sid) -> slot
            # canonical pair -> W_AB; an 8-slot dummy unless weighted
            weab=(pow2(2 * self.m_cap)
                  if self.objective == "weighted" else 8),
        )


TABLES = ("adj", "epos", "eab", "snadj", "snpos", "weab")


@dataclasses.dataclass
class EngineState:
    # per node
    n2s: torch.Tensor       # int32[n_cap], -1 = unseen node
    deg: torch.Tensor       # int32[n_cap]
    minh: torch.Tensor      # int32[n_cap], min-hash cluster id
    # per supernode (sid space == node space)
    ssize: torch.Tensor     # int32[n_cap]
    sndeg: torch.Tensor     # int32[n_cap], |SN(sid)|
    free: torch.Tensor      # int32[n_cap], free sid stack
    free_top: torch.Tensor  # int32 scalar, #free sids
    # weighted-objective view (1-long dummies under "exact")
    wsum: torch.Tensor      # int32[n_cap]
    wsq: torch.Tensor       # int32[n_cap]
    # tables
    adj: HashTable
    epos: HashTable
    eab: HashTable
    snadj: HashTable
    snpos: HashTable
    weab: HashTable
    # scalars
    phi: torch.Tensor        # int32
    num_edges: torch.Tensor  # int32
    step_no: torch.Tensor    # int64 holding the uint32 PRNG stream position
    n_trials: torch.Tensor   # int32
    n_accept: torch.Tensor   # int32
    n_skipped: torch.Tensor  # int32

    @property
    def device(self) -> torch.device:
        return self.n2s.device

    def clone(self) -> "EngineState":
        """A deep copy (the in-place engine would change a shared one)."""
        return copy_state(self)


def copy_state(st, device=None):
    """A deep copy of a state dataclass of tensors and ``HashTable``s (an
    ``EngineState`` or the router's ``InternState``), on ``device`` or,
    by default, where each leaf lies."""
    def copy(v):
        if isinstance(v, HashTable):
            return HashTable(*(copy(t) for t in (v.k1, v.k2, v.val)))
        return v.to(v.device if device is None else device, copy=True)
    return type(st)(**{f.name: copy(getattr(st, f.name))
                       for f in dataclasses.fields(st)})


def _scalar(x: int, dtype=torch.int32, device=None) -> torch.Tensor:
    return torch.tensor(x, dtype=dtype, device=device)


def new_state(cfg: EngineConfig, device) -> EngineState:
    caps = cfg.table_caps()
    n = cfg.n_cap
    nw = n if cfg.objective == "weighted" else 1
    i32 = dict(dtype=torch.int32, device=device)
    return EngineState(
        n2s=torch.full((n,), -1, **i32),
        deg=torch.zeros((n,), **i32),
        minh=torch.full((n,), NO_CLUSTER, **i32),
        ssize=torch.zeros((n,), **i32),
        sndeg=torch.zeros((n,), **i32),
        free=torch.arange(n - 1, -1, -1, **i32),
        free_top=_scalar(n, device=device),
        wsum=torch.zeros((nw,), **i32),
        wsq=torch.zeros((nw,), **i32),
        **{t: ht_new(caps[t], device) for t in TABLES},
        phi=_scalar(0, device=device),
        num_edges=_scalar(0, device=device),
        step_no=_scalar(cfg.seed & 0xFFFFFFFF, torch.int64, device),
        n_trials=_scalar(0, device=device),
        n_accept=_scalar(0, device=device),
        n_skipped=_scalar(0, device=device),
    )


def _table_words(t) -> tuple:
    if isinstance(t, Mapping):
        return t["k1"], t["k2"], t["val"]
    return t.k1, t.k2, t.val


def state_from_numpy(arrays: Mapping[str, object], device) -> EngineState:
    """Build a state from numpy leaves named as ``EngineState``'s fields.

    A table leaf may be a mapping or an object with ``k1``/``k2``/``val``
    (a JAX ``HashTable`` of numpy arrays).
    ``step_no`` may be uint32 (as in JAX) or any integer type.
    """
    out = {}
    for f in dataclasses.fields(EngineState):
        leaf = arrays[f.name]
        if f.name in TABLES:
            k1, k2, val = (torch.from_numpy(np.array(w, np.int32))
                           for w in _table_words(leaf))
            out[f.name] = HashTable(k1.to(device), k2.to(device),
                                    val.to(device))
        elif f.name == "step_no":
            out[f.name] = _scalar(int(np.asarray(leaf)) & 0xFFFFFFFF,
                                  torch.int64, device)
        else:
            out[f.name] = torch.from_numpy(
                np.array(leaf, np.int32)).to(device)
    return EngineState(**out)


def state_to_numpy(st: EngineState) -> Dict[str, object]:
    """Numpy leaves of a state, with JAX's types: int32 everywhere,
    ``step_no`` uint32, and each table a dict of ``k1``/``k2``/``val``."""
    out: Dict[str, object] = {}
    for f in dataclasses.fields(st):
        v = getattr(st, f.name)
        if isinstance(v, HashTable):
            out[f.name] = {w: getattr(v, w).cpu().numpy()
                           for w in ("k1", "k2", "val")}
        elif f.name == "step_no":
            out[f.name] = np.asarray(int(v), np.uint32)
        else:
            out[f.name] = v.cpu().numpy()
    return out
