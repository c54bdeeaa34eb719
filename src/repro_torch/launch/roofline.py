"""Roofline terms of a dry-run step, and the tracer that counts them (port
of ``repro/launch/roofline.py``).

  compute term    = FLOPs / peak FLOP/s
  memory term     = bytes accessed / HBM bytes/s
  collective term = collective bytes / link bytes/s

each per rank, at the card's published rates (``launch/mesh.py``: the H100
SXM 80GB).  JAX takes FLOPs and bytes from XLA's ``cost_analysis()`` of
the partitioned program, and the collective bytes by parsing its
post-SPMD HLO.  Torch has neither, so :class:`LocalStepMode` counts what
one rank runs while the step executes under DTensor on ``meta`` tensors:

* it lets each DTensor op desugar first (its dispatch returns
  ``NotImplemented`` for DTensor types, as ``CommDebugMode`` does), so it
  sees the rank's LOCAL ops on local shards and the ``_c10d_functional``
  collectives that the redistributions issue;
* FLOPs: FlopCounterMode's formulas (``torch.utils.flop_counter.
  flop_registry``) over each local op, so a replicated op counts on every
  rank and a sharded one only its shard;
* bytes accessed: each local op's tensor inputs and outputs, once per op
  (the counterpart of XLA's "bytes accessed"; views, metadata ops and
  collectives move nothing here);
* collective bytes: each collective's output bytes on the rank, by kind,
  which is the proxy JAX's count takes from the HLO (exact for
  all-reduce, the whole gathered tensor for all-gather, the shard for
  reduce-scatter).  DTensor picks its own redistributions (it may move an
  activation where GSPMD gathers a weight), so the collectives are
  DTensor's, not the HLO's; the tracer's replicate fallback (below) adds
  the all-gathers a replicated op needs;
* memory: the live bytes of the rank's storages, from the parameters,
  optimizer state and inputs on; a storage is freed when its last tensor
  dies (autograd's saved tensors included).  Its peak is the port's
  counterpart of XLA's ``temp_size_in_bytes`` plus the arguments;
  temporaries inside a collective are not seen.

An op that DTensor cannot run sharded (no sharding strategy, a view that
does not divide, a failure inside its sharded implementation) is retried
with its DTensor arguments gathered over one more mesh dim each time,
'model' first (counted), and at the end on the whole tensors: what GSPMD
does with an op it cannot partition.  An in-place op of that kind into a
DTensor is taken as each rank writing its own shard: it returns its
destination as it was and moves nothing (meta tensors hold no values).
"""
from __future__ import annotations

import weakref
from collections import Counter
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
import torch.utils._pytree as pytree

from repro_torch.launch.mesh import HBM_BW, ICI_BW, PEAK_FLOPS_BF16

_COLLECTIVES = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all", "broadcast": "collective-permute",
    "broadcast_": "collective-permute",
}
_KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
          "collective-permute")


def _tensors(tree):
    return [t for t in pytree.tree_leaves(tree)
            if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def _is_fake(t) -> bool:
    from torch._subclasses.fake_tensor import FakeTensor
    return isinstance(t, FakeTensor)


def no_collectives() -> Dict[str, int]:
    """Bytes per collective kind (JAX's keys), all 0."""
    return {k: 0 for k in _KINDS}


class _Counts:
    """What one rank's local step did: FLOPs, bytes, collectives, and the
    live bytes of its storages."""

    def __init__(self):
        self.flops = 0
        self.bytes_accessed = 0
        self.collectives: Dict[str, int] = no_collectives()
        self.fallback_ops: Counter = Counter()
        self.live = 0
        self.peak = 0
        self._seen: Dict[int, int] = {}

    def track(self, t: torch.Tensor) -> None:
        """Count ``t``'s storage as live until it dies."""
        if _is_dtensor(t):
            t = t._local_tensor
        if _is_fake(t) or t.is_sparse:
            return
        st = t.untyped_storage()
        key = id(st)
        if key in self._seen:
            return
        n = st.nbytes()
        self._seen[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self.live -= self._seen.pop(key, 0)


class _Counter(TorchDispatchMode):
    """Counts the local ops (see the module docstring)."""

    def __init__(self, counts: _Counts):
        super().__init__()
        self.c = counts

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if any(t is DTensor or issubclass(t, DTensor) for t in types):
            return NotImplemented       # let DTensor desugar, see its ops
        out = func(*args, **kwargs)
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        if any(_is_fake(t) for t in ins + outs):
            return out                  # DTensor's shape propagation
        name = func._schema.name.split("::")[-1]
        kind = _COLLECTIVES.get(name)
        if kind is not None and "c10d" in func._schema.name:
            self.c.collectives[kind] += sum(_nbytes(t) for t in outs)
        elif not func.is_view and outs:
            from torch.utils.flop_counter import flop_registry
            fn = flop_registry.get(func._overloadpacket)
            if fn is not None:
                self.c.flops += int(fn(*args, **kwargs, out_val=out))
            self.c.bytes_accessed += sum(_nbytes(t) for t in ins + outs)
        for t in outs:
            self.c.track(t)
        return out


def _writes_first(func) -> bool:
    first = func._schema.arguments[0] if func._schema.arguments else None
    return first is not None and first.alias_info is not None and \
        first.alias_info.is_write


def _relaxed(func, args, kwargs, counter):
    """``func`` with its DTensor arguments gathered one mesh dim at a time,
    the innermost ('model') first, until DTensor can run it; on the whole
    tensors (outputs replicated) if it never can."""
    from torch.distributed.tensor import DTensor, Replicate
    mesh = next(t.device_mesh for t in _tensors((args, kwargs))
                if isinstance(t, DTensor))
    ndim = mesh.ndim

    def gather(a, k):
        if not isinstance(a, DTensor):
            return a
        want = [Replicate() if j >= k else p
                for j, p in enumerate(a.placements)]
        return a if list(a.placements) == want else \
            a.redistribute(mesh, want)
    if _writes_first(func) and isinstance(args[0], DTensor):
        # a write into a sharded destination: each rank writes its shard
        # (meta tensors hold no values, so nothing is gathered)
        return args[0]
    out = None
    for k in range(ndim - 1, -1, -1):
        with counter:
            a2 = pytree.tree_map(lambda a: gather(a, k), args)
            k2 = pytree.tree_map(lambda a: gather(a, k), kwargs)
            try:
                out = func(*a2, **k2)
                break
            except Exception:
                if k:
                    continue
            whole = pytree.tree_map(
                lambda a: a.to_local() if isinstance(a, DTensor) else a,
                (a2, k2))
            out = pytree.tree_map(
                lambda o: DTensor.from_local(o, mesh, [Replicate()] * ndim,
                                             run_check=False)
                if isinstance(o, torch.Tensor) else o,
                func(*whole[0], **whole[1]))
    return out


class LocalStepMode(TorchDispatchMode):
    """Trace one rank's step under DTensor: ``with LocalStepMode() as m:
    step(...)``, then ``m.counts``.  Call :meth:`track` on the step's
    arguments first, so their bytes count as live from the start."""

    def __init__(self):
        super().__init__()
        self.counts = _Counts()
        self._counter = _Counter(self.counts)

    def track(self, tree) -> None:
        for t in _tensors(tree):
            self.counts.track(t)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        try:
            with self._counter:
                return func(*args, **kwargs)
        except Exception as e:
            if not any(_is_dtensor(t) for t in _tensors((args, kwargs))):
                raise
            err = e
        try:
            out = _relaxed(func, args, kwargs, self._counter)
        except Exception:
            raise err
        # the kept error's traceback holds this frame, and so this op's
        # tensors, in a cycle that only the garbage collector would free
        del err
        self.counts.fallback_ops[str(func)] += 1
        return out


def roofline_terms(cost: dict, coll: Dict[str, int], n_chips: int) -> dict:
    flops = float(cost.get("flops", 0.0))
    byts = float(cost.get("bytes accessed", 0.0))
    cbytes = float(sum(coll.values()))
    # the counts are one rank's (its local step)
    t_compute = flops / PEAK_FLOPS_BF16
    t_memory = byts / HBM_BW
    t_collective = cbytes / ICI_BW
    dominant = max((("compute", t_compute), ("memory", t_memory),
                    ("collective", t_collective)), key=lambda kv: kv[1])[0]
    return dict(flops=flops, bytes=byts, collective_bytes=cbytes,
                t_compute=t_compute, t_memory=t_memory,
                t_collective=t_collective, dominant=dominant,
                n_chips=n_chips)


def model_flops(n_params_active: int, tokens: int) -> float:
    """MODEL_FLOPS = 6 * N * D (dense) / 6 * N_active * D (MoE)."""
    return 6.0 * n_params_active * tokens
