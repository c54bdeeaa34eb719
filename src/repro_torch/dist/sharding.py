"""Sharding specs from logical-axis rules, resolved to DTensor placements
on a ``DeviceMesh`` (port of ``repro/dist/sharding.py``).

The declarative per-leaf rules live in :mod:`repro_torch.configs.base`
(``LM_LOGICAL_RULES`` et al.).  This module resolves them against a mesh
into specs, guarding every placement for divisibility so one rule set
serves the 512-rank production meshes and small test meshes alike.

A *spec* is the port's ``PartitionSpec``: a tuple with one entry per
tensor dimension, each ``None`` (replicated), a mesh axis name, or a
tuple of axis names.  :func:`placements` turns it into DTensor
placements, one per mesh dimension: ``Shard(d)`` on every mesh dimension
that the entry of tensor dim ``d`` names (a dim spread over ``("pod",
"data")`` takes ``Shard(d)`` on both, pod the major), ``Replicate()`` on
the others.  A mesh here is anything with ``mesh_dim_names`` and
``shape``: a ``DeviceMesh``, or a stand-in that carries only the names
and sizes (what resolving a spec needs).

The JAX module loads its rule tables lazily to break an import cycle
(its models import ``dist``, whose ``sharding`` imports ``configs``,
which imports the models).  The port's ``annotate`` imports this module
only inside its functions, so there is no cycle to break.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.utils._pytree as pytree

from repro_torch.configs.base import (GNN_LOGICAL_RULES, LM_LOGICAL_RULES,
                                      LOGICAL_TO_MESH, MOE_FFN_LOGICAL_RULES,
                                      RECSYS_LOGICAL_RULES)

LM_RULES = LM_LOGICAL_RULES
GNN_RULES = GNN_LOGICAL_RULES
RECSYS_RULES = RECSYS_LOGICAL_RULES

Spec = Tuple[Any, ...]


def _axis_sizes(mesh) -> Dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


# ----------------------------------------------------------------- mesh utils


def batch_axes(mesh) -> Tuple[str, ...]:
    """Mesh axes that carry the batch (data-parallel) dimension."""
    return tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)


def batch_spec(mesh, rank: int) -> Spec:
    """A spec sharding dim 0 over the data axes, replicating the rest."""
    ax = batch_axes(mesh)
    lead = ax if len(ax) > 1 else (ax[0] if ax else None)
    return (lead, *([None] * (rank - 1)))


def _local(t, spec, mesh):
    """A DTensor's local shard once it is laid out by the guarded
    ``spec`` (redistributed if it is not), and that spec."""
    spec = guard_spec(spec, t.shape, mesh)
    want = tuple(placements(spec, mesh))
    if tuple(t.placements) != want:
        t = t.redistribute(mesh, want)
    return t.to_local(), spec


def _entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    if isinstance(entry, str):
        return (entry,)
    return tuple(a for a in entry if a is not None)


def guard_spec(spec: Sequence, shape: Sequence[int], mesh) -> Spec:
    """Drop per-dim placements that are absent from the mesh, already used
    on an earlier dim, or do not divide the dim."""
    sizes = _axis_sizes(mesh)
    entries = list(spec) + [None] * (len(shape) - len(spec))
    used: set = set()
    out = []
    for entry, dim in zip(entries, shape):
        axes = tuple(a for a in _entry_axes(entry)
                     if a in sizes and a not in used)
        size = 1
        for a in axes:
            size *= sizes[a]
        if not axes or size <= 1 or dim % size != 0:
            out.append(None)
        else:
            used.update(axes)
            out.append(axes if len(axes) > 1 else axes[0])
    return tuple(out)


def placements(spec: Sequence, mesh) -> list:
    """DTensor placements (one per mesh dim) of a guarded spec."""
    from torch.distributed.tensor import Replicate, Shard
    out = [Replicate() for _ in mesh.mesh_dim_names]
    for d, entry in enumerate(spec):
        for a in _entry_axes(entry):
            out[mesh.mesh_dim_names.index(a)] = Shard(d)
    return out


def input_sharding(mesh, shape: Sequence[int], spec: Sequence) -> list:
    """Placements for an input of the given shape, divisibility-guarded."""
    return placements(guard_spec(spec, shape, mesh), mesh)


# ------------------------------------------------------------ rule resolution


def _logical_to_entry(logical: Optional[str],
                      fsdp_axes: Tuple[str, ...]) -> Optional[Tuple[str, ...]]:
    mapped = LOGICAL_TO_MESH.get(logical)
    if mapped == "__fsdp__":
        mapped = tuple(fsdp_axes)
    return mapped


def spec_for_leaf(name: Optional[str], shape: Sequence[int], mesh,
                  rules: Dict[str, tuple],
                  fsdp_axes: Tuple[str, ...] = ("data",),
                  is_moe: bool = False) -> Spec:
    """Resolve one leaf's logical rule to a guarded spec."""
    rule = None
    if name is not None:
        if is_moe and name in MOE_FFN_LOGICAL_RULES and \
                len(shape) >= len(MOE_FFN_LOGICAL_RULES[name]):
            rule = MOE_FFN_LOGICAL_RULES[name]
        else:
            rule = rules.get(name)
    if rule is None:
        return ()
    # rules address the TRAILING dims; leading (layer-stack/expert) dims
    # replicate unless the rule names them explicitly.  A leaf with FEWER
    # dims than its rule keeps only the rule's trailing entries.
    rule = rule[-len(shape):] if shape else ()
    lead = [None] * (len(shape) - len(rule))
    entries = lead + [_logical_to_entry(l, tuple(fsdp_axes)) for l in rule]
    return guard_spec(entries, shape, mesh)


def _map_named(fn, tree, name=None):
    """``fn(name, leaf)`` over a nested dict/list/tuple, ``name`` the last
    string key on the leaf's path (list and tuple indices skipped)."""
    if isinstance(tree, dict):
        return {k: _map_named(fn, v, k if isinstance(k, str) else name)
                for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(_map_named(fn, v, f)
                            for f, v in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_named(fn, v, name) for v in tree)
    return fn(name, tree)


def tree_specs(tree: Any, rules: Dict[str, tuple], mesh, *,
               fsdp_axes: Tuple[str, ...] = ("data",),
               is_moe: bool = False) -> Any:
    """The spec tree of a parameter tree under the given logical rules."""
    return _map_named(
        lambda name, leaf: spec_for_leaf(
            name, tuple(getattr(leaf, "shape", ())), mesh, rules,
            fsdp_axes=fsdp_axes, is_moe=is_moe), tree)


def tree_shardings(tree: Any, rules: Dict[str, tuple], mesh, *,
                   fsdp_axes: Tuple[str, ...] = ("data",),
                   is_moe: bool = False) -> Any:
    """The placements tree (the DTensor form of ``tree_specs``)."""
    return _map_named(
        lambda name, leaf: placements(spec_for_leaf(
            name, tuple(getattr(leaf, "shape", ())), mesh, rules,
            fsdp_axes=fsdp_axes, is_moe=is_moe), mesh), tree)


def distribute(tree: Any, specs: Any, mesh) -> Any:
    """``tree``'s tensors as DTensors laid out by the spec at the same place
    of ``specs`` (a tree of the same structure).  Each tensor is taken as
    the global one and split (``distribute_tensor``; ``meta`` tensors move
    no data)."""
    from torch.distributed.tensor import distribute_tensor
    if isinstance(tree, dict):
        return {k: distribute(v, specs[k], mesh) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(distribute(v, s, mesh)
                            for v, s in zip(tree, specs)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(distribute(v, s, mesh)
                          for v, s in zip(tree, specs))
    if tree is None:
        return None
    return distribute_tensor(tree, mesh, placements(specs, mesh))


# ------------------------------------------------- attention over DTensors


def per_rank_attention(fn, q, k, v, **kw):
    """``fn(q, k, v, **kw)`` (an attention over ``[B, H, T, D]`` q and
    ``[B, Hkv, T, D]`` k, v) run per rank on DTensors, as tensor-parallel
    attention runs: q by batch over the data axes and heads over 'model',
    k and v likewise where their heads divide (else whole on every rank,
    each rank then keeping the kv heads its q heads read), the sequence
    whole; ``fn`` runs on the local shards and the output is q's layout.
    The redistributions are the collectives; ``fn`` never sees a
    DTensor (the dry-run: ``launch/dryrun.py``)."""
    from torch.distributed.tensor import DTensor
    mesh = q.device_mesh
    lead = batch_spec(mesh, 1)[0]
    model = "model" if "model" in mesh.mesh_dim_names else None
    (ql, q_spec), (kl, k_spec), (vl, _) = (
        _local(t, (lead, model, None, None), mesh) for t in (q, k, v))
    if q_spec[1] is not None and k_spec[1] is None:
        # this rank's q heads [r hl, (r + 1) hl) read kv heads h // g
        g = q.shape[1] // k.shape[1]
        hl = ql.shape[1]
        r = mesh.get_local_rank(model)
        lo, hi = r * hl // g, (r * hl + hl - 1) // g + 1
        kl, vl = kl[:, lo:hi], vl[:, lo:hi]
    out = fn(ql, kl, vl, **kw)
    return DTensor.from_local(out, mesh, placements(q_spec, mesh),
                              run_check=False)


MOE_LEAVES = ("router", "w_gate", "w_up", "w_down")


def per_rank_moe(fn, p, x):
    """``fn(p, x, expert_lo=...)`` (a capacity-dispatch MoE over ``[B, T,
    D]`` tokens) run per rank on DTensors, as expert parallelism with
    tokens replicated over 'model' runs: the tokens by batch over the data
    axes and whole otherwise, the router whole, each rank's experts (the
    [E] dim over 'model', as the rules lay it) whole in D and F.  ``fn``
    runs only this rank's experts, so its output is a partial sum over
    'model'."""
    from torch.distributed.tensor import DTensor, Partial
    mesh = x.device_mesh
    model = "model" if "model" in mesh.mesh_dim_names else None
    xl, x_spec = _local(x, batch_spec(mesh, 3), mesh)
    pl = {"router": _local(p["router"], (), mesh)[0]}
    for name in MOE_LEAVES[1:]:
        pl[name], w_spec = _local(p[name], (model, None, None), mesh)
    lo = 0
    out_pl = placements(x_spec, mesh)
    if w_spec[0] is not None:
        lo = mesh.get_local_rank(model) * pl["w_gate"].shape[0]
        out_pl[mesh.mesh_dim_names.index(model)] = Partial()
    out = fn(pl, h=xl, expert_lo=lo)
    return DTensor.from_local(out, mesh, out_pl, run_check=False)


# -------------------------------------------------------- data-parallel wrap


def data_parallel(fn, group=None):
    """Run ``fn`` on this rank's share of a batch: every tensor argument
    (each rank holds the whole batch, as a global array) is split on dim 0
    into the group's world size, ``fn`` runs on this rank's part, and each
    output tensor is gathered on dim 0 from every rank.

    ``fn`` must be shardwise-independent: no cross-batch reductions, each
    output carries the batch on dim 0.  (JAX's wrapper is a ``shard_map``
    over the mesh's batch axes; a process group is the port's mesh of data
    ranks.)
    """
    import torch.distributed as dist

    def wrapped(*args):
        n = dist.get_world_size(group)
        r = dist.get_rank(group)
        leaves, spec = pytree.tree_flatten(args)
        mine = [torch.tensor_split(x, n, dim=0)[r]
                if isinstance(x, torch.Tensor) else x for x in leaves]
        out = fn(*pytree.tree_unflatten(mine, spec))
        o_leaves, o_spec = pytree.tree_flatten(out)
        gathered = []
        for y in o_leaves:
            parts = [torch.empty_like(y) for _ in range(n)]
            dist.all_gather(parts, y.contiguous(), group=group)
            gathered.append(torch.cat(parts, dim=0))
        return pytree.tree_unflatten(gathered, o_spec)

    return wrapped
