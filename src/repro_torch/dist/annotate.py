"""Logical-axis annotation helpers for model code (port of
``repro/dist/annotate.py``).

Model forward passes declare *where an activation wants to live* without
naming a concrete mesh::

    h = annotate.constrain(h, annotate.data_axes(), "model", None)

The mesh is installed by the launcher (``set_mesh``).  With no mesh
installed, or with an input that is not a DTensor, every helper returns
its input unchanged, so single-device runs, the CPU tests and the card
never touch a process group.  Each per-dim entry may be ``None``
(replicated), a mesh axis name, or a tuple of axis names; entries that
reference axes absent from the installed mesh, or that do not divide the
dimension, are dropped rather than erroring (``sharding.guard_spec``):
the constraint is a placement hint, not a shape contract.  Where it
applies, a DTensor is redistributed to the spec's placements (JAX's
``with_sharding_constraint``): a ``Partial`` sum becomes a reduce-scatter
or an all-reduce, a replicated dim a local slice.
"""
from __future__ import annotations

from typing import Tuple, Union

import torch

AxisSpec = Union[None, str, Tuple[str, ...]]

_MESH = None


def set_mesh(mesh) -> None:
    """Install the ``DeviceMesh`` consumed by later ``constrain`` calls."""
    global _MESH
    _MESH = mesh


def get_mesh():
    return _MESH


def clear_mesh() -> None:
    set_mesh(None)


def data_axes() -> Tuple[str, ...]:
    """Mesh axes carrying data parallelism (empty without a mesh)."""
    if _MESH is None:
        return ()
    from repro_torch.dist.sharding import batch_axes
    return batch_axes(_MESH)


def model_axes() -> Tuple[str, ...]:
    if _MESH is None:
        return ()
    return tuple(a for a in ("model",) if a in _MESH.mesh_dim_names)


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def constrain(x: torch.Tensor, *axes: AxisSpec) -> torch.Tensor:
    """Redistribute a DTensor to the spec's placements on the installed
    mesh (or identity).

    One ``AxisSpec`` per tensor dim; invalid placements degrade to
    replicated per-dim (via the shared ``sharding.guard_spec``) instead of
    failing, so model code stays mesh-shape agnostic.  A spec that guards
    to all-replicated is no constraint, as in JAX.
    """
    if _MESH is None:
        return x
    if len(axes) != x.ndim:
        raise ValueError(
            f"constrain got {len(axes)} axis specs for rank-{x.ndim} tensor")
    if not _is_dtensor(x):
        return x
    from repro_torch.dist.sharding import guard_spec, placements
    spec = guard_spec(axes, x.shape, _MESH)
    if all(e is None for e in spec):
        return x
    want = tuple(placements(spec, _MESH))
    if tuple(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


def constrain_batch(x: torch.Tensor) -> torch.Tensor:
    """Shard the leading (batch) dim over the data axes; identity
    otherwise."""
    if _MESH is None or x.ndim == 0:
        return x
    return constrain(x, data_axes(), *([None] * (x.ndim - 1)))
