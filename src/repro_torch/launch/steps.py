"""Per-family step builders: (ArchSpec, cell, mesh) -> a step the dry-run
traces (port of ``repro/launch/steps.py``).

Each builder returns ``(fn, args, in_specs, out_specs)``: every arg is a
``meta`` tensor of its global shape (or a tree of them: nothing full-size
is allocated), ``in_specs`` the spec tree that lays the args out on the
mesh (``dist/sharding.py``; ``sharding.distribute`` makes them DTensors),
``out_specs`` the layout the outputs are brought back to (``None``: as
they come).  The step is the port's own function (``train/step.py``,
``models/*``), the plain path that the CPU runs: the hand-written kernels
take CUDA tensors only, so a meta or DTensor never reaches one.
"""
from __future__ import annotations

import dataclasses
import os
from functools import partial
from typing import Dict, Optional

import torch

from repro_torch.configs.base import ArchSpec, ShapeCell
from repro_torch.dist import annotate
from repro_torch.dist import sharding as shd
from repro_torch.models import gnn as gnn_mod
from repro_torch.models import sasrec as sasrec_mod
from repro_torch.models import transformer as tfm
from repro_torch.optim import adamw
from repro_torch.train.step import make_train_step

# per-arch training knobs (memory-driven)
TRAIN_OVERRIDES: Dict[str, dict] = {
    "llama3-405b": dict(n_microbatches=8, moment_dtype=torch.bfloat16),
    "internlm2-20b": dict(n_microbatches=2, moment_dtype=torch.float32),
    "moonshot-v1-16b-a3b": dict(n_microbatches=2, moment_dtype=torch.float32),
}


def _opt_cfg(arch_id: str) -> adamw.AdamWConfig:
    ov = TRAIN_OVERRIDES.get(arch_id, {})
    return adamw.AdamWConfig(moment_dtype=ov.get("moment_dtype",
                                                 torch.float32))


def _data_spec(mesh, rank: int):
    return shd.batch_spec(mesh, rank)


def _meta(inputs: dict, names) -> tuple:
    return tuple(inputs[n].meta() for n in names)


def _opt(params, specs, opt_cfg):
    """The optimizer state of ``params`` (meta) and its specs: the moments
    laid out as the parameters, the step count replicated."""
    opt = adamw.init(params, opt_cfg)
    return opt, adamw.AdamWState(step=(), m=specs, v=specs)


# ------------------------------------------------------------------------- #
# LM family
# ------------------------------------------------------------------------- #


def build_lm(spec: ArchSpec, cell: ShapeCell, mesh, smoke: bool = False,
             n_layers: Optional[int] = None):
    """``n_layers`` cuts the depth (the dry-run traces 1 and 2 layers and
    extrapolates: the layers are identical)."""
    annotate.set_mesh(mesh)
    cfg = spec.make_smoke_config() if smoke else spec.make_config()
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    inputs = cell.inputs(cfg)
    params = tfm.init_transformer(cfg, device="meta")
    p_specs = shd.tree_specs(params, shd.LM_RULES, mesh,
                             fsdp_axes=cfg.fsdp_axes, is_moe=cfg.moe)

    if cell.kind == "train":
        opt_cfg = _opt_cfg(spec.arch_id)
        nm = TRAIN_OVERRIDES.get(spec.arch_id, {}).get("n_microbatches", 1)
        nm = int(os.environ.get("REPRO_MICRO", nm))  # the JAX package's knob
        loss = partial(tfm.loss_fn, cfg=cfg)
        step = make_train_step(lambda p, t, l: loss(p, t, l), opt_cfg,
                               n_microbatches=1 if smoke else nm)
        opt, o_specs = _opt(params, p_specs, opt_cfg)
        b_specs = tuple(shd.guard_spec(_data_spec(mesh, 2), inputs[k].shape,
                                       mesh) for k in ("tokens", "labels"))
        args = (params, opt) + _meta(inputs, ("tokens", "labels"))
        return step, args, (p_specs, o_specs) + b_specs, \
            (p_specs, o_specs, None)

    if cell.kind == "prefill":
        fn = partial(tfm.forward, cfg=cfg)
        tok = shd.guard_spec(_data_spec(mesh, 2), inputs["tokens"].shape, mesh)
        return (lambda p, t: fn(p, t)), (params, inputs["tokens"].meta()), \
            (p_specs, tok), None

    # decode
    cb, cl = inputs["cache_batch"], inputs["cache_len"]
    cache = tfm.init_cache(cfg, cb, cl, device="meta")
    dax = shd.batch_axes(mesh)
    dax = dax if len(dax) > 1 else (dax[0] if dax else None)
    model_ok = "model" in mesh.mesh_dim_names

    def cache_spec(shape):
        # shard batch over data axes, cache length over model (keeps the
        # per-rank KV slice bounded on the 500k/32k cells)
        if len(shape) == 4:   # mla: [L, B, S, d]
            return (None, dax, "model" if model_ok else None, None)
        if len(shape) == 5:   # gqa: [L, B, Hkv, S, d]
            return (None, dax, None, "model" if model_ok else None, None)
        return ()

    tensors = {k: v for k, v in cache.items() if isinstance(v, torch.Tensor)}
    c_specs = {k: shd.guard_spec(cache_spec(v.shape), v.shape, mesh)
               for k, v in tensors.items()}
    tok = shd.guard_spec((dax,), inputs["tokens"].shape, mesh)
    fn = partial(tfm.decode_step, cfg=cfg)

    def step(p, c, t):
        logits, c = fn(p, dict(c, len=cl - 1), t)
        return logits, {k: c[k] for k in tensors}
    return step, (params, tensors, inputs["tokens"].meta()), \
        (p_specs, c_specs, tok), (None, c_specs)


# ------------------------------------------------------------------------- #
# GNN family
# ------------------------------------------------------------------------- #


def build_gnn(spec: ArchSpec, cell: ShapeCell, mesh, smoke: bool = False):
    annotate.set_mesh(mesh)
    cfg = spec.make_smoke_config() if smoke else spec.make_config()
    # widen the input projection to the cell's feature dim (JAX's builder
    # does so at full width only; its smoke configs then miss the cell)
    f = cell.inputs(cfg)["node_feat"].shape[1]
    cfg = dataclasses.replace(cfg, d_in=f)
    inputs = cell.inputs(cfg)
    params = gnn_mod.init_gnn(cfg, device="meta")
    p_specs = shd.tree_specs(params, shd.GNN_RULES, mesh)

    all_axes = tuple(a for a in ("pod", "data", "model")
                     if a in mesh.mesh_dim_names)
    row = all_axes if len(all_axes) > 1 else (all_axes[0] if all_axes
                                              else None)
    field_names = list(inputs.keys())

    def to_batch(**kw):
        return gnn_mod.GraphBatch(
            node_feat=kw["node_feat"], senders=kw["senders"],
            receivers=kw["receivers"], edge_mask=kw["edge_mask"],
            node_mask=kw["node_mask"], labels=kw["labels"],
            coords=kw.get("coords"), triplet_kj=kw.get("triplet_kj"),
            triplet_ji=kw.get("triplet_ji"))

    opt_cfg = _opt_cfg(spec.arch_id)
    step = make_train_step(
        lambda p, *arrs: gnn_mod.gnn_loss(
            p, to_batch(**dict(zip(field_names, arrs))), cfg), opt_cfg)
    opt, o_specs = _opt(params, p_specs, opt_cfg)
    arr_specs = tuple(
        shd.guard_spec((row, *([None] * (len(inputs[n].shape) - 1))),
                       inputs[n].shape, mesh) for n in field_names)
    args = (params, opt) + _meta(inputs, field_names)
    return step, args, (p_specs, o_specs) + arr_specs, \
        (p_specs, o_specs, None)


# ------------------------------------------------------------------------- #
# recsys family
# ------------------------------------------------------------------------- #


def build_recsys(spec: ArchSpec, cell: ShapeCell, mesh,
                 smoke: bool = False):
    cfg = spec.make_smoke_config() if smoke else spec.make_config()
    inputs = cell.inputs(cfg)
    params = sasrec_mod.init_sasrec(cfg, device="meta")
    p_specs = shd.tree_specs(params, shd.RECSYS_RULES, mesh)
    dspec = _data_spec(mesh, 2)

    if cell.kind == "train":
        opt_cfg = _opt_cfg(spec.arch_id)
        step = make_train_step(
            lambda p, s, po, ne: sasrec_mod.train_loss(p, s, po, ne, cfg),
            opt_cfg)
        opt, o_specs = _opt(params, p_specs, opt_cfg)
        b_specs = tuple(shd.guard_spec(dspec, inputs[k].shape, mesh)
                        for k in ("seq", "pos", "neg"))
        args = (params, opt) + _meta(inputs, ("seq", "pos", "neg"))
        return step, args, (p_specs, o_specs) + b_specs, \
            (p_specs, o_specs, None)

    fn = partial(sasrec_mod.score_candidates, cfg=cfg)
    cand = shd.guard_spec(("model" if "model" in mesh.mesh_dim_names
                           else None,), inputs["candidates"].shape, mesh)
    args = (params,) + _meta(inputs, ("seq", "candidates"))
    return (lambda p, s, c: fn(p, s, c)), args, \
        (p_specs, shd.guard_spec(dspec, inputs["seq"].shape, mesh), cand), \
        None


# ------------------------------------------------------------------------- #
# mosso family: sharded summarization (edge-partitioned engines)
# ------------------------------------------------------------------------- #


def state_leaves(st) -> Dict[str, torch.Tensor]:
    """An engine state's tensors by name (a table's words as
    ``adj.k1``, ...)."""
    out = {}
    for f in dataclasses.fields(st):
        v = getattr(st, f.name)
        if isinstance(v, torch.Tensor):
            out[f.name] = v
        else:
            for w in ("k1", "k2", "val"):
                out[f"{f.name}.{w}"] = getattr(v, w)
    return out


def build_mosso(spec: ArchSpec, cell: ShapeCell, mesh, smoke: bool = False):
    """Each rank steps one engine replica over its own batch of changes,
    then the ranks sum ``phi`` (JAX's ``shard_map`` of ``step_fn`` with one
    ``psum``).  The args are the replicas stacked on a leading rank dim,
    sharded over every mesh axis, so each rank holds one state.  The
    engine's step reads the host (its trial loop) and cannot run on meta
    tensors, so no step comes back (``fn`` is ``None``): the dry-run
    reports the state's bytes and the one all-reduce."""
    from repro_torch.core.engine.state import new_state

    cfg = spec.make_smoke_config() if smoke else spec.make_config()
    inputs = cell.inputs(cfg)
    n_dev = mesh.size()
    axes = tuple(mesh.mesh_dim_names)
    lead = axes if len(axes) > 1 else axes[0]

    state1 = state_leaves(new_state(cfg, "meta"))
    stacked = {k: torch.empty((n_dev, *v.shape), dtype=v.dtype, device="meta")
               for k, v in state1.items()}
    st_specs = {k: shd.guard_spec((lead,), v.shape, mesh)
                for k, v in stacked.items()}
    ch = tuple(torch.empty((n_dev, *inputs[k].shape), dtype=inputs[k].dtype,
                           device="meta") for k in ("u", "v", "ins"))
    ch_specs = tuple(shd.guard_spec((lead,), c.shape, mesh) for c in ch)
    return None, (stacked,) + ch, (st_specs,) + ch_specs, \
        (st_specs, ch_specs[0])


BUILDERS = {"lm": build_lm, "gnn": build_gnn, "recsys": build_recsys,
            "mosso": build_mosso}


def build(spec: ArchSpec, cell: ShapeCell, mesh, smoke: bool = False,
          **kw):
    return BUILDERS[spec.family](spec, cell, mesh, smoke, **kw)
