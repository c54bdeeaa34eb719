"""Train-step factory: loss -> grads -> AdamW, with microbatch
accumulation (port of ``repro/train/step.py``).

``make_train_step`` builds the step ``launch/train.py`` runs.  Gradients
come from torch autograd over a detached copy of the parameters; the
step returns new parameters and a new optimizer state, as JAX's does.
The batch is pinned to the mesh's data axes with
``annotate.constrain_batch`` (the identity without a mesh, or on a tensor
that is not a DTensor), as JAX's is, and so is each microbatch: DTensor
cannot keep a batch sharding through the ``[n_micro, B / n_micro]``
reshape when ``n_micro`` does not divide by the data ranks, where GSPMD
reshards on its own.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.dist import annotate
from repro_torch.models.common import tree_leaves, tree_map, tree_unflatten
from repro_torch.optim import adamw


def value_and_grad(loss_fn: Callable, params, *batch):
    """``(loss, grads)`` of ``loss_fn(params, *batch)``: the loss detached,
    the grads a tree like ``params`` (zeros where a leaf gets none)."""
    live = tree_map(lambda p: p.detach().requires_grad_(True), params)
    leaves = tree_leaves(live)
    with torch.enable_grad():
        loss = loss_fn(live, *batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    return loss.detach(), tree_unflatten(params, grads)


def make_train_step(loss_fn: Callable, opt_cfg: adamw.AdamWConfig,
                    n_microbatches: int = 1):
    """loss_fn(params, *batch_parts) -> scalar.

    Batch parts must have a leading batch dim divisible by
    ``n_microbatches``; the microbatches' losses and gradients are summed
    in float32, then divided by their count, as JAX's ``scan`` does.
    """

    def train_step(params, opt_state, *batch):
        batch = tuple(annotate.constrain_batch(x) for x in batch)
        if n_microbatches == 1:
            loss, grads = value_and_grad(loss_fn, params, *batch)
        else:
            loss = torch.zeros((), dtype=torch.float32,
                               device=opt_state.step.device)
            grads = tree_map(lambda p: torch.zeros_like(
                p, dtype=torch.float32), params)
            for i in range(n_microbatches):
                parts = tuple(annotate.constrain_batch(
                    x.reshape(n_microbatches, -1, *x.shape[1:])[i])
                    for x in batch)
                l, g = value_and_grad(loss_fn, params, *parts)
                loss = loss + l
                grads = tree_unflatten(grads, [
                    a + b for a, b in zip(tree_leaves(grads),
                                          tree_leaves(g))])
            loss = loss / n_microbatches
            grads = tree_map(lambda g: g / n_microbatches, grads)
        params, opt_state, metrics = adamw.update(grads, opt_state, params,
                                                  opt_cfg)
        metrics = dict(metrics, loss=loss)
        return params, opt_state, metrics

    return train_step


def make_eval_step(loss_fn: Callable):
    @torch.no_grad()
    def eval_step(params, *batch):
        return loss_fn(params, *batch)
    return eval_step
