"""AdamW with a low-precision moment option (port of
``repro/optim/adamw.py``).

Plain tensor ops in the JAX package's order of float32 casts: JAX leaves
the update to XLA (no Pallas kernel), so the port needs no kernel here.
The state mirrors the parameter tree (nested dicts and lists), and the
update is functional: it returns new parameters and a new state.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

from repro_torch.models.common import (params_from_numpy, tree_leaves,
                                       tree_map, tree_unflatten)


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moment_dtype: Any = torch.float32   # bf16 for memory-bound giants
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


class AdamWState(NamedTuple):
    step: torch.Tensor      # int32, 0-d
    m: Any
    v: Any


def init(params, cfg: AdamWConfig) -> AdamWState:
    zeros = lambda p: torch.zeros(p.shape, dtype=cfg.moment_dtype,  # noqa
                                  device=p.device)
    step = torch.zeros((), dtype=torch.int32,
                       device=tree_leaves(params)[0].device)
    return AdamWState(step=step, m=tree_map(zeros, params),
                      v=tree_map(zeros, params))


def schedule(step: torch.Tensor, cfg: AdamWConfig) -> torch.Tensor:
    """Linear warm-up, then a cosine down to ``min_lr_frac`` of ``lr``
    (float32)."""
    step = step.to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos)


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in tree_leaves(tree)))


@torch.no_grad()
def update(grads, state: AdamWState, params, cfg: AdamWConfig):
    """Returns ``(new_params, new_state, metrics)``; the moments are kept
    in ``cfg.moment_dtype`` and the sums in float32."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    step = state.step + 1
    lr = schedule(step, cfg)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - b1 ** step.to(torch.float32)
    bc2 = 1 - b2 ** step.to(torch.float32)

    def upd(p, g, m, v):
        g = g.to(torch.float32) * scale
        m32 = b1 * m.to(torch.float32) + (1 - b1) * g
        v32 = b2 * v.to(torch.float32) + (1 - b2) * g * g
        mhat = m32 / bc1
        vhat = v32 / bc2
        p32 = p.to(torch.float32)
        step_ = mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * p32
        return ((p32 - lr * step_).to(p.dtype), m32.to(cfg.moment_dtype),
                v32.to(cfg.moment_dtype))

    out = [upd(*leaves) for leaves in zip(
        tree_leaves(params), tree_leaves(grads), tree_leaves(state.m),
        tree_leaves(state.v))]
    newp, newm, newv = (tree_unflatten(params, [o[i] for o in out])
                        for i in range(3))
    return newp, AdamWState(step=step, m=newm, v=newv), {
        "grad_norm": gnorm, "lr": lr}


def opt_state_from_numpy(state, device="cuda") -> AdamWState:
    """The port's state from the JAX package's, as ``jax.tree.map(
    np.asarray, adamw.init(...))`` gives it."""
    step, m, v = state
    return AdamWState(*params_from_numpy((step, m, v), device))


def opt_state_to_numpy(state: AdamWState) -> AdamWState:
    """Numpy arrays in the JAX package's layout: ``AdamWState(step, m,
    v)`` with the moments as nested dicts and lists (bfloat16 moments as
    float32, which holds them exactly: numpy has no bfloat16)."""
    def to_np(t):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return AdamWState(to_np(state.step), tree_map(to_np, state.m),
                      tree_map(to_np, state.v))
