"""Shared model building blocks (port of ``repro/models/common.py``)."""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device


def dense_init(gen: torch.Generator, shape: Sequence[int],
               scale: Optional[float] = None,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """A truncated normal in [-2, 2] times ``scale`` (default
    ``fan_in ** -0.5``, ``fan_in = shape[0]``), drawn from ``gen`` on the
    generator's device.  The same seed gives other numbers than
    ``jax.random``; carry JAX weights across with ``params_from_numpy``."""
    fan_in = shape[0] if len(shape) > 1 else 1
    scale = scale if scale is not None else fan_in ** -0.5
    t = torch.empty(tuple(shape), dtype=torch.float32, device=gen.device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (t * scale).to(dtype)


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.to(torch.float32)
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * w.to(torch.float32) + b.to(torch.float32)).to(dt)


def rms_norm(x: torch.Tensor, w: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.to(torch.float32)
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * w.to(torch.float32)).to(dt)


def rope_freqs(d: int, max_pos: int, base: float = 10000.0) -> torch.Tensor:
    """Rotary angles ``[max_pos, d // 2]`` in float32."""
    inv = 1.0 / (base ** (torch.arange(0, d, 2, dtype=torch.float32) / d))
    t = torch.arange(max_pos, dtype=torch.float32)
    return torch.outer(t, inv)


def apply_rope(x: torch.Tensor, pos: torch.Tensor,
               base: float = 10000.0) -> torch.Tensor:
    """Rotary embedding of ``x[..., T, D]`` (D even) at integer positions
    ``pos`` (broadcastable to ``[..., T]``), in the JAX package's roll form
    ``x cos + sign roll(x, D/2) sin`` with float32 angles and full-width
    tables (the same rotation as the split-halves form up to ~1 ulp)."""
    d = x.shape[-1]
    half = d // 2
    dev = x.device
    idx = torch.arange(d, dtype=torch.float32, device=dev) % half
    inv = base ** (-2.0 * idx / d)
    ang = pos.to(torch.float32)[..., None] * inv              # [..., T, D]
    sign = torch.where(torch.arange(d, device=dev) < half, -1.0, 1.0)
    xf = x.to(torch.float32)
    rot = torch.roll(xf, half, dims=-1)
    return (xf * torch.cos(ang) + sign * rot * torch.sin(ang)).to(x.dtype)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    return (torch.nn.functional.silu(x @ w_gate) * (x @ w_up)) @ w_down


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean token NLL in float32 (a stable logsumexp); with ``mask``, the
    mean over the positions it marks.

    The label's logit is picked by a compare and a sum over the classes,
    which is exact (every other term is a zero) and keeps a class dim
    sharded over ranks sharded: a gather along it has no such layout in
    DTensor, whose gather backward builds replicated zeros of the whole
    logits (the dry-run, ``launch/dryrun.py``)."""
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    classes = torch.arange(logits.shape[-1], device=logits.device)
    hit = classes == labels.long()[..., None]
    ll = torch.sum(torch.where(hit, logits, 0.0), dim=-1)
    nll = lse - ll
    if mask is not None:
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1)
    return torch.mean(nll)


def param_count(params) -> int:
    """Elements over every tensor of a nested dict/list of parameters."""
    if isinstance(params, torch.Tensor):
        return params.numel()
    items = params.values() if isinstance(params, dict) else params
    return sum(param_count(p) for p in items)


def tree_map(fn, tree):
    """``fn`` over the tensors of a nested dict/list of parameters."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def tree_leaves(tree) -> list:
    """The tensors of a nested dict/list, in :func:`tree_map`'s order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_unflatten(tree, leaves):
    """``tree``'s structure with its tensors replaced, in
    :func:`tree_leaves`'s order, by ``leaves``."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def params_to(params, device):
    """A copy of the parameters on ``device``."""
    device = resolve_device(device)
    return tree_map(lambda t: t.to(device), params)


def _from_numpy(a) -> torch.Tensor:
    a = np.array(a)
    if a.dtype.name == "bfloat16":
        # JAX's bfloat16 reaches numpy as ml_dtypes.bfloat16, which
        # torch.from_numpy rejects: carry the bits as uint16
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def params_from_numpy(tree, device="cuda"):
    """The port's parameters from the JAX package's, as
    ``jax.tree.map(np.asarray, init_...(cfg, key))`` gives them."""
    device = resolve_device(device)
    return tree_map(lambda a: _from_numpy(a).to(device), tree)
