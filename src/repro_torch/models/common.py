"""Shared model building blocks (port of ``repro/models/common.py``)."""
from __future__ import annotations

from typing import Optional, Sequence

import torch


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
