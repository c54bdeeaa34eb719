"""Dispatching wrappers of the kernel layer.

Each wrapper picks by device: the hand-written kernel for CUDA tensors,
its plain torch version for CPU tensors.  A CUDA tensor goes to the
kernel or the call raises; nothing falls back.  Each wrapper counts its
kernel launches in a plain integer attribute (``ht_probe.launches``), and
``ht_probe.by_batch`` counts them by ``(mode, lanes)``, so a run can show
that its main path went through the kernel and with which shapes.
"""
from __future__ import annotations

from collections import Counter
from typing import Tuple

import torch

from repro_torch.kernels.ht_probe import ht_probe_cuda, ht_probe_plain


def ht_probe(tk1: torch.Tensor, tk2: torch.Tensor, tval: torch.Tensor,
             q1: torch.Tensor, q2: torch.Tensor, *, prehashed: bool = False,
             mode: str = "find",
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batched open-addressing probe: ``(slot, found, val)`` per query.

    Tables ``int32[cap]`` (``cap`` a power of two), queries ``int32[B]``;
    ``mode`` is ``"find"`` or ``"insert"`` (see ``kernels/ht_probe.py``).
    """
    if tk1.device.type == "cuda":
        out = ht_probe_cuda(tk1, tk2, tval, q1, q2, prehashed=prehashed,
                            mode=mode)
        ht_probe.launches += 1
        ht_probe.by_batch[mode, q1.shape[0]] += 1
        return out
    if tk1.device.type != "cpu":
        raise ValueError(f"ht_probe runs on CUDA or CPU tensors: "
                         f"{tk1.device}")
    return ht_probe_plain(tk1, tk2, tval, q1, q2, prehashed=prehashed,
                          mode=mode)


ht_probe.launches = 0
ht_probe.by_batch = Counter()


def reset_counts() -> None:
    """Set every kernel's launch count to 0."""
    ht_probe.launches = 0
    ht_probe.by_batch = Counter()
