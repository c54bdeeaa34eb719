"""Where the port's entry points run: a CUDA device unless asked for the
CPU; and which mesh position the host is working for.

The sharded tier steps the positions of its mesh in turn
(:func:`repro_torch.dist.router.for_positions`); the launch and host-read
counters of the kernel and engine layers also count by
:func:`current_position`.
"""
from __future__ import annotations

import contextlib
from typing import Iterator, Optional

import torch

_position: Optional[int] = None


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device must be there, never
    a silent CPU fallback."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible; pass device='cpu' to run on the CPU")
    return device


def current_position() -> Optional[int]:
    """The mesh position the host is working for, or None outside
    :func:`at_position`."""
    return _position


@contextlib.contextmanager
def at_position(index: int, device: torch.device) -> Iterator[None]:
    """Work for mesh position ``index``, whose device is ``device``: the
    current CUDA device is ``device`` (on a CUDA one) and the counters
    count under ``index``."""
    global _position
    prev, _position = _position, index
    try:
        if device.type == "cuda":
            with torch.cuda.device(device):
                yield
        else:
            yield
    finally:
        _position = prev
