"""Batched hash-table probe: the CUDA kernel and its plain torch version.

Replaces the Pallas kernel ``repro/kernels/ht_probe.py::_probe_kernel``
(wrapper ``ht_probe_batch``).  Both functions here compute, per lane, one
linear-probe chain of the key ``(q1, q2)`` and return ``(slot, found,
val)``: ``mode="find"`` stops at the key or at EMPTY (``ht_find``);
``mode="insert"`` adds the upsert's second pass to the first EMPTY/TOMB
slot when the key is absent (``_find_insert_slot``).  ``val`` is read at
the key's find-chain end whether or not the key was found.  The contract
is bitwise: the probe sequence is the table layout.

* :func:`ht_probe_cuda` launches ``csrc/ht_probe.cu`` (one thread per
  lane; the source says what bounds it).  The shared library is built
  with ``nvcc`` at first use into ``build/`` at the repository root, from
  this checkout's source, and loaded with ``ctypes`` (``kernels/_build.py``).
* :func:`ht_probe_plain` is the uniform masked loop over the whole batch
  of ``_probe_kernel``, in ``int64`` torch.  The CPU tests run it, and
  ``chip_smoke.py`` holds the kernel to it on the card.

Nothing here imports a GPU toolchain at import time: the CPU tests import
this module.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.core.engine.hashtable import EMPTY, TOMB, _probe_start
from repro_torch.kernels import _build

MODES = ("find", "insert")
SOURCE = _build.CSRC / "ht_probe.cu"


def check_args(tk1, tk2, tval, q1, q2, mode: str) -> None:
    """Raise on what neither version takes: mixed devices, a dtype other
    than int32, a non-contiguous or non-1-D tensor, a capacity that is
    not a power of two, or an unknown mode."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}: {mode!r}")
    cap = tk1.shape[0]
    if cap <= 0 or cap & (cap - 1):
        raise ValueError(f"table capacity must be a power of two: {cap}")
    for name, t in (("tk1", tk1), ("tk2", tk2), ("tval", tval)):
        if t.shape != (cap,):
            raise ValueError(f"{name} must have shape ({cap},): {t.shape}")
    if q1.dim() != 1 or q2.shape != q1.shape:
        raise ValueError(f"queries must be 1-D and of one shape: "
                         f"{tuple(q1.shape)} vs {tuple(q2.shape)}")
    for name, t in (("tk1", tk1), ("tk2", tk2), ("tval", tval),
                    ("q1", q1), ("q2", q2)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32: {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != tk1.device:
            raise ValueError(f"{name} is on {t.device}, the table on "
                             f"{tk1.device}")


# --------------------------------------------------------------------- #
# plain version
# --------------------------------------------------------------------- #


def probe_chains(tk1, tk2, q1, q2, *, prehashed: bool, mode: str,
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(start, i1, i2)`` per lane, all int64: the chain start, the
    pass-1 offset where the find chain ends and, in insert mode, the
    pass-2 offset of the first free slot (zeros in find mode).

    Each pass is one uniform loop over the batch: a lane's offset
    advances while its scalar loop would go on and freezes once it
    stops, and the loop runs until every lane froze.
    """
    cap = tk1.shape[0]
    start = _probe_start(q1, q2, cap, prehashed)

    def chain(stop_fn):
        i = torch.zeros_like(start)
        done = torch.zeros(start.shape, dtype=torch.bool, device=start.device)
        while not bool(done.all()):
            slot = (start + i) & (cap - 1)
            done = done | stop_fn(tk1[slot], tk2[slot]) | (i >= cap)
            i = torch.where(done, i, i + 1)
        return i

    i1 = chain(lambda a, b: ((a == q1) & (b == q2)) | (a == EMPTY))
    if mode == "find":
        return start, i1, torch.zeros_like(i1)
    i2 = chain(lambda a, b: (a == EMPTY) | (a == TOMB))
    return start, i1, i2


def ht_probe_plain(tk1, tk2, tval, q1, q2, *, prehashed: bool = False,
                   mode: str = "find",
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kernel's function in plain torch, on any device."""
    check_args(tk1, tk2, tval, q1, q2, mode)
    cap = tk1.shape[0]
    start, i1, i2 = probe_chains(tk1, tk2, q1, q2, prehashed=prehashed,
                                 mode=mode)
    slot1 = (start + i1) & (cap - 1)
    found = (tk1[slot1] == q1) & (tk2[slot1] == q2)
    slot = slot1
    if mode == "insert":
        slot = torch.where(found, slot1, (start + i2) & (cap - 1))
    return slot.to(torch.int32), found, tval[slot1]


# --------------------------------------------------------------------- #
# CUDA kernel
# --------------------------------------------------------------------- #


def _bind(lib: ctypes.CDLL) -> None:
    lib.ht_probe_launch.argtypes = [ctypes.c_void_p] * 8 + [
        ctypes.c_int, ctypes.c_uint, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p]
    lib.ht_probe_launch.restype = ctypes.c_int


def ht_probe_cuda(tk1, tk2, tval, q1, q2, *, prehashed: bool = False,
                  mode: str = "find",
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the kernel on the current stream (no sync).  Every tensor
    must lie on one CUDA device."""
    check_args(tk1, tk2, tval, q1, q2, mode)
    if tk1.device.type != "cuda":
        raise ValueError(f"ht_probe_cuda needs CUDA tensors: {tk1.device}")
    n = q1.shape[0]
    if n >= 2 ** 31:
        raise ValueError(f"too many lanes for one launch: {n}")
    slot = torch.empty_like(q1)
    found = torch.empty(q1.shape, dtype=torch.bool, device=q1.device)
    val = torch.empty_like(q1)
    lib = _build.load(SOURCE, _bind)
    with torch.cuda.device(tk1.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.ht_probe_launch(
            tk1.data_ptr(), tk2.data_ptr(), tval.data_ptr(), q1.data_ptr(),
            q2.data_ptr(), slot.data_ptr(), found.data_ptr(), val.data_ptr(),
            n, tk1.shape[0], int(mode == "insert"), int(prehashed), stream)
    if err != 0:
        raise RuntimeError(f"ht_probe kernel launch failed: CUDA error {err}")
    return slot, found, val
