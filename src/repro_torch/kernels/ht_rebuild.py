"""Hash-table compaction: the CUDA rebuild kernel and its plain version.

Replaces the JAX package's ``repro/core/engine/hashtable.py::ht_rebuild``
(a sequential ``lax.fori_loop`` of ``ht_set``s over the old slots; XLA, not
a Pallas kernel).  Both functions here take a table ``(k1, k2, val)`` of
int32 ``[cap]`` (cap a power of two, ``k1 == EMPTY`` free, ``k1 == TOMB``
deleted) and return the fresh table that inserting every live entry
(``k1 >= 0``), in ascending order of its old slot, gives.  Tombstones
vanish and ``val`` travels with its key.  The insert order is the layout,
so the contract is bitwise: the result equals JAX's fold for plain and
prehashed tables.

**Why an insert is "the first EMPTY slot or the key's own".**  JAX's
``ht_set`` probes twice from the key's home slot: pass 1 stops at the key
or at EMPTY, and when the key is absent pass 2 takes the first EMPTY or
TOMB slot.  A fresh table holds no TOMB, so pass 2's slot is the first
EMPTY from home, which is where pass 1 stopped.  So every insert of the
fold takes the first slot from home that is EMPTY or holds the same key.
A table always keeps one EMPTY slot for the next insert (at most cap - 1
keys precede the last), so the walk ends within cap steps.

**On the card** every maximal run of the old table's non-EMPTY slots is
replayed on its own by ``csrc/ht_rebuild.cu``: the tables that this
hashtable's operations make keep each live key behind a chain of
non-EMPTY slots from its home, so a run's keys stay inside the run in the
new table (the source gives the argument).  A block takes a tile of
``TILE`` slots and a halo of ``HALO`` past it in shared memory, and
replays the runs that start in its tile from there, a bitmap of each
run's taken offsets giving every key its slot.  The kernel checks each
key's chain and the wrapper raises on a table that breaks it.

* :func:`ht_rebuild_plain` is the sequential fold on CPU tensors.  The CPU
  tests and ``maybe_compact`` on the CPU run it, and ``chip_smoke.py``
  holds the kernel to it.
* :func:`ht_rebuild_cuda` launches the kernel (:func:`launch_cuda`) into
  a table it allocates, and reads one status word.  The library is built
  with ``nvcc`` at first use into ``build/`` and loaded with ``ctypes``
  (``kernels/_build.py``).

Nothing here imports a GPU toolchain at import time.
"""
from __future__ import annotations

import ctypes
from array import array
from typing import Tuple

import numpy as np
import torch

from repro_torch.core.engine.hashtable import EMPTY, _probe_start
from repro_torch.kernels import _build

SOURCE = _build.CSRC / "ht_rebuild.cu"
# the kernel's tile and halo (kTile, kHalo in the source; the CPU tests
# hold the two equal): what the hard tables of repro_torch.testing.tables
# are shaped against
TILE = 2048
HALO = 256

Table = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def check_args(k1, k2, val) -> None:
    """Raise on what neither version takes: mixed devices, a dtype other
    than int32, a non-contiguous or non-1-D tensor, or a capacity that is
    not a power of two."""
    cap = k1.shape[0] if k1.dim() == 1 else -1
    if cap <= 0 or cap & (cap - 1) or cap > 1 << 30:
        raise ValueError(f"table capacity must be a power of two up to "
                         f"2^30: {tuple(k1.shape)}")
    for name, t in (("k1", k1), ("k2", k2), ("val", val)):
        if t.shape != (cap,):
            raise ValueError(f"{name} must have shape ({cap},): {t.shape}")
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32: {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != k1.device:
            raise ValueError(f"{name} is on {t.device}, k1 on {k1.device}")


# --------------------------------------------------------------------- #
# plain version
# --------------------------------------------------------------------- #


def ht_rebuild_plain(k1, k2, val, *, prehashed: bool = False) -> Table:
    """The sequential fold on CPU tensors: each live entry, in old-slot
    order, at the first slot from its home that is EMPTY or holds its key
    (after ``cap`` steps, its home, as ``ht_set`` would)."""
    check_args(k1, k2, val)
    if k1.device.type != "cpu":
        raise ValueError(f"ht_rebuild_plain runs on CPU tensors: "
                         f"{k1.device}")
    cap, mask = k1.shape[0], k1.shape[0] - 1
    live = np.flatnonzero(k1.numpy() >= 0)
    idx = torch.from_numpy(live)
    homes = _probe_start(k1[idx], k2[idx], cap, prehashed).tolist()
    n1 = array("i", [EMPTY]) * cap
    n2 = array("i", [EMPTY]) * cap
    nv = array("i", [0]) * cap
    for h, a, b, v in zip(homes, k1[idx].tolist(), k2[idx].tolist(),
                          val[idx].tolist()):
        x, j = h, 0
        while j < cap:
            c = n1[x]
            if c == EMPTY or (c == a and n2[x] == b):
                break
            x = (x + 1) & mask
            j += 1
        n1[x], n2[x], nv[x] = a, b, v
    return tuple(torch.from_numpy(np.frombuffer(t, np.int32).copy())
                 for t in (n1, n2, nv))


# --------------------------------------------------------------------- #
# CUDA kernel
# --------------------------------------------------------------------- #


def _bind(lib: ctypes.CDLL) -> None:
    lib.ht_rebuild_launch.argtypes = [ctypes.c_void_p] * 3 + [
        ctypes.c_uint, ctypes.c_int] + [ctypes.c_void_p] * 5
    lib.ht_rebuild_launch.restype = ctypes.c_int


def launch_cuda(k1, k2, val, out: Table, status: torch.Tensor, *,
                prehashed: bool = False) -> None:
    """Launch the kernel on the table's current stream, no sync: the
    rebuilt table into ``out`` (three int32 ``[cap]`` tensors on the same
    card, any contents), a nonzero ``status`` (one int32, zeroed by the
    caller) for a key whose chain from its home holds an EMPTY slot."""
    lib = _build.load(SOURCE, _bind)
    with torch.cuda.device(k1.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.ht_rebuild_launch(
            k1.data_ptr(), k2.data_ptr(), val.data_ptr(), k1.shape[0],
            int(prehashed), out[0].data_ptr(), out[1].data_ptr(),
            out[2].data_ptr(), status.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"ht_rebuild kernel launch failed: CUDA error "
                           f"{err}")


def ht_rebuild_cuda(k1, k2, val, *, prehashed: bool = False) -> Table:
    """The rebuilt table on the card, bitwise :func:`ht_rebuild_plain`'s:
    one launch and one host read of the status word.  Every tensor must
    lie on one CUDA device; nothing is copied to the host.  Raises on a
    table with a live key behind an EMPTY slot of its chain (no
    ``ht_set``/``ht_delete`` sequence makes one)."""
    check_args(k1, k2, val)
    if k1.device.type != "cuda":          # before building the kernel
        raise ValueError(f"ht_rebuild_cuda needs CUDA tensors: {k1.device}")
    out = tuple(torch.empty_like(t) for t in (k1, k2, val))
    status = torch.zeros(1, dtype=torch.int32, device=k1.device)
    launch_cuda(k1, k2, val, out, status, prehashed=prehashed)
    if int(status.item()):
        raise ValueError("ht_rebuild: a live key has an EMPTY slot between "
                         "its home and its slot; the kernel takes only "
                         "tables made by ht_set/ht_delete")
    return out
