"""Node interning: the CUDA intern kernel and its plain version.

Replaces the JAX package's ``repro/dist/router.py::intern_changes`` (a
batch pre-lookup, then a ``lax.scan`` of ``_intern_one`` over the changes;
XLA, not a Pallas kernel).  Both functions here take a stacked block of R
intern states, each leaf with a leading ``[R]`` axis:

* ``table``: the ``h2l`` hash table ``(k1, k2, val)``, int32 ``[R, cap]``
  (cap a power of two), probed prehashed (start ``(k1 ^ k2) & (cap - 1)``);
* ``l2h`` int32 ``[R, n_cap, 2]``, ``n_nodes`` and ``n_dropped`` int32
  ``[R]``;
* ``words``: the changes' label-hash words ``(uh, ul, vh, vl)``, int32
  ``[R, L]`` views with one pair of strides (the columns of the router's
  ``[R, L, 5]`` buckets), ``-1`` padded,

and return the local ids ``(u, v)``, int32 ``[R, L]``, writing the tables
and counters in place: row ``r`` interned exactly as JAX interns it, for
either of JAX's lowerings (its ``dense`` flag changes how XLA lowers the
scan, not the bits).  Endpoints go in order ``u_0, v_0, u_1, ...``; a key
the table held at entry takes its id; every other key of a valid change
is probed against the table as it stands, so a repeat of a key this call
interned finds it; a miss takes ``n_nodes`` (inserted at the first EMPTY
or TOMB slot from its start) while ``n_nodes < n_cap``, else adds one to
``n_dropped``; ``u``/``v`` are -1 unless both endpoints got an id.  The
insert order is the table layout, so the contract is bitwise.

* :func:`intern_plain` is that sequence on CPU tensors, step by step.  The
  CPU tests hold it to JAX, and ``chip_smoke.py`` holds the kernel to it.
* :func:`intern_cuda` launches ``csrc/intern.cu`` (one block a row: the
  keys not found at entry deduplicated, ranked by a prefix sum and placed
  in parallel where their first free slots differ; the source says what
  bounds it) on the tensors' device, built with ``nvcc`` at first use
  into ``build/`` and loaded with ``ctypes`` (``kernels/_build.py``).

Nothing here imports a GPU toolchain at import time.
"""
from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.engine.hashtable import EMPTY, M32, TOMB
from repro_torch.kernels import _build

SOURCE = _build.CSRC / "intern.cu"

Table = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
Ids = Tuple[torch.Tensor, torch.Tensor]


def check_args(table: Table, l2h, n_nodes, n_dropped,
               words: Sequence[torch.Tensor], n_cap: int) -> Tuple[int, int]:
    """Raise on what neither version takes; returns ``(R, L)``.  Every
    tensor int32 on one CPU or CUDA device; the tables, ``l2h`` and the
    counters contiguous; the four words ``[R, L]`` with equal strides.
    One pass over the ten tensors: a kernel call pays it on the host."""
    k1 = table[0]
    device = k1.device
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"intern runs on CUDA or CPU tensors: {device}")
    if k1.dim() != 2:
        raise ValueError(f"the table must be [R, cap]: {tuple(k1.shape)}")
    n_rep, cap = k1.shape
    if cap <= 0 or cap & (cap - 1) or cap > 1 << 30:
        raise ValueError(f"table capacity must be a power of two up to "
                         f"2^30: {cap}")
    if len(words) != 4:
        raise ValueError(f"words are (uh, ul, vh, vl): {len(words)}")
    lanes = (n_rep, words[0].shape[1] if words[0].dim() == 2 else -1)
    row, rows = (n_rep, cap), (n_rep,)
    for n, (t, shape) in enumerate(zip(
            (*table, l2h, n_nodes, n_dropped, *words),
            (row, row, row, (n_rep, n_cap, 2), rows, rows) + (lanes,) * 4)):
        if t.shape != shape:
            raise ValueError(f"intern expects shape {tuple(shape)}: "
                             f"{tuple(t.shape)}")
        if t.dtype is not torch.int32:
            raise TypeError(f"intern takes int32 tensors: {t.dtype}")
        if t.device != device:
            raise ValueError(f"a tensor is on {t.device}, the table on "
                             f"{device}")
        if n < 6 and not t.is_contiguous():
            raise ValueError("the tables, l2h and the counters must be "
                             "contiguous")
    strides = words[0].stride()
    if any(w.stride() != strides for w in words[1:]):
        raise ValueError(f"the four words must share strides: "
                         f"{[w.stride() for w in words]}")
    return n_rep, lanes[1]


# --------------------------------------------------------------------- #
# plain version
# --------------------------------------------------------------------- #


def _find(k1: np.ndarray, k2: np.ndarray, h1: int, h2: int,
          cap: int) -> Tuple[int, bool]:
    """``ht_find``'s walk from the prehashed start: (chain end, found)."""
    x = ((h1 & M32) ^ (h2 & M32)) & (cap - 1)
    for _ in range(cap):
        c = int(k1[x])
        if c == EMPTY:
            return x, False
        if c == h1 and int(k2[x]) == h2:
            return x, True
        x = (x + 1) & (cap - 1)
    return x, False


def _free_slot(k1: np.ndarray, h1: int, h2: int, cap: int) -> int:
    """The upsert's second pass: the first EMPTY or TOMB slot from the
    start within ``cap`` steps, else the start."""
    start = ((h1 & M32) ^ (h2 & M32)) & (cap - 1)
    for i in range(cap):
        x = (start + i) & (cap - 1)
        if int(k1[x]) in (EMPTY, TOMB):
            return x
    return start


def intern_plain(table: Table, l2h, n_nodes, n_dropped,
                 words: Sequence[torch.Tensor], n_cap: int) -> Ids:
    """The intern on CPU tensors, in place: the pre-lookup of every
    endpoint against the tables at entry, then each other endpoint in
    order (see the module docstring)."""
    n_rep, n_lanes = check_args(table, l2h, n_nodes, n_dropped, words,
                                n_cap)
    if table[0].device.type != "cpu":
        raise ValueError(f"intern_plain runs on CPU tensors: "
                         f"{table[0].device}")
    cap = table[0].shape[1]
    # numpy views of the tensors: writes land in them
    k1, k2, val = (t.numpy() for t in table)
    l2h_np, nn_np, nd_np = l2h.numpy(), n_nodes.numpy(), n_dropped.numpy()
    uh, ul, vh, vl = (w.numpy() for w in words)
    u = np.full((n_rep, n_lanes), -1, np.int32)
    v = np.full((n_rep, n_lanes), -1, np.int32)
    for r in range(n_rep):
        t1, t2, tv = k1[r], k2[r], val[r]
        lanes = np.flatnonzero((uh[r] >= 0) & (vh[r] >= 0))
        keys = [[(int(h[r, i]), int(lo[r, i])) for i in lanes]
                for h, lo in ((uh, ul), (vh, vl))]
        # the pre-lookup, against the table at entry
        pre = [[_find(t1, t2, a, b, cap) for a, b in side] for side in keys]
        pre_val = [[int(tv[x]) if hit else None for x, hit in side]
                   for side in pre]
        nn, nd = int(nn_np[r]), int(nd_np[r])
        for n, i in enumerate(lanes):
            ids = []
            for side in (0, 1):
                nid = pre_val[side][n]
                if nid is None:
                    a, b = keys[side][n]
                    x, hit = _find(t1, t2, a, b, cap)
                    if hit:
                        nid = int(tv[x])
                    elif nn < n_cap:
                        x = _free_slot(t1, a, b, cap)
                        t1[x], t2[x], tv[x] = a, b, nn
                        l2h_np[r, nn] = (a, b)
                        nid, nn = nn, nn + 1
                    else:
                        nd += 1
                        nid = -1
                ids.append(nid)
            if ids[0] >= 0 and ids[1] >= 0:
                u[r, i], v[r, i] = ids
        nn_np[r], nd_np[r] = nn, nd
    return torch.from_numpy(u), torch.from_numpy(v)


# --------------------------------------------------------------------- #
# CUDA kernel
# --------------------------------------------------------------------- #


def _bind(lib: ctypes.CDLL) -> None:
    lib.intern_launch.argtypes = (
        [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_uint,
         ctypes.c_int] + [ctypes.c_void_p] * 10 + [ctypes.c_longlong] * 2
        + [ctypes.c_void_p] * 3)
    lib.intern_launch.restype = ctypes.c_int


def intern_cuda(table: Table, l2h, n_nodes, n_dropped,
                words: Sequence[torch.Tensor], n_cap: int) -> Ids:
    """One launch of the kernel on the tensors' device and its current
    stream, no sync; ``(u, v)`` on the card (views of one ``[2, R, L]``
    allocation), bitwise :func:`intern_plain`'s.  Every tensor must lie on
    one CUDA device; the launcher sets that device for the launch itself,
    so the caller's current device does not matter."""
    n_rep, n_lanes = check_args(table, l2h, n_nodes, n_dropped, words,
                                n_cap)
    device = table[0].device
    if device.type != "cuda":            # before building the kernel
        raise ValueError(f"intern_cuda needs CUDA tensors: {device}")
    uv = torch.empty((2, n_rep, n_lanes), dtype=torch.int32, device=device)
    if n_rep == 0 or n_lanes == 0:
        return uv[0], uv[1]
    lib = _build.load(SOURCE, _bind)
    index = device.index
    if index is None:
        index = torch.cuda.current_device()
    u_ptr = uv.data_ptr()
    err = lib.intern_launch(
        index, n_rep, n_lanes, table[0].shape[1], n_cap,
        *(t.data_ptr() for t in (*table, l2h, n_nodes, n_dropped, *words)),
        *words[0].stride(), u_ptr, u_ptr + 4 * n_rep * n_lanes,
        torch._C._cuda_getCurrentRawStream(index))
    if err != 0:
        raise RuntimeError(f"intern kernel launch failed: CUDA error {err}")
    return uv[0], uv[1]
