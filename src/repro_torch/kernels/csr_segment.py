"""CSR segment-reduce: the layout pass, the CUDA kernel and its plain version.

Replaces the Pallas kernel ``repro/kernels/csr_segment.py::_kernel``
(wrapper ``csr_segment_reduce``, layout pass ``build_blocked_csr``).  With
the edges sorted by destination row, both functions here compute

    out[r] = reduce over edges e of row r of x[senders[e]]

for ``reduce`` in ``sum``/``min``/``max``; a row with no edge gets 0, and
for min/max that is decided by the row's edge count, so ±inf inputs pass
through.

* :func:`build_csr` is the layout pass: a stable sort of the edges by
  receiver (as ``jnp.argsort`` in ``build_blocked_csr``) and per-row
  offsets.  The TPU kernel's offsets are per 128-row block; a per-row CSR
  lets the GPU kernel's warps split a block's rows by their edge counts.
* :func:`csr_segment_cuda` launches ``csrc/csr_segment.cu`` (the source
  says what bounds it and how it is laid out) with the launch plan of
  :func:`launch_plan`.  The library is built with ``nvcc`` at first use
  into ``build/`` and loaded with ``ctypes`` (``kernels/_build.py``).
* :func:`csr_segment_plain` is a gather plus ``index_add_`` /
  ``scatter_reduce_`` with the count mask, in chunks of edges so that the
  gathered rows stay small.  The CPU tests run it, and ``chip_smoke.py``
  holds the kernel to it on the card.

Nothing here imports a GPU toolchain at import time.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import _build

REDUCES = ("sum", "min", "max")
SOURCE = _build.CSRC / "csr_segment.cu"
PLAIN_CHUNK = 1 << 26        # gathered elements per chunk of the plain version
SLOTS = (1, 2, 3, 4, 6, 8, 10, 12)   # vectors a lane of a wide row: the builds
LANE_FLOATS = 20             # floats of a row a lane gathers at once


def build_csr(receivers: torch.Tensor, n_out: int,
              edge_mask: Optional[torch.Tensor] = None,
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(order, row_off)``: ``order`` (int64) lists the kept edges sorted
    by receiver, stably, so a row keeps its edges in their input order;
    row ``r``'s edges are ``order[row_off[r]:row_off[r + 1]]``
    (``row_off`` int32[n_out + 1]).

    Edges whose ``edge_mask`` is false are dropped here, and so are
    receivers outside ``[0, n_out)``, as ``jax.ops.segment_sum`` drops
    them: a negative receiver sorts before row 0, so ``row_off[0]`` counts
    those edges.  No host sync.  A ``meta`` tensor holds no values (the
    dry-run), so there every edge is kept: the layout's largest shape.
    """
    if receivers.numel() >= 2 ** 31:
        raise ValueError(f"too many edges for int32 offsets: "
                         f"{receivers.numel()}")
    r = receivers.reshape(-1).to(torch.int64)
    if edge_mask is not None and r.device.type == "meta":
        edge_mask = None
    if edge_mask is not None:
        keep = torch.nonzero(edge_mask.reshape(-1)).flatten()
        r = r[keep]
    sorted_r, order = torch.sort(r, stable=True)
    if edge_mask is not None:
        order = keep[order]
    bounds = torch.arange(n_out + 1, device=r.device, dtype=torch.int64)
    return order, torch.searchsorted(sorted_r, bounds).to(torch.int32)


def check_args(senders, row_off, x, reduce: str) -> None:
    """Raise on what neither version takes."""
    if reduce not in REDUCES:
        raise ValueError(f"reduce must be one of {REDUCES}: {reduce!r}")
    if senders.dim() != 1 or row_off.dim() != 1 or row_off.numel() < 1:
        raise ValueError(f"senders and row_off must be 1-D (row_off of "
                         f"n_out + 1): {tuple(senders.shape)}, "
                         f"{tuple(row_off.shape)}")
    if x.dim() != 2:
        raise ValueError(f"x must be [N, F]: {tuple(x.shape)}")
    for name, t, dt in (("senders", senders, torch.int32),
                        ("row_off", row_off, torch.int32),
                        ("x", x, torch.float32)):
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}: {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    if x.shape[0] == 0 and senders.numel():
        raise ValueError("x has no rows to gather")


# --------------------------------------------------------------------- #
# plain version
# --------------------------------------------------------------------- #


def csr_segment_plain(senders: torch.Tensor, row_off: torch.Tensor,
                      x: torch.Tensor, reduce: str = "sum") -> torch.Tensor:
    """The kernel's function in plain torch, on any device: ``senders``
    (int32[E], in row order), ``row_off`` (int32[n_out + 1]), ``x``
    (float32[N, F]) -> float32[n_out, F]."""
    check_args(senders, row_off, x, reduce)
    n_out, f = row_off.numel() - 1, x.shape[1]
    counts = (row_off[1:] - row_off[:-1]).to(torch.int64)
    if x.device.type == "meta":
        return _plain_shapes(senders, x, n_out, reduce)
    first = int(row_off[0])
    rows = torch.repeat_interleave(
        torch.arange(n_out, device=x.device), counts)
    src = senders[first:first + rows.numel()].to(torch.int64)
    init = {"sum": 0.0, "min": float("inf"), "max": float("-inf")}[reduce]
    out = torch.full((n_out, f), init, dtype=torch.float32, device=x.device)
    step = max(1, PLAIN_CHUNK // max(f, 1))
    for lo in range(0, rows.numel(), step):
        idx, msgs = rows[lo:lo + step], x[src[lo:lo + step]]
        if reduce == "sum":
            out.index_add_(0, idx, msgs)
        else:
            # include_self over the ±inf init, so chunks compose
            out.scatter_reduce_(0, idx[:, None].expand_as(msgs), msgs,
                                "amin" if reduce == "min" else "amax",
                                include_self=True)
    if reduce != "sum":
        out = torch.where((counts > 0)[:, None], out, torch.zeros_like(out))
    return out


def _plain_shapes(senders: torch.Tensor, x: torch.Tensor, n_out: int,
                 reduce: str) -> torch.Tensor:
    """The plain version's ops on ``meta`` tensors, which hold no values
    (the dry-run): every edge's row gathered and reduced into ``n_out``
    rows, with the senders standing in for the edges' rows (each row's
    edge count lives in ``row_off``'s values)."""
    idx = senders.to(torch.int64)
    msgs = x.index_select(0, idx)
    out = torch.zeros((n_out, x.shape[1]), dtype=torch.float32,
                      device=x.device)
    if reduce == "sum":
        return out.index_add(0, idx, msgs)
    return out.scatter_reduce(0, idx[:, None].expand_as(msgs), msgs,
                              "amin" if reduce == "min" else "amax")


# --------------------------------------------------------------------- #
# CUDA kernel
# --------------------------------------------------------------------- #


class Plan(NamedTuple):
    """How the kernel covers a row of ``F`` floats: ``vec`` floats a load
    (4, 2 or 1); ``lanes`` lanes an edge (32: a wide row, each lane
    ``slots`` vectors of each of ``chunks`` grid columns; fewer: a narrow
    row, 32 / ``lanes`` edges at once).  A block takes 32 rows."""
    vec: int
    lanes: int
    slots: int
    chunks: int


def launch_plan(f: int, x_ptr: int) -> Plan:
    """The kernel's launch plan for ``x[:, F]`` at address ``x_ptr``: the
    widest load that ``F`` and the address allow; a narrow row where its
    vectors fit in 16 lanes; else the fewest slots (of :data:`SLOTS`, up
    to :data:`LANE_FLOATS` floats a lane) that cover the row in the
    fewest grid columns."""
    vec = (4 if f % 4 == 0 and x_ptr % 16 == 0 else
           2 if f % 2 == 0 and x_ptr % 8 == 0 else 1)
    w = f // vec
    if w <= 16:
        lanes = 1 << max(w - 1, 0).bit_length()
        slots = chunks = 1
    else:
        lanes = 32
        most = max(s for s in SLOTS if s * vec <= LANE_FLOATS)
        chunks = -(-w // (32 * most))
        slots = min(s for s in SLOTS if 32 * s * chunks >= w)
    return Plan(vec, lanes, slots, chunks)


def _bind(lib: ctypes.CDLL) -> None:
    lib.csr_segment_launch.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong] + [
        ctypes.c_int] * 5 + [ctypes.c_void_p]
    lib.csr_segment_launch.restype = ctypes.c_int


def csr_segment_cuda(senders: torch.Tensor, row_off: torch.Tensor,
                     x: torch.Tensor, reduce: str = "sum") -> torch.Tensor:
    """Launch the kernel on the current stream (no sync).  Every tensor
    must lie on one CUDA device."""
    check_args(senders, row_off, x, reduce)
    if x.device.type != "cuda":
        raise ValueError(f"csr_segment_cuda needs CUDA tensors: {x.device}")
    return launch(_build.load(SOURCE, _bind), senders, row_off, x, reduce)


def launch(lib: ctypes.CDLL, senders: torch.Tensor, row_off: torch.Tensor,
           x: torch.Tensor, reduce: str) -> torch.Tensor:
    """One launch of ``lib``'s kernel (a build of ``csrc/csr_segment.cu``)
    on checked CUDA tensors, with :func:`launch_plan`'s plan."""
    n_out, f = row_off.numel() - 1, x.shape[1]
    out = torch.empty((n_out, f), dtype=torch.float32, device=x.device)
    plan = launch_plan(f, x.data_ptr())
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.csr_segment_launch(
            senders.data_ptr(), row_off.data_ptr(), x.data_ptr(),
            out.data_ptr(), n_out, x.shape[0], senders.numel(), f,
            REDUCES.index(reduce), plan.vec, plan.slots, plan.lanes, stream)
    if err != 0:
        raise RuntimeError(f"csr_segment kernel launch failed: CUDA error "
                           f"{err}")
    return out
