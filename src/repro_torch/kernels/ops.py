"""Dispatching wrappers of the kernel layer.

Each wrapper picks by device: the hand-written kernel for CUDA tensors,
its plain torch version for CPU tensors.  A CUDA tensor goes to the
kernel or the call raises; nothing falls back.  Each kernel counts its
launches in a plain integer attribute of its wrapper, set where the
wrapper launches it and nowhere else: ``ht_probe.launches`` (with
``ht_probe.jobs``, the probe batches those launches served, and
``ht_probe.by_batch`` by each job's ``(mode, lanes)`` and
``ht_probe.by_position`` by the current mesh position;
:func:`ht_probe` and :func:`ht_probe_many` share them),
``ht_rebuild.launches``, ``intern.launches`` (with
``intern.by_position``),
``segment_reduce.launches``
(incremented by :func:`segment_reduce_csr`, forward and backward, the one
place that launches the CSR kernel; ``segment_reduce.backward_launches``
counts the backward's share) and ``attention.launches`` (with
``attention.by_variant`` by
:func:`~repro_torch.kernels.flash_attention.kernel_variant`), so a run
can show that its path went through them and which kernel ran.

The graph ops (port of ``repro/kernels/ops.py``) all reduce through the
CSR segment-reduce kernel: :func:`segment_reduce`, :func:`spmm`,
:func:`summary_spmm` (four segment sums), :func:`embedding_bag` and
:func:`minhash_signature`.
"""
from __future__ import annotations

from collections import Counter
from typing import List, Optional, Sequence

import torch
from torch.utils._python_dispatch import _get_current_dispatch_mode

from repro_torch.device import current_position
from repro_torch.kernels import ref
from repro_torch.kernels.csr_segment import (build_csr, csr_segment_cuda,
                                             csr_segment_plain)
from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                 flash_attention_plain,
                                                 kernel_variant)
from repro_torch.kernels.ht_probe import (Probe, ProbeJob, ht_probe_many_cuda,
                                          ht_probe_many_plain, probe_op)
from repro_torch.kernels.ht_rebuild import (Table, ht_rebuild_cuda,
                                            ht_rebuild_plain)
from repro_torch.kernels.intern import Ids, intern_cuda, intern_plain


def _route(t: torch.Tensor, name: str) -> bool:
    """True for a CUDA tensor (the kernel), False for a CPU one or a
    ``meta`` one (the plain version; the dry-run traces shapes on meta
    tensors); raises for any other device."""
    if t.device.type == "cuda":
        return True
    if t.device.type not in ("cpu", "meta"):
        raise ValueError(f"{name} runs on CUDA or CPU tensors: {t.device}")
    return False


def ht_probe(tk1: torch.Tensor, tk2: torch.Tensor, tval: torch.Tensor,
             q1: torch.Tensor, q2: torch.Tensor, *, prehashed: bool = False,
             mode: str = "find") -> Probe:
    """Batched open-addressing probe: ``(slot, found, val)`` per query.

    Tables ``int32[cap]`` (``cap`` a power of two), queries ``int32[B]``;
    ``mode`` is ``"find"`` or ``"insert"`` (see ``kernels/ht_probe.py``).
    """
    return ht_probe_many([(tk1, tk2, tval, q1, q2, prehashed, mode)])[0]


def ht_probe_many(jobs: Sequence[ProbeJob]) -> List[Probe]:
    """Several probe batches, each a :class:`~repro_torch.kernels.ht_probe.
    ProbeJob` ``(tk1, tk2, tval, q1, q2, prehashed, mode)`` on its own
    table, cap and mode: ``(slot, found, val)`` per job.  On the card they
    share one launch (one per ``MAX_JOBS`` kernel jobs; a stacked ``[R,
    cap]`` job is R of them, and ``ht_probe.jobs`` counts R).  On the
    CPU each job runs the plain version; on ``meta`` tensors, and on CPU
    ones under a dispatch mode (the dry-run's tracer), each job is one
    call of the custom op ``repro_torch::ht_probe``
    (:func:`~repro_torch.kernels.ht_probe.probe_op`), no launch counted."""
    if not jobs:
        return []
    if not _route(jobs[0][0], "ht_probe"):
        where = jobs[0][0].device.type
        for job in jobs:
            if job[0].device.type != where:
                name = "CPU" if where == "cpu" else "meta device"
                raise ValueError(f"every job of one call must lie on the "
                                 f"{name}: {job[0].device}")
        if where == "meta" or _get_current_dispatch_mode() is not None:
            # one op a job: a tracer sees the probe whole, as a launch
            op = probe_op()
            return [op(*job[:5], bool(job[5]), job[6] == "insert")
                    for job in jobs]
        return ht_probe_many_plain(jobs)
    out, launches = ht_probe_many_cuda(jobs)
    ht_probe.launches += launches
    ht_probe.by_position[current_position()] += launches
    for job in jobs:
        rows = job[0].shape[0] if job[0].dim() == 2 else 1
        ht_probe.jobs += rows
        ht_probe.by_batch[job[6], job[3].shape[-1]] += rows
    return out


ht_probe.launches = 0
ht_probe.jobs = 0
ht_probe.by_batch = Counter()
ht_probe.by_position = Counter()


def ht_rebuild(k1: torch.Tensor, k2: torch.Tensor, val: torch.Tensor, *,
               prehashed: bool = False) -> Table:
    """Compaction: the fresh table ``(k1, k2, val)`` that inserting every
    live entry, in old-slot order, gives (see ``kernels/ht_rebuild.py``).
    A CUDA table goes to the rebuild kernel and stays on the card (or the
    call raises); a CPU table to the sequential fold."""
    if _route(k1, "ht_rebuild"):
        out = ht_rebuild_cuda(k1, k2, val, prehashed=prehashed)
        ht_rebuild.launches += 1
        return out
    return ht_rebuild_plain(k1, k2, val, prehashed=prehashed)


ht_rebuild.launches = 0


def intern(table: Table, l2h: torch.Tensor, n_nodes: torch.Tensor,
           n_dropped: torch.Tensor, words: Sequence[torch.Tensor],
           n_cap: int) -> Ids:
    """Node interning of a stacked block of R intern states: the local ids
    ``(u, v)`` of the changes ``words = (uh, ul, vh, vl)`` (``[R, L]``),
    tables and counters written in place (see ``kernels/intern.py``).  A
    CUDA block goes to the intern kernel, one launch, and its ids stay on
    the card (or the call raises); a CPU block to the plain version."""
    if _route(table[0], "intern"):
        out = intern_cuda(table, l2h, n_nodes, n_dropped, words, n_cap)
        if out[0].numel():      # an empty block launches nothing
            intern.launches += 1
            intern.by_position[current_position()] += 1
        return out
    return intern_plain(table, l2h, n_nodes, n_dropped, words, n_cap)


intern.launches = 0
intern.by_position = Counter()


# --------------------------------------------------------------------- #
# graph ops over the CSR segment-reduce kernel
# --------------------------------------------------------------------- #


class Csr:
    """An edge list laid out by destination row: ``senders`` (int32, in
    row order) and ``row_off`` (int32[n_out + 1]); row ``r``'s edges are
    ``senders[row_off[r]:row_off[r + 1]]``.  Unpacks as ``(senders,
    row_off)``.  Keeps the transposed layouts that the segment sum's
    backward builds, so the layers that share a layout build each once."""

    def __init__(self, senders: torch.Tensor, row_off: torch.Tensor):
        self.senders = senders
        self.row_off = row_off
        self._transposed = {}

    def __iter__(self):
        return iter((self.senders, self.row_off))

    def degree(self) -> torch.Tensor:
        """Edges per row (int32[n_out])."""
        return self.row_off[1:] - self.row_off[:-1]

    def transposed(self, n_src: int) -> "Csr":
        """The same edges laid out by sender (rows ``[0, n_src)``), each
        carrying its destination row as the row to gather: ``out[s] =
        sum of g[r] over the edges r <- s`` is the segment sum's
        gradient.  Edges outside ``row_off[0]:row_off[-1]`` (receivers
        that ``build_csr`` dropped) drop out here too.  No host sync."""
        t = self._transposed.get(n_src)
        if t is None:
            e, n_out = self.senders.numel(), self.row_off.numel() - 1
            dev = self.senders.device
            off = self.row_off.to(torch.int64)
            # every edge slot's row: -1 before row_off[0], n_out after
            # row_off[-1]; those edges get sender -1, which sorts first
            # and drops out of the rows
            reps = torch.diff(off, prepend=off.new_zeros(1),
                              append=off.new_full((1,), e))
            rows = torch.repeat_interleave(
                torch.arange(-1, n_out + 1, device=dev), reps,
                output_size=e)
            live = (rows >= 0) & (rows < n_out)
            by_sender = torch.where(live, self.senders.to(torch.int64), -1)
            order, row_off = build_csr(by_sender, n_src)
            t = Csr(rows[order].to(torch.int32).contiguous(), row_off)
            self._transposed[n_src] = t
        return t


def csr_layout(senders: torch.Tensor, receivers: torch.Tensor, n_out: int,
               edge_mask: Optional[torch.Tensor] = None) -> Csr:
    """Sort the edges by receiver (stably) into a :class:`Csr`; edges
    whose mask is false, and receivers outside ``[0, n_out)``, drop out."""
    order, row_off = build_csr(receivers, n_out, edge_mask)
    return Csr(senders.reshape(-1)[order].to(torch.int32).contiguous(),
               row_off)


def _segment_reduce(layout: Csr, x: torch.Tensor, reduce: str,
                    backward: bool = False) -> torch.Tensor:
    """The kernel on a CUDA tensor (counted), the plain version on a CPU
    one."""
    if _route(x, "segment_reduce"):
        out = csr_segment_cuda(layout.senders, layout.row_off, x, reduce)
        if out.numel():
            segment_reduce.launches += 1
            segment_reduce.backward_launches += backward
        return out
    return csr_segment_plain(layout.senders, layout.row_off, x, reduce)


class _SegmentSum(torch.autograd.Function):
    """The segment sum with its gradient: ``grad_x`` is the segment sum
    of ``grad_out`` over the transposed layout, through the same kernel
    (or plain version), so the CPU runs the backward the card runs."""

    @staticmethod
    def forward(ctx, layout: Csr, x: torch.Tensor) -> torch.Tensor:
        ctx.layout, ctx.n_src = layout, x.shape[0]
        return _segment_reduce(layout, x, "sum")

    @staticmethod
    def backward(ctx, grad_out: torch.Tensor):
        if not ctx.needs_input_grad[1]:
            return None, None
        if grad_out.shape[0] == 0:      # no row, so no edge to carry back
            return None, grad_out.new_zeros((ctx.n_src, grad_out.shape[1]))
        t = ctx.layout.transposed(ctx.n_src)
        return None, _segment_reduce(t, grad_out.contiguous(), "sum",
                                     backward=True)


def segment_reduce_csr(layout: Csr, x: torch.Tensor,
                       reduce: str = "sum") -> torch.Tensor:
    """``out[r] = reduce over row r's edges of x[sender]`` (float32
    ``x[N, F]``); rows with no edge get 0, ±inf inputs pass min/max.

    Where grad mode is on and ``x`` requires grad, ``sum`` records its
    backward (:class:`_SegmentSum`); ``min``/``max`` raise
    ``NotImplementedError``: no path differentiates them (ROADMAP queue
    3)."""
    x = x.contiguous()
    if torch.is_grad_enabled() and x.requires_grad:
        if reduce != "sum":
            raise NotImplementedError(
                f"segment_reduce_csr({reduce!r}) has no backward: only sum "
                f"is differentiated (ROADMAP queue 3)")
        return _SegmentSum.apply(layout, x)
    return _segment_reduce(layout, x, reduce)


def segment_reduce(senders: torch.Tensor, receivers: torch.Tensor,
                   x: torch.Tensor, n_out: int,
                   reduce: str = "sum") -> torch.Tensor:
    """Graph message passing: ``out[r] = reduce_{e: receivers[e]==r}
    x[senders[e]]``."""
    return segment_reduce_csr(csr_layout(senders, receivers, n_out), x,
                              reduce)


segment_reduce.launches = 0
segment_reduce.backward_launches = 0


def spmm(senders: torch.Tensor, receivers: torch.Tensor,
         x: torch.Tensor) -> torch.Tensor:
    """A @ X for an edge-list adjacency (destination-major)."""
    return segment_reduce(senders, receivers, x, x.shape[0], "sum")


def summary_spmm(x, n2s, n_super, p_src, p_dst, cp_src, cp_dst,
                 cm_src, cm_dst, self_loop_super) -> torch.Tensor:
    """A @ X straight from (G*, C): |P|+|C+|+|C-| work instead of |E|.

    The terms of ``ref.summary_spmm_ref``, with each of its four segment
    sums through :func:`segment_reduce`.
    """
    n = x.shape[0]
    nodes = torch.arange(n, device=x.device)
    z = segment_reduce(nodes, n2s, x, n_super)          # supernode sums
    w = segment_reduce(p_src, p_dst, z, n_super)
    n2s = n2s.to(torch.int64)
    y = w[n2s]
    self_mask = self_loop_super[n2s][:, None]
    y = y + torch.where(self_mask, z[n2s] - x, torch.zeros_like(x))
    y = y + segment_reduce(cp_src, cp_dst, x, n)
    return y - segment_reduce(cm_src, cm_dst, x, n)


def embedding_bag(table: torch.Tensor, indices: torch.Tensor,
                  offsets: torch.Tensor, mode: str = "sum") -> torch.Tensor:
    """EmbeddingBag: bag ``b`` reduces ``table[indices[offsets[b]:
    offsets[b + 1]]]``.  The bags are already rows of a CSR (``offsets``
    is its ``row_off``), so no sort is needed."""
    if mode not in ("sum", "mean"):
        raise ValueError(f"mode must be 'sum' or 'mean': {mode!r}")
    layout = Csr(indices.to(torch.int32).contiguous(),
                 offsets.to(torch.int32).contiguous())
    out = segment_reduce_csr(layout, table, "sum")
    if mode == "mean":
        counts = torch.clamp(layout.degree(), min=1)
        out = out / counts[:, None].to(out.dtype)
    return out


def minhash_signature(senders: torch.Tensor, receivers: torch.Tensor,
                      n_nodes: int, seed: int = 0) -> torch.Tensor:
    """Bulk min-hash signatures (coarse clustering over a whole snapshot):
    the min over a node's in-edges of ``_mixhash(sender)``, taken in
    float32 through the kernel; isolated nodes get ``2^31 - 1``."""
    h = ref._mixhash(senders, seed).to(torch.float32)[:, None]
    layout = csr_layout(torch.arange(senders.shape[0], device=h.device),
                        receivers, n_nodes)
    out = ref.to_int32_saturating(segment_reduce_csr(layout, h, "min")[:, 0])
    return torch.where(layout.degree() > 0, out,
                       torch.full_like(out, ref.INT32_MAX))


# --------------------------------------------------------------------- #
# attention over the flash-attention kernel
# --------------------------------------------------------------------- #


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True,
              bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Multi-head attention with GQA: ``q[B, H, Tq, D]``, ``k[B, Hkv,
    Tk, D]``, ``v[B, Hkv, Tk, Dv]`` -> ``[B, H, Tq, Dv]`` in q's dtype.

    The JAX package's routing rule off a TPU (``repro/kernels/ops.py::
    attention``): a call with a bias, with ``Tq`` or ``Tk`` not a multiple
    of 128, or that needs a gradient (grad mode on and ``q``, ``k`` or
    ``v`` requiring grad) goes to ``ref.flash_attention_ref`` on every
    device.  That is the reference's own dispatch, which its decode step
    (``Tq = 1``, a bias) takes on a TPU too, and the function whose
    gradient JAX's trainer takes on every backend but a TPU; it is not a
    fallback.  Every other call takes the kernel route: a CUDA tensor
    launches the flash-attention kernel or raises, a CPU tensor runs its
    plain version.  The kernel route takes ``Dv != D`` at MLA's pairs
    ``(288, 256)`` and ``(32, 24)`` and computes there what the reference
    computes (the TPU kernel crashes on them: ROADMAP queue 3, fault 1).
    It raises ``ValueError`` for causal ``Tq != Tk`` and a ``(D, Dv)``
    pair the kernel is not built for (``flash_attention.check_args``).
    The kernel has no backward, as JAX's ``pallas_call`` has none; a call
    that needs one never reaches it.
    """
    from torch.distributed.tensor import DTensor
    if isinstance(q, DTensor):
        # the dry-run's sharded step: per rank, on the local shards
        from repro_torch.dist.sharding import per_rank_attention
        return per_rank_attention(attention, q, k, v, causal=causal,
                                  bias=bias)
    needs_grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v))
    if (bias is not None or q.shape[2] % 128 or k.shape[2] % 128
            or needs_grad):
        return ref.flash_attention_ref(q, k, v, causal, bias)
    if _route(q, "attention"):
        out = flash_attention_cuda(q, k, v, causal=causal)
        attention.launches += 1
        attention.by_variant[kernel_variant(q.dtype, q.shape[-1],
                                            v.shape[-1])] += 1
        return out
    return flash_attention_plain(q, k, v, causal=causal)


attention.launches = 0
attention.by_variant = Counter()


def reset_counts() -> None:
    """Set every kernel's launch count to 0."""
    ht_probe.launches = 0
    ht_probe.jobs = 0
    ht_probe.by_batch = Counter()
    ht_probe.by_position = Counter()
    ht_rebuild.launches = 0
    intern.launches = 0
    intern.by_position = Counter()
    segment_reduce.launches = 0
    segment_reduce.backward_launches = 0
    attention.launches = 0
    attention.by_variant = Counter()
