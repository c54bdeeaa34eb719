"""Plain torch oracles of the graph ops and attention (port of
``repro/kernels/ref.py``).

The semantics of record for the port's graph ops, written independently
of the kernel's CSR layout: a gather and a scatter over the edge list.
They run on any device; the CPU tests hold them to the JAX package's
``ref.py``.  uint32 hash arithmetic runs in int64 with ``& 0xFFFFFFFF``
masks (torch on the CPU has no uint32 ``>>``).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

M32 = 0xFFFFFFFF
INT32_MAX = 2 ** 31 - 1
_INIT = {"sum": 0.0, "min": float("inf"), "max": float("-inf")}


def _scatter(msgs: torch.Tensor, ids: torch.Tensor, n: int,
             reduce: str) -> torch.Tensor:
    """Reduce the rows of ``msgs`` into ``n`` segments by ``ids``; ids
    outside ``[0, n)`` are dropped (as ``jax.ops.segment_*`` drop them);
    an empty segment keeps the reduction's identity."""
    ids = ids.to(torch.int64)
    keep = (ids >= 0) & (ids < n)
    ids, msgs = ids[keep], msgs[keep]
    out = torch.full((n,) + tuple(msgs.shape[1:]), _INIT[reduce],
                     dtype=msgs.dtype, device=msgs.device)
    if reduce == "sum":
        return out.index_add_(0, ids, msgs)
    idx = ids.reshape((-1,) + (1,) * (msgs.dim() - 1)).expand_as(msgs)
    return out.scatter_reduce_(0, idx, msgs,
                               "amin" if reduce == "min" else "amax",
                               include_self=True)


def segment_reduce_ref(senders: torch.Tensor, receivers: torch.Tensor,
                       x: torch.Tensor, n_out: int, reduce: str = "sum",
                       ) -> torch.Tensor:
    """out[r] = reduce over edges e with receivers[e]==r of x[senders[e]]."""
    if reduce not in _INIT:
        raise ValueError(reduce)
    out = _scatter(x[senders.to(torch.int64)], receivers, n_out, reduce)
    if reduce == "sum":
        return out
    # zero EMPTY segments only: ±inf inputs survive a nonempty min/max
    cnt = _scatter(torch.ones_like(receivers, dtype=torch.int64), receivers,
                   n_out, "sum")
    mask = (cnt > 0).reshape((n_out,) + (1,) * (out.dim() - 1))
    return torch.where(mask, out, torch.zeros_like(out))


def summary_spmm_ref(x, n2s, n_super, p_src, p_dst, cp_src, cp_dst,
                     cm_src, cm_dst, self_loop_super) -> torch.Tensor:
    """Y = A @ X from the summary (G*, C) without materialising A.

    Y[u] = sum over superedges {S_u, B} of sum_{v in B} X[v] (+ the
    clique of S_u minus u itself when (S_u, S_u) is a superedge) + C+
    terms - C- terms.  Superedges come in both directions in
    (p_src, p_dst) except self-pairs, flagged in ``self_loop_super``;
    C+/C- node pairs come in both directions.
    """
    n2s = n2s.to(torch.int64)
    z = _scatter(x, n2s, n_super, "sum")                  # supernode sums
    w = _scatter(z[p_src.to(torch.int64)], p_dst, n_super, "sum")
    y = w[n2s]
    self_mask = self_loop_super[n2s][:, None]
    y = y + torch.where(self_mask, z[n2s] - x, torch.zeros_like(x))
    y = y + _scatter(x[cp_src.to(torch.int64)], cp_dst, x.shape[0], "sum")
    y = y - _scatter(x[cm_src.to(torch.int64)], cm_dst, x.shape[0], "sum")
    return y


def dense_spmm_ref(senders: torch.Tensor, receivers: torch.Tensor,
                   x: torch.Tensor) -> torch.Tensor:
    """Plain edge-list A @ X."""
    return _scatter(x[senders.to(torch.int64)], receivers, x.shape[0], "sum")


def embedding_bag_ref(table: torch.Tensor, indices: torch.Tensor,
                      offsets: torch.Tensor, mode: str = "sum",
                      ) -> torch.Tensor:
    """``torch.nn.EmbeddingBag`` semantics by gather + segment sum;
    ``offsets`` int[B + 1] are the bag boundaries."""
    b = offsets.shape[0] - 1
    pos = torch.arange(indices.shape[0], device=indices.device)
    bag_ids = torch.searchsorted(offsets.to(torch.int64), pos,
                                 right=True) - 1
    summed = _scatter(table[indices.to(torch.int64)], bag_ids, b, "sum")
    if mode == "sum":
        return summed
    counts = torch.clamp(offsets[1:] - offsets[:-1], min=1)
    return summed / counts[:, None].to(summed.dtype)


def to_int32_saturating(f: torch.Tensor) -> torch.Tensor:
    """float -> int32 clamped into range, as XLA's convert does (torch's
    cast of an out-of-range float is undefined); ``f`` must be finite."""
    return f.to(torch.int64).clamp(-INT32_MAX - 1, INT32_MAX).to(torch.int32)


def minhash_signature_ref(senders: torch.Tensor, receivers: torch.Tensor,
                          n_nodes: int, seed: int = 0) -> torch.Tensor:
    """Min-hash signature per node: min over neighbors of hash(nbr)."""
    h = _mixhash(senders, seed).to(torch.float32)
    out = _scatter(h, receivers, n_nodes, "min")
    out = torch.where(torch.isfinite(out), out,
                      torch.full_like(out, float(INT32_MAX)))
    return to_int32_saturating(out)


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """``a * c mod 2^32`` for ``a`` in [0, 2^32), split so that no int64
    product overflows."""
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & M32


def _mixhash(x: torch.Tensor, seed: int) -> torch.Tensor:
    """The oracle's uint32 mix, masked by ``0x7FFFFFFE`` (not the engine's
    ``mixhash``); int64 in, int64 values in [0, 2^31) out."""
    h = (_mul32(x.to(torch.int64) & M32, 0x9E3779B9) + (seed & M32)) & M32
    h = _mul32(h ^ (h >> 16), 0x85EBCA6B)
    h = h ^ (h >> 13)
    return h & 0x7FFFFFFE


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True,
                        bias: Optional[torch.Tensor] = None,
                        q_chunk: int = 1024) -> torch.Tensor:
    """Reference multi-head attention: ``q[B, H, Tq, D]``, ``k[B, Hkv, Tk,
    D]``, ``v[B, Hkv, Tk, Dv]`` -> ``[B, H, Tq, Dv]``.

    Scores in q's dtype divided by ``sqrt(D)`` (cast to q's dtype), then
    float32 with ``bias`` added; the causal mask is aligned bottom-right
    (query ``i`` sees keys ``<= i + Tk - Tq``); KV heads are repeated over
    their query groups; ``Dv`` may differ from ``D`` (MLA attends over the
    latent).  Query lengths above ``q_chunk`` that it divides run in chunks
    of ``q_chunk`` rows, so the score matrix is never whole.
    """
    b, h, tq, d = q.shape
    hkv = k.shape[1]
    if hkv != h:        # GQA: repeat the KV heads over their query groups
        k = torch.repeat_interleave(k, h // hkv, dim=1)
        v = torch.repeat_interleave(v, h // hkv, dim=1)
    tk = k.shape[2]
    root = torch.tensor(math.sqrt(d), dtype=torch.float32).to(q.dtype)

    def block(qb: torch.Tensor, qpos: torch.Tensor) -> torch.Tensor:
        scores = (qb @ k.transpose(-1, -2)) / root.to(qb.device)
        scores = scores.to(torch.float32)
        if bias is not None:
            scores = scores + bias
        if causal:
            kpos = torch.arange(tk, device=q.device)
            mask = qpos[:, None] + (tk - tq) >= kpos[None, :]
            scores = torch.where(mask, scores,
                                 torch.full_like(scores, -1e30))
        probs = torch.softmax(scores, dim=-1)
        return probs.to(v.dtype) @ v

    qpos = torch.arange(tq, device=q.device)
    if tq <= q_chunk or tq % q_chunk:
        return block(q, qpos)
    return torch.cat([block(q[:, :, lo:lo + q_chunk], qpos[lo:lo + q_chunk])
                      for lo in range(0, tq, q_chunk)], dim=2)
