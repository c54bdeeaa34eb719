"""SASRec (self-attentive sequential recommendation, arXiv:1808.09781),
port of ``repro/models/sasrec.py``.

An item-embedding table and causal self-attention blocks over user
histories (item id 0 is padding).  Training is BCE over the next item
against a sampled negative; serving scores candidates against the last
position's state.  ``seq_len`` is 50 (smoke 12), never a multiple of
128, so ``ops.attention`` sends every call to the reference on every
device, as in the JAX package: the path runs no hand-written kernel.

Parameters are a nested dict (``blocks`` a list of dicts) laid out as
the JAX package's, so ``params_from_numpy`` carries JAX weights across.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.models.common import (  # noqa: F401 (re-exported)
    dense_init, layer_norm, params_from_numpy, params_to)

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class SASRecConfig:
    name: str = "sasrec"
    n_items: int = 1_000_000
    embed_dim: int = 50
    n_blocks: int = 2
    n_heads: int = 1
    seq_len: int = 50
    dropout: float = 0.0
    param_dtype: Any = torch.float32


def init_sasrec(cfg: SASRecConfig, seed: int = 0, device="cuda") -> Params:
    """Random parameters drawn on ``device`` from one ``torch.Generator``
    seeded with ``seed`` (other numbers than ``jax.random``: carry JAX
    weights across with ``params_from_numpy``).  On the ``meta`` device
    nothing is drawn: the tree holds the shapes only."""
    device = resolve_device(device)
    d, dt = cfg.embed_dim, cfg.param_dtype
    if device.type == "meta":
        def draw(shape, scale=None):
            return torch.empty(shape, dtype=dt, device=device)
    else:
        gen = torch.Generator(device=device).manual_seed(seed)

        def draw(shape, scale=None):
            return dense_init(gen, shape, scale=scale, dtype=dt)
    item_emb = draw((cfg.n_items, d), scale=d ** -0.5)
    pos_emb = draw((cfg.seq_len, d), scale=0.02)
    blocks = []
    for _ in range(cfg.n_blocks):
        blk = {name: draw((d, d))
               for name in ("wq", "wk", "wv", "wo", "ff1", "ff2")}
        blk["ln1"] = torch.ones((d,), dtype=dt, device=device)
        blk["ln2"] = torch.ones((d,), dtype=dt, device=device)
        blocks.append(blk)
    return {"item_emb": item_emb, "pos_emb": pos_emb, "blocks": blocks,
            "ln_f": torch.ones((d,), dtype=dt, device=device)}


def _ln(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return layer_norm(x, w, torch.zeros_like(w))


def encode(params: Params, seq: torch.Tensor,
           cfg: SASRecConfig) -> torch.Tensor:
    """seq: int32 ``[B, L]`` item ids (0 = padding) -> representations
    ``[B, L, D]``; a padded position's state is 0 after every block."""
    b, L = seq.shape
    h = params["item_emb"][seq.long()] + params["pos_emb"][None, :L]
    pad = (seq == 0)[..., None]
    zero = torch.zeros((), dtype=h.dtype, device=h.device)
    h = torch.where(pad, zero, h)
    nh = cfg.n_heads
    dh = cfg.embed_dim // nh
    for blk in params["blocks"]:
        x = _ln(h, blk["ln1"])
        q, k, v = ((x @ blk[w]).reshape(b, L, nh, dh).transpose(1, 2)
                   for w in ("wq", "wk", "wv"))
        ctx = ops.attention(q, k, v, causal=True)
        ctx = ctx.transpose(1, 2).reshape(b, L, cfg.embed_dim)
        h = h + ctx @ blk["wo"]
        x = _ln(h, blk["ln2"])
        h = h + torch.relu(x @ blk["ff1"]) @ blk["ff2"]
        h = torch.where(pad, zero, h)
    return _ln(h, params["ln_f"])


def train_loss(params: Params, seq: torch.Tensor, pos: torch.Tensor,
               neg: torch.Tensor, cfg: SASRecConfig) -> torch.Tensor:
    """BCE over (positive next item, sampled negative) per position; a
    position whose positive is padding counts for nothing."""
    h = encode(params, seq, cfg)
    pe = params["item_emb"][pos.long()]
    ne = params["item_emb"][neg.long()]
    pos_logit = torch.sum(h * pe, dim=-1).to(torch.float32)
    neg_logit = torch.sum(h * ne, dim=-1).to(torch.float32)
    mask = (pos != 0).to(torch.float32)
    loss = (F.softplus(-pos_logit) + F.softplus(neg_logit)) * mask
    return torch.sum(loss) / torch.clamp(torch.sum(mask), min=1)


def score_candidates(params: Params, seq: torch.Tensor,
                     candidates: torch.Tensor,
                     cfg: SASRecConfig) -> torch.Tensor:
    """User state vs candidate scores: ``[B, L]`` x int32 ``[C]`` -> float32
    ``[B, C]``, one ``[B, D] @ [D, C]`` product (retrieval's B = 1,
    C = 10^6 included)."""
    h = encode(params, seq, cfg)[:, -1]                   # [B, D]
    emb = params["item_emb"][candidates.long()]           # [C, D]
    return (h @ emb.T).to(torch.float32)


def serve_topk(params: Params, seq: torch.Tensor, candidates: torch.Tensor,
               cfg: SASRecConfig, k: int = 10,
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` best candidates per user, ``(scores, positions in
    candidates)``, in ``lax.top_k``'s order: descending, the lower
    position first among equal scores.  ``torch.topk`` does not promise
    that order on a card, so this takes a stable descending sort."""
    scores = score_candidates(params, seq, candidates, cfg)
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k].to(torch.int32)
