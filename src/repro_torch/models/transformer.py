"""LM transformer family (port of ``repro/models/transformer.py``): the
dense GQA and MoE decoder stacks, forward and KV-cache decode.

Attention goes through ``kernels/ops.py::attention``, so a forward whose
length is a multiple of 128 runs the flash-attention kernel on the card
(its plain version on the CPU); a decode step passes a bias with one
query row, which sends it to ``kernels/ref.py`` on every device, as in
the JAX package.  The projections, the FFN and the MoE expert products
stay ``torch.matmul``.  Inference only: the loss and backward wait for
the training slice.

Parameters are nested dicts of tensors laid out as the JAX package's,
layer leaves stacked on a leading ``[L]`` axis, so ``params_from_numpy``
(``models/common.py``) carries JAX-initialised weights across.  The
JAX stack's sharding constraints (``annotate.constrain``) and remat are
for a mesh and for training; on one GPU at inference both are no-ops and
are left out.  MLA (``attn="mla"``) is not ported: the TPU kernel cannot
run its ``d_v != d_q`` call (ROADMAP queue 3), so it waits for a decision
on that kernel.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.models.common import (  # noqa: F401 (re-exported)
    apply_rope, dense_init, params_from_numpy, params_to, rms_norm, swiglu)

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    name: str = "lm"
    n_layers: int = 4
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    d_head: int = 64
    d_ff: int = 1024
    vocab: int = 1024
    max_seq: int = 8192
    attn: str = "gqa"          # "gqa" | "mla"
    # MoE (n_experts == 0 -> dense FFN)
    n_experts: int = 0
    top_k: int = 2
    capacity_factor: float = 1.25
    # MLA dims
    q_lora: int = 0            # 0 = full-rank q
    kv_lora: int = 256
    rope_dim: int = 32
    nope_dim: int = 64
    v_head_dim: int = 64
    # vocab padding: padded logits are masked to -1e30
    pad_vocab_to: int = 256
    # numerics
    param_dtype: Any = torch.bfloat16
    compute_dtype: Any = torch.bfloat16
    # training and mesh hints of the JAX config, kept so that the two
    # configs compare field for field; inference on one GPU reads none
    remat: bool = True
    remat_policy: str = "full"
    seq_shard: bool = True
    fsdp_axes: Tuple[str, ...] = ("data",)

    @property
    def moe(self) -> bool:
        return self.n_experts > 0

    @property
    def vocab_padded(self) -> int:
        m = max(self.pad_vocab_to, 1)
        return (self.vocab + m - 1) // m * m


def _check_gqa(cfg: TransformerConfig) -> None:
    if cfg.attn == "mla":
        raise NotImplementedError(
            "MLA attention is not ported: the TPU kernel cannot run its "
            "d_v != d_q call (ROADMAP.md, queue 3)")
    if cfg.attn != "gqa":
        raise ValueError(f"attn must be 'gqa' or 'mla': {cfg.attn!r}")


# --------------------------------------------------------------------------- #
# init
# --------------------------------------------------------------------------- #


def _layer_shapes(cfg: TransformerConfig) -> Dict[str, tuple]:
    """Each layer leaf's shape and dtype, in the order they are drawn."""
    d, dt, hd = cfg.d_model, cfg.param_dtype, cfg.d_head
    shapes = {
        "q_proj": ((d, cfg.n_heads * hd), dt),
        "k_proj": ((d, cfg.n_kv_heads * hd), dt),
        "v_proj": ((d, cfg.n_kv_heads * hd), dt),
        "o_proj": ((cfg.n_heads * hd, d), dt),
    }
    if cfg.moe:
        e = cfg.n_experts
        shapes["router"] = ((d, e), torch.float32)
        shapes["w_gate"] = ((e, d, cfg.d_ff), dt)
        shapes["w_up"] = ((e, d, cfg.d_ff), dt)
        shapes["w_down"] = ((e, cfg.d_ff, d), dt)
    else:
        shapes["w_gate"] = ((d, cfg.d_ff), dt)
        shapes["w_up"] = ((d, cfg.d_ff), dt)
        shapes["w_down"] = ((cfg.d_ff, d), dt)
    return shapes


def init_transformer(cfg: TransformerConfig, seed: int = 0,
                     device="cuda") -> Params:
    """Random parameters drawn on ``device`` from one ``torch.Generator``
    seeded with ``seed`` (a seed gives other numbers on the CPU than on a
    card, and other numbers than ``jax.random``: carry JAX weights across
    with ``params_from_numpy``).  Each layer's leaves are drawn one
    layer at a time and written into the stacked ``[L, ...]`` tensors, so
    no float32 copy of the whole stack is ever held."""
    _check_gqa(cfg)
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    d, dt, n = cfg.d_model, cfg.param_dtype, cfg.n_layers
    embed = dense_init(gen, (cfg.vocab_padded, d), scale=1.0, dtype=dt)
    shapes = _layer_shapes(cfg)
    layers = {name: torch.empty((n, *shape), dtype=ldt, device=device)
              for name, (shape, ldt) in shapes.items()}
    for i in range(n):
        for name, (shape, ldt) in shapes.items():
            scale = d ** -0.5 if name == "router" else None
            layers[name][i] = dense_init(gen, shape, scale=scale, dtype=ldt)
    layers["ln_attn"] = torch.ones((n, d), dtype=dt, device=device)
    layers["ln_ffn"] = torch.ones((n, d), dtype=dt, device=device)
    return {
        "embed": embed,
        "layers": layers,
        "ln_f": torch.ones((d,), dtype=dt, device=device),
        "lm_head": dense_init(gen, (d, cfg.vocab_padded), dtype=dt),
    }


def layer_params(params: Params, i: int) -> Params:
    """Layer ``i``'s leaves (views into the stack)."""
    return {k: v[i] for k, v in params["layers"].items()}


# --------------------------------------------------------------------------- #
# attention, FFN, MoE
# --------------------------------------------------------------------------- #


def _gqa_qkv(p: Params, cfg: TransformerConfig, h: torch.Tensor,
             pos: torch.Tensor):
    b, t, _ = h.shape
    q = (h @ p["q_proj"]).reshape(b, t, cfg.n_heads, cfg.d_head)
    k = (h @ p["k_proj"]).reshape(b, t, cfg.n_kv_heads, cfg.d_head)
    v = (h @ p["v_proj"]).reshape(b, t, cfg.n_kv_heads, cfg.d_head)
    q = apply_rope(q.transpose(1, 2), pos[:, None, :])
    k = apply_rope(k.transpose(1, 2), pos[:, None, :])
    return q, k, v.transpose(1, 2)


def _dense_ffn(p: Params, h: torch.Tensor) -> torch.Tensor:
    return swiglu(h, p["w_gate"], p["w_up"], p["w_down"])


def _moe_ffn(p: Params, cfg: TransformerConfig,
             h: torch.Tensor) -> torch.Tensor:
    """Top-k MoE with capacity-bucket dispatch, as the JAX package's: each
    batch row scatters its tokens into an ``[E, C, D]`` buffer (C the
    capacity; tokens past it are dropped), the experts run as batched
    products, and the outputs are gathered back and mixed by gate."""
    b, t, d = h.shape
    e, k = cfg.n_experts, cfg.top_k
    cap = max(1, int(t * k / e * cfg.capacity_factor))

    logits = h.to(torch.float32) @ p["router"]                  # [B,t,E]
    probs = torch.softmax(logits, dim=-1)
    gate, idx = torch.topk(probs, k, dim=-1)                    # [B,t,k]
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)

    flat = idx.reshape(b, t * k)                                # expert ids
    oh = F.one_hot(flat, e).to(torch.int32)                     # [B,t*k,E]
    rank_all = torch.cumsum(oh, dim=1) - 1
    rank = torch.gather(rank_all, 2, flat[..., None])[..., 0]   # [B,t*k]
    keep = rank < cap
    slot = torch.where(keep, rank, torch.zeros_like(rank)).to(torch.int64)
    rows = torch.arange(b, device=h.device)[:, None]
    tok_in_row = torch.arange(t * k, device=h.device) // k      # [t*k]

    buf = torch.zeros((b, e, cap, d), dtype=h.dtype, device=h.device)
    upd = torch.where(keep[..., None], h[:, tok_in_row, :],
                      torch.zeros((), dtype=h.dtype, device=h.device))
    buf.index_put_((rows, flat, slot), upd, accumulate=True)

    y = F.silu(torch.einsum("becd,edf->becf", buf, p["w_gate"]))
    y = y * torch.einsum("becd,edf->becf", buf, p["w_up"])
    y = torch.einsum("becf,efd->becd", y, p["w_down"])

    out = y[rows, flat, slot]                                   # [B,t*k,D]
    out = torch.where(keep[..., None], out,
                      torch.zeros((), dtype=out.dtype, device=out.device))
    out = out.reshape(b, t, k, d) * gate[..., None].to(out.dtype)
    return out.sum(dim=2)


def _ffn(p: Params, cfg: TransformerConfig, x: torch.Tensor) -> torch.Tensor:
    return _moe_ffn(p, cfg, x) if cfg.moe else _dense_ffn(p, x)


# --------------------------------------------------------------------------- #
# forward / decode
# --------------------------------------------------------------------------- #


def _layer_fn(cfg: TransformerConfig, h: torch.Tensor, pos: torch.Tensor,
              p: Params) -> torch.Tensor:
    x = rms_norm(h, p["ln_attn"])
    b, t, _ = h.shape
    q, k, v = _gqa_qkv(p, cfg, x, pos)
    ctx = ops.attention(q, k, v, causal=True)
    ctx = ctx.transpose(1, 2).reshape(b, t, -1)
    h = h + ctx @ p["o_proj"]
    x = rms_norm(h, p["ln_ffn"])
    return h + _ffn(p, cfg, x)


def _mask_pad_vocab(logits: torch.Tensor,
                    cfg: TransformerConfig) -> torch.Tensor:
    if cfg.vocab_padded == cfg.vocab:
        return logits
    pad = torch.arange(cfg.vocab_padded, device=logits.device) >= cfg.vocab
    return logits.masked_fill(pad, -1e30)


@torch.no_grad()
def forward(params: Params, tokens: torch.Tensor,
            cfg: TransformerConfig) -> torch.Tensor:
    """tokens ``[B, T]`` -> logits ``[B, T, V_padded]``, layer by layer
    over the stacked parameters."""
    _check_gqa(cfg)
    h = params["embed"][tokens].to(cfg.compute_dtype)
    pos = torch.arange(tokens.shape[1], device=tokens.device).expand(
        tokens.shape)
    for i in range(cfg.n_layers):
        h = _layer_fn(cfg, h, pos, layer_params(params, i))
    h = rms_norm(h, params["ln_f"])
    logits = h @ params["lm_head"].to(cfg.compute_dtype)
    return _mask_pad_vocab(logits, cfg)


def init_cache(cfg: TransformerConfig, batch: int, max_len: int,
               device="cuda") -> Params:
    """An empty KV cache: ``k``, ``v`` of ``[L, B, Hkv, max_len, D]`` in
    the compute dtype and ``len``, the host int of positions filled."""
    _check_gqa(cfg)
    device = resolve_device(device)
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, max_len, cfg.d_head)
    return {"k": torch.zeros(shape, dtype=cfg.compute_dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.compute_dtype, device=device),
            "len": 0}


@torch.no_grad()
def decode_step(params: Params, cache: Params, tokens: torch.Tensor,
                cfg: TransformerConfig) -> Tuple[torch.Tensor, Params]:
    """One-token decode: tokens ``[B]`` -> logits ``[B, V_padded]`` and
    the cache.

    The cache is written IN PLACE: this step's keys and values go into
    ``cache["k"]``/``cache["v"]`` at position ``cache["len"]`` (a host
    int, so no sync), and ``len`` is incremented; the dict returned is
    ``cache`` itself.  Keep a ``.clone()`` of a cache you still need.
    (The JAX step returns a new cache.)  Attention covers the positions
    up to ``len`` through a bias, so it runs ``kernels/ref.py``.
    """
    _check_gqa(cfg)
    b = tokens.shape[0]
    t_now = cache["len"]
    max_len = cache["k"].shape[3]
    if t_now >= max_len:
        raise ValueError(f"the cache is full: {t_now} of {max_len}")
    h = params["embed"][tokens][:, None].to(cfg.compute_dtype)   # [B,1,D]
    pos = torch.full((b, 1), t_now, dtype=torch.int64, device=h.device)
    live = torch.arange(max_len, device=h.device) <= t_now
    bias = torch.where(live, 0.0, -1e30).to(torch.float32)[None, None, None]
    for i in range(cfg.n_layers):
        p = layer_params(params, i)
        x = rms_norm(h, p["ln_attn"])
        q, k1, v1 = _gqa_qkv(p, cfg, x, pos)
        cache["k"][i, :, :, t_now] = k1[:, :, 0]
        cache["v"][i, :, :, t_now] = v1[:, :, 0]
        ctx = ops.attention(q, cache["k"][i], cache["v"][i], causal=False,
                            bias=bias)
        ctx = ctx.transpose(1, 2).reshape(b, 1, -1)
        h = h + ctx @ p["o_proj"]
        x = rms_norm(h, p["ln_ffn"])
        h = h + _ffn(p, cfg, x)
    cache["len"] = t_now + 1
    h = rms_norm(h, params["ln_f"])
    logits = (h @ params["lm_head"].to(cfg.compute_dtype))[:, 0]
    return _mask_pad_vocab(logits, cfg), cache
