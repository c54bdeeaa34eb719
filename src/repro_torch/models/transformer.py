"""LM transformer family (port of ``repro/models/transformer.py``): the
dense and MoE decoder stacks with GQA or MLA attention, forward and
KV-cache decode.

Attention goes through ``kernels/ops.py::attention``, so a forward whose
length is a multiple of 128 runs the flash-attention kernel on the card
(its plain version on the CPU); a decode step passes a bias with one
query row, which sends it to ``kernels/ref.py`` on every device, as in
the JAX package.  The projections, the FFN and the MoE expert products
stay ``torch.matmul``.  :func:`loss_fn` trains through the same layers;
the attention kernel has no backward (nor has the TPU kernel), so a
training call must take the reference route (``train.py`` trains at
T = 64), and the kernel route raises under autograd.

Parameters are nested dicts of tensors laid out as the JAX package's,
layer leaves stacked on a leading ``[L]`` axis, so ``params_from_numpy``
(``models/common.py``) carries JAX-initialised weights across.  The
JAX stack's sharding constraint on the residual (``annotate.constrain``)
is the identity without an installed mesh, and its remat (policy
``"full"``: ``torch.utils.checkpoint`` of each layer) acts only under
autograd with ``cfg.remat`` (every smoke config turns it off).

MLA (``attn="mla"``, MiniCPM3/DeepSeek-V2 style) caches the compressed
latent ``c_kv`` and the shared rope key, not per-head keys and values,
and attends matrix-absorbed: ``W_kb`` is folded into the query, so every
head attends with one KV head over ``[c_kv, k_rope]`` (``kv_lora +
rope_dim`` wide) and takes ``c_kv`` itself as its value (``kv_lora``
wide), then the context expands through ``W_vb``.  That is an attention
call with ``d_v != d_q``, which the kernel route takes at minicpm3-4b's
widths (``kernels/flash_attention.py``); the TPU kernel crashes on it
(ROADMAP queue 3, fault 1).
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch.device import resolve_device
from repro_torch.dist import annotate
from repro_torch.kernels import ops
from repro_torch.models.common import (  # noqa: F401 (re-exported)
    apply_rope, cross_entropy, dense_init, params_from_numpy, params_to,
    rms_norm, swiglu)

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


def _check_attn(cfg: TransformerConfig) -> None:
    if cfg.attn not in ("gqa", "mla"):
        raise ValueError(f"attn must be 'gqa' or 'mla': {cfg.attn!r}")


def _vdim(cfg: TransformerConfig) -> int:
    return cfg.v_head_dim if cfg.attn == "mla" else cfg.d_head


# --------------------------------------------------------------------------- #
# init
# --------------------------------------------------------------------------- #


def _layer_shapes(cfg: TransformerConfig) -> Dict[str, tuple]:
    """Each drawn layer leaf's shape and dtype, in the order they are
    drawn (the norm weights, all ones, are added beside them)."""
    d, dt, hd, nh = cfg.d_model, cfg.param_dtype, cfg.d_head, cfg.n_heads
    if cfg.attn == "gqa":
        shapes = {
            "q_proj": ((d, nh * hd), dt),
            "k_proj": ((d, cfg.n_kv_heads * hd), dt),
            "v_proj": ((d, cfg.n_kv_heads * hd), dt),
        }
    else:
        qd = cfg.nope_dim + cfg.rope_dim
        shapes = ({"q_a": ((d, cfg.q_lora), dt),
                   "q_b": ((cfg.q_lora, nh * qd), dt)} if cfg.q_lora
                  else {"q_proj": ((d, nh * qd), dt)})
        shapes["kv_a"] = ((d, cfg.kv_lora + cfg.rope_dim), dt)
        shapes["k_b"] = ((cfg.kv_lora, nh * cfg.nope_dim), dt)
        shapes["v_b"] = ((cfg.kv_lora, nh * cfg.v_head_dim), dt)
    shapes["o_proj"] = ((nh * _vdim(cfg), d), dt)
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


def _norm_shapes(cfg: TransformerConfig) -> Dict[str, int]:
    """Each layer's RMSNorm weights (ones) and their widths."""
    norms = {"ln_attn": cfg.d_model, "ln_ffn": cfg.d_model}
    if cfg.attn == "mla":
        if cfg.q_lora:
            norms["q_a_norm"] = cfg.q_lora
        norms["kv_a_norm"] = cfg.kv_lora
    return norms


def init_transformer(cfg: TransformerConfig, seed: int = 0,
                     device="cuda") -> Params:
    """Random parameters drawn on ``device`` from one ``torch.Generator``
    seeded with ``seed`` (a seed gives other numbers on the CPU than on a
    card, and other numbers than ``jax.random``: carry JAX weights across
    with ``params_from_numpy``).  Each layer's leaves are drawn one
    layer at a time and written into the stacked ``[L, ...]`` tensors, so
    no float32 copy of the whole stack is ever held.  On the ``meta``
    device nothing is drawn: the tree holds the shapes only (what
    ``param_count`` needs at a full width that would not fit)."""
    _check_attn(cfg)
    device = resolve_device(device)
    meta = device.type == "meta"
    gen = None if meta else torch.Generator(device=device).manual_seed(seed)
    d, dt, n = cfg.d_model, cfg.param_dtype, cfg.n_layers

    def draw(shape, scale=None, dtype=dt):
        if meta:
            return torch.empty(shape, dtype=dtype, device=device)
        return dense_init(gen, shape, scale=scale, dtype=dtype)

    embed = draw((cfg.vocab_padded, d), scale=1.0)
    shapes = _layer_shapes(cfg)
    layers = {name: torch.empty((n, *shape), dtype=ldt, device=device)
              for name, (shape, ldt) in shapes.items()}
    if not meta:
        for i in range(n):
            for name, (shape, ldt) in shapes.items():
                scale = d ** -0.5 if name == "router" else None
                layers[name][i] = draw(shape, scale, ldt)
    for name, width in _norm_shapes(cfg).items():
        layers[name] = torch.ones((n, width), dtype=dt, device=device)
    return {
        "embed": embed,
        "layers": layers,
        "ln_f": torch.ones((d,), dtype=dt, device=device),
        "lm_head": draw((d, cfg.vocab_padded)),
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


def _mla_q(p: Params, cfg: TransformerConfig, h: torch.Tensor,
           pos: torch.Tensor):
    """Per-head ``q_nope [B, H, T, nope]`` and roped ``q_rope [B, H, T,
    rope]``, through the low-rank ``q_a``/``q_b`` when ``q_lora``."""
    b, t, _ = h.shape
    qd = cfg.nope_dim + cfg.rope_dim
    if cfg.q_lora:
        qa = rms_norm(h @ p["q_a"], p["q_a_norm"])
        q = (qa @ p["q_b"]).reshape(b, t, cfg.n_heads, qd)
    else:
        q = (h @ p["q_proj"]).reshape(b, t, cfg.n_heads, qd)
    q = q.transpose(1, 2)
    q_nope, q_rope = q[..., :cfg.nope_dim], q[..., cfg.nope_dim:]
    return q_nope, apply_rope(q_rope, pos[:, None, :])


def _mla_latent(p: Params, cfg: TransformerConfig, h: torch.Tensor,
                pos: torch.Tensor):
    """The compressed latent ``c_kv [B, T, kv_lora]`` and the shared
    roped key ``k_rope [B, T, rope]``: what the cache holds."""
    kv = h @ p["kv_a"]
    c_kv = rms_norm(kv[..., :cfg.kv_lora], p["kv_a_norm"])
    k_rope = apply_rope(kv[..., None, cfg.kv_lora:].transpose(1, 2),
                        pos[:, None, :])[:, 0]
    return c_kv, k_rope


def _mla_attend(p: Params, cfg: TransformerConfig, q_nope: torch.Tensor,
                q_rope: torch.Tensor, c_kv: torch.Tensor,
                k_rope: torch.Tensor, causal: bool,
                bias=None) -> torch.Tensor:
    """Matrix-absorbed MLA attention over the latent (``c_kv``, ``k_rope``
    of ``[B, S, .]``): ``q_eff = q_nope W_kb`` per head, one KV head
    ``[c_kv, k_rope]`` of width ``kv_lora + rope_dim``, ``c_kv`` as the
    value (a view of that head's first ``kv_lora`` columns, so that the
    attention kernel reads the latent once), and the context expanded
    through ``W_vb`` to ``[B, H, T, v_head_dim]``."""
    nh = q_nope.shape[1]
    w_kb = p["k_b"].reshape(cfg.kv_lora, nh, cfg.nope_dim)
    q_eff = torch.einsum("bhtd,lhd->bhtl", q_nope, w_kb)     # [B,H,T,l]
    q_full = torch.cat([q_eff, q_rope], dim=-1)
    k_full = torch.cat([c_kv, k_rope], dim=-1)[:, None].to(q_full.dtype)
    ctx = ops.attention(q_full, k_full, k_full[..., :cfg.kv_lora],
                        causal=causal, bias=bias)             # [B,H,T,l]
    w_vb = p["v_b"].reshape(cfg.kv_lora, nh, cfg.v_head_dim)
    return torch.einsum("bhtl,lhv->bhtv", ctx, w_vb)


def _dense_ffn(p: Params, h: torch.Tensor) -> torch.Tensor:
    return swiglu(h, p["w_gate"], p["w_up"], p["w_down"])


def _moe_ffn(p: Params, cfg: TransformerConfig, h: torch.Tensor,
             expert_lo: int = 0) -> torch.Tensor:
    """Top-k MoE with capacity-bucket dispatch, as the JAX package's: each
    batch row scatters its tokens into an ``[E, C, D]`` buffer (C the
    capacity; tokens past it are dropped), the experts run as batched
    products, and the outputs are gathered back and mixed by gate.

    Expert weights of fewer than ``E`` experts hold experts ``[expert_lo,
    expert_lo + E_w)`` (one rank's share under expert parallelism): only
    those run, and the output is that share's part of the sum."""
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

    e_w = p["w_gate"].shape[0]
    if e_w != e:
        buf = buf[:, expert_lo:expert_lo + e_w]
    y = F.silu(torch.einsum("becd,edf->becf", buf, p["w_gate"]))
    y = y * torch.einsum("becd,edf->becf", buf, p["w_up"])
    y = torch.einsum("becf,efd->becd", y, p["w_down"])
    if e_w != e:
        y = F.pad(y, (0, 0, 0, 0, expert_lo, e - expert_lo - e_w))

    out = y[rows, flat, slot]                                   # [B,t*k,D]
    out = torch.where(keep[..., None], out,
                      torch.zeros((), dtype=out.dtype, device=out.device))
    out = out.reshape(b, t, k, d) * gate[..., None].to(out.dtype)
    return out.sum(dim=2)


def _ffn(p: Params, cfg: TransformerConfig, x: torch.Tensor) -> torch.Tensor:
    if not cfg.moe:
        return _dense_ffn(p, x)
    from torch.distributed.tensor import DTensor
    if isinstance(x, DTensor):
        # the dry-run's sharded step: per rank, on its experts
        from repro_torch.dist.sharding import per_rank_moe
        return per_rank_moe(partial(_moe_ffn, cfg=cfg), p, x)
    return _moe_ffn(p, cfg, x)


# --------------------------------------------------------------------------- #
# forward / decode
# --------------------------------------------------------------------------- #


def _layer_fn(cfg: TransformerConfig, h: torch.Tensor, pos: torch.Tensor,
              p: Params) -> torch.Tensor:
    if cfg.seq_shard:
        # Megatron-SP: the inter-layer residual is the dominant live
        # activation; shard its seq dim over 'model' so the per-rank
        # footprint is B*T*D/(dp*tp), not B*T*D/dp (the identity without
        # an installed mesh or on a tensor that is not a DTensor)
        h = annotate.constrain(h, annotate.data_axes(), "model", None)
    x = rms_norm(h, p["ln_attn"])
    b, t, _ = h.shape
    if cfg.attn == "gqa":
        q, k, v = _gqa_qkv(p, cfg, x, pos)
        ctx = ops.attention(q, k, v, causal=True)
    else:
        q_nope, q_rope = _mla_q(p, cfg, x, pos)
        c_kv, k_rope = _mla_latent(p, cfg, x, pos)
        ctx = _mla_attend(p, cfg, q_nope, q_rope, c_kv, k_rope, causal=True)
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


def forward_logits(params: Params, tokens: torch.Tensor,
                   cfg: TransformerConfig) -> torch.Tensor:
    """tokens ``[B, T]`` -> logits ``[B, T, V_padded]``, layer by layer
    over the stacked parameters, recording gradients where grad mode is
    on (:func:`loss_fn`'s forward)."""
    _check_attn(cfg)
    h = params["embed"][tokens].to(cfg.compute_dtype)
    pos = torch.arange(tokens.shape[1], device=tokens.device).expand(
        tokens.shape)
    # JAX's remat (policy "full"): under autograd each layer keeps only its
    # input and is recomputed in the backward
    remat = cfg.remat and torch.is_grad_enabled()
    for i in range(cfg.n_layers):
        if remat:
            h = torch.utils.checkpoint.checkpoint(
                _layer_fn, cfg, h, pos, layer_params(params, i),
                use_reentrant=False)
        else:
            h = _layer_fn(cfg, h, pos, layer_params(params, i))
    h = rms_norm(h, params["ln_f"])
    logits = h @ params["lm_head"].to(cfg.compute_dtype)
    return _mask_pad_vocab(logits, cfg)


@torch.no_grad()
def forward(params: Params, tokens: torch.Tensor,
            cfg: TransformerConfig) -> torch.Tensor:
    """The serving forward: :func:`forward_logits` with no gradient."""
    return forward_logits(params, tokens, cfg)


def loss_fn(params: Params, tokens: torch.Tensor, labels: torch.Tensor,
            cfg: TransformerConfig) -> torch.Tensor:
    """Mean next-token NLL of ``labels`` ``[B, T]``."""
    return cross_entropy(forward_logits(params, tokens, cfg), labels)


def init_cache(cfg: TransformerConfig, batch: int, max_len: int,
               device="cuda") -> Params:
    """An empty KV cache in the compute dtype and ``len``, the host int
    of positions filled: GQA's ``k``, ``v`` of ``[L, B, Hkv, max_len,
    D]``; MLA's latent ``c_kv [L, B, max_len, kv_lora]`` and ``k_rope [L,
    B, max_len, rope_dim]``."""
    _check_attn(cfg)
    device = resolve_device(device)
    if cfg.attn == "mla":
        lead = (cfg.n_layers, batch, max_len)
        return {"c_kv": torch.zeros((*lead, cfg.kv_lora),
                                    dtype=cfg.compute_dtype, device=device),
                "k_rope": torch.zeros((*lead, cfg.rope_dim),
                                      dtype=cfg.compute_dtype, device=device),
                "len": 0}
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, max_len, cfg.d_head)
    return {"k": torch.zeros(shape, dtype=cfg.compute_dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.compute_dtype, device=device),
            "len": 0}


@torch.no_grad()
def decode_step(params: Params, cache: Params, tokens: torch.Tensor,
                cfg: TransformerConfig) -> Tuple[torch.Tensor, Params]:
    """One-token decode: tokens ``[B]`` -> logits ``[B, V_padded]`` and
    the cache.

    The cache is written IN PLACE: this step's keys and values (MLA: its
    latent and rope key) go into the cache at position ``cache["len"]``
    (a host int, so no sync), and ``len`` is incremented; the dict
    returned is ``cache`` itself.  Keep a ``.clone()`` of a cache you
    still need.  (The JAX step returns a new cache.)  Attention covers
    the positions up to ``len`` through a bias, so it runs
    ``kernels/ref.py``.
    """
    _check_attn(cfg)
    b = tokens.shape[0]
    t_now = cache["len"]
    max_len = (cache["c_kv"].shape[2] if cfg.attn == "mla"
               else cache["k"].shape[3])
    if t_now >= max_len:
        raise ValueError(f"the cache is full: {t_now} of {max_len}")
    h = params["embed"][tokens][:, None].to(cfg.compute_dtype)   # [B,1,D]
    pos = torch.full((b, 1), t_now, dtype=torch.int64, device=h.device)
    live = torch.arange(max_len, device=h.device) <= t_now
    bias = torch.where(live, 0.0, -1e30).to(torch.float32)[None, None, None]
    for i in range(cfg.n_layers):
        p = layer_params(params, i)
        x = rms_norm(h, p["ln_attn"])
        if cfg.attn == "gqa":
            q, k1, v1 = _gqa_qkv(p, cfg, x, pos)
            cache["k"][i, :, :, t_now] = k1[:, :, 0]
            cache["v"][i, :, :, t_now] = v1[:, :, 0]
            ctx = ops.attention(q, cache["k"][i], cache["v"][i],
                                causal=False, bias=bias)
        else:
            q_nope, q_rope = _mla_q(p, cfg, x, pos)
            c1, r1 = _mla_latent(p, cfg, x, pos)
            cache["c_kv"][i, :, t_now] = c1[:, 0]
            cache["k_rope"][i, :, t_now] = r1[:, 0]
            ctx = _mla_attend(p, cfg, q_nope, q_rope, cache["c_kv"][i],
                              cache["k_rope"][i], causal=False, bias=bias)
        ctx = ctx.transpose(1, 2).reshape(b, 1, -1)
        h = h + ctx @ p["o_proj"]
        x = rms_norm(h, p["ln_ffn"])
        h = h + _ffn(p, cfg, x)
    cache["len"] = t_now + 1
    h = rms_norm(h, params["ln_f"])
    logits = (h @ params["lm_head"].to(cfg.compute_dtype))[:, 0]
    return _mask_pad_vocab(logits, cfg), cache
