"""Serving loop (port of ``repro/launch/serve.py``): batched greedy
decode with a KV cache.

Prefills a prompt batch by teacher forcing through ``decode_step``, then
decodes ``gen_tokens`` tokens per request, as the JAX module does.  The
weights and the prompt are drawn from ``torch.Generator``s seeded with
``seed`` and ``seed + 1`` on the device.  ``full=True`` runs the arch's
full configuration (minicpm3-4b's, the default arch, is 4.26 B parameters,
8.52 GB in bfloat16; internlm2-20b's about 19.9 B, 39.7 GB), else its
smoke configuration.

    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
        --arch minicpm3-4b --tokens 4
    PYTHONPATH=src python -m repro_torch.launch.serve --full   # on a card
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import (granite_moe_3b_a800m, internlm2_20b,
                                 llama3_405b, minicpm3_4b,
                                 moonshot_v1_16b_a3b)
from repro_torch.device import resolve_device
from repro_torch.models import transformer as tfm

ARCHS = {m.ARCH_ID: m for m in (minicpm3_4b, internlm2_20b, llama3_405b,
                                granite_moe_3b_a800m, moonshot_v1_16b_a3b)}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.no_grad()
def generate(params, cfg: tfm.TransformerConfig, prompt: torch.Tensor,
             gen_tokens: int) -> dict:
    """Teacher-force ``prompt`` ``[B, P]`` through ``decode_step``, then
    decode ``gen_tokens`` greedily.  Returns the generated tokens ``[B,
    gen_tokens]`` (int64) and the seconds of each phase."""
    batch, prompt_len = prompt.shape
    device = prompt.device
    cache = tfm.init_cache(cfg, batch, prompt_len + gen_tokens, device)
    _sync(device)
    t0 = time.perf_counter()
    for t in range(prompt_len):
        logits, cache = tfm.decode_step(params, cache, prompt[:, t], cfg)
    _sync(device)
    prefill_s = time.perf_counter() - t0

    toks = []
    t0 = time.perf_counter()
    tok = torch.argmax(logits, dim=-1)
    for _ in range(gen_tokens):
        toks.append(tok)
        logits, cache = tfm.decode_step(params, cache, tok, cfg)
        tok = torch.argmax(logits, dim=-1)
    _sync(device)
    decode_s = time.perf_counter() - t0
    return dict(tokens=torch.stack(toks, dim=1), prefill_s=prefill_s,
                decode_s=decode_s,
                ms_per_token=1e3 * decode_s / max(gen_tokens, 1))


def serve(arch: str, batch: int = 4, prompt_len: int = 16,
          gen_tokens: int = 32, seed: int = 0, device="cuda",
          full: bool = False) -> dict:
    """Draw the arch's weights and a prompt from ``seed`` on ``device``
    and run :func:`generate`; returns its dict."""
    if arch not in ARCHS:
        raise KeyError(f"unknown LM arch {arch!r}: {sorted(ARCHS)}")
    mod = ARCHS[arch]
    cfg = mod.full_config() if full else mod.smoke_config()
    device = resolve_device(device)
    params = tfm.init_transformer(cfg, seed, device=device)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    prompt = torch.randint(0, cfg.vocab, (batch, prompt_len), generator=gen,
                           device=device)
    return generate(params, cfg, prompt, gen_tokens)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=minicpm3_4b.ARCH_ID,
                    choices=sorted(ARCHS))
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--full", action="store_true",
                    help="the full configuration (default: smoke)")
    args = ap.parse_args()
    out = serve(args.arch, args.batch, args.prompt_len, args.tokens,
                args.seed, args.device, args.full)
    print(f"{args.arch} ({'full' if args.full else 'smoke'}): generated "
          f"{tuple(out['tokens'].shape)} tokens on "
          f"device={args.device}; prefill {out['prefill_s']:.2f}s, "
          f"{out['ms_per_token']:.1f} ms/token decode")


if __name__ == "__main__":
    main()
