#!/usr/bin/env python3
"""Quick check of the flash-attention kernels on one GPU.

    timeout 300 python3 tools/attention_check.py [--time]

Builds ``src/repro_torch/csrc/flash_attention.cu`` (printing ``nvcc``'s
register and spill lines), then holds every kernel variant to its plain
torch version at small shapes: the ``wgmma`` kernel (bf16, D = 64 and 128;
contiguous and the transformer's strided layout, causal and not, GQA), the
``mma.sync`` kernel (bf16, D = 16 and 32), the MLA kernel (bf16,
``(D, Dv) = (288, 256)``) and the SIMT kernel (float32, bf16 at D = 8 and
at ``(32, 24)``), within 3e-2 in bf16 and 2e-3 in float32.  A failing
``wgmma`` shape is probed further: with q = 0 (uniform p: only the p v
product and the epilogue count) and with v = 1 (only the normalisation
counts).  ``--time`` adds the kernel's device time at internlm2-20b's,
granite-moe-3b-a800m's and minicpm3-4b's layer shapes beside
``scaled_dot_product_attention`` (at minicpm3-4b's, through
``chip_smoke.mla_library_call``).

It takes a minute, so it is the first thing to run on the card after an
edit of the kernel, under ``timeout`` (a broken pipeline traps after a few
seconds rather than hanging, but the timeout bounds the run regardless);
``chip_smoke.py`` phase 9 is the full check.  Exits non-zero on a mismatch
and without a CUDA device.
"""
from __future__ import annotations

import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# (dtype, B, H, Hkv, T, D, Dv, causal, strided); the first two give the
# producer more key tiles than ring stages, so a stuck pipeline traps; the
# last six are MLA's pairs (one KV head, v narrower than q)
SHAPES = (
    ("bfloat16", 1, 2, 1, 512, 64, 64, True, False),
    ("bfloat16", 1, 2, 1, 512, 128, 128, True, False),
    ("bfloat16", 2, 4, 2, 256, 64, 64, True, False),
    ("bfloat16", 1, 8, 8, 128, 128, 128, True, False),
    ("bfloat16", 2, 4, 1, 384, 64, 64, False, False),
    ("bfloat16", 2, 8, 2, 512, 128, 128, False, True),
    ("bfloat16", 1, 4, 1, 1024, 128, 128, True, True),
    ("bfloat16", 2, 6, 2, 768, 64, 64, True, True),
    ("bfloat16", 2, 4, 4, 256, 16, 16, True, False),
    ("bfloat16", 2, 4, 2, 256, 32, 32, True, True),
    ("bfloat16", 2, 8, 2, 256, 8, 8, True, False),
    ("float32", 2, 4, 2, 256, 64, 64, True, True),
    ("float32", 1, 8, 8, 128, 128, 128, False, False),
    ("bfloat16", 1, 4, 1, 256, 288, 256, True, False),
    ("bfloat16", 2, 3, 1, 384, 288, 256, False, False),
    ("bfloat16", 1, 2, 1, 128, 288, 256, True, False),
    ("float32", 1, 2, 1, 256, 288, 256, True, False),
    ("bfloat16", 2, 4, 1, 256, 32, 24, True, False),
    ("float32", 2, 4, 1, 256, 32, 24, False, False),
)
# (name, B, H, Hkv, T, D, Dv, strided) of the timed layer shapes, bf16,
# causal, in the layout the transformer hands over
LAYERS = (("internlm2-20b", 2, 48, 8, 4096, 128, 128, True),
          ("granite-moe-3b-a800m", 2, 24, 8, 4096, 64, 64, True),
          ("minicpm3-4b", 2, 40, 1, 4096, 288, 256, False))


def err(got, want) -> float:
    return float((got.float() - want.float()).abs().max())


def probe(q, k, v, causal) -> str:
    """Where a wrong wgmma result comes from: q = 0 leaves only p v and
    the epilogue; v = 1 leaves only the normalisation."""
    import torch
    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     flash_attention_plain)
    out = []
    for name, (qq, vv) in (("q=0", (torch.zeros_like(q), v)),
                           ("v=1", (q, torch.ones_like(v)))):
        got = flash_attention_cuda(qq, k, vv, causal=causal)
        want = flash_attention_plain(qq, k, vv, causal=causal)
        torch.cuda.synchronize()
        diff = (got.float() - want.float()).abs()
        bad = diff > 3e-2
        cols = bad.any(dim=(0, 1, 2)).nonzero().flatten().tolist()
        rows = bad.any(dim=(0, 1, 3)).nonzero().flatten().tolist()
        out.append(f"{name}: max |err| {float(diff.max()):.3e}, "
                   f"{int(bad.sum())} of {bad.numel()} wrong; wrong columns "
                   f"{cols[:8]}{'...' if len(cols) > 8 else ''}, rows "
                   f"{rows[:8]}{'...' if len(rows) > 8 else ''}")
    return "; ".join(out)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("attention_check: no CUDA device is visible", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from chip_smoke import (MLA_SDPA_BACKEND, attn_inputs, graph_ms,
                             mla_library_call)
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import (SOURCE,
                                                     flash_attention_cuda,
                                                     flash_attention_plain,
                                                     kernel_variant)
    t0 = time.perf_counter()
    (_, text), = _build.build_all([SOURCE]).values()
    print(f"built {SOURCE.name} in {time.perf_counter() - t0:.1f} s")
    for line in text.strip().splitlines():
        print(f"  nvcc: {line.strip()}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    failed = 0
    for name, b, h, hkv, t, d, dv, causal, strided in SHAPES:
        dtype = getattr(torch, name)
        tol = 3e-2 if dtype == torch.bfloat16 else 2e-3
        q, k, v = attn_inputs(b, h, hkv, t, d, dtype, gen, strided, dv)
        got = flash_attention_cuda(q, k, v, causal=causal)
        want = flash_attention_plain(q, k, v, causal=causal)
        torch.cuda.synchronize()
        e = err(got, want)
        ok = e <= tol and bool(torch.isfinite(got).all())
        failed += not ok
        variant = kernel_variant(dtype, d, dv)
        print(f"{'ok  ' if ok else 'FAIL'} {variant:5s} {name:8s} B={b} "
              f"H={h} Hkv={hkv} T={t} D={d} Dv={dv} causal={causal} "
              f"strided={strided}: max |err| {e:.3e} (tol {tol})",
              flush=True)
        if not ok and variant in ("wgmma", "mla"):
            print(f"     {probe(q, k, v, causal)}", flush=True)
    if failed:
        print(f"attention_check: {failed} shapes failed", file=sys.stderr)
        return 1
    if "--time" in sys.argv[1:]:
        import torch.nn.functional as F
        for name, b, h, hkv, t, d, dv, strided in LAYERS:
            q, k, v = attn_inputs(b, h, hkv, t, d, torch.bfloat16, gen,
                                  strided, dv)
            e = err(flash_attention_cuda(q, k, v),
                    flash_attention_plain(q, k, v))
            ms = graph_ms(lambda: flash_attention_cuda(q, k, v), 3, 3)
            if dv == d:
                how = "GQA"
                sdpa = graph_ms(lambda: F.scaled_dot_product_attention(
                    q, k, v, is_causal=True, enable_gqa=True), 3, 3)
            else:
                how = f"k, v expanded to {h} heads, {MLA_SDPA_BACKEND}"
                sdpa = graph_ms(mla_library_call(q, k, v), 3, 3)
            flops = 2 * (d + dv) * b * h * (t * (t + 1) // 2)
            print(f"{name} layer B={b} H={h} Hkv={hkv} T={t} D={d} Dv={dv}:"
                  f" kernel {ms:.3f} ms ({flops / ms / 1e9:.1f} TFLOP/s), "
                  f"SDPA ({how}) {sdpa:.3f} ms, ratio {ms / sdpa:.2f}; max "
                  f"|err| {e:.3e}", flush=True)
    print("attention_check: every shape matches its plain version")
    return 0


if __name__ == "__main__":
    sys.exit(main())
