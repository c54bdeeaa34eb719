"""granite-moe-3b-a800m [moe]: 32L d=1536 24H (kv=8) d_ff=512 vocab=49155,
MoE 40e top-8.  [hf:ibm-granite/granite-3.0-1b-a400m-base; hf]"""
import torch

from repro_torch.models.transformer import TransformerConfig

ARCH_ID = "granite-moe-3b-a800m"


def full_config() -> TransformerConfig:
    return TransformerConfig(
        name=ARCH_ID, n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8,
        d_head=64, d_ff=512, vocab=49155, attn="gqa",
        n_experts=40, top_k=8, max_seq=524288)


def smoke_config() -> TransformerConfig:
    return TransformerConfig(
        name=ARCH_ID + "-smoke", n_layers=2, d_model=48, n_heads=6,
        n_kv_heads=2, d_head=8, d_ff=32, vocab=211, attn="gqa",
        n_experts=5, top_k=2, max_seq=128, remat=False,
        param_dtype=torch.float32, compute_dtype=torch.float32)
