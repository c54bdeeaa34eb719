"""moonshot-v1-16b-a3b [moe]: 48L d=2048 16H (kv=16) d_ff=1408 vocab=163840,
MoE 64e top-6.  [hf:moonshotai/Moonlight-16B-A3B; hf]"""
import torch

from repro_torch.configs.base import ArchSpec, lm_cells, register
from repro_torch.models.transformer import TransformerConfig

ARCH_ID = "moonshot-v1-16b-a3b"


def full_config() -> TransformerConfig:
    return TransformerConfig(
        name=ARCH_ID, n_layers=48, d_model=2048, n_heads=16, n_kv_heads=16,
        d_head=128, d_ff=1408, vocab=163840, attn="gqa",
        n_experts=64, top_k=6, max_seq=524288)


def smoke_config() -> TransformerConfig:
    return TransformerConfig(
        name=ARCH_ID + "-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, d_head=16, d_ff=32, vocab=211, attn="gqa",
        n_experts=8, top_k=2, max_seq=128, remat=False,
        param_dtype=torch.float32, compute_dtype=torch.float32)


SPEC = register(ArchSpec(
    arch_id=ARCH_ID, family="lm", source="hf:moonshotai/Moonlight-16B-A3B",
    make_config=full_config, make_smoke_config=smoke_config,
    cells=lm_cells(full_attention=True),
    technique_applicable="no (dense LM; exercises MoE/EP substrate)"))
