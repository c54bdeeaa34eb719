"""minicpm3-4b [dense]: 62L d=2560 40H d_ff=6400 vocab=73448 — MLA.
[hf:openbmb/MiniCPM3-4B; hf]"""
import torch

from repro_torch.configs.base import ArchSpec, lm_cells, register
from repro_torch.models.transformer import TransformerConfig

ARCH_ID = "minicpm3-4b"


def full_config() -> TransformerConfig:
    return TransformerConfig(
        name=ARCH_ID, n_layers=62, d_model=2560, n_heads=40, n_kv_heads=40,
        d_head=64, d_ff=6400, vocab=73448, attn="mla",
        q_lora=768, kv_lora=256, rope_dim=32, nope_dim=64, v_head_dim=64,
        max_seq=524288)


def smoke_config() -> TransformerConfig:
    return TransformerConfig(
        name=ARCH_ID + "-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, d_head=16, d_ff=128, vocab=211, attn="mla",
        q_lora=32, kv_lora=24, rope_dim=8, nope_dim=16, v_head_dim=16,
        max_seq=128, remat=False,
        param_dtype=torch.float32, compute_dtype=torch.float32)


SPEC = register(ArchSpec(
    arch_id=ARCH_ID, family="lm", source="hf:openbmb/MiniCPM3-4B",
    make_config=full_config, make_smoke_config=smoke_config,
    cells=lm_cells(full_attention=True),
    technique_applicable="no (dense LM; exercises MLA latent-cache serving)"))
