"""internlm2-20b [dense]: 48L d=6144 48H (kv=8) d_ff=16384 vocab=92544.
[arXiv:2403.17297; hf]"""
import torch

from repro_torch.configs.base import ArchSpec, lm_cells, register
from repro_torch.models.transformer import TransformerConfig

ARCH_ID = "internlm2-20b"


def full_config() -> TransformerConfig:
    return TransformerConfig(
        name=ARCH_ID, n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8,
        d_head=128, d_ff=16384, vocab=92544, attn="gqa", max_seq=524288)


def smoke_config() -> TransformerConfig:
    return TransformerConfig(
        name=ARCH_ID + "-smoke", n_layers=2, d_model=64, n_heads=8,
        n_kv_heads=2, d_head=8, d_ff=160, vocab=211, attn="gqa",
        max_seq=128, remat=False,
        param_dtype=torch.float32, compute_dtype=torch.float32)


SPEC = register(ArchSpec(
    arch_id=ARCH_ID, family="lm", source="arXiv:2403.17297",
    make_config=full_config, make_smoke_config=smoke_config,
    cells=lm_cells(full_attention=True),
    technique_applicable="no (dense LM)"))
