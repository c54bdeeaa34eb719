"""llama3-405b [dense]: 126L d=16384 128H (kv=8) d_ff=53248 vocab=128256.
[arXiv:2407.21783; unverified]

Its full configuration (about 405 B parameters) does not fit one 80 GB
card; the port runs its smoke configuration."""
import torch

from repro_torch.configs.base import ArchSpec, lm_cells, register
from repro_torch.models.transformer import TransformerConfig

ARCH_ID = "llama3-405b"


def full_config() -> TransformerConfig:
    return TransformerConfig(
        name=ARCH_ID, n_layers=126, d_model=16384, n_heads=128, n_kv_heads=8,
        d_head=128, d_ff=53248, vocab=128256, attn="gqa", max_seq=524288,
        fsdp_axes=("pod", "data"))


def smoke_config() -> TransformerConfig:
    return TransformerConfig(
        name=ARCH_ID + "-smoke", n_layers=2, d_model=64, n_heads=8,
        n_kv_heads=2, d_head=8, d_ff=160, vocab=211, attn="gqa",
        max_seq=128, remat=False,
        param_dtype=torch.float32, compute_dtype=torch.float32)


SPEC = register(ArchSpec(
    arch_id=ARCH_ID, family="lm", source="arXiv:2407.21783",
    make_config=full_config, make_smoke_config=smoke_config,
    cells=lm_cells(full_attention=True),
    technique_applicable="no (dense LM; the FSDP/TP stress test)"))
