"""sasrec [recsys]: embed_dim=50 2 blocks 1 head seq_len=50, self-attn-seq.
[arXiv:1808.09781; paper]"""
from repro_torch.configs.base import ArchSpec, recsys_cells, register
from repro_torch.models.sasrec import SASRecConfig

ARCH_ID = "sasrec"


def full_config() -> SASRecConfig:
    return SASRecConfig(name=ARCH_ID, n_items=1_000_000, embed_dim=50,
                        n_blocks=2, n_heads=1, seq_len=50)


def smoke_config() -> SASRecConfig:
    return SASRecConfig(name=ARCH_ID + "-smoke", n_items=1000, embed_dim=16,
                        n_blocks=2, n_heads=1, seq_len=12)


SPEC = register(ArchSpec(
    arch_id=ARCH_ID, family="recsys", source="arXiv:1808.09781",
    make_config=full_config, make_smoke_config=smoke_config,
    cells=recsys_cells(),
    technique_applicable=("YES (beyond-paper): the user-item interaction "
                          "stream is a dynamic bipartite graph; MoSSo keeps "
                          "a lossless online summary of it (storage layer)")))
