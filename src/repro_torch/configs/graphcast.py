"""graphcast [gnn]: 16L d_hidden=512 agg=sum n_vars=227,
encoder-processor-decoder mesh GNN.  [arXiv:2212.12794]"""
from repro_torch.configs.base import ArchSpec, gnn_cells, register
from repro_torch.models.gnn import GNNConfig

ARCH_ID = "graphcast"


def full_config() -> GNNConfig:
    return GNNConfig(name=ARCH_ID, arch="graphcast", n_layers=16,
                     d_hidden=512, d_in=227, n_classes=227,
                     n_mesh_frac=4, aggregator="sum")


def smoke_config() -> GNNConfig:
    return GNNConfig(name=ARCH_ID + "-smoke", arch="graphcast", n_layers=2,
                     d_hidden=32, d_in=16, n_classes=8)


SPEC = register(ArchSpec(
    arch_id=ARCH_ID, family="gnn", source="arXiv:2212.12794",
    make_config=full_config, make_smoke_config=smoke_config,
    cells=gnn_cells(needs_coords=False),
    technique_applicable=("partial: summarize-once for the static bipartite "
                          "grid<->mesh graphs; processor mesh gains little")))
