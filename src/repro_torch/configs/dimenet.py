"""dimenet [gnn]: 6 blocks d_hidden=128 n_bilinear=8 n_spherical=7
n_radial=6.  [arXiv:2003.03123]"""
from repro_torch.configs.base import ArchSpec, gnn_cells, register
from repro_torch.models.gnn import GNNConfig

ARCH_ID = "dimenet"


def full_config() -> GNNConfig:
    return GNNConfig(name=ARCH_ID, arch="dimenet", n_layers=6, d_hidden=128,
                     d_in=32, n_classes=8, n_rbf=6, n_sbf=7, n_bilinear=8)


def smoke_config() -> GNNConfig:
    return GNNConfig(name=ARCH_ID + "-smoke", arch="dimenet", n_layers=2,
                     d_hidden=16, d_in=8, n_classes=4, n_rbf=4, n_sbf=4,
                     n_bilinear=4)


SPEC = register(ArchSpec(
    arch_id=ARCH_ID, family="gnn", source="arXiv:2003.03123",
    make_config=full_config, make_smoke_config=smoke_config,
    cells=gnn_cells(needs_coords=True),
    technique_applicable=("marginal: 30-node radius graphs have near-unique "
                          "neighborhoods (phi/|E| ~ 1); supported, off by "
                          "default. Triplets capped at 4/edge on the large "
                          "non-molecular shapes (DESIGN.md)")))
