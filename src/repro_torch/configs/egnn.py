"""egnn [gnn]: 4L d_hidden=64 E(n)-equivariant.  [arXiv:2102.09844]"""
from repro_torch.models.gnn import GNNConfig

ARCH_ID = "egnn"


def full_config() -> GNNConfig:
    return GNNConfig(name=ARCH_ID, arch="egnn", n_layers=4, d_hidden=64,
                     d_in=32, n_classes=8)


def smoke_config() -> GNNConfig:
    return GNNConfig(name=ARCH_ID + "-smoke", arch="egnn", n_layers=2,
                     d_hidden=16, d_in=8, n_classes=4)
