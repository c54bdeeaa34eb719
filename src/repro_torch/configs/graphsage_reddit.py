"""graphsage-reddit [gnn]: 2L d_hidden=128 mean agg.  [arXiv:1706.02216]

The paper samples 25-10 neighbors; the ``minibatch_lg`` shape this model
runs at pads a 1024-seed subgraph to 262,144 edges, which holds 15-10
(1024 x (15 + 150) = 168,960 edges) but not 25-10 (281,600).
"""
from repro_torch.configs.base import ArchSpec, gnn_cells, register
from repro_torch.models.gnn import GNNConfig

ARCH_ID = "graphsage-reddit"
FANOUTS = (15, 10)


def full_config() -> GNNConfig:
    return GNNConfig(name=ARCH_ID, arch="graphsage", n_layers=2,
                     d_hidden=128, d_in=602, n_classes=41, aggregator="mean")


def smoke_config() -> GNNConfig:
    return GNNConfig(name=ARCH_ID + "-smoke", arch="graphsage", n_layers=2,
                     d_hidden=16, d_in=8, n_classes=4)


SPEC = register(ArchSpec(
    arch_id=ARCH_ID, family="gnn", source="arXiv:1706.02216",
    make_config=full_config, make_smoke_config=smoke_config,
    cells=gnn_cells(needs_coords=False),
    technique_applicable=("YES: summarize the input graph online (MoSSo); "
                          "mean-agg message passing runs on (G*,C) via "
                          "summary_spmm; GetRandomNeighbor doubles as the "
                          "fanout sampler")))
