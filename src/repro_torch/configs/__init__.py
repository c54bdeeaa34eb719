"""Import every arch config to populate the registry (side-effectful), as
``repro/configs/__init__.py`` does."""
from repro_torch.configs.base import (REGISTRY, ArchSpec,  # noqa: F401
                                      ShapeCell)
from repro_torch.configs import (dimenet, egnn,  # noqa: F401
                                 granite_moe_3b_a800m, graphcast,
                                 graphsage_reddit, internlm2_20b,
                                 llama3_405b, minicpm3_4b,
                                 moonshot_v1_16b_a3b, mosso_stream, sasrec)

ASSIGNED = [
    "moonshot-v1-16b-a3b", "granite-moe-3b-a800m", "minicpm3-4b",
    "llama3-405b", "internlm2-20b",
    "graphcast", "dimenet", "egnn", "graphsage-reddit",
    "sasrec",
]
