"""Import every arch config to populate the registry (side-effectful), as
``repro/configs/__init__.py`` does."""
from repro_torch.configs.base import REGISTRY, ArchSpec  # noqa: F401
from repro_torch.configs import (dimenet, egnn,  # noqa: F401
                                 granite_moe_3b_a800m, graphcast,
                                 graphsage_reddit, internlm2_20b,
                                 llama3_405b, minicpm3_4b,
                                 moonshot_v1_16b_a3b, mosso_stream, sasrec)
