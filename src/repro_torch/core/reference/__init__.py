"""The Tier-A reference: a copy of ``repro/core/reference/`` (plain
Python, host only).  The faithful MoSSo family over the exact summary
state, the min-hash clusters, GetRandomNeighbor and the query oracle."""
from repro_torch.core.reference.algorithms import (ALGORITHMS, MoSSo,
                                                   MoSSoGreedy, MoSSoMags,
                                                   MoSSoMCMC, MoSSoSimple,
                                                   StreamingSummarizer)
from repro_torch.core.reference.dynamic_summary import (
    DynamicSummary, WeightedDynamicSummary)
from repro_torch.core.reference.minhash import MinHashClusters
from repro_torch.core.reference.neighbor_sampler import get_random_neighbors
from repro_torch.core.reference.summary_query import SummaryQueryOracle
from repro_torch.core.reference.weights import host_node_weight

__all__ = [
    "ALGORITHMS", "MoSSo", "MoSSoGreedy", "MoSSoMCMC", "MoSSoMags",
    "MoSSoSimple", "StreamingSummarizer", "DynamicSummary",
    "WeightedDynamicSummary", "MinHashClusters", "get_random_neighbors",
    "SummaryQueryOracle", "host_node_weight",
]
