"""Online serving layer: read queries answered from the live summary."""
from repro_torch.serve.query import SummaryQuery

__all__ = ["SummaryQuery"]
