"""Fault tolerance: fault injection and the recovering stream driver (port
of the JAX package's ``repro.ft``)."""
from repro_torch.ft import inject, resilience
from repro_torch.ft.inject import SimulatedCrash, drive
from repro_torch.ft.resilience import (StragglerDetector, plan_elastic_mesh,
                                       rebalance_batch,
                                       run_stream_with_recovery,
                                       run_with_retries)

__all__ = ["SimulatedCrash", "StragglerDetector", "drive", "inject",
           "plan_elastic_mesh", "rebalance_batch", "resilience",
           "run_stream_with_recovery", "run_with_retries"]
