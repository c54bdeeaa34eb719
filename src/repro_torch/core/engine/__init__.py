from repro_torch.core.engine.api import BatchedSummarizer, ShardedSummarizer
from repro_torch.core.engine.state import EngineConfig, EngineState, new_state
from repro_torch.core.engine.trial import step_fn

__all__ = ["BatchedSummarizer", "EngineConfig", "EngineState",
           "ShardedSummarizer", "new_state", "step_fn"]
