"""The paper's own workload: batched incremental summarization of a fully
dynamic graph stream (MoSSo, KDD 2020), as in ``repro/configs/
mosso_stream.py``."""
from repro_torch.core.engine.state import EngineConfig

ARCH_ID = "mosso-stream"


def full_config() -> EngineConfig:
    """The repository's full deployment configuration (~1.4 GB of tables)."""
    return EngineConfig(n_cap=1 << 20, m_cap=1 << 23, d_cap=64, sn_cap=48,
                        c=32, batch=256, escape=0.2)


def smoke_config() -> EngineConfig:
    return EngineConfig(n_cap=512, m_cap=4096, d_cap=32, sn_cap=24,
                        c=8, batch=16, escape=0.3)
