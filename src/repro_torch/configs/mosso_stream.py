"""The paper's own workload: batched incremental summarization of a fully
dynamic graph stream (MoSSo, KDD 2020), as in ``repro/configs/
mosso_stream.py``."""
import torch

from repro_torch.configs.base import ArchSpec, ShapeCell, register, sds
from repro_torch.core.engine.state import EngineConfig

ARCH_ID = "mosso-stream"


def full_config() -> EngineConfig:
    """The repository's full deployment configuration (~1.4 GB of tables)."""
    return EngineConfig(n_cap=1 << 20, m_cap=1 << 23, d_cap=64, sn_cap=48,
                        c=32, batch=256, escape=0.2)


def smoke_config() -> EngineConfig:
    return EngineConfig(n_cap=512, m_cap=4096, d_cap=32, sn_cap=24,
                        c=8, batch=16, escape=0.3)


def _inputs(cfg):
    b = cfg.batch
    return dict(u=sds((b,), torch.int32), v=sds((b,), torch.int32),
                ins=sds((b,), torch.bool))


SPEC = register(ArchSpec(
    arch_id=ARCH_ID, family="mosso", source="KDD 2020 (this paper)",
    make_config=full_config, make_smoke_config=smoke_config,
    cells=(ShapeCell(name="stream_batch", kind="stream", inputs=_inputs),),
    technique_applicable="this IS the technique"))
