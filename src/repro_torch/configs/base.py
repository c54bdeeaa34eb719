"""Arch registry and input shapes (port of ``repro/configs/base.py``).

An :class:`ArchSpec` binds an arch's full and smoke configurations;
``configs/__init__.py`` imports every ported config, which registers
itself in :data:`REGISTRY`.  The dry-run's shape cells (``ShapeCell`` and
the ``*_cells`` builders) are not ported yet: ``cells`` stays ``()``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    family: str                    # lm | gnn | recsys | mosso
    source: str                    # public-literature citation
    make_config: Callable[[], Any]
    make_smoke_config: Callable[[], Any]
    cells: Tuple[Any, ...] = ()
    technique_applicable: str = ""


REGISTRY: Dict[str, ArchSpec] = {}


def register(spec: ArchSpec) -> ArchSpec:
    REGISTRY[spec.arch_id] = spec
    return spec


def _pad512(x: int) -> int:
    """Node/edge counts padded to the 512-chip multi-pod mesh (masked)."""
    return (x + 511) // 512 * 512


GNN_SHAPES = dict(
    full_graph_sm=dict(n=_pad512(2708), e=_pad512(10556), f=1433,
                       kind="train", note="2708 live nodes, rest masked"),
    minibatch_lg=dict(n=262144, e=262144, f=602, kind="train",
                      note="1024 seeds x fanout 15-10 padded subgraph; "
                           "sampler in repro_torch.graph.sampling"),
    ogb_products=dict(n=_pad512(2449029), e=_pad512(61859140), f=100,
                      kind="train", note="2449029 live nodes, rest masked"),
    molecule=dict(n=_pad512(30 * 128), e=64 * 128 * 2, f=32, kind="train",
                  note="128 molecules of 30 nodes, flattened disjoint union"),
)


# tokens per sequence and sequences per batch of the LM cells; decode is
# one new token against a ``seq``-long KV cache
LM_SHAPES = dict(
    train_4k=dict(seq=4096, batch=256, kind="train"),
    prefill_32k=dict(seq=32768, batch=32, kind="prefill"),
    decode_32k=dict(seq=32768, batch=128, kind="decode"),
    long_500k=dict(seq=524288, batch=1, kind="decode"),
)


# the recsys cells: sequences per batch, and candidates per request
RECSYS_SHAPES = dict(
    train_batch=dict(batch=65536, kind="train"),
    serve_p99=dict(batch=512, kind="serve", n_cand=4096),
    serve_bulk=dict(batch=262144, kind="serve", n_cand=4096),
    retrieval_cand=dict(batch=1, kind="serve", n_cand=1_000_000),
)
