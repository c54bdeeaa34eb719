"""Arch registry, shape cells and logical sharding rules (port of
``repro/configs/base.py``).

An :class:`ArchSpec` binds an arch's full and smoke configurations and
its dry-run shape cells; ``configs/__init__.py`` imports every config,
which registers itself in :data:`REGISTRY`.  A cell's ``inputs`` returns
:class:`SDS` records (shape and dtype) only: the dry-run never allocates
a full-size tensor (``SDS.meta()`` gives a ``meta`` tensor of the shape).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import torch

F32, I32, BF16, BOOL = torch.float32, torch.int32, torch.bfloat16, torch.bool


@dataclasses.dataclass(frozen=True)
class SDS:
    """A shape and a dtype: the port's ``jax.ShapeDtypeStruct``."""
    shape: Tuple[int, ...]
    dtype: torch.dtype

    @property
    def nbytes(self) -> int:
        n = 1
        for d in self.shape:
            n *= d
        return n * torch.empty((), dtype=self.dtype).element_size()

    def meta(self) -> torch.Tensor:
        return torch.empty(self.shape, dtype=self.dtype, device="meta")


def sds(shape, dtype) -> SDS:
    return SDS(tuple(int(x) for x in shape), dtype)


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    """One (architecture x input-shape) dry-run cell."""
    name: str
    kind: str                      # train | prefill | decode | serve | stream
    inputs: Callable[[Any], Dict[str, Any]]
    note: str = ""
    skip: bool = False             # e.g. long_500k on pure full-attention LMs


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    family: str                    # lm | gnn | recsys | mosso
    source: str                    # public-literature citation
    make_config: Callable[[], Any]
    make_smoke_config: Callable[[], Any]
    cells: Tuple[ShapeCell, ...] = ()
    technique_applicable: str = ""

    def cell(self, name: str) -> ShapeCell:
        for c in self.cells:
            if c.name == name:
                return c
        raise KeyError(f"{self.arch_id} has no shape {name}")


REGISTRY: Dict[str, ArchSpec] = {}


def register(spec: ArchSpec) -> ArchSpec:
    REGISTRY[spec.arch_id] = spec
    return spec


# ---------------------------------------------------------------- LM shapes

# tokens per sequence and sequences per batch of the LM cells; decode is
# one new token against a ``seq``-long KV cache
LM_SHAPES = dict(
    train_4k=dict(seq=4096, batch=256, kind="train"),
    prefill_32k=dict(seq=32768, batch=32, kind="prefill"),
    decode_32k=dict(seq=32768, batch=128, kind="decode"),
    long_500k=dict(seq=524288, batch=1, kind="decode"),
)


def lm_cells(full_attention: bool = True) -> Tuple[ShapeCell, ...]:
    cells = []
    for name, s in LM_SHAPES.items():
        kind = s["kind"]
        seq, batch = s["seq"], s["batch"]
        if kind == "train":
            def inputs(cfg, seq=seq, batch=batch):
                return dict(tokens=sds((batch, seq), I32),
                            labels=sds((batch, seq), I32))
        elif kind == "prefill":
            def inputs(cfg, seq=seq, batch=batch):
                return dict(tokens=sds((batch, seq), I32))
        else:  # decode: one new token against a seq-long KV cache
            def inputs(cfg, seq=seq, batch=batch):
                return dict(tokens=sds((batch,), I32),
                            cache_len=seq, cache_batch=batch)
        skip = (name == "long_500k" and full_attention)
        note = ("skipped: pure full-attention arch (DESIGN.md) — decode is "
                "O(L)/token but no sub-quadratic variant exists in the "
                "public config" if skip else "")
        cells.append(ShapeCell(name=name, kind=kind, inputs=inputs,
                               skip=skip, note=note))
    return tuple(cells)


# --------------------------------------------------------------- GNN shapes

def _pad512(x: int) -> int:
    """Node/edge counts padded to the 512-chip multi-pod mesh (masked)."""
    return (x + 511) // 512 * 512


GNN_SHAPES = dict(
    full_graph_sm=dict(n=_pad512(2708), e=_pad512(10556), f=1433,
                       kind="train", note="2708 live nodes, rest masked"),
    minibatch_lg=dict(n=262144, e=262144, f=602, kind="train",
                      note="1024 seeds x fanout 15-10 padded subgraph; "
                           "sampler in repro.graph.sampling"),
    ogb_products=dict(n=_pad512(2449029), e=_pad512(61859140), f=100,
                      kind="train", note="2449029 live nodes, rest masked"),
    molecule=dict(n=_pad512(30 * 128), e=64 * 128 * 2, f=32, kind="train",
                  note="128 molecules of 30 nodes, flattened disjoint union"),
)


def gnn_cells(needs_coords: bool,
              triplet_cap: int = 4) -> Tuple[ShapeCell, ...]:
    cells = []
    for name, s in GNN_SHAPES.items():
        def inputs(cfg, s=s):
            n, e, f = s["n"], s["e"], s["f"]
            d = dict(
                node_feat=sds((n, f), F32),
                senders=sds((e,), I32),
                receivers=sds((e,), I32),
                edge_mask=sds((e,), BOOL),
                node_mask=sds((n,), BOOL),
                labels=sds((n,), I32),
            )
            if needs_coords:
                d["coords"] = sds((n, 3), F32)
                if getattr(cfg, "arch", "") == "dimenet":
                    t = e * triplet_cap
                    d["triplet_kj"] = sds((t,), I32)
                    d["triplet_ji"] = sds((t,), I32)
            return d
        cells.append(ShapeCell(name=name, kind="train", inputs=inputs,
                               note=s.get("note", "")))
    return tuple(cells)


# ------------------------------------------------------------ recsys shapes

# the recsys cells: sequences per batch, and candidates per request
RECSYS_SHAPES = dict(
    train_batch=dict(batch=65536, kind="train"),
    serve_p99=dict(batch=512, kind="serve", n_cand=4096),
    serve_bulk=dict(batch=262144, kind="serve", n_cand=4096),
    retrieval_cand=dict(batch=1, kind="serve", n_cand=1_000_000),
)


def recsys_cells() -> Tuple[ShapeCell, ...]:
    cells = []
    for name, s in RECSYS_SHAPES.items():
        if s["kind"] == "train":
            def inputs(cfg, s=s):
                L = cfg.seq_len
                return dict(seq=sds((s["batch"], L), I32),
                            pos=sds((s["batch"], L), I32),
                            neg=sds((s["batch"], L), I32))
        else:
            def inputs(cfg, s=s):
                L = cfg.seq_len
                return dict(seq=sds((s["batch"], L), I32),
                            candidates=sds((s["n_cand"],), I32))
        cells.append(ShapeCell(name=name, kind=s["kind"], inputs=inputs))
    return tuple(cells)


# ----------------------------------------------------- logical sharding rules
#
# Declarative logical-axis layout per parameter leaf, resolved to mesh
# specs by :mod:`repro_torch.dist.sharding`.  A rule maps a leaf NAME (the
# last string key on its tree path) to one logical axis name per TRAILING
# dimension; leading dims (the [L] layer stack, MoE [E] experts) are
# padded with None.  Logical names resolve through LOGICAL_TO_MESH, where
# "__fsdp__" stands for the arch's ``fsdp_axes`` (ZeRO-3-style parameter
# sharding over the data axes).  Any placement that does not divide the
# leaf shape on the target mesh is dropped per-dim at resolution time, so
# the same rules serve the 512-rank production meshes and small test
# meshes.

MESH_AXES = ("pod", "data", "model")

LOGICAL_TO_MESH = {
    None: None,
    "batch": ("pod", "data"),
    "embed": "__fsdp__",
    "vocab": ("model",),
    "heads": ("model",),
    "ffn": ("model",),
    "expert": ("model",),
    "hidden": ("model",),
    "items": ("model",),
}

LM_LOGICAL_RULES = {
    # embeddings / unembedding (Megatron vocab-parallel)
    "embed": ("vocab", "embed"),
    "lm_head": ("embed", "vocab"),
    # GQA attention: column-parallel qkv, row-parallel output
    "q_proj": ("embed", "heads"),
    "k_proj": ("embed", "heads"),
    "v_proj": ("embed", "heads"),
    "o_proj": ("heads", "embed"),
    # MLA low-rank path: shard only the per-head expansions
    "q_a": ("embed", None),
    "q_b": (None, "heads"),
    "kv_a": ("embed", None),
    "k_b": (None, "heads"),
    "v_b": (None, "heads"),
    # dense FFN: column-parallel up, row-parallel down
    "w_gate": ("embed", "ffn"),
    "w_up": ("embed", "ffn"),
    "w_down": ("ffn", "embed"),
    "router": (None, None),
}

# Expert-parallel overrides used when the arch is MoE: the [E] expert dim
# is sharded over 'model', so the ffn dim must stay unsharded.
MOE_FFN_LOGICAL_RULES = {
    "w_gate": ("expert", "embed", None),
    "w_up": ("expert", "embed", None),
    "w_down": ("expert", None, "embed"),
}

GNN_LOGICAL_RULES = {
    "embed": (None, "hidden"),
    "grid_embed": (None, "hidden"),
    "w_self": (None, "hidden"),
    "w_nbr": (None, "hidden"),
    "w": (None, "hidden"),          # generic MLP layer weight
    "head": (None, None),
    "w_rbf": (None, "hidden"),
}

RECSYS_LOGICAL_RULES = {
    "item_emb": ("items", "embed"),
    "wq": ("embed", "hidden"),
    "wk": ("embed", "hidden"),
    "wv": ("embed", "hidden"),
    "wo": ("hidden", "embed"),
    "ff1": ("embed", "hidden"),
    "ff2": ("hidden", "embed"),
}
