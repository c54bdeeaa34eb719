"""The four GNN architectures over one edge-list GraphBatch (port of
``repro/models/gnn.py``): graphsage-reddit, egnn, dimenet and graphcast.

Every neighborhood sum goes through ``kernels/ops.py``'s segment-reduce,
so on the card message passing runs the CSR kernel; the matrix products
stay ``torch.matmul``.  (The JAX package's docstring says its message
passing is routed through its kernel layer, but its ``_agg`` calls
``jax.ops.segment_sum``; the port does what that docstring says, which is
the same function.)  Forward only: the loss and backward wait for the
training slice.

Parameters are nested dicts and lists of tensors, laid out as the JAX
package's, so :func:`params_from_numpy` carries JAX-initialised weights
across unchanged.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.common import (  # noqa: F401 (re-exported)
    dense_init, layer_norm, params_from_numpy, params_to)

Params = Dict[str, Any]


class GraphBatch(NamedTuple):
    """Fixed-shape graph sample (padded; masks mark live entries)."""
    node_feat: torch.Tensor                     # f32[N, F]
    senders: torch.Tensor                       # i32[E]
    receivers: torch.Tensor                     # i32[E]
    edge_mask: torch.Tensor                     # bool[E]
    node_mask: torch.Tensor                     # bool[N]
    labels: torch.Tensor                        # i32[N] or f32[N, dy]
    coords: Optional[torch.Tensor] = None       # f32[N, 3] (egnn/dimenet)
    triplet_kj: Optional[torch.Tensor] = None   # i32[T] edge ids (dimenet)
    triplet_ji: Optional[torch.Tensor] = None   # i32[T]

    def to(self, device) -> "GraphBatch":
        return GraphBatch(*(None if t is None else t.to(device)
                            for t in self))


@dataclasses.dataclass(frozen=True)
class GNNConfig:
    name: str = "gnn"
    arch: str = "graphsage"     # graphsage | egnn | dimenet | graphcast
    n_layers: int = 2
    d_hidden: int = 128
    d_in: int = 128
    n_classes: int = 16
    # dimenet
    n_rbf: int = 6
    n_sbf: int = 7
    n_bilinear: int = 8
    # graphcast
    n_mesh_frac: int = 4        # mesh nodes = N // n_mesh_frac
    aggregator: str = "sum"
    param_dtype: Any = torch.float32


def _mlp_init(gen, dims, dtype):
    return [{"w": dense_init(gen, (a, b), dtype=dtype),
             "b": torch.zeros((b,), dtype=dtype)}
            for a, b in zip(dims[:-1], dims[1:])]


def _mlp(layers, x, act=F.silu):
    for i, l in enumerate(layers):
        x = x @ l["w"] + l["b"]
        if i + 1 < len(layers):
            x = act(x)
    return x


def _agg(receivers, msgs, n, mode="sum"):
    """Sum (or mean) the per-edge rows ``msgs`` into ``n`` rows by
    receiver: a segment-reduce whose senders are the edge ids."""
    edges = torch.arange(msgs.shape[0], device=msgs.device)
    layout = ops.csr_layout(edges, receivers, n)
    out = ops.segment_reduce_csr(layout, msgs, "sum")
    if mode == "mean":
        deg = torch.clamp(layout.degree(), min=1).to(msgs.dtype)
        out = out / deg[:, None]
    return out


# --------------------------------------------------------------------------- #
# GraphSAGE (mean aggregator)
# --------------------------------------------------------------------------- #


def init_graphsage(cfg: GNNConfig, gen: torch.Generator) -> Params:
    dims = [cfg.d_in] + [cfg.d_hidden] * cfg.n_layers
    layers = [{"w_self": dense_init(gen, (dims[i], dims[i + 1]),
                                    dtype=cfg.param_dtype),
               "w_nbr": dense_init(gen, (dims[i], dims[i + 1]),
                                   dtype=cfg.param_dtype)}
              for i in range(cfg.n_layers)]
    return {"layers": layers,
            "head": dense_init(gen, (cfg.d_hidden, cfg.n_classes),
                               dtype=cfg.param_dtype)}


def graphsage_forward(params: Params, g: GraphBatch,
                      cfg: GNNConfig) -> torch.Tensor:
    h = g.node_feat
    n = h.shape[0]
    # one layout for both layers; masked edges are dropped from it, so the
    # degree is the row length
    layout = ops.csr_layout(g.senders, g.receivers, n, g.edge_mask)
    deg = layout.degree().to(h.dtype)
    inv_deg = (1.0 / torch.clamp(deg, min=1.0))[:, None]
    for l in params["layers"]:
        # mean aggregation commutes with the linear map: project BEFORE
        # gathering when d_out < d_in, so the kernel moves d_out-wide rows
        if l["w_nbr"].shape[1] < h.shape[1]:
            z = h @ l["w_nbr"]
            agg = ops.segment_reduce_csr(layout, z, "sum") * inv_deg
        else:
            agg = (ops.segment_reduce_csr(layout, h, "sum")
                   * inv_deg) @ l["w_nbr"]
        h = torch.relu(h @ l["w_self"] + agg)
        h = h / torch.clamp(torch.linalg.vector_norm(h, dim=-1,
                                                     keepdim=True), min=1e-6)
    return h @ params["head"]


# --------------------------------------------------------------------------- #
# EGNN (E(n)-equivariant)
# --------------------------------------------------------------------------- #


def init_egnn(cfg: GNNConfig, gen: torch.Generator) -> Params:
    d, dt = cfg.d_hidden, cfg.param_dtype
    layers = [{"phi_e": _mlp_init(gen, [2 * d + 1, d, d], dt),
               "phi_x": _mlp_init(gen, [d, d, 1], dt),
               "phi_h": _mlp_init(gen, [2 * d, d, d], dt)}
              for _ in range(cfg.n_layers)]
    return {"embed": dense_init(gen, (cfg.d_in, d), dtype=dt),
            "layers": layers,
            "head": dense_init(gen, (d, cfg.n_classes), dtype=dt)}


def egnn_forward(params: Params, g: GraphBatch,
                 cfg: GNNConfig) -> torch.Tensor:
    h = g.node_feat @ params["embed"]
    x = g.coords
    n = h.shape[0]
    s, r = g.senders.long(), g.receivers.long()
    w = g.edge_mask[:, None].to(h.dtype)
    for l in params["layers"]:
        diff = x[s] - x[r]
        d2 = torch.sum(diff * diff, dim=-1, keepdim=True)
        m = _mlp(l["phi_e"], torch.cat([h[s], h[r], d2], dim=-1)) * w
        xw = torch.tanh(_mlp(l["phi_x"], m))          # bounded coord gate
        x = x + _agg(r, diff * xw * w, n) / (n + 1)
        magg = _agg(r, m, n)
        h = h + _mlp(l["phi_h"], torch.cat([h, magg], dim=-1))
    return h @ params["head"]


# --------------------------------------------------------------------------- #
# DimeNet (directional message passing with RBF/SBF bases)
# --------------------------------------------------------------------------- #


def _rbf(d, n_rbf, cutoff=5.0):
    """Bessel-style radial basis."""
    freq = torch.arange(1, n_rbf + 1, dtype=torch.float32,
                        device=d.device) * math.pi
    dn = torch.clamp(d / cutoff, 1e-4, 1.0)
    return torch.sin(freq * dn[..., None]) / dn[..., None]


def _sbf(angle, n_sbf):
    k = torch.arange(n_sbf, dtype=torch.float32, device=angle.device)
    return torch.cos(angle[..., None] * (k + 1.0))


def init_dimenet(cfg: GNNConfig, gen: torch.Generator) -> Params:
    d, dt = cfg.d_hidden, cfg.param_dtype
    blocks = [{"w_rbf": dense_init(gen, (cfg.n_rbf, d), dtype=dt),
               "w_sbf": dense_init(gen, (cfg.n_sbf, cfg.n_bilinear),
                                   dtype=dt),
               "bilinear": dense_init(gen, (cfg.n_bilinear, d, d),
                                      scale=0.1, dtype=dt),
               "upd": _mlp_init(gen, [2 * d, d, d], dt)}
              for _ in range(cfg.n_layers)]
    return {"embed": dense_init(gen, (cfg.d_in, d), dtype=dt),
            "msg0": _mlp_init(gen, [2 * d + cfg.n_rbf, d, d], dt),
            "blocks": blocks,
            "head": dense_init(gen, (d, cfg.n_classes), dtype=dt)}


def dimenet_forward(params: Params, g: GraphBatch,
                    cfg: GNNConfig) -> torch.Tensor:
    h = g.node_feat @ params["embed"]
    n = h.shape[0]
    s, r = g.senders.long(), g.receivers.long()
    diff = g.coords[s] - g.coords[r]
    dist = torch.sqrt(torch.sum(diff * diff, dim=-1) + 1e-9)
    rbf = _rbf(dist, cfg.n_rbf)
    w = g.edge_mask[:, None].to(h.dtype)
    m = _mlp(params["msg0"], torch.cat([h[s], h[r], rbf], dim=-1)) * w

    tkj, tji = g.triplet_kj.long(), g.triplet_ji.long()
    triplets = torch.arange(tkj.shape[0], device=tkj.device)
    # the triplet sum's layout is the same in every block
    t_layout = ops.csr_layout(triplets, tji, m.shape[0])
    for blk in params["blocks"]:
        # edge (k->j) modulates edge (j->i) through the angle between them
        d_kj, d_ji = diff[tkj], diff[tji]
        cosang = torch.sum(d_kj * d_ji, dim=-1) / (
            torch.linalg.vector_norm(d_kj, dim=-1)
            * torch.linalg.vector_norm(d_ji, dim=-1) + 1e-9)
        sbf = _sbf(torch.arccos(torch.clamp(cosang, -1 + 1e-6, 1 - 1e-6)),
                   cfg.n_sbf)
        basis = sbf @ blk["w_sbf"]                          # [T, n_bilinear]
        inter = torch.einsum("tb,bio,ti->to", basis, blk["bilinear"],
                             m[tkj])
        t_agg = ops.segment_reduce_csr(t_layout, inter, "sum")
        gate = rbf @ blk["w_rbf"]
        m = m + _mlp(blk["upd"], torch.cat([m * gate, t_agg], dim=-1)) * w
    out = _agg(r, m, n)
    return out @ params["head"]


# --------------------------------------------------------------------------- #
# GraphCast-style encoder-processor-decoder
# --------------------------------------------------------------------------- #


def init_graphcast(cfg: GNNConfig, gen: torch.Generator) -> Params:
    d, dt = cfg.d_hidden, cfg.param_dtype
    proc = [{"edge": _mlp_init(gen, [3 * d, d, d], dt),
             "node": _mlp_init(gen, [2 * d, d, d], dt),
             "ln_e": torch.ones((d,), dtype=dt),
             "ln_n": torch.ones((d,), dtype=dt)}
            for _ in range(cfg.n_layers)]
    return {"grid_embed": dense_init(gen, (cfg.d_in, d), dtype=dt),
            "g2m": _mlp_init(gen, [2 * d, d, d], dt),
            "processor": proc,
            "m2g": _mlp_init(gen, [2 * d, d, d], dt),
            "head": dense_init(gen, (d, cfg.n_classes), dtype=dt)}


def graphcast_forward(params: Params, g: GraphBatch,
                      cfg: GNNConfig) -> torch.Tensor:
    """Encode grid->mesh, process on the mesh, decode mesh->grid; mesh
    nodes are the first N // n_mesh_frac node ids, and the edges fold
    into the mesh id range."""
    n = g.node_feat.shape[0]
    nm = max(1, n // cfg.n_mesh_frac)
    h_grid = g.node_feat @ params["grid_embed"]
    s, r = g.senders.long(), g.receivers.long()
    w = g.edge_mask[:, None].to(h_grid.dtype)

    # encoder: grid -> mesh
    mesh_rcv = r % nm
    msgs = _mlp(params["g2m"], torch.cat(
        [h_grid[s], h_grid[mesh_rcv]], dim=-1)) * w
    h_mesh = _agg(mesh_rcv, msgs, nm, cfg.aggregator)

    # processor: n_layers of residual message passing on the mesh
    ms, mr = s % nm, r % nm
    e_feat = torch.zeros((s.shape[0], h_mesh.shape[1]), dtype=h_mesh.dtype,
                         device=h_mesh.device)
    for blk in params["processor"]:
        e_in = torch.cat([e_feat, h_mesh[ms], h_mesh[mr]], dim=-1)
        e_feat = e_feat + layer_norm(_mlp(blk["edge"], e_in) * w,
                                     blk["ln_e"],
                                     torch.zeros_like(blk["ln_e"]))
        agg = _agg(mr, e_feat * w, nm, cfg.aggregator)
        n_in = torch.cat([h_mesh, agg], dim=-1)
        h_mesh = h_mesh + layer_norm(_mlp(blk["node"], n_in), blk["ln_n"],
                                     torch.zeros_like(blk["ln_n"]))

    # decoder: mesh -> grid
    msgs = _mlp(params["m2g"], torch.cat(
        [h_mesh[ms], h_grid[r]], dim=-1)) * w
    h_out = h_grid + _agg(r, msgs, n, cfg.aggregator)
    return h_out @ params["head"]


# --------------------------------------------------------------------------- #
# dispatch
# --------------------------------------------------------------------------- #

GNN_INITS = {"graphsage": init_graphsage, "egnn": init_egnn,
             "dimenet": init_dimenet, "graphcast": init_graphcast}
GNN_FORWARDS = {"graphsage": graphsage_forward, "egnn": egnn_forward,
                "dimenet": dimenet_forward, "graphcast": graphcast_forward}


def init_gnn(cfg: GNNConfig, seed: int = 0, device="cuda") -> Params:
    """Random parameters from ``seed`` (drawn on the CPU, so a seed gives
    the same weights on every device), placed on ``device``."""
    return params_to(GNN_INITS[cfg.arch](
        cfg, torch.Generator().manual_seed(seed)), device)


def gnn_forward(params: Params, g: GraphBatch,
                cfg: GNNConfig) -> torch.Tensor:
    return GNN_FORWARDS[cfg.arch](params, g, cfg)
