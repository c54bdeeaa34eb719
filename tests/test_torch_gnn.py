"""PyTorch port: the GNN forwards, the sampler and the summary-served
aggregation script, against the JAX package.

Parameters are initialised by JAX and carried across with
``params_from_numpy``; batches are drawn with numpy from a seed by both
packages' ``graph_batch``.  The JAX forward runs its ``jax.ops`` segment
sums (it reaches no Pallas kernel).  Tolerance: rtol = atol = 1e-4
(float32 matmuls and sums in another order).
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.data import synthetic as jsyn  # noqa: E402
from repro.graph import sampling as jsamp  # noqa: E402
from repro.models import gnn as jgnn  # noqa: E402
from repro_torch.data import synthetic as tsyn  # noqa: E402
from repro_torch.graph import sampling as tsamp  # noqa: E402
from repro_torch.models import gnn as tgnn  # noqa: E402

SRC = Path(__file__).resolve().parent.parent / "src"
ARCHS = [("graphsage_reddit", False), ("egnn", True), ("dimenet", True),
         ("graphcast", False)]


def _configs(module: str, **over):
    """The arch's smoke config in both packages, with ``over`` applied."""
    import importlib
    jcfg = importlib.import_module(f"repro.configs.{module}").smoke_config()
    tcfg = importlib.import_module(
        f"repro_torch.configs.{module}").smoke_config()
    jcfg, tcfg = (dataclasses.replace(c, **over) for c in (jcfg, tcfg))
    assert {f.name: getattr(tcfg, f.name) for f in dataclasses.fields(tcfg)
            if f.name != "param_dtype"} == {
        f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)
        if f.name != "param_dtype"}
    return jcfg, tcfg


def _both_forwards(jcfg, tcfg, jb, tb, seed=0):
    jparams = jgnn.init_gnn(jcfg, jax.random.key(seed))
    want = np.asarray(jgnn.gnn_forward(jparams, jb, jcfg))
    tparams = tgnn.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                     device="cpu")
    got = tgnn.gnn_forward(tparams, tb, tcfg)
    return got.numpy(), want


def _batches(coords, mask=None):
    arrays = jsyn.graph_batch(40, 120, 16, 5, seed=1, with_coords=coords)
    tb = tsyn.graph_batch(40, 120, 16, 5, seed=1, with_coords=coords,
                          device="cpu")
    if mask is not None:
        arrays = arrays._replace(edge_mask=mask)
        tb = tb._replace(edge_mask=torch.from_numpy(mask))
    return jax.tree.map(jnp.asarray, arrays), tb


def test_graph_batch_matches_jax():
    for coords in (False, True):
        arrays = jsyn.graph_batch(40, 120, 16, 5, seed=1, with_coords=coords)
        tb = tsyn.graph_batch(40, 120, 16, 5, seed=1, with_coords=coords,
                              device="cpu")
        for name, a, t in zip(tb._fields, arrays, tb):
            assert (a is None) == (t is None), name
            if a is not None:
                assert t.numpy().dtype == a.dtype, name
                np.testing.assert_array_equal(t.numpy(), a, err_msg=name)


@pytest.mark.parametrize("module,coords", ARCHS)
def test_gnn_forward_matches_jax(module, coords):
    """Smoke configs (``d_in`` set to the batch's 16 features)."""
    jcfg, tcfg = _configs(module, d_in=16)
    jb, tb = _batches(coords)
    got, want = _both_forwards(jcfg, tcfg, jb, tb)
    assert got.shape == (40, tcfg.n_classes)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("module,coords", ARCHS)
def test_gnn_forward_with_masked_edges_matches_jax(module, coords):
    """A third of the edges masked, as a padded batch's dead slots are:
    GraphSAGE drops them from its layout (its degree is the row length);
    the others multiply their messages by the mask, as JAX does."""
    mask = np.random.default_rng(2).random(120) > 1 / 3
    jcfg, tcfg = _configs(module, d_in=16)
    jb, tb = _batches(coords, mask)
    got, want = _both_forwards(jcfg, tcfg, jb, tb, seed=3)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def _sample(mod, g_args, seed, n_pad, e_pad):
    g = mod.CSRGraph(*g_args)
    rng = np.random.default_rng(seed)
    seeds = rng.choice(g.n_nodes, 16, replace=False)
    nodes, s, r = mod.sample_fanout(g, seeds, (15, 10), rng)
    return mod.pad_subgraph(nodes, s, r, n_pad, e_pad)


def test_sampler_matches_jax():
    g = tsyn.random_csr_graph(500, 12000, seed=4)
    src = g.indices
    rcv = np.repeat(np.arange(500, dtype=np.int32), np.diff(g.indptr))
    for a, b in zip(_sample(jsamp, (500, src, rcv), 7, 4096, 4096),
                    _sample(tsamp, (500, src, rcv), 7, 4096, 4096)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        tsamp.pad_subgraph(np.zeros(5, np.int32), np.zeros(9, np.int32),
                           np.zeros(9, np.int32), 8, 8)


def test_graphsage_reddit_request_matches_jax():
    """The slice's path at a small size: full_config() (602 features,
    128 hidden, 41 classes, mean), a 15-10 sample of 16 seeds padded to
    n = e = 4096, masked pad edges."""
    from repro.configs import graphsage_reddit as jcfgmod
    from repro_torch.configs import graphsage_reddit as tcfgmod
    g = tsyn.random_csr_graph(2000, 40000, seed=5)
    nodes, s, r, nmask, emask = _sample(
        tsamp, (2000, g.indices,
                np.repeat(np.arange(2000, dtype=np.int32),
                          np.diff(g.indptr))), 5, 4096, 4096)
    assert not emask.all()
    feat = np.random.default_rng(5).normal(size=(2000, 602)).astype(
        np.float32)[nodes]
    labels = np.zeros(4096, np.int32)
    arrays = (feat, s, r, emask, nmask, labels)
    jb = jgnn.GraphBatch(*map(jnp.asarray, arrays))
    tb = tgnn.GraphBatch(*map(torch.from_numpy, arrays))
    got, want = _both_forwards(jcfgmod.full_config(), tcfgmod.full_config(),
                               jb, tb)
    assert got.shape == (4096, 41)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_init_gnn_shapes_match_jax():
    for module, _ in ARCHS:
        jcfg, tcfg = _configs(module)
        jp = jax.tree.map(np.asarray,
                          jgnn.init_gnn(jcfg, jax.random.key(0)))
        tp = tgnn.init_gnn(tcfg, seed=0, device="cpu")
        jl, jt = jax.tree.flatten(jp)
        tl, tt = jax.tree.flatten(
            jax.tree.map(lambda t: t.numpy(), tp,
                         is_leaf=lambda x: isinstance(x, torch.Tensor)))
        assert jt == tt, module
        assert [a.shape for a in jl] == [b.shape for b in tl], module


def test_gnn_over_summary_runs_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.gnn_over_summary",
         "--device", "cpu", "--nodes", "48", "--blocks", "4", "--c", "4"],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "query-served == summary_spmm == dense" in proc.stdout
    assert "device=cpu" in proc.stdout
