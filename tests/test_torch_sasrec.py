"""PyTorch port: SASRec against the JAX package.

Parameters are initialised by JAX and carried across with
``params_from_numpy`` (its nested ``blocks`` list included); batches come
from both packages' ``sasrec_batches``, which draw the same numpy numbers
from a seed.  The sequence length (12 in the smoke config) is not a
multiple of 128, so attention takes the reference on both sides.
Tolerances: forward values rtol = atol = 1e-5, gradients 1e-4 (float32
sums in another order), top-k indices exact.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import sasrec as jcfgs  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro.models import sasrec as jsas  # noqa: E402
from repro_torch.configs import sasrec as tcfgs  # noqa: E402
from repro_torch.data import synthetic as tsyn  # noqa: E402
from repro_torch.models import sasrec as tsas  # noqa: E402
from repro_torch.train.step import value_and_grad  # noqa: E402


def _flat(tree, prefix=""):
    """``{path: numpy array}`` of a nested dict/list of arrays/tensors."""
    if isinstance(tree, dict):
        return {k: v for key in tree
                for k, v in _flat(tree[key], f"{prefix}/{key}").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, x in enumerate(tree)
                for k, v in _flat(x, f"{prefix}/{i}").items()}
    if isinstance(tree, torch.Tensor):
        tree = tree.detach().numpy()
    return {prefix: np.asarray(tree)}


@pytest.fixture(scope="module")
def model():
    jcfg, tcfg = jcfgs.smoke_config(), tcfgs.smoke_config()
    assert {f.name: getattr(tcfg, f.name) for f in dataclasses.fields(tcfg)
            if f.name != "param_dtype"} == {
        f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)
        if f.name != "param_dtype"}
    jparams = jsas.init_sasrec(jcfg, jax.random.key(0))
    tparams = tsas.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                     device="cpu")
    return jcfg, tcfg, jparams, tparams


def _batch(cfg, b=6, seed=3):
    jb = next(jsyn.sasrec_batches(cfg.n_items, b, cfg.seq_len, seed=seed))
    tb = next(tsyn.sasrec_batches(cfg.n_items, b, cfg.seq_len, seed=seed,
                                  device="cpu"))
    for a, t in zip(jb, tb):
        assert t.dtype == torch.int32
        np.testing.assert_array_equal(t.numpy(), a)
    return tuple(map(jnp.asarray, jb)), tb


def test_full_config_matches_jax_and_params_carry_the_blocks_list(model):
    jfull = jcfgs.full_config()
    assert {f.name: getattr(tcfgs.full_config(), f.name)
            for f in dataclasses.fields(jfull) if f.name != "param_dtype"} \
        == {f.name: getattr(jfull, f.name)
            for f in dataclasses.fields(jfull) if f.name != "param_dtype"}
    _, tcfg, jparams, tparams = model
    assert isinstance(tparams["blocks"], list)
    assert len(tparams["blocks"]) == tcfg.n_blocks
    want = _flat(jax.tree.map(np.asarray, jparams))
    got = _flat(tparams)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # the port's own init has JAX's layout, shapes and dtypes
    own = _flat(tsas.init_sasrec(tcfg, 0, device="cpu"))
    assert {k: (v.shape, v.dtype) for k, v in own.items()} == {
        k: (v.shape, v.dtype) for k, v in want.items()}


def test_encode_loss_scores_and_topk_match_jax(model):
    jcfg, tcfg, jparams, tparams = model
    jb, tb = _batch(jcfg)
    np.testing.assert_allclose(
        tsas.encode(tparams, tb[0], tcfg).numpy(),
        np.asarray(jsas.encode(jparams, jb[0], jcfg)), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        float(tsas.train_loss(tparams, *tb, tcfg)),
        float(jsas.train_loss(jparams, *jb, jcfg)), rtol=1e-5, atol=1e-5)
    cand = np.random.default_rng(4).integers(
        1, jcfg.n_items, 64).astype(np.int32)
    np.testing.assert_allclose(
        tsas.score_candidates(tparams, tb[0], torch.from_numpy(cand),
                              tcfg).numpy(),
        np.asarray(jsas.score_candidates(jparams, jb[0], jnp.asarray(cand),
                                         jcfg)), rtol=1e-5, atol=1e-5)
    tv, ti = tsas.serve_topk(tparams, tb[0], torch.from_numpy(cand), tcfg)
    jv, ji = jsas.serve_topk(jparams, jb[0], jnp.asarray(cand), jcfg)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5,
                               atol=1e-5)
    assert ti.dtype == torch.int32
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def test_serve_topk_breaks_ties_as_lax_top_k(model):
    """Repeated candidates score exactly alike: the lower position comes
    first, as ``lax.top_k`` orders them."""
    jcfg, tcfg, jparams, tparams = model
    jb, tb = _batch(jcfg, b=3)
    cand = np.repeat(np.array([7, 3, 7, 11, 3], np.int32), 5)[
        np.random.default_rng(5).permutation(25)]
    tv, ti = tsas.serve_topk(tparams, tb[0], torch.from_numpy(cand), tcfg,
                             k=12)
    jv, ji = jsas.serve_topk(jparams, jb[0], jnp.asarray(cand), jcfg, k=12)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5,
                               atol=1e-5)
    # ties really occur, and come in ascending position
    for row_v, row_i in zip(tv.numpy(), ti.numpy()):
        for a in range(11):
            if row_v[a] == row_v[a + 1]:
                assert row_i[a] < row_i[a + 1]


def test_padding_stays_inert(model):
    """Item 0 is padding: its row changes neither the states nor the loss,
    and gets no gradient."""
    _, tcfg, _, tparams = model
    seq, pos, neg = next(tsyn.sasrec_batches(tcfg.n_items, 4, tcfg.seq_len,
                                             seed=8, device="cpu"))
    seq[:, :5] = 0                      # left-padded histories
    pos[:, :4] = 0
    assert bool((seq == 0).any()) and bool((pos == 0).any())
    other = dict(tparams, item_emb=tparams["item_emb"].clone())
    other["item_emb"][0] = 3.0
    h = tsas.encode(tparams, seq, tcfg)
    assert bool((h[:, :5] == 0).all())
    np.testing.assert_array_equal(tsas.encode(other, seq, tcfg).numpy(),
                                  h.numpy())
    assert float(tsas.train_loss(other, seq, pos, neg, tcfg)) == float(
        tsas.train_loss(tparams, seq, pos, neg, tcfg))
    _, grads = value_and_grad(
        lambda p, *b: tsas.train_loss(p, *b, tcfg), tparams, seq, pos, neg)
    assert bool((grads["item_emb"][0] == 0).all())
    assert bool((grads["item_emb"] != 0).any())


def test_train_loss_gradient_matches_jax(model):
    jcfg, tcfg, jparams, tparams = model
    jb, tb = _batch(jcfg, b=8, seed=6)
    jloss, jgrads = jax.value_and_grad(jsas.train_loss)(jparams, *jb, jcfg)
    tloss, tgrads = value_and_grad(
        lambda p, *b: tsas.train_loss(p, *b, tcfg), tparams, *tb)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    want = _flat(jax.tree.map(np.asarray, jgrads))
    got = _flat(tgrads)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-4,
                                   err_msg=k)
