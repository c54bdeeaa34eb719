"""PyTorch port: the training stack against the JAX package.

``cross_entropy``, ``gnn_loss`` (the four GNN archs), the LM ``loss_fn``
and their gradients, AdamW, ``make_train_step`` (microbatching too),
``launch/train.py`` and its checkpoints.  Parameters and optimizer states
are initialised by JAX and carried across by ``params_from_numpy`` and
``opt_state_from_numpy``; batches come from both packages' synthetic
pipelines, which draw the same numpy numbers from a seed.  Tolerances:
losses rtol = 1e-5, gradients rtol = atol = 1e-4 (float32 sums in another
order), AdamW on identical gradients 1e-6, parameters after one train
step rtol = atol = 1e-6 (one step moves a leaf by at most about lr, and
Adam divides each gradient by its own size, so a last-bit difference
stays a last-bit difference only in the first step: after several steps
the parameters are not held, the losses are).
"""
import dataclasses
import importlib
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import REGISTRY as JREG  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro.launch import train as jlaunch  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import gnn as jgnn  # noqa: E402
from repro.models import sasrec as jsas  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.optim import adamw as jadam  # noqa: E402
from repro.train import step as jstep  # noqa: E402
from repro_torch.configs import REGISTRY as TREG  # noqa: E402
from repro_torch.data import synthetic as tsyn  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402
from repro_torch.models import gnn as tgnn  # noqa: E402
from repro_torch.models import sasrec as tsas  # noqa: E402
from repro_torch.models import transformer as ttfm  # noqa: E402
from repro_torch.optim import adamw as tadam  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402

SRC = Path(__file__).resolve().parent.parent / "src"
GNN_ARCHS = [("graphsage_reddit", False), ("egnn", True), ("dimenet", True),
             ("graphcast", False)]
LM_ARCHS = ["internlm2_20b", "granite_moe_3b_a800m", "minicpm3_4b"]
OPT = dict(lr=1e-3, warmup_steps=10, total_steps=1000)


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


def _close_trees(got, want, rtol, atol):
    got, want = _flat(got), _flat(jax.tree.map(np.asarray, want))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol,
                                   err_msg=k)


def _configs(module):
    jcfg = importlib.import_module(f"repro.configs.{module}").smoke_config()
    tcfg = importlib.import_module(
        f"repro_torch.configs.{module}").smoke_config()
    assert {f.name: getattr(tcfg, f.name) for f in dataclasses.fields(tcfg)
            if "dtype" not in f.name} == {
        f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)
        if "dtype" not in f.name}
    return jcfg, tcfg


def _carry(jparams):
    return tcommon.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                     device="cpu")


def _family(name):
    """``(jax loss, port loss, jax params, [jax batches], [port batches])``
    of one smoke config per family, three batches each."""
    if name == "recsys":
        jcfg, tcfg = _configs("sasrec")
        jp = jsas.init_sasrec(jcfg, jax.random.key(0))
        jb = jsyn.sasrec_batches(jcfg.n_items, 8, jcfg.seq_len)
        tb = tsyn.sasrec_batches(tcfg.n_items, 8, tcfg.seq_len,
                                 device="cpu")
        return (lambda p, *b: jsas.train_loss(p, *b, jcfg),
                lambda p, *b: tsas.train_loss(p, *b, tcfg), jp,
                [tuple(map(jnp.asarray, next(jb))) for _ in range(3)],
                [next(tb) for _ in range(3)])
    if name == "gnn":
        jcfg, tcfg = _configs("graphsage_reddit")
        g = jsyn.graph_batch(64, 256, jcfg.d_in, jcfg.n_classes, seed=0)
        tg = tsyn.graph_batch(64, 256, tcfg.d_in, tcfg.n_classes, seed=0,
                              device="cpu")
        return (lambda p, b: jgnn.gnn_loss(p, b, jcfg),
                lambda p, b: tgnn.gnn_loss(p, b, tcfg),
                jgnn.init_gnn(jcfg, jax.random.key(0)),
                [(jax.tree.map(jnp.asarray, g),)] * 3, [(tg,)] * 3)
    jcfg, tcfg = _configs("granite_moe_3b_a800m")
    jb = jsyn.lm_batches(jcfg.vocab, 8, 64)
    tb = tsyn.lm_batches(tcfg.vocab, 8, 64, device="cpu")
    return (lambda p, t, l: jtfm.loss_fn(p, t, l, jcfg),
            lambda p, t, l: ttfm.loss_fn(p, t, l, tcfg),
            jtfm.init_transformer(jcfg, jax.random.key(0)),
            [tuple(map(jnp.asarray, next(jb))) for _ in range(3)],
            [next(tb) for _ in range(3)])


def test_registry_holds_every_ported_arch():
    assert set(TREG) == set(JREG)
    for arch, spec in TREG.items():
        jspec = JREG[arch]
        assert (spec.family, spec.source, spec.technique_applicable) == (
            jspec.family, jspec.source, jspec.technique_applicable), arch
        assert spec.cells == ()
        assert type(spec.make_config()).__name__ == type(
            jspec.make_config()).__name__


def test_synthetic_pipelines_draw_jax_numbers():
    for jit, tit in ((jsyn.lm_batches(211, 3, 9, seed=2),
                      tsyn.lm_batches(211, 3, 9, seed=2, device="cpu")),
                     (jsyn.sasrec_batches(500, 3, 7, seed=2),
                      tsyn.sasrec_batches(500, 3, 7, seed=2,
                                          device="cpu"))):
        for _ in range(2):
            for a, t in zip(next(jit), next(tit)):
                assert t.dtype == torch.int32
                np.testing.assert_array_equal(t.numpy(), a)


def test_cross_entropy_matches_jax():
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(3, 5, 11)).astype(np.float32) * 4
    logits[..., 9:] = -1e30                             # masked vocab pad
    labels = rng.integers(0, 9, (3, 5)).astype(np.int32)
    mask = rng.random((3, 5)) < 0.6
    for m in (None, mask, np.zeros_like(mask)):
        want = jcommon.cross_entropy(jnp.asarray(logits),
                                     jnp.asarray(labels),
                                     None if m is None else jnp.asarray(m))
        got = tcommon.cross_entropy(torch.from_numpy(logits),
                                    torch.from_numpy(labels),
                                    None if m is None else
                                    torch.from_numpy(m))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("module,coords", GNN_ARCHS)
def test_gnn_loss_gradient_matches_jax(module, coords):
    """The port's gradient runs the CSR segment sum's backward (the
    transposed layout) wherever the forward aggregates; JAX's runs
    ``jax.ops.segment_sum``'s."""
    jcfg, tcfg = _configs(module)
    g = jsyn.graph_batch(40, 120, jcfg.d_in, jcfg.n_classes, seed=1,
                         with_coords=coords)
    mask = np.random.default_rng(1).random(120) < 0.8
    nmask = np.random.default_rng(2).random(40) < 0.7
    g = g._replace(edge_mask=mask, node_mask=nmask)
    tg = tsyn.graph_batch(40, 120, tcfg.d_in, tcfg.n_classes, seed=1,
                          with_coords=coords, device="cpu")._replace(
        edge_mask=torch.from_numpy(mask), node_mask=torch.from_numpy(nmask))
    jp = jgnn.init_gnn(jcfg, jax.random.key(3))
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jgnn.gnn_loss(p, b, jcfg)))(
        jp, jax.tree.map(jnp.asarray, g))
    tloss, tgrads = tstep.value_and_grad(
        lambda p, b: tgnn.gnn_loss(p, b, tcfg), _carry(jp), tg)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    _close_trees(tgrads, jgrads, 1e-4, 1e-4)


@pytest.mark.parametrize("module", LM_ARCHS)
def test_lm_loss_gradient_matches_jax(module):
    jcfg, tcfg = _configs(module)
    tokens, labels = next(jsyn.lm_batches(jcfg.vocab, 2, 24, seed=4))
    jp = jtfm.init_transformer(jcfg, jax.random.key(4))
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p, t, l: jtfm.loss_fn(p, t, l, jcfg)))(
        jp, jnp.asarray(tokens), jnp.asarray(labels))
    tloss, tgrads = tstep.value_and_grad(
        lambda p, t, l: ttfm.loss_fn(p, t, l, tcfg), _carry(jp),
        torch.from_numpy(tokens), torch.from_numpy(labels))
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    _close_trees(tgrads, jgrads, 1e-4, 1e-4)
    # the serving forward keeps its name and records nothing
    with torch.enable_grad():
        p = tcommon.tree_map(lambda t: t.requires_grad_(True), _carry(jp))
        assert not ttfm.forward(p, torch.from_numpy(tokens),
                                tcfg).requires_grad


@pytest.mark.parametrize("moment", ["float32", "bfloat16"])
def test_adamw_update_and_schedule_match_jax(moment):
    """Three updates on identical numpy gradients (one large enough to be
    clipped), from one state carried across."""
    rng = np.random.default_rng(5)
    tree = {"a": rng.normal(size=(4, 6)).astype(np.float32),
            "blocks": [{"w": rng.normal(size=(3,)).astype(np.float32)},
                       {"w": rng.normal(size=(2, 2)).astype(np.float32)}]}
    jcfg = jadam.AdamWConfig(moment_dtype=getattr(jnp, moment), **OPT)
    tcfg = tadam.AdamWConfig(moment_dtype=getattr(torch, moment), **OPT)
    jp = jax.tree.map(jnp.asarray, tree)
    js = jadam.init(jp, jcfg)
    tp = tcommon.params_from_numpy(tree, device="cpu")
    ts = tadam.opt_state_from_numpy(jax.tree.map(np.asarray, js),
                                    device="cpu")
    assert ts.step.dtype == torch.int32 and ts.step.shape == ()
    for i, scale in enumerate((1.0, 30.0, 0.01)):
        g = jax.tree.map(lambda a: (rng.normal(size=a.shape) * scale)
                         .astype(np.float32), tree)
        jp, js, jm = jadam.update(jax.tree.map(jnp.asarray, g), js, jp,
                                  jcfg)
        tp, ts, tm = tadam.update(tcommon.params_from_numpy(g, "cpu"), ts,
                                  tp, tcfg)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]),
                                   rtol=1e-6)
        _close_trees(tp, jp, 1e-6, 1e-6)
        got = tadam.opt_state_to_numpy(ts)
        want = jax.tree.map(np.asarray, js)
        assert int(got.step) == int(want.step) == i + 1
        assert {t.dtype for t in tcommon.tree_leaves([ts.m, ts.v])} == {
            tcfg.moment_dtype}
        for a, b in ((got.m, want.m), (got.v, want.v)):
            a, b = _flat(a), _flat(b)
            for k in b:
                np.testing.assert_allclose(a[k].astype(np.float32),
                                           b[k].astype(np.float32),
                                           rtol=1e-6, atol=1e-6)
    for step in (0, 1, 5, 10, 11, 500, 999, 1000, 2000):
        np.testing.assert_allclose(
            float(tadam.schedule(torch.tensor(step, dtype=torch.int32),
                                 tcfg)),
            float(jadam.schedule(jnp.int32(step), jcfg)), rtol=1e-6)


@pytest.mark.parametrize("family", ["lm", "gnn", "recsys"])
def test_train_step_matches_jax(family):
    """One step: loss and parameters; then two more: the losses only (see
    the module's note on Adam)."""
    jloss, tloss, jp, jbs, tbs = _family(family)
    jcfg, tcfg = jadam.AdamWConfig(**OPT), tadam.AdamWConfig(**OPT)
    tp = _carry(jp)
    jo = jadam.init(jp, jcfg)
    to = tadam.opt_state_from_numpy(jax.tree.map(np.asarray, jo), "cpu")
    jfn = jax.jit(jstep.make_train_step(jloss, jcfg))
    tfn = tstep.make_train_step(tloss, tcfg)
    for i in range(3):
        jp, jo, jm = jfn(jp, jo, *jbs[i])
        tp, to, tm = tfn(tp, to, *tbs[i])
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        if i == 0:
            _close_trees(tp, jp, 1e-6, 1e-6)
    assert int(to.step) == 3


def test_mla_train_step_matches_jax():
    """One AdamW step of minicpm3-4b's smoke config at T = 64 (the
    reference route, as the trainer's): the loss and every gradient
    (1e-4), then the parameters (1e-6)."""
    jcfg, tcfg = _configs("minicpm3_4b")
    tokens, labels = next(jsyn.lm_batches(jcfg.vocab, 4, 64, seed=6))
    jp = jtfm.init_transformer(jcfg, jax.random.key(6))
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p, t, l: jtfm.loss_fn(p, t, l, jcfg)))(
        jp, jnp.asarray(tokens), jnp.asarray(labels))
    tloss, tgrads = tstep.value_and_grad(
        lambda p, t, l: ttfm.loss_fn(p, t, l, tcfg), _carry(jp),
        torch.from_numpy(tokens), torch.from_numpy(labels))
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-4)
    _close_trees(tgrads, jgrads, 1e-4, 1e-4)
    assert {"q_a", "q_a_norm", "kv_a", "kv_a_norm", "k_b",
            "v_b"} <= set(tgrads["layers"])
    jcfg_o, tcfg_o = jadam.AdamWConfig(**OPT), tadam.AdamWConfig(**OPT)
    jo = jadam.init(jp, jcfg_o)
    to = tadam.opt_state_from_numpy(jax.tree.map(np.asarray, jo), "cpu")
    jp1, _, jm = jax.jit(jstep.make_train_step(
        lambda p, t, l: jtfm.loss_fn(p, t, l, jcfg), jcfg_o))(
        jp, jo, jnp.asarray(tokens), jnp.asarray(labels))
    tp1, _, tm = tstep.make_train_step(
        lambda p, t, l: ttfm.loss_fn(p, t, l, tcfg), tcfg_o)(
        _carry(jp), to, torch.from_numpy(tokens), torch.from_numpy(labels))
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-4)
    _close_trees(tp1, jp1, 1e-6, 1e-6)


# T a multiple of 128, where ops.attention's kernel route would serve the
# forward: with a gradient needed, the call takes the reference, as JAX's
# does off a TPU; one GQA and one MLA smoke config
KERNEL_LENGTHS = [128, 256]
KERNEL_LENGTH_ARCHS = ["internlm2_20b", "minicpm3_4b"]


@pytest.mark.parametrize("t", KERNEL_LENGTHS)
@pytest.mark.parametrize("module", KERNEL_LENGTH_ARCHS)
def test_lm_gradient_at_kernel_lengths_matches_jax(module, t):
    jcfg, tcfg = _configs(module)
    tokens, labels = next(jsyn.lm_batches(jcfg.vocab, 2, t, seed=7))
    jp = jtfm.init_transformer(jcfg, jax.random.key(7))
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p, a, b: jtfm.loss_fn(p, a, b, jcfg)))(
        jp, jnp.asarray(tokens), jnp.asarray(labels))
    tloss, tgrads = tstep.value_and_grad(
        lambda p, a, b: ttfm.loss_fn(p, a, b, tcfg), _carry(jp),
        torch.from_numpy(tokens), torch.from_numpy(labels))
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    _close_trees(tgrads, jgrads, 1e-4, 1e-4)


@pytest.mark.parametrize("t", KERNEL_LENGTHS)
@pytest.mark.parametrize("module", KERNEL_LENGTH_ARCHS)
def test_lm_train_step_at_kernel_lengths_matches_jax(module, t):
    """One AdamW step from JAX's parameters: the loss and every
    parameter."""
    jcfg, tcfg = _configs(module)
    tokens, labels = next(jsyn.lm_batches(jcfg.vocab, 2, t, seed=8))
    jp = jtfm.init_transformer(jcfg, jax.random.key(8))
    jo_cfg, to_cfg = jadam.AdamWConfig(**OPT), tadam.AdamWConfig(**OPT)
    jo = jadam.init(jp, jo_cfg)
    to = tadam.opt_state_from_numpy(jax.tree.map(np.asarray, jo), "cpu")
    jp1, _, jm = jax.jit(jstep.make_train_step(
        lambda p, a, b: jtfm.loss_fn(p, a, b, jcfg), jo_cfg))(
        jp, jo, jnp.asarray(tokens), jnp.asarray(labels))
    tp1, _, tm = tstep.make_train_step(
        lambda p, a, b: ttfm.loss_fn(p, a, b, tcfg), to_cfg)(
        _carry(jp), to, torch.from_numpy(tokens), torch.from_numpy(labels))
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    _close_trees(tp1, jp1, 1e-6, 1e-6)


@pytest.mark.parametrize("arch", ["internlm2-20b", "minicpm3-4b"])
def test_train_cli_at_seq_128_continues_jax(arch, tmp_path):
    """``launch/train.py --seq 128 --device cpu`` trains.  The port draws
    its own weights, so to hold its losses to JAX's it continues a JAX run
    saved at step 1: the CLI prints JAX's continuation's losses (to its
    four decimals), and ``train`` returns them within 1e-5."""
    jd = str(tmp_path / "jax")
    jlaunch.train(arch, 1, batch=2, seq=128, ckpt_dir=jd, ckpt_every=1,
                  log_every=0)
    for copy in ("_jax", "_cli"):
        shutil.copytree(jd, jd + copy)
    want = jlaunch.train(arch, 3, batch=2, seq=128, ckpt_dir=jd + "_jax",
                         ckpt_every=1, log_every=0)["losses"]
    env = dict(os.environ, PYTHONPATH=str(SRC), CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", arch,
         "--steps", "3", "--batch", "2", "--seq", "128", "--ckpt-dir",
         jd + "_cli", "--device", "cpu"],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    first, last = proc.stdout.splitlines()[-1].split()[1::2]
    np.testing.assert_allclose([float(first), float(last)],
                               [want[0], want[-1]], rtol=0, atol=5e-5)
    got = tlaunch.train(arch, 3, batch=2, seq=128, ckpt_dir=jd,
                        ckpt_every=1, log_every=0, device="cpu")["losses"]
    np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize("family", ["lm", "recsys"])
def test_four_microbatches_equal_one(family):
    """JAX's GraphBatch does not split into microbatches, so the GNN has
    none.  The port's four-microbatch step equals its one-batch step and
    JAX's four-microbatch step."""
    jloss, tloss, jp, jbs, tbs = _family(family)
    jcfg, tcfg = jadam.AdamWConfig(**OPT), tadam.AdamWConfig(**OPT)
    tp = _carry(jp)
    to = tadam.init(tp, tcfg)
    one = tstep.make_train_step(tloss, tcfg)(tp, to, *tbs[0])
    four = tstep.make_train_step(tloss, tcfg, 4)(tp, to, *tbs[0])
    jfour = jax.jit(jstep.make_train_step(jloss, jcfg, 4))(
        jp, jadam.init(jp, jcfg), *jbs[0])
    for other in (one, jfour):
        np.testing.assert_allclose(float(four[2]["loss"]),
                                   float(other[2]["loss"]), rtol=1e-5)
        _close_trees(four[0], jax.tree.map(np.asarray, other[0])
                     if other is jfour else other[0], 1e-6, 1e-6)


def test_train_restart_continues_as_unbroken(tmp_path):
    """The GNN trains on one fixed batch, so a run killed after a
    checkpoint and restarted is the unbroken run; the checkpoint has JAX's
    archive keys (``.step``/``.m``/``.v`` for the optimizer)."""
    full = tlaunch.train("graphsage-reddit", 6, log_every=0, device="cpu")
    d = str(tmp_path / "ck")
    first = tlaunch.train("graphsage-reddit", 3, ckpt_dir=d, ckpt_every=3,
                          log_every=0, device="cpu")
    rest = tlaunch.train("graphsage-reddit", 6, ckpt_dir=d, ckpt_every=3,
                         log_every=0, device="cpu")
    assert len(rest["losses"]) == 3
    assert first["losses"] + rest["losses"] == full["losses"]
    with open(os.path.join(d, "opt", "step_00000006", "meta.json")) as f:
        keys = json.load(f)["keys"]
    assert ".step" in keys and ".m/layers/0/w_nbr" in keys


@pytest.mark.parametrize("arch", ["graphsage-reddit", "sasrec"])
def test_checkpoints_continue_across_packages(arch, tmp_path):
    """The port continues a JAX run's directory, and JAX the port's, each
    with the losses the other package's own continuation gives (both
    restart their data streams from the seed, as the JAX trainer does)."""
    def pair(base):
        shutil.copytree(base, base + "_b")
        return base, base + "_b"

    jd = str(tmp_path / "jax")
    jlaunch.train(arch, 2, ckpt_dir=jd, ckpt_every=2, log_every=0)
    jd, jd2 = pair(jd)
    by_port = tlaunch.train(arch, 4, ckpt_dir=jd, ckpt_every=2, log_every=0,
                            device="cpu")["losses"]
    by_jax = jlaunch.train(arch, 4, ckpt_dir=jd2, ckpt_every=2,
                           log_every=0)["losses"]
    np.testing.assert_allclose(by_port, by_jax, rtol=1e-5)

    td = str(tmp_path / "port")
    tlaunch.train(arch, 2, ckpt_dir=td, ckpt_every=2, log_every=0,
                  device="cpu")
    td, td2 = pair(td)
    by_jax = jlaunch.train(arch, 4, ckpt_dir=td, ckpt_every=2,
                           log_every=0)["losses"]
    by_port = tlaunch.train(arch, 4, ckpt_dir=td2, ckpt_every=2,
                            log_every=0, device="cpu")["losses"]
    np.testing.assert_allclose(by_jax, by_port, rtol=1e-5)


def test_train_cli_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(SRC), CUDA_VISIBLE_DEVICES="")
    args = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
            "sasrec", "--steps", "3"]
    proc = subprocess.run(args + ["--device", "cpu"], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("loss ")
    # without a card and without --device cpu it raises, never falls back
    proc = subprocess.run(args, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0 and "device='cpu'" in proc.stderr
