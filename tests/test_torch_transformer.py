"""PyTorch port: the GQA/MLA/MoE transformer, its decode step and the
serve loop, against the JAX package.

Parameters are initialised by JAX and carried across with
``params_from_numpy``; tokens are drawn with numpy from a seed.  The JAX
forward runs ``ref.flash_attention_ref`` (no TPU here); the port's runs
the kernel's plain version at T = 128 and 256 and the reference at
T = 12 and 64 (MLA's kernel route at ``d_v != d_q`` too: minicpm3-4b's
smoke pair is (32, 24)).  Tolerances: float32 rtol = atol = 1e-4
(matmuls and softmax sums in another order, online vs one-pass
softmax); bfloat16 3e-2 (the two frameworks round bf16 at other
places); decode vs forward 2e-3, the bar of
``tests/test_models.py::test_decode_matches_forward``.
"""
import dataclasses
import functools
import importlib
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import transformer as jtfm  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.flash_attention import v_shares_k  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import transformer as ttfm  # noqa: E402
from repro_torch.models.common import (  # noqa: E402
    param_count, tree_leaves)

SRC = Path(__file__).resolve().parent.parent / "src"
ARCHS = ["internlm2_20b", "llama3_405b", "granite_moe_3b_a800m",
         "moonshot_v1_16b_a3b", "minicpm3_4b"]
# MLA at minicpm3-4b's smoke widths: (q_lora, n_experts), full-rank and
# low-rank q, dense and MoE (tests/test_models.py runs ("mla", 8))
MLA_VARIANTS = [(0, 0), (8, 0), (0, 8), (8, 8)]
DTYPES = ("param_dtype", "compute_dtype")


def _configs(module: str, **over):
    """The arch's smoke config in both packages (``over`` applied to the
    JAX one; dtypes carried across by name), checked field for field."""
    jcfg = importlib.import_module(f"repro.configs.{module}").smoke_config()
    tcfg = importlib.import_module(
        f"repro_torch.configs.{module}").smoke_config()
    jcfg = dataclasses.replace(jcfg, **over)
    tcfg = dataclasses.replace(tcfg, **{
        k: getattr(torch, np.dtype(v).name) if k in DTYPES else v
        for k, v in over.items()})
    for f in dataclasses.fields(jcfg):
        want, got = getattr(jcfg, f.name), getattr(tcfg, f.name)
        if f.name in DTYPES:
            assert str(got) == f"torch.{np.dtype(want).name}", f.name
        else:
            assert got == want, f.name
    assert tcfg.vocab_padded == jcfg.vocab_padded
    return jcfg, tcfg


@functools.lru_cache(maxsize=None)
def _jax_params(jcfg, seed):
    return jtfm.init_transformer(jcfg, jax.random.key(seed))


def _params(jcfg, seed=0):
    jparams = _jax_params(jcfg, seed)
    tparams = ttfm.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                     device="cpu")
    return jparams, tparams


def _tokens(cfg, b, t, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, t),
                                                dtype=np.int32)


def _f32(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def test_common_blocks_match_jax():
    from repro.models import common as jcommon
    from repro_torch.models import common as tcommon
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 3, 5, 16)).astype(np.float32)
    w = rng.normal(size=(16,)).astype(np.float32)
    pos = rng.integers(0, 500, (2, 1, 5))
    ws = [rng.normal(size=s).astype(np.float32)
          for s in ((16, 24), (16, 24), (24, 16))]
    for got, want in (
            (tcommon.rms_norm(torch.from_numpy(x), torch.from_numpy(w)),
             jcommon.rms_norm(jnp.asarray(x), jnp.asarray(w))),
            (tcommon.rope_freqs(16, 64), jcommon.rope_freqs(16, 64)),
            (tcommon.apply_rope(torch.from_numpy(x), torch.from_numpy(pos)),
             jcommon.apply_rope(jnp.asarray(x), jnp.asarray(pos))),
            (tcommon.swiglu(torch.from_numpy(x),
                            *(torch.from_numpy(a) for a in ws)),
             jcommon.swiglu(jnp.asarray(x), *(jnp.asarray(a) for a in ws)))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)


def test_full_configs_match_jax_field_for_field():
    for module in ARCHS:
        jm = importlib.import_module(f"repro.configs.{module}")
        tm = importlib.import_module(f"repro_torch.configs.{module}")
        assert tm.ARCH_ID == jm.ARCH_ID
        j, t = jm.full_config(), tm.full_config()
        assert {f.name: getattr(t, f.name) for f in dataclasses.fields(t)
                if f.name not in DTYPES} == {
            f.name: getattr(j, f.name) for f in dataclasses.fields(j)
            if f.name not in DTYPES}
        assert (t.param_dtype, t.compute_dtype) == (torch.bfloat16,
                                                    torch.bfloat16)


@pytest.mark.parametrize("t", [12, 128, 256])
@pytest.mark.parametrize("module", ARCHS)
def test_forward_matches_jax(module, t):
    jcfg, tcfg = _configs(module)
    jparams, tparams = _params(jcfg)
    assert param_count(tparams) == sum(
        int(a.size) for a in jax.tree.leaves(jparams))
    toks = _tokens(jcfg, 2, t)
    want = np.asarray(jtfm.forward(jparams, jnp.asarray(toks), jcfg))
    ops.reset_counts()
    got = ttfm.forward(tparams, torch.from_numpy(toks), tcfg)
    assert ops.attention.launches == 0       # the CPU runs the plain version
    assert got.shape == (2, t, tcfg.vocab_padded)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("module", ["internlm2_20b", "granite_moe_3b_a800m"])
def test_decode_step_matches_jax(module):
    jcfg, tcfg = _configs(module)
    jparams, tparams = _params(jcfg)
    toks = _tokens(jcfg, 2, 8)
    jcache = jtfm.init_cache(jcfg, 2, 12)
    tcache = ttfm.init_cache(tcfg, 2, 12, device="cpu")
    step = jax.jit(lambda p, c, x: jtfm.decode_step(p, c, x, jcfg))
    for i in range(8):
        want, jcache = step(jparams, jcache, jnp.asarray(toks[:, i]))
        got, tcache = ttfm.decode_step(tparams, tcache,
                                       torch.from_numpy(toks[:, i]), tcfg)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-4, err_msg=f"step {i}")
    assert tcache["len"] == int(jcache["len"]) == 8
    for name in ("k", "v"):
        np.testing.assert_allclose(tcache[name].numpy(),
                                   np.asarray(jcache[name]), rtol=1e-4,
                                   atol=1e-4, err_msg=name)


@pytest.mark.parametrize("module", ARCHS)
def test_decode_matches_forward(module):
    # MoE at capacity factor 8, as tests/test_models.py: no token is
    # dropped at T = 8 or T = 1, so both see the same experts
    _, tcfg = _configs(module, capacity_factor=8.0)
    params = ttfm.init_transformer(tcfg, 0, device="cpu")
    toks = torch.from_numpy(_tokens(tcfg, 2, 8)).long()
    logits = ttfm.forward(params, toks, tcfg)
    cache = ttfm.init_cache(tcfg, 2, 16, device="cpu")
    outs = []
    for t in range(8):
        lg, cache = ttfm.decode_step(params, cache, toks[:, t], tcfg)
        outs.append(lg)
    err = float((torch.stack(outs, 1) - logits).abs().max())
    assert err < 2e-3, f"decode diverged from forward: {err}"


def test_bf16_forward_matches_jax():
    jcfg, tcfg = _configs("internlm2_20b", param_dtype=jnp.bfloat16,
                          compute_dtype=jnp.bfloat16)
    jparams, tparams = _params(jcfg)
    assert tparams["layers"]["q_proj"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        tparams["embed"].to(torch.float32).numpy(), _f32(jparams["embed"]))
    toks = _tokens(jcfg, 2, 128)
    want = _f32(jtfm.forward(jparams, jnp.asarray(toks), jcfg))
    got = ttfm.forward(tparams, torch.from_numpy(toks), tcfg)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.to(torch.float32).numpy(), want,
                               rtol=3e-2, atol=3e-2)


def test_serve_loop_matches_jax_tokens():
    jcfg, tcfg = _configs("granite_moe_3b_a800m")
    jparams, tparams = _params(jcfg, seed=3)
    prompt = _tokens(jcfg, 3, 6, seed=4)
    out = tserve.generate(tparams, tcfg, torch.from_numpy(prompt), 10)
    # JAX's loop of repro/launch/serve.py, on the same params and prompt
    cache = jtfm.init_cache(jcfg, 3, 16)
    step = jax.jit(lambda p, c, x: jtfm.decode_step(p, c, x, jcfg))
    for t in range(6):
        logits, cache = step(jparams, cache, jnp.asarray(prompt[:, t]))
    toks = []
    tok = jnp.argmax(logits, axis=-1)
    for _ in range(10):
        toks.append(tok)
        logits, cache = step(jparams, cache, tok)
        tok = jnp.argmax(logits, axis=-1)
    np.testing.assert_array_equal(out["tokens"].numpy(),
                                  np.asarray(jnp.stack(toks, axis=1)))


@pytest.mark.parametrize("t", [64, 128])
@pytest.mark.parametrize("q_lora,n_experts", MLA_VARIANTS)
def test_mla_forward_matches_jax(q_lora, n_experts, t):
    """T = 128 takes the kernel route (the plain version here) at the
    (32, 24) pair, T = 64 the reference."""
    jcfg, tcfg = _configs("minicpm3_4b", q_lora=q_lora,
                          n_experts=n_experts)
    jparams, tparams = _params(jcfg)
    assert ("q_a" in tparams["layers"]) == bool(q_lora)
    assert param_count(tparams) == sum(
        int(a.size) for a in jax.tree.leaves(jparams))
    toks = _tokens(jcfg, 2, t)
    want = np.asarray(jtfm.forward(jparams, jnp.asarray(toks), jcfg))
    got = ttfm.forward(tparams, torch.from_numpy(toks), tcfg)
    assert got.shape == (2, t, tcfg.vocab_padded)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("t", [128, 256])
def test_mla_attend_hands_the_kernel_route_a_view_of_the_latent(
        t, monkeypatch):
    """``_mla_attend`` passes v as ``k_full[..., :kv_lora]``, a view that
    ``flash_attention.v_shares_k`` takes (so that the ``mla`` kernel reads
    the latent once), to the kernel route (its plain version here); its
    output still equals JAX's ``_mla_attend``."""
    jcfg, tcfg = _configs("minicpm3_4b")
    jparams, tparams = _params(jcfg)
    rng = np.random.default_rng(t)
    b, nh = 2, jcfg.n_heads
    shapes = dict(q_nope=(b, nh, t, jcfg.nope_dim),
                  q_rope=(b, nh, t, jcfg.rope_dim),
                  c_kv=(b, t, jcfg.kv_lora), k_rope=(b, t, jcfg.rope_dim))
    x = [rng.normal(size=sh).astype(np.float32) for sh in shapes.values()]
    seen = []
    plain = ops.flash_attention_plain

    def spy(q, k, v, causal=True):
        seen.append((v_shares_k(k, v), v.shape[-1]))
        return plain(q, k, v, causal=causal)
    monkeypatch.setattr(ops, "flash_attention_plain", spy)
    want = np.asarray(jtfm._mla_attend(
        jax.tree.map(lambda a: a[0], jparams["layers"]), jcfg,
        *map(jnp.asarray, x), causal=True))
    got = ttfm._mla_attend(ttfm.layer_params(tparams, 0), tcfg,
                           *map(torch.from_numpy, x), causal=True)
    assert seen == [(True, tcfg.kv_lora)]
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("q_lora,n_experts", MLA_VARIANTS)
def test_mla_decode_step_matches_jax(q_lora, n_experts):
    """Teacher-forced over 8 tokens: logits and the latent cache."""
    jcfg, tcfg = _configs("minicpm3_4b", q_lora=q_lora,
                          n_experts=n_experts)
    jparams, tparams = _params(jcfg)
    toks = _tokens(jcfg, 2, 8)
    jcache = jtfm.init_cache(jcfg, 2, 12)
    tcache = ttfm.init_cache(tcfg, 2, 12, device="cpu")
    step = jax.jit(lambda p, c, x: jtfm.decode_step(p, c, x, jcfg))
    for i in range(8):
        want, jcache = step(jparams, jcache, jnp.asarray(toks[:, i]))
        got, tcache = ttfm.decode_step(tparams, tcache,
                                       torch.from_numpy(toks[:, i]), tcfg)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-4, err_msg=f"step {i}")
    assert tcache["len"] == int(jcache["len"]) == 8
    for name in ("c_kv", "k_rope"):
        np.testing.assert_allclose(tcache[name].numpy(),
                                   np.asarray(jcache[name]), rtol=1e-4,
                                   atol=1e-4, err_msg=name)


@pytest.mark.parametrize("module", ["minicpm3_4b", "internlm2_20b"])
def test_init_cache_shapes_match_jax(module):
    """MLA caches the latent (``c_kv``, ``k_rope``), GQA per-head k, v."""
    jcfg, tcfg = _configs(module)
    jcache = jtfm.init_cache(jcfg, 3, 20)
    tcache = ttfm.init_cache(tcfg, 3, 20, device="cpu")
    assert set(tcache) == set(jcache)
    for name, arr in jcache.items():
        if name == "len":
            assert tcache["len"] == int(arr) == 0
            continue
        assert tuple(tcache[name].shape) == arr.shape, name
        assert tcache[name].dtype == tcfg.compute_dtype
        assert not bool(tcache[name].any())


def test_mla_serve_loop_matches_jax_tokens():
    jcfg, tcfg = _configs("minicpm3_4b")
    jparams, tparams = _params(jcfg, seed=5)
    prompt = _tokens(jcfg, 3, 6, seed=6)
    out = tserve.generate(tparams, tcfg, torch.from_numpy(prompt), 10)
    cache = jtfm.init_cache(jcfg, 3, 16)
    step = jax.jit(lambda p, c, x: jtfm.decode_step(p, c, x, jcfg))
    for t in range(6):
        logits, cache = step(jparams, cache, jnp.asarray(prompt[:, t]))
    toks = []
    tok = jnp.argmax(logits, axis=-1)
    for _ in range(10):
        toks.append(tok)
        logits, cache = step(jparams, cache, tok)
        tok = jnp.argmax(logits, axis=-1)
    np.testing.assert_array_equal(out["tokens"].numpy(),
                                  np.asarray(jnp.stack(toks, axis=1)))


@pytest.mark.parametrize("module", ["minicpm3_4b", "internlm2_20b"])
def test_param_count_at_full_width_matches_jax(module):
    """On the meta device, so nothing is drawn: against the JAX package's
    ``eval_shape`` of its initialiser (minicpm3-4b: 4,262,025,728)."""
    jcfg = importlib.import_module(f"repro.configs.{module}").full_config()
    tcfg = importlib.import_module(
        f"repro_torch.configs.{module}").full_config()
    shapes = jax.eval_shape(lambda k: jtfm.init_transformer(jcfg, k),
                            jax.random.key(0))
    meta = ttfm.init_transformer(tcfg, device="meta")
    assert all(t.device.type == "meta" for t in tree_leaves(meta))
    want = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(shapes))
    assert param_count(meta) == want
    if module == "minicpm3_4b":
        assert want == 4_262_025_728


@pytest.mark.parametrize("arch", ["internlm2-20b", None])
def test_serve_cli_runs_on_the_cpu(arch):
    """With ``--arch``, and without: the default arch, minicpm3-4b, as in
    the JAX package's CLI."""
    env = dict(os.environ, PYTHONPATH=str(SRC))
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--device",
           "cpu", "--tokens", "4"]
    if arch:
        cmd += ["--arch", arch]
    proc = subprocess.run(cmd, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith(f"{arch or 'minicpm3-4b'} (smoke): "
                                  f"generated (4, 4) tokens on device=cpu")
