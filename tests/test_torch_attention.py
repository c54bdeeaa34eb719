"""PyTorch port: the flash-attention kernel's plain version, the attention
reference and ``ops.attention``'s routing, against the JAX package.

Inputs are drawn with numpy from a seed and handed to both packages.  The
plain version is held to the Pallas kernel in interpret mode (the same
128 x 128 blocks in the same order, float32: rtol = atol = 1e-5; bf16
inputs 3e-2, as ``tests/test_kernels.py`` holds the kernel), and the
port's ``ref.flash_attention_ref`` to JAX's (1e-5).  At MLA's ``d_v !=
d_q`` the Pallas kernel crashes (pinned below), so the plain version is
held there to JAX's ``ref.flash_attention_ref``, the function the JAX
package's MLA computes off a TPU (float32 1e-5, bf16 3e-2).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    DTYPES, HEAD_DIMS, MLA_WIDTHS, _kernel_view, flash_attention_cuda,
    flash_attention_plain, kernel_variant, tma_ok)

# the sweep of tests/test_kernels.py::test_flash_attention_sweep
SWEEP = [(2, 4, 2, 256, 64, True), (1, 8, 8, 128, 128, True),
         (2, 4, 1, 384, 64, False)]


def _qkv(b, h, hkv, tq, tk, d, seed, dv=None):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, h, tq, d)).astype(np.float32),
            rng.normal(size=(b, hkv, tk, d)).astype(np.float32),
            rng.normal(size=(b, hkv, tk, dv or d)).astype(np.float32))


def _jax_bf16(a):
    return jnp.asarray(a, jnp.bfloat16)


def _torch_bf16(a):
    return torch.from_numpy(a).to(torch.bfloat16)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", 3e-2)])
@pytest.mark.parametrize("b,h,hkv,t,d,causal", SWEEP)
def test_plain_matches_pallas_kernel(b, h, hkv, t, d, causal, dtype, tol):
    q, k, v = _qkv(b, h, hkv, t, t, d, seed=b * t + h)
    if dtype == "float32":
        jin = [jnp.asarray(a) for a in (q, k, v)]
        tin = [torch.from_numpy(a) for a in (q, k, v)]
    else:
        jin = [_jax_bf16(a) for a in (q, k, v)]
        tin = [_torch_bf16(a) for a in (q, k, v)]
    want = jops.attention(*jin, causal=causal, use_pallas=True,
                          interpret=True)
    got = flash_attention_plain(*tin, causal=causal)
    assert got.dtype == tin[0].dtype and got.shape == (b, h, t, d)
    np.testing.assert_allclose(got.to(torch.float32).numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("d", [8, 16])
def test_plain_matches_pallas_kernel_at_smoke_head_widths(d):
    q, k, v = _qkv(2, 8, 2, 256, 256, d, seed=d)
    want = jops.attention(*(jnp.asarray(a) for a in (q, k, v)), causal=True,
                          use_pallas=True, interpret=True)
    got = flash_attention_plain(*(torch.from_numpy(a) for a in (q, k, v)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", 3e-2)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("t", [128, 256])
def test_plain_matches_jax_ref_at_mla_widths(t, causal, dtype, tol):
    """minicpm3-4b's smoke pair (32, 24): one KV head, v narrower than q;
    the output is v's width and the scale 1/sqrt(d_q)."""
    q, k, v = _qkv(2, 4, 1, t, t, 32, seed=t + causal, dv=24)
    cast = ((jnp.asarray, torch.from_numpy) if dtype == "float32"
            else (_jax_bf16, _torch_bf16))
    want = jref.flash_attention_ref(*(cast[0](a) for a in (q, k, v)),
                                    causal)
    got = flash_attention_plain(*(cast[1](a) for a in (q, k, v)),
                                causal=causal)
    assert got.dtype == cast[1](q).dtype and got.shape == (2, 4, t, 24)
    np.testing.assert_allclose(got.to(torch.float32).numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=tol, atol=tol)


def test_plain_matches_jax_ref_at_minicpm3_full_widths():
    q, k, v = _qkv(1, 4, 1, 128, 128, 288, seed=20, dv=256)
    want = jref.flash_attention_ref(*(jnp.asarray(a) for a in (q, k, v)),
                                    True)
    got = flash_attention_plain(*(torch.from_numpy(a) for a in (q, k, v)))
    assert got.shape == (1, 4, 128, 256)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_pallas_kernel_crashes_at_mla_widths():
    """Fault 1 (ROADMAP queue 3): the TPU kernel reshapes v with q's
    width, so JAX's kernel route cannot run MLA's call; the port's kernel
    takes it and computes what the reference computes."""
    q, k, v = _qkv(1, 4, 1, 128, 128, 32, seed=21, dv=24)
    with pytest.raises(TypeError, match="reshape"):
        jops.attention(*(jnp.asarray(a) for a in (q, k, v)), causal=True,
                       use_pallas=True, interpret=True)


def _decode_bias(s, t_now):
    return np.where(np.arange(s) <= t_now, 0.0, -1e30).astype(
        np.float32)[None, None, None]


@pytest.mark.parametrize("case", ["decode_bias", "gqa_causal", "dv_ne_dq",
                                  "chunked", "cross_causal"])
def test_ref_matches_jax_ref(case):
    bias = None
    causal = True
    if case == "decode_bias":      # Tq = 1 against a 40-slot cache, GQA
        q, k, v = _qkv(2, 8, 2, 1, 40, 16, seed=1)
        bias, causal = _decode_bias(40, 17), False
    elif case == "gqa_causal":
        q, k, v = _qkv(2, 8, 2, 96, 96, 16, seed=2)
    elif case == "dv_ne_dq":       # MLA's shape: one KV head, d_v != d_q
        q, k, v = _qkv(1, 4, 1, 64, 64, 32, seed=3, dv=24)
    elif case == "chunked":        # Tq = 2048 runs in chunks of 1024
        q, k, v = _qkv(1, 2, 1, 2048, 2048, 8, seed=4)
    else:                          # causal Tq < Tk: bottom-right mask
        q, k, v = _qkv(1, 4, 2, 32, 80, 8, seed=5)
    want = jref.flash_attention_ref(
        *(jnp.asarray(a) for a in (q, k, v)), causal,
        None if bias is None else jnp.asarray(bias))
    got = ref.flash_attention_ref(
        *(torch.from_numpy(a) for a in (q, k, v)), causal,
        None if bias is None else torch.from_numpy(bias))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_ref_matches_jax_ref_in_bf16():
    q, k, v = _qkv(2, 8, 2, 1, 40, 16, seed=6)
    bias = _decode_bias(40, 30)
    want = jref.flash_attention_ref(*(_jax_bf16(a) for a in (q, k, v)),
                                    False, jnp.asarray(bias))
    got = ref.flash_attention_ref(*(_torch_bf16(a) for a in (q, k, v)),
                                  False, torch.from_numpy(bias))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.to(torch.float32).numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=3e-2, atol=3e-2)


def test_routing_sends_bias_and_ragged_lengths_to_ref():
    ops.reset_counts()
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 4, 2, 128, 128, 8, 7))
    bias = torch.zeros((1, 1, 1, 128))
    np.testing.assert_array_equal(
        ops.attention(q, k, v, causal=False, bias=bias).numpy(),
        ref.flash_attention_ref(q, k, v, False, bias).numpy())
    q2, k2, v2 = (torch.from_numpy(a) for a in _qkv(1, 4, 2, 100, 100, 8, 8))
    np.testing.assert_array_equal(ops.attention(q2, k2, v2).numpy(),
                                  ref.flash_attention_ref(q2, k2,
                                                          v2).numpy())
    # T a multiple of 128 and no bias: the kernel route, here the plain
    np.testing.assert_array_equal(ops.attention(q, k, v).numpy(),
                                  flash_attention_plain(q, k, v).numpy())
    assert ops.attention.launches == 0       # no kernel launched on the CPU
    assert not ops.attention.by_variant


def test_kernel_route_raises_where_the_tpu_kernel_is_wrong():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 4, 2, 128, 256, 16, 9))
    with pytest.raises(ValueError, match="Tq=128 != Tk=256"):
        ops.attention(q, k, v, causal=True)
    ops.attention(q, k, v, causal=False)     # not causal: fine
    # MLA's d_v != d_q: the route answers as the reference does
    q, k, v = (torch.from_numpy(a)
               for a in _qkv(1, 4, 1, 128, 128, 32, 10, dv=24))
    np.testing.assert_allclose(ops.attention(q, k, v).numpy(),
                               ref.flash_attention_ref(q, k, v).numpy(),
                               rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match=r"widths \(d_q 32, d_v 16\)"):
        ops.attention(q, k, v[..., :16])
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 4, 1, 128, 128, 24, 11))
    with pytest.raises(ValueError, match="head width 24"):
        ops.attention(q, k, v)


@pytest.mark.parametrize("needs_grad", ["q", "k", "v"])
def test_kernel_route_raises_under_autograd(needs_grad):
    """The kernel has no backward (nor has the TPU kernel's pallas_call):
    with grad mode on and an input that requires grad, the kernel route
    raises on the CPU as on a card; under no_grad it runs."""
    qkv = dict(zip("qkv", (torch.from_numpy(a)
                           for a in _qkv(1, 4, 2, 128, 128, 8, 13))))
    qkv[needs_grad].requires_grad_(True)
    with pytest.raises(NotImplementedError, match="fault 3"):
        ops.attention(qkv["q"], qkv["k"], qkv["v"])
    with torch.no_grad():
        ops.attention(qkv["q"], qkv["k"], qkv["v"])


def test_reference_route_stays_differentiable():
    """A bias, or T not a multiple of 128, takes the reference, whose
    gradient is torch's own: held to JAX's gradient of its reference."""
    import jax
    for t, bias in ((100, None), (128, np.zeros((1, 1, 1, 128),
                                                np.float32))):
        q, k, v = _qkv(1, 4, 2, t, t, 8, 14)
        w = np.random.default_rng(15).normal(size=q.shape).astype(
            np.float32)
        tq, tk, tv = (torch.from_numpy(a).requires_grad_(True)
                      for a in (q, k, v))
        tb = None if bias is None else torch.from_numpy(bias)
        torch.sum(ops.attention(tq, tk, tv, bias=tb)
                  * torch.from_numpy(w)).backward()
        jb = None if bias is None else jnp.asarray(bias)
        want = jax.grad(lambda a, b, c: jnp.sum(jref.flash_attention_ref(
            a, b, c, True, jb) * w), argnums=(0, 1, 2))(q, k, v)
        for got, exp in zip((tq.grad, tk.grad, tv.grad), want):
            np.testing.assert_allclose(got.numpy(), np.asarray(exp),
                                       rtol=1e-5, atol=1e-5)


def test_kernel_wrapper_refuses_cpu_tensors():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 2, 1, 128, 128, 8, 12))
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        flash_attention_cuda(q, k, v)


# the kernel each (dtype, D) runs: Hopper's wgmma kernel at the full
# configurations' head widths, mma.sync below them, SIMT for float32 and D 8
VARIANTS = {(torch.bfloat16, 8): "simt", (torch.bfloat16, 16): "mma",
            (torch.bfloat16, 32): "mma", (torch.bfloat16, 64): "wgmma",
            (torch.bfloat16, 128): "wgmma"}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_kernel_variant_by_dtype_and_width(dtype, d):
    assert kernel_variant(dtype, d) == VARIANTS.get((dtype, d), "simt")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d,dv", MLA_WIDTHS)
def test_kernel_variant_at_mla_widths(dtype, d, dv):
    """bf16 at minicpm3-4b's full pair runs the MLA tensor-core kernel;
    float32, and bf16 at the smoke pair, the SIMT kernel."""
    want = "mla" if (dtype, d, dv) == (torch.bfloat16, 288, 256) else "simt"
    assert kernel_variant(dtype, d, dv) == want


def _strided(b, h, t, d, dtype):
    """The transformer's layout: ``[B, T, heads, D]`` memory viewed as
    ``[B, heads, T, D]``."""
    return torch.randn((b, t, h, d)).to(dtype).transpose(1, 2)


@pytest.mark.parametrize("dtype", DTYPES)
def test_tma_check_takes_the_transformer_layout(dtype):
    x = _strided(2, 6, 256, 64, dtype)
    assert not x.is_contiguous() and tma_ok(x)
    assert _kernel_view(x) is x                  # no copy


@pytest.mark.parametrize("case", ["last_dim_strided", "unaligned_base",
                                  "row_stride_not_16_bytes",
                                  "stride_past_2_40"])
def test_tma_check_copies_what_it_cannot_take(case):
    if case == "last_dim_strided":
        x = torch.randn((2, 4, 64, 128)).to(torch.bfloat16).transpose(2, 3)
    elif case == "unaligned_base":             # 4 bytes past a boundary
        x = torch.randn((2, 4, 128, 72)).to(torch.bfloat16)[..., 2:66]
    elif case == "row_stride_not_16_bytes":   # rows 68 bf16 = 136 bytes
        x = torch.randn((2, 4, 128, 68)).to(torch.bfloat16)[..., :64]
    else:                                      # a size-1 batch, huge stride
        base = torch.randn((4 * 128 * 64,)).to(torch.bfloat16)
        x = base.as_strided((1, 4, 128, 64), (1 << 40, 128 * 64, 64, 1))
    assert not tma_ok(x)
    y = _kernel_view(x)
    assert y is not x and tma_ok(y) and y.shape == x.shape
    assert torch.equal(y, x)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [("float32", 2e-3),
                                       ("bfloat16", 3e-2)])
def test_kernel_matches_plain_on_the_card(dtype, tol):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dt = getattr(torch, dtype)
    # the sweep and the smoke widths, contiguous; then GQA at the wgmma
    # kernel's widths in the transformer's strided layout, causal and not
    shapes = [(*s, False) for s in SWEEP + [(2, 8, 2, 256, 8, True),
                                            (2, 4, 4, 256, 16, True)]]
    shapes += [(2, 8, 2, 512, 128, True, True),
               (2, 8, 2, 512, 128, False, True),
               (2, 6, 2, 768, 64, True, True),
               (1, 4, 1, 384, 64, False, True)]
    # MLA's pairs (d, dv), one KV head
    shapes += [(1, 4, 1, 256, (288, 256), True, False),
               (2, 3, 1, 384, (288, 256), False, False),
               (2, 4, 1, 256, (32, 24), True, False)]
    for b, h, hkv, t, d, causal, strided in shapes:
        d, dv = d if isinstance(d, tuple) else (d, d)
        rng = np.random.default_rng(b * t + h + d)
        if strided:
            q, k, v = (torch.from_numpy(rng.normal(size=(b, t, n, d)).astype(
                np.float32)).to("cuda", dt).transpose(1, 2)
                for n in (h, hkv, hkv))
        else:
            q, k, v = (torch.from_numpy(a).to("cuda", dt)
                       for a in _qkv(b, h, hkv, t, t, d, seed=b * t + h,
                                     dv=dv))
        got = flash_attention_cuda(q, k, v, causal=causal)
        want = flash_attention_plain(q, k, v, causal=causal)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)
