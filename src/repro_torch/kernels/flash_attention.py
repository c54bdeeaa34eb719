"""Flash attention: the CUDA kernel and its plain torch version.

Replaces the Pallas kernel ``repro/kernels/flash_attention.py::_attn_kernel``
(wrapper ``flash_attention``).  Both functions here compute, for
``q[B, H, Tq, D]``, ``k[B, Hkv, Tk, D]`` and ``v[B, Hkv, Tk, Dv]`` (float32
or bfloat16), the online-softmax attention of the TPU kernel: ``q`` scaled
by ``1/sqrt(D)`` in float32, the running max, denominator and accumulator
in float32, masked scores ``-1e30``, output ``acc / max(l, 1e-30)`` in
q's dtype.
Query head ``h`` reads KV head ``h // (H / Hkv)`` with no copy of K/V;
causal mode masks ``key > query`` (top-left) and skips the key blocks above
the diagonal.

* :func:`flash_attention_cuda` launches ``csrc/flash_attention.cu``.  What
  bounds it is operations: 4 T D flops per query row against 2 D bytes of
  q and o, far above the card's flop/byte ridge, so the bound is the
  tensor cores' bf16 rate.  :func:`kernel_variant` names the kernel that
  a ``(dtype, D, Dv)`` runs, and the C dispatch follows it:

  - ``"wgmma"``, bfloat16 at D = 64 and 128 (every ported LM's full
    configuration): Hopper's own path.  A block owns a (batch, head,
    128-row query tile) and has three warpgroups: a producer whose one
    thread streams q and then k, v through a two-stage ring of 128-key
    tiles with TMA loads and mbarriers, and two consumers of 64 rows
    that compute ``q k^T`` and ``p v`` with ``wgmma`` (p packed to bf16
    in registers) and the online softmax in registers between them, so
    the copies overlap the products.  The tensor maps are built from q, k
    and v's strides, so the tensors must meet TMA's rules
    (:func:`tma_ok`).
  - ``"mma"``, bfloat16 at D = 16 and 32: ``mma.sync`` on the tensor
    cores with synchronous copies, 64-row query tiles.
  - ``"mla"``, bfloat16 at ``(D, Dv) = (288, 256)`` (minicpm3-4b's
    attention over its latent): ``mma.sync`` as ``"mma"``, each row
    group's 256 output columns split over two warps that share p through
    shared memory.  It has not had a Hopper pass (no TMA, no ``wgmma``).
  - ``"simt"``, float32 at every width and bfloat16 at D = 8 and at
    ``(32, 24)``: float32 FMAs on the SIMT units, bound by their 67
    TFLOP/s.

  Every variant keeps the running max, denominator and accumulator in
  float32; bf16 variants round p to bf16 for its product.  ``PERF.md``
  has the times beside the bound and beside
  ``scaled_dot_product_attention``.  The kernels loop over the key tiles
  of their block, heaviest causal tiles first, and read q, k and v
  through their batch, head and row strides, so the transposed views the
  transformer hands over need no copy; a tensor that :func:`tma_ok`
  refuses is copied once (read and written once more).  There is no
  fallback between variants: a CUDA tensor launches its variant or the
  call raises.  The library is built with ``nvcc`` at first use into
  ``build/`` and loaded with ``ctypes`` (``kernels/_build.py``).
* :func:`flash_attention_plain` is the TPU kernel's loop in torch: 128 x
  128 blocks, key blocks in order, every query block at once, in float32.
  The CPU tests run it and hold it to the Pallas kernel in interpret mode;
  ``chip_smoke.py`` holds the CUDA kernel to it on the card.

Both versions take the widths the kernel is built for (:data:`WIDTHS`)
and raise on the rest (:func:`check_args`).  ``Dv != D`` is taken at MLA's
two pairs, ``(288, 256)`` and ``(32, 24)``, where the port deviates from
the TPU kernel: that kernel reshapes v with q's width, so an MLA call
crashes it (ROADMAP queue 3, fault 1), while the function it was written
for, ``kernels/ref.py::flash_attention_ref``, has an output of v's width
and the scale ``1/sqrt(D)``; these versions compute that function, with
an accumulator of v's width.  The TPU kernel aligns the causal mask
top-left where ``kernels/ref.py`` aligns it bottom-right, so the two
disagree when ``Tq != Tk``; the kernel route refuses that (fault 2).

Nothing here imports a GPU toolchain at import time.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

SOURCE = _build.CSRC / "flash_attention.cu"
HEAD_DIMS = (8, 16, 32, 64, 128)     # the head widths the kernel is built for
MLA_WIDTHS = ((288, 256), (32, 24))  # (D, Dv) of minicpm3-4b, full and smoke
WIDTHS = tuple((d, d) for d in HEAD_DIMS) + MLA_WIDTHS
BLOCK = 128                          # the TPU kernel's bq = bk
NEG_INF = -1e30
DTYPES = (torch.float32, torch.bfloat16)


def check_args(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               causal: bool) -> None:
    """Raise on what neither version takes: shapes that are not
    ``[B, H, Tq, D]`` / ``[B, Hkv, Tk, D]`` / ``[B, Hkv, Tk, Dv]`` with
    ``H % Hkv == 0`` and T a multiple of 128, mixed devices or dtypes, a
    dtype other than float32 or bfloat16, a ``(D, Dv)`` pair the kernel is
    not built for (:data:`WIDTHS`), or causal with ``Tq != Tk``."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"q, k, v must be 4-D: {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, h, tq, d = q.shape
    dv = v.shape[-1]
    if (k.shape[:3] != v.shape[:3] or k.shape[0] != b
            or k.shape[-1] != d):
        raise ValueError(f"k and v must be [B, Hkv, Tk, D] and [B, Hkv, "
                         f"Tk, Dv] of q's B and D: {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    hkv, tk = k.shape[1], k.shape[2]
    if hkv == 0 or h % hkv:
        raise ValueError(f"query heads {h} are not a multiple of KV heads "
                         f"{hkv}")
    if (d, dv) not in WIDTHS:
        what = (f"head width {d}" if d == dv
                else f"widths (d_q {d}, d_v {dv})")
        raise ValueError(f"{what}: not a pair the kernel is built for: "
                         f"{WIDTHS}")
    if tq % BLOCK or tk % BLOCK:
        raise ValueError(f"Tq={tq} and Tk={tk} must be multiples of {BLOCK}")
    if causal and tq != tk:
        raise ValueError(f"causal attention with Tq={tq} != Tk={tk}: the "
                         f"kernel aligns the mask top-left, kernels/ref.py "
                         f"bottom-right")
    for name, t in (("k", k), ("v", v)):
        if t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}, q {q.dtype}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    if q.dtype not in DTYPES:
        raise TypeError(f"q must be float32 or bfloat16: {q.dtype}")


# --------------------------------------------------------------------- #
# plain version
# --------------------------------------------------------------------- #


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True) -> torch.Tensor:
    """The TPU kernel's online softmax in plain torch, on any device.

    Key block ``kb`` updates every query block that the TPU kernel's loop
    reaches it from (all of them, or causal those at or below the
    diagonal), so the blocks meet the same updates in the same order.
    """
    check_args(q, k, v, causal)
    b, h, tq, d = q.shape
    hkv, tk, dv = k.shape[1], k.shape[2], v.shape[-1]
    g = h // hkv
    qf = (q.to(torch.float32) * (1.0 / (d ** 0.5))).reshape(b, hkv, g, tq, d)
    kf = k.to(torch.float32)[:, :, None]        # [B, Hkv, 1, Tk, D]
    vf = v.to(torch.float32)[:, :, None]        # [B, Hkv, 1, Tk, Dv]
    m = torch.full((b, hkv, g, tq), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, hkv, g, tq, dv), dtype=torch.float32,
                      device=q.device)
    for kb in range(tk // BLOCK):
        k0 = kb * BLOCK
        r0 = k0 if causal else 0                # first query block reached
        kblk, vblk = kf[..., k0:k0 + BLOCK, :], vf[..., k0:k0 + BLOCK, :]
        s = qf[..., r0:, :] @ kblk.transpose(-1, -2)
        if causal:
            qpos = torch.arange(r0, tq, device=q.device)[:, None]
            kpos = torch.arange(k0, k0 + BLOCK, device=q.device)[None, :]
            s = torch.where(qpos >= kpos, s, torch.full_like(s, NEG_INF))
        m_old = m[..., r0:]
        m_new = torch.maximum(m_old, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        scale = torch.exp(m_old - m_new)
        l[..., r0:] = l[..., r0:] * scale + p.sum(dim=-1)
        acc[..., r0:, :] = acc[..., r0:, :] * scale[..., None] + p @ vblk
        m[..., r0:] = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(b, h, tq, dv).to(q.dtype)


# --------------------------------------------------------------------- #
# CUDA kernel
# --------------------------------------------------------------------- #


def _bind(lib: ctypes.CDLL) -> None:
    lib.flash_attention_launch.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
        + [ctypes.c_longlong] * 9 + [ctypes.c_int, ctypes.c_float,
                                     ctypes.c_void_p])
    lib.flash_attention_launch.restype = ctypes.c_int


def kernel_variant(dtype: torch.dtype, d: int, d_v: int | None = None
                   ) -> str:
    """The kernel that ``flash_attention_cuda`` launches for q's dtype,
    q's width ``d`` and v's width ``d_v`` (default ``d``): ``"wgmma"``
    (bf16, D = 64 and 128), ``"mma"`` (bf16, D = 16 and 32), ``"mla"``
    (bf16, ``(288, 256)``) or ``"simt"`` (float32; bf16 at D = 8 and at
    ``(32, 24)``)."""
    d_v = d if d_v is None else d_v
    if dtype == torch.bfloat16 and d_v != d:
        return "mla" if (d, d_v) == (288, 256) else "simt"
    if dtype == torch.bfloat16 and d in (64, 128):
        return "wgmma"
    if dtype == torch.bfloat16 and d in (16, 32):
        return "mma"
    return "simt"


def tma_ok(t: torch.Tensor) -> bool:
    """Whether the kernels read ``t`` as it lies: last dimension
    contiguous, base 16-byte aligned, and every other stride a positive
    multiple of 16 bytes below 2^40 (what a TMA tensor map takes; the
    other variants need the first two)."""
    size = t.element_size()
    return (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(0 < s * size < 1 << 40 and s * size % 16 == 0
                    for s in t.stride()[:-1]))


def _kernel_view(t: torch.Tensor) -> torch.Tensor:
    """``t`` as the kernel reads it: itself if :func:`tma_ok`, else a
    fresh contiguous copy (which always is)."""
    if tma_ok(t):
        return t
    t = t.clone(memory_format=torch.contiguous_format)
    if not tma_ok(t):
        raise ValueError(f"strides {t.stride()} of a {tuple(t.shape)} copy "
                         f"are not what TMA takes")
    return t


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True) -> torch.Tensor:
    """Launch the kernel on the current stream (no sync); q, k, v on one
    CUDA device.  Returns a contiguous ``[B, H, Tq, Dv]`` in q's dtype."""
    check_args(q, k, v, causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_cuda needs CUDA tensors: "
                         f"{q.device}")
    q, k, v = _kernel_view(q), _kernel_view(k), _kernel_view(v)
    b, h, tq, d = q.shape
    hkv, tk, dv = k.shape[1], k.shape[2], v.shape[-1]
    out = torch.empty((b, h, tq, dv), dtype=q.dtype, device=q.device)
    lib = _build.load(SOURCE, _bind)
    strides = [s for t in (q, k, v) for s in t.stride()[:3]]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            DTYPES.index(q.dtype), b, h, hkv, tq, tk, d, dv, *strides,
            int(causal), 1.0 / (d ** 0.5), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    return out
