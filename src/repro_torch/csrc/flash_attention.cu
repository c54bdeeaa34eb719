// Flash attention for Hopper (sm_90a): the LM forward's attention.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py::
// _attn_kernel (wrapper flash_attention).  For q[B, H, Tq, D],
// k[B, Hkv, Tk, D] and v[B, Hkv, Tk, Dv] (H a multiple of Hkv) it
// computes, per query row,
//   o = softmax((q / sqrt(D)) k^T) v          (o is Dv wide)
// with the online softmax: the scale 1/sqrt(D) is applied in float32 (to
// q in the SIMT kernel, to the scores in the tensor-core ones), the running
// max m, the denominator l and the accumulator stay in float32, masked
// scores are -1e30 (not -inf) as in the TPU kernel, and the output is
// acc / max(l, 1e-30) written in q's type (float32 or bfloat16).  Query
// head ih reads KV head ih / (H / Hkv): grouped-query attention with no
// copy of K or V.  Causal mode masks key position > query position
// (aligned top-left, as the TPU kernel; the wrapper takes causal only with
// Tq == Tk) and skips every key tile above the diagonal.
//
// What bounds it: operations.  Attention over T keys does 4 T D flops per
// query row (2 T D in q k^T, 2 T D in p v; half of that causal) against
// 2 D bytes of q and o per row, far above the card's ~295 flop/byte ridge
// at any prefill length, so the bound is the tensor cores' rate (989
// TFLOP/s dense bf16).  Four kernels, chosen by (dtype, D, Dv) in
// launch_bf16 / launch_f32 (the wrapper's kernel_variant names the same).
// Dv equals D except at MLA's two pairs, (288, 256) at minicpm3-4b's full
// width and (32, 24) at its smoke width, where v is the kv_lora-wide
// latent and q, k carry the rope part beside it; the TPU kernel cannot run
// those (its reshape of v takes q's width), the reference computes them
// with the scale 1/sqrt(D), and so do these kernels.
//
// - flash_attention_wgmma_kernel, bfloat16 at D = 64 and 128 (every
//   ported LM's full configuration): Hopper's own path.  TMA loads into
//   shared memory, driven by a producer warpgroup through a two-stage
//   ring of mbarriers, keep the copies off the consumers; wgmma runs both
//   products from one 128-row query tile at the tensor cores' full issue
//   rate; what bounds it then is the softmax between the two products (an
//   exp2 per score on the special-function unit), which runs while the
//   other consumer warpgroup's products run.
// - flash_attention_mma_kernel, bfloat16 at D = 16 and 32: mma.sync on the
//   tensor cores, copies synchronous with the products; bound by the copies
//   and the older instruction's rate.
// - flash_attention_mla_kernel, bfloat16 at (D, Dv) = (288, 256): mma.sync
//   as the kernel above, with a row group's 256 output columns split over
//   two warps (a warp's 16 rows x 256 float32 columns would not fit in
//   registers beside the scores) and p shared between them through shared
//   memory; not yet given Hopper's own path.
// - flash_attention_kernel, float32 at every width and pair, and bfloat16
//   at D = 8 and at (32, 24): float32 FMAs on the SIMT units (67 TFLOP/s
//   peak), which keeps float32 exact enough to hold the card to the CPU.
//
// Every kernel loops over the key tiles of its block, so no state crosses
// blocks and the TPU kernel's sequential grid is not needed; causal query
// tiles are launched heaviest first, so the long tiles do not trail.  Rows
// are addressed through the caller's batch, head and row strides (the last
// dimension contiguous, the base and every stride 16-byte aligned: what a
// TMA tensor map takes), so a transposed view needs no copy.  Tiles above
// 48 KB of shared memory take cudaFuncSetAttribute.
//
// flash_attention_kernel and flash_attention_mma_kernel give one block one
// (batch, head, 64-row query tile); their global loads are 16 bytes a
// thread.
//
// flash_attention_kernel: 256 threads, 32-key tiles.  The scaled query
// tile, the key and value tiles (converted to float32) and the tile of
// probabilities live in shared memory (76,800 bytes at D = 128, two blocks
// per SM; 154,624 at (288, 256), one).  Thread (ty, tx) of a 16 x 16 grid owns query rows 4 ty ..
// 4 ty + 3: it computes their scores for keys tx and tx + 16 from 16-byte
// shared loads (the query rows are broadcast across the half-warp; rows
// are padded to D + 4 floats so the key rows spread over the banks),
// reduces the row max and sum over its half-warp with shuffles, writes its
// probabilities to shared memory, and accumulates Dv / 16 (rounded up)
// output columns of its four rows.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "sm90.cuh"

namespace {

constexpr int kBQ = 64;                // query rows per block
constexpr int kBK = 32;                // keys per tile
constexpr int kThreads = 256;          // a 16 x 16 grid
constexpr int kRows = kBQ / 16;        // query rows per thread
constexpr int kKeys = kBK / 16;        // keys per thread per tile
constexpr float kNegInf = -1e30f;      // the TPU kernel's mask value
constexpr unsigned kFull = 0xffffffffu;

template <int D, int DV>
struct Smem {
  static constexpr int kStride = D + 4;        // floats per q/k row
  static constexpr int kVStride = DV + 4;      // floats per v row
  static constexpr int kPStride = kBK + 4;     // floats per probability row
  static constexpr int kQ = kBQ * kStride;
  static constexpr int kK = kBK * kStride;
  static constexpr int kV = kBK * kVStride;
  static constexpr int kP = kBQ * kPStride;
  static constexpr int kBytes = sizeof(float) * (kQ + kK + kV + kP);
};

// 16 bytes of T from global memory as float32 values times `scale`
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void load(const float* p, float* out,
                                              float scale) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    out[0] = v.x * scale;
    out[1] = v.y * scale;
    out[2] = v.z * scale;
    out[3] = v.w * scale;
  }
  __device__ __forceinline__ static float store(float x) { return x; }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p,
                                              float* out, float scale) {
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x * scale;
      out[2 * i + 1] = f.y * scale;
    }
  }
  __device__ __forceinline__ static __nv_bfloat16 store(float x) {
    return __float2bfloat16(x);
  }
};

// rows [row0, row0 + rows) of one head, W values wide, into shared memory
// as float32 rows of STRIDE floats (rows at or past n_valid become 0)
template <typename T, int W, int STRIDE>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          int64_t row_stride, int row0,
                                          int rows, int n_valid,
                                          float scale) {
  constexpr int N = Vec<T>::N;
  constexpr int kChunks = W / N;
  for (int c = threadIdx.x; c < rows * kChunks; c += kThreads) {
    const int r = c / kChunks;
    const int col = (c % kChunks) * N;
    float vals[N];
    if (row0 + r < n_valid) {
      Vec<T>::load(src + static_cast<int64_t>(row0 + r) * row_stride + col,
                   vals, scale);
    } else {
#pragma unroll
      for (int i = 0; i < N; ++i) vals[i] = 0.0f;
    }
    float* d = dst + r * STRIDE + col;
#pragma unroll
    for (int i = 0; i < N; i += 4)
      *reinterpret_cast<float4*>(d + i) =
          make_float4(vals[i], vals[i + 1], vals[i + 2], vals[i + 3]);
  }
}

// the output columns a thread owns: groups of four at D >= 64 (16-byte
// shared loads; D a multiple of 64), else one column every 16 (threads
// past D hold none)
template <int D>
struct Cols {
  static constexpr int kN = D >= 64 ? D / 16 : (D + 15) / 16;
  __device__ __forceinline__ static int col(int tx, int c) {
    if constexpr (D >= 64) return 4 * (tx + 16 * (c / 4)) + (c % 4);
    return tx + 16 * c;
  }
  __device__ __forceinline__ static void load(const float* row, int tx,
                                              float (&out)[kN]) {
    if constexpr (D >= 64) {
#pragma unroll
      for (int g = 0; g < kN / 4; ++g) {
        const float4 t =
            *reinterpret_cast<const float4*>(row + 4 * (tx + 16 * g));
        out[4 * g] = t.x;
        out[4 * g + 1] = t.y;
        out[4 * g + 2] = t.z;
        out[4 * g + 3] = t.w;
      }
    } else {
#pragma unroll
      for (int c = 0; c < kN; ++c) {
        const int j = tx + 16 * c;
        out[c] = j < D ? row[j] : 0.0f;
      }
    }
  }
};

__device__ __forceinline__ float component(const float4& v, int e) {
  return e == 0 ? v.x : (e == 1 ? v.y : (e == 2 ? v.z : v.w));
}

template <typename T, int D, int DV>
__global__ void __launch_bounds__(kThreads, 2)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int h,
                       int group, int tq, int tk, int64_t qsb, int64_t qsh,
                       int64_t qst, int64_t ksb, int64_t ksh, int64_t kst,
                       int64_t vsb, int64_t vsh, int64_t vst, int causal,
                       float sm_scale) {
  using S = Smem<D, DV>;
  using C = Cols<DV>;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* ks = qs + S::kQ;
  float* vs = ks + S::kK;
  float* ps = vs + S::kV;

  const int n_qt = (tq + kBQ - 1) / kBQ;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x)) * kBQ;
  const int ih = blockIdx.y;
  const int ib = blockIdx.z;
  const int ikv = ih / group;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;

  const T* qp = q + ib * qsb + ih * qsh;
  const T* kp = k + ib * ksb + ikv * ksh;
  const T* vp = v + ib * vsb + ikv * vsh;
  load_tile<T, D, S::kStride>(qs, qp, qst, q0, kBQ, tq, sm_scale);

  float acc[kRows][C::kN];
  float m[kRows], l[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < C::kN; ++c) acc[i][c] = 0.0f;
  }

  // causal: keys past the tile's last query row are masked for every row
  const int kv_end = causal ? min(tk, q0 + kBQ) : tk;
  const int n_kt = (kv_end + kBK - 1) / kBK;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();   // the previous tile's readers are done
    load_tile<T, D, S::kStride>(ks, kp, kst, k0, kBK, tk, 1.0f);
    load_tile<T, DV, S::kVStride>(vs, vp, vst, k0, kBK, tk, 1.0f);
    __syncthreads();

    float s[kRows][kKeys];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kKeys; ++j) s[i][j] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < D; d += 4) {
      float4 qv[kRows], kv[kKeys];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        qv[i] = *reinterpret_cast<const float4*>(
            qs + (ty * kRows + i) * S::kStride + d);
#pragma unroll
      for (int j = 0; j < kKeys; ++j)
        kv[j] = *reinterpret_cast<const float4*>(
            ks + (tx + 16 * j) * S::kStride + d);
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kKeys; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
    }

    // mask, then the online-softmax update of each row (its 16 threads
    // hold one half-warp, so the reductions are shuffles)
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int row = ty * kRows + i;
      const int qpos = q0 + row;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        const int kpos = k0 + tx + 16 * j;
        if (kpos >= tk || (causal && kpos > qpos)) s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        const float p = expf(s[i][j] - m_new);
        ps[row * S::kPStride + tx + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(kFull, sum, off);
      const float scale = expf(m[i] - m_new);
      l[i] = l[i] * scale + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < C::kN; ++c) acc[i][c] *= scale;
    }
    __syncthreads();

    // acc += p v over the tile's keys
#pragma unroll 2
    for (int kk = 0; kk < kBK; kk += 4) {
      float4 pv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        pv[i] = *reinterpret_cast<const float4*>(
            ps + (ty * kRows + i) * S::kPStride + kk);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float vv[C::kN];
        C::load(vs + (kk + e) * S::kVStride, tx, vv);
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          const float p = component(pv[i], e);
#pragma unroll
          for (int c = 0; c < C::kN; ++c)
            acc[i][c] = fmaf(p, vv[c], acc[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qpos = q0 + ty * kRows + i;
    if (qpos >= tq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* orow = o + ((static_cast<int64_t>(ib) * h + ih) * tq + qpos) * DV;
#pragma unroll
    for (int c = 0; c < C::kN; ++c) {
      const int col = C::col(tx, c);
      if (col < DV) orow[col] = Vec<T>::store(acc[i][c] / denom);
    }
  }
}

template <typename T, int D, int DV = D>
int launch(const void* q, const void* k, const void* v, void* o, int b,
           int h, int hkv, int tq, int tk, const long long* st, int causal,
           float sm_scale, cudaStream_t stream) {
  auto kernel = flash_attention_kernel<T, D, DV>;
  static bool configured = false;   // once per instantiation (one device)
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        Smem<D, DV>::kBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const dim3 grid((tq + kBQ - 1) / kBQ, h, b);
  kernel<<<grid, kThreads, Smem<D, DV>::kBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), h, h / hkv, tq, tk,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], causal,
      sm_scale);
  return static_cast<int>(cudaGetLastError());
}

int launch_f32(int d, int dv, const void* q, const void* k, const void* v,
               void* o, int b, int h, int hkv, int tq, int tk,
               const long long* st, int causal, float sm_scale,
               cudaStream_t stream) {
  if (d == 32 && dv == 24)
    return launch<float, 32, 24>(q, k, v, o, b, h, hkv, tq, tk, st, causal,
                                 sm_scale, stream);
  if (d == 288 && dv == 256)
    return launch<float, 288, 256>(q, k, v, o, b, h, hkv, tq, tk, st,
                                   causal, sm_scale, stream);
  if (d != dv) return cudaErrorInvalidValue;
  switch (d) {
    case 8:
      return launch<float, 8>(q, k, v, o, b, h, hkv, tq, tk, st, causal,
                              sm_scale, stream);
    case 16:
      return launch<float, 16>(q, k, v, o, b, h, hkv, tq, tk, st, causal,
                               sm_scale, stream);
    case 32:
      return launch<float, 32>(q, k, v, o, b, h, hkv, tq, tk, st, causal,
                               sm_scale, stream);
    case 64:
      return launch<float, 64>(q, k, v, o, b, h, hkv, tq, tk, st, causal,
                               sm_scale, stream);
    case 128:
      return launch<float, 128>(q, k, v, o, b, h, hkv, tq, tk, st, causal,
                                sm_scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}


// ---------------------------------------------------------------------
// bfloat16 at D = 16 and 32: the products on the tensor cores (mma.sync)
// ---------------------------------------------------------------------

constexpr int kMmaWarps = 4;               // 16 query rows each
constexpr int kMmaBQ = 16 * kMmaWarps;     // query rows per block
constexpr int kMmaBK = 64;                 // keys per tile
constexpr int kMmaThreads = 32 * kMmaWarps;

template <int D>
struct MmaSmem {
  static constexpr int kStride = D + 8;    // bf16 per row: 16-byte rows
                                           // whose 8-row groups hit
                                           // distinct banks
  static constexpr int kQ = kMmaBQ * kStride;
  static constexpr int kK = kMmaBK * kStride;
  static constexpr int kBytes = 2 * (kQ + 2 * kK);
};

// D += A B for one 16 x 8 x 16 tile: A (16 x 16, row-major) and B
// (16 x 8, given as its 8 x 16 transpose) in bf16, D in float32
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8 x 8 bf16 matrices from shared memory, transposed: lane l gives
// the address of row l % 8 of matrix l / 8
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  const unsigned addr =
      static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
      "{%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// rows [row0, row0 + rows) of one head, W values wide, into shared memory
// as they are (bf16 rows of STRIDE values, 16 bytes a thread of THREADS;
// rows at or past n_valid become 0)
template <int W, int STRIDE, int THREADS>
__device__ __forceinline__ void copy_rows(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          int64_t row_stride, int row0,
                                          int rows, int n_valid) {
  constexpr int kChunks = W / 8;
  for (int c = threadIdx.x; c < rows * kChunks; c += THREADS) {
    const int r = c / kChunks;
    const int col = (c % kChunks) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n_valid)
      v = __ldg(reinterpret_cast<const uint4*>(
          src + static_cast<int64_t>(row0 + r) * row_stride + col));
    *reinterpret_cast<uint4*>(dst + r * STRIDE + col) = v;
  }
}

template <int D>
__device__ __forceinline__ void copy_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          int64_t row_stride, int row0,
                                          int rows, int n_valid) {
  copy_rows<D, MmaSmem<D>::kStride, kMmaThreads>(dst, src, row_stride, row0,
                                                 rows, n_valid);
}

// The same function as flash_attention_kernel for bf16, with q k^T and
// p v as bf16 tensor-core products accumulated in float32: warp w owns
// query rows 16 w .. 16 w + 15 of a 64-row tile and keeps their q
// fragments in registers; per 64-key tile it computes its 16 x 64 scores
// (one m16n8k16 per 8 keys and 16 of D), scales them by 1/sqrt(D) in
// float32, masks, updates the row max and sum with quad shuffles, rounds
// p to bf16 in place as the A operand of p v (the accumulator layout of
// two 8-key score tiles is the operand layout of one 16-key step), and
// reads v's fragments with ldmatrix.trans.  Beside the order of the sums,
// only p's rounding to bf16 differs from the float32 arithmetic of the TPU
// kernel (bf16 products of q and k are exact in float32).  Shared memory:
// the q, k and v tiles in bf16, rows padded to D + 8 (15,360 bytes at
// D = 32).
template <int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_attention_mma_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v,
                           __nv_bfloat16* __restrict__ o, int h, int group,
                           int tq, int tk, int64_t qsb, int64_t qsh,
                           int64_t qst, int64_t ksb, int64_t ksh,
                           int64_t kst, int64_t vsb, int64_t vsh,
                           int64_t vst, int causal, float sm_scale) {
  using S = MmaSmem<D>;
  constexpr int kSteps = D / 16;           // 16-wide steps of q k^T
  constexpr int kNT = kMmaBK / 8;          // 8-key score tiles
  constexpr int kDT = D / 8;               // 8-column output tiles
  extern __shared__ uint4 smem16[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem16);
  __nv_bfloat16* ks = qs + S::kQ;
  __nv_bfloat16* vs = ks + S::kK;

  const int n_qt = (tq + kMmaBQ - 1) / kMmaBQ;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x)) * kMmaBQ;
  const int ih = blockIdx.y;
  const int ib = blockIdx.z;
  const int ikv = ih / group;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gr = lane >> 2;                // row (and key) within 8
  const int gc = (lane & 3) * 2;           // column pair within 8

  const __nv_bfloat16* kp = k + ib * ksb + ikv * ksh;
  const __nv_bfloat16* vp = v + ib * vsb + ikv * vsh;
  copy_tile<D>(qs, q + ib * qsb + ih * qsh, qst, q0, kMmaBQ, tq);
  __syncthreads();
  uint32_t qa[kSteps][4];
  {
    const __nv_bfloat16* r0 = qs + (16 * warp + gr) * S::kStride + gc;
    const __nv_bfloat16* r1 = r0 + 8 * S::kStride;
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      qa[s][0] = lds32(r0 + 16 * s);
      qa[s][1] = lds32(r1 + 16 * s);
      qa[s][2] = lds32(r0 + 16 * s + 8);
      qa[s][3] = lds32(r1 + 16 * s + 8);
    }
  }

  // row halves: index 0 is row gr of the warp's 16, index 1 row gr + 8
  float acc[kDT][4];
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.0f, 0.0f};
#pragma unroll
  for (int t = 0; t < kDT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[t][e] = 0.0f;
  const int qpos0 = q0 + 16 * warp + gr;

  const int kv_end = causal ? min(tk, q0 + kMmaBQ) : tk;
  const int n_kt = (kv_end + kMmaBK - 1) / kMmaBK;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kMmaBK;
    __syncthreads();   // every warp is done with the previous tile
    copy_tile<D>(ks, kp, kst, k0, kMmaBK, tk);
    copy_tile<D>(vs, vp, vst, k0, kMmaBK, tk);
    __syncthreads();

    float s[kNT][4];
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.0f;
      const __nv_bfloat16* kr = ks + (8 * n + gr) * S::kStride + gc;
#pragma unroll
      for (int st = 0; st < kSteps; ++st)
        mma16816(s[n], qa[st], lds32(kr + 16 * st), lds32(kr + 16 * st + 8));
    }

    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int half = e >> 1;
        const int kpos = k0 + 8 * n + gc + (e & 1);
        float x = s[n][e] * sm_scale;
        if (kpos >= tk || (causal && kpos > qpos0 + 8 * half)) x = kNegInf;
        s[n][e] = x;
        mx[half] = fmaxf(mx[half], x);
      }
    float scale[2], sum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(kFull, mx[hf], 1));
      mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(kFull, mx[hf], 2));
      const float m_new = fmaxf(m[hf], mx[hf]);
      scale[hf] = expf(m[hf] - m_new);
      m[hf] = m_new;
    }
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[n][e] - m[e >> 1]);
        s[n][e] = p;
        sum[e >> 1] += p;
      }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      sum[hf] += __shfl_xor_sync(kFull, sum[hf], 1);
      sum[hf] += __shfl_xor_sync(kFull, sum[hf], 2);
      l[hf] = l[hf] * scale[hf] + sum[hf];
    }
#pragma unroll
    for (int t = 0; t < kDT; ++t) {
      acc[t][0] *= scale[0];
      acc[t][1] *= scale[0];
      acc[t][2] *= scale[1];
      acc[t][3] *= scale[1];
    }

    // acc += p v, 16 keys a step
#pragma unroll
    for (int j = 0; j < kNT / 2; ++j) {
      const uint32_t pa[4] = {pack_bf16(s[2 * j][0], s[2 * j][1]),
                              pack_bf16(s[2 * j][2], s[2 * j][3]),
                              pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]),
                              pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3])};
      // lanes 0-7 / 8-15 address keys 16 j + 0..7 / 8..15 of columns
      // 8 t .. 8 t + 7; lanes 16-31 the same of columns 8 t + 8 ..
      const __nv_bfloat16* vr =
          vs + (16 * j + (lane & 15)) * S::kStride + 8 * (lane >> 4);
#pragma unroll
      for (int t = 0; t < kDT; t += 2) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, vr + 8 * t);
        mma16816(acc[t], pa, b[0], b[1]);
        mma16816(acc[t + 1], pa, b[2], b[3]);
      }
    }
  }

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int qpos = qpos0 + 8 * hf;
    if (qpos >= tq) continue;
    const float denom = fmaxf(l[hf], 1e-30f);
    __nv_bfloat16* orow =
        o + ((static_cast<int64_t>(ib) * h + ih) * tq + qpos) * D + gc;
#pragma unroll
    for (int t = 0; t < kDT; ++t)
      *reinterpret_cast<uint32_t*>(orow + 8 * t) =
          pack_bf16(acc[t][2 * hf] / denom, acc[t][2 * hf + 1] / denom);
  }
}

template <int D>
int launch_mma(const void* q, const void* k, const void* v, void* o, int b,
               int h, int hkv, int tq, int tk, const long long* st,
               int causal, float sm_scale, cudaStream_t stream) {
  auto kernel = flash_attention_mma_kernel<D>;
  static bool configured = false;   // once per instantiation (one device)
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        MmaSmem<D>::kBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const dim3 grid((tq + kMmaBQ - 1) / kMmaBQ, h, b);
  kernel<<<grid, kMmaThreads, MmaSmem<D>::kBytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      h, h / hkv, tq, tk, st[0], st[1], st[2], st[3], st[4], st[5], st[6],
      st[7], st[8], causal, sm_scale);
  return static_cast<int>(cudaGetLastError());
}


// ---------------------------------------------------------------------
// bfloat16 at (D, Dv) = (288, 256): MLA's call (kv_lora + rope wide q and
// k, the kv_lora-wide latent as v), mma.sync with the output split over
// warp pairs
// ---------------------------------------------------------------------

constexpr int kMlaD = 288;                 // q and k: kv_lora + rope_dim
constexpr int kMlaDv = 256;                // v and o: kv_lora
constexpr int kMlaBQ = 64;                 // query rows per block
constexpr int kMlaBK = 32;                 // keys per tile
constexpr int kMlaThreads = 256;           // 8 warps: 4 row groups x 2 halves

struct MlaSmem {
  static constexpr int kQStride = kMlaD + 8;     // bf16 per q / k row
  static constexpr int kVStride = kMlaDv + 8;    // bf16 per v row
  static constexpr int kPStride = kMlaBK + 8;    // bf16 per p row
  static constexpr int kQ = kMlaBQ * kQStride;
  static constexpr int kK = kMlaBK * kQStride;
  static constexpr int kV = kMlaBK * kVStride;
  static constexpr int kP = kMlaBQ * kPStride;
  // + two float halves per query row: the row maxima, then the row sums
  static constexpr int kBytes = 2 * (kQ + kK + kV + kP) + 4 * 2 * kMlaBQ;
};

// The same function as flash_attention_mma_kernel at MLA's widths, where
// one warp cannot hold its rows' output: 16 rows x 256 float32 columns
// would be 128 registers a thread before the scores.  Block: one (batch,
// head, 64-row query tile), 8 warps.  Warp w owns query rows 16 (w % 4) ..
// + 15 and half w / 4: the keys 16 half .. + 15 of each 32-key tile for
// q k^T, and the output columns 128 half .. + 127 for p v, so every warp
// holds 64 accumulator registers and no product is computed twice.  Per
// tile: each warp computes its 16 x 16 scores (18 k-steps of 16 over
// D = 288, q's and k's fragments read from shared memory), scales them by
// 1/sqrt(D) in float32 and masks them; the two warps of a row group swap
// their partial row maxima through shared memory, so both take the same
// running max m; each writes its p, rounded to bf16, to a 64 x 32 tile
// in shared memory and keeps its own partial row sums l; after a barrier
// each warp reads the A operand of p v for all 32 keys of its rows from
// that tile and v's fragments with ldmatrix.trans.  The two halves' row
// sums are added at the end.  Shared memory: q, k and v tiles in bf16
// (rows padded by 8 values, so 8 rows of 16 bytes hit distinct banks), p,
// and the row exchange: 79,360 bytes, two blocks per SM.  Copies are
// synchronous; the other block on the SM runs while one waits.  Not yet
// tuned for Hopper: no TMA, no wgmma, each block reads every key tile
// up to its diagonal from L2.
__global__ void __launch_bounds__(kMlaThreads, 2)
flash_attention_mla_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v,
                           __nv_bfloat16* __restrict__ o, int h, int group,
                           int tq, int tk, int64_t qsb, int64_t qsh,
                           int64_t qst, int64_t ksb, int64_t ksh,
                           int64_t kst, int64_t vsb, int64_t vsh,
                           int64_t vst, int causal, float sm_scale) {
  using S = MlaSmem;
  constexpr int kSteps = kMlaD / 16;       // 16-wide steps of q k^T
  constexpr int kNT = kMlaBK / 2 / 8;      // 8-key score tiles of a warp
  constexpr int kDT = kMlaDv / 2 / 8;      // 8-column output tiles of a warp
  extern __shared__ uint4 smem16[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem16);
  __nv_bfloat16* ks = qs + S::kQ;
  __nv_bfloat16* vs = ks + S::kK;
  __nv_bfloat16* ps = vs + S::kV;
  float* red = reinterpret_cast<float*>(ps + S::kP);   // [2][kMlaBQ]

  const int n_qt = (tq + kMlaBQ - 1) / kMlaBQ;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x)) * kMlaBQ;
  const int ih = blockIdx.y;
  const int ib = blockIdx.z;
  const int ikv = ih / group;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gr = lane >> 2;                // row (and key) within 8
  const int gc = (lane & 3) * 2;           // column pair within 8
  const int half = warp >> 2;              // key half, output column half
  const int row = 16 * (warp & 3) + gr;    // this thread's rows: row, row + 8
  const int mine = half * kMlaBQ + row;    // its slots in red (+ 8)
  const int other = (half ^ 1) * kMlaBQ + row;

  const __nv_bfloat16* kp = k + ib * ksb + ikv * ksh;
  const __nv_bfloat16* vp = v + ib * vsb + ikv * vsh;
  copy_rows<kMlaD, S::kQStride, kMlaThreads>(qs, q + ib * qsb + ih * qsh,
                                             qst, q0, kMlaBQ, tq);
  const __nv_bfloat16* qr = qs + row * S::kQStride + gc;

  // row halves: index 0 is row `row`, index 1 row `row + 8`
  float acc[kDT][4];
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.0f, 0.0f};
#pragma unroll
  for (int t = 0; t < kDT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[t][e] = 0.0f;
  const int qpos0 = q0 + row;

  const int kv_end = causal ? min(tk, q0 + kMlaBQ) : tk;
  const int n_kt = (kv_end + kMlaBK - 1) / kMlaBK;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kMlaBK;
    __syncthreads();   // every warp is done with the previous tile
    copy_rows<kMlaD, S::kQStride, kMlaThreads>(ks, kp, kst, k0, kMlaBK, tk);
    copy_rows<kMlaDv, S::kVStride, kMlaThreads>(vs, vp, vst, k0, kMlaBK,
                                                tk);
    __syncthreads();

    // S = q k^T over this warp's 16 keys
    float s[kNT][4];
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.0f;
    const __nv_bfloat16* kr = ks + (16 * half + gr) * S::kQStride + gc;
#pragma unroll 6
    for (int st = 0; st < kSteps; ++st) {
      const uint32_t a[4] = {lds32(qr + 16 * st),
                             lds32(qr + 8 * S::kQStride + 16 * st),
                             lds32(qr + 16 * st + 8),
                             lds32(qr + 8 * S::kQStride + 16 * st + 8)};
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
        const __nv_bfloat16* kn = kr + 8 * n * S::kQStride + 16 * st;
        mma16816(s[n], a, lds32(kn), lds32(kn + 8));
      }
    }

    // scale, mask, and this warp's partial row maxima
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hf = e >> 1;
        const int kpos = k0 + 16 * half + 8 * n + gc + (e & 1);
        float x = s[n][e] * sm_scale;
        if (kpos >= tk || (causal && kpos > qpos0 + 8 * hf)) x = kNegInf;
        s[n][e] = x;
        mx[hf] = fmaxf(mx[hf], x);
      }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(kFull, mx[hf], 1));
      mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(kFull, mx[hf], 2));
    }
    if ((lane & 3) == 0) {
      red[mine] = mx[0];
      red[mine + 8] = mx[1];
    }
    __syncthreads();

    // the row max over both halves, then p, l and the rescaled acc
    float scale[2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const float m_new = fmaxf(m[hf], fmaxf(mx[hf], red[other + 8 * hf]));
      scale[hf] = expf(m[hf] - m_new);
      m[hf] = m_new;
      l[hf] *= scale[hf];
    }
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[n][e] - m[e >> 1]);
        s[n][e] = p;
        l[e >> 1] += p;
      }
#pragma unroll
    for (int t = 0; t < kDT; ++t) {
      acc[t][0] *= scale[0];
      acc[t][1] *= scale[0];
      acc[t][2] *= scale[1];
      acc[t][3] *= scale[1];
    }
    // p in bf16 to shared memory: rows row, row + 8; keys 16 half + 8 n + gc
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        *reinterpret_cast<uint32_t*>(
            ps + (row + 8 * hf) * S::kPStride + 16 * half + 8 * n + gc) =
            pack_bf16(s[n][2 * hf], s[n][2 * hf + 1]);
    __syncthreads();

    // acc += p v over the tile's 32 keys, this warp's 128 columns
#pragma unroll
    for (int j = 0; j < kMlaBK / 16; ++j) {
      const __nv_bfloat16* pr = ps + row * S::kPStride + 16 * j + gc;
      const uint32_t pa[4] = {lds32(pr), lds32(pr + 8 * S::kPStride),
                              lds32(pr + 8), lds32(pr + 8 * S::kPStride + 8)};
      const __nv_bfloat16* vr = vs + (16 * j + (lane & 15)) * S::kVStride +
                                128 * half + 8 * (lane >> 4);
#pragma unroll
      for (int t = 0; t < kDT; t += 2) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, vr + 8 * t);
        mma16816(acc[t], pa, b[0], b[1]);
        mma16816(acc[t + 1], pa, b[2], b[3]);
      }
    }
  }

  // the row sums: over the quad, then over the two halves (every read of
  // the maxima in red came before the loop's last barrier)
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    l[hf] += __shfl_xor_sync(kFull, l[hf], 1);
    l[hf] += __shfl_xor_sync(kFull, l[hf], 2);
  }
  if ((lane & 3) == 0) {
    red[mine] = l[0];
    red[mine + 8] = l[1];
  }
  __syncthreads();
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int qpos = qpos0 + 8 * hf;
    if (qpos >= tq) continue;
    const float denom = fmaxf(l[hf] + red[other + 8 * hf], 1e-30f);
    __nv_bfloat16* orow = o +
        ((static_cast<int64_t>(ib) * h + ih) * tq + qpos) * kMlaDv +
        128 * half + gc;
#pragma unroll
    for (int t = 0; t < kDT; ++t)
      *reinterpret_cast<uint32_t*>(orow + 8 * t) =
          pack_bf16(acc[t][2 * hf] / denom, acc[t][2 * hf + 1] / denom);
  }
}

int launch_mla(const void* q, const void* k, const void* v, void* o, int b,
               int h, int hkv, int tq, int tk, const long long* st,
               int causal, float sm_scale, cudaStream_t stream) {
  auto kernel = flash_attention_mla_kernel;
  static bool configured = false;   // once per process (one device)
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        MlaSmem::kBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const dim3 grid((tq + kMlaBQ - 1) / kMlaBQ, h, b);
  kernel<<<grid, kMlaThreads, MlaSmem::kBytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      h, h / hkv, tq, tk, st[0], st[1], st[2], st[3], st[4], st[5], st[6],
      st[7], st[8], causal, sm_scale);
  return static_cast<int>(cudaGetLastError());
}


// ---------------------------------------------------------------------
// bfloat16 at D = 64 and 128: wgmma, TMA and warp specialisation
// ---------------------------------------------------------------------

constexpr int kWgBQ = 128;               // query rows per block (2 x 64)
constexpr int kWgBK = 128;               // keys per tile
constexpr int kWgStages = 2;             // depth of the K/V ring
constexpr int kWgThreads = 384;          // 3 warpgroups: TMA + 2 consumers
constexpr int kBoxCols = 64;             // bf16 columns of one 128-byte box
constexpr int kBoxBytes = kWgBK * 128;   // one box of 128 rows: 16 KB
constexpr float kLog2e = 1.4426950408889634f;

// 2^x on the special-function unit (what exp2f becomes under fast math:
// relative error ~2^-22, far below p's rounding to bf16)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int D>
struct WgSmem {
  static constexpr int kBoxes = D / kBoxCols;          // boxes per tile
  static constexpr int kTile = kBoxes * kBoxBytes;     // a 128 x D tile
  static constexpr int kK = kTile;                     // q at 0, then k
  static constexpr int kV = kK + kWgStages * kTile;    // then v
  static constexpr int kBar = kV + kWgStages * kTile;  // then the barriers
  static constexpr int kBars = 1 + 3 * kWgStages;
  static constexpr int kBytes = kBar + 8 * kBars + 1024;   // + alignment
};

// One online-softmax step of a consumer over its 64 rows x 128 keys of
// scores s (the wgmma accumulator: s[4 j + e] is row row0 + 8 (e / 2) of
// the block's tile, key 8 j + gc + e % 2 of the key tile): mask (only on
// the diagonal tile: key > row), update the row max m, turn s into
// p = 2^((s - m) log2(e) / sqrt(D)) with the scale folded into one float32
// multiply-add, update this thread's partial row sums l and rescale acc.
// Row maxima are reduced over the quad of threads that holds a row; the
// sums only at the end.
template <bool kMask, int N>
__device__ __forceinline__ void softmax_step(float (&s)[64], float (&acc)[N],
                                             float (&m)[2], float (&l)[2],
                                             float scale_log2, int row0,
                                             int gc) {
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    if constexpr (kMask) {
      const int key = 8 * (i / 4) + gc + (i & 1);
      if (key > row0 + 8 * ((i >> 1) & 1)) s[i] = kNegInf;
    }
    mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
  }
  float scale[2], mc[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(kFull, mx[hf], 1));
    mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(kFull, mx[hf], 2));
    scale[hf] = ex2((m[hf] - mx[hf]) * scale_log2);
    m[hf] = mx[hf];
    mc[hf] = mx[hf] * scale_log2;
    l[hf] *= scale[hf];
  }
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const float p = ex2(fmaf(s[i], scale_log2, -mc[(i >> 1) & 1]));
    s[i] = p;
    l[(i >> 1) & 1] += p;
  }
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] *= scale[(i >> 1) & 1];
}

// The same function as flash_attention_mma_kernel on Hopper's own path.
// Block: one (batch, head, 128-row query tile), three warpgroups.
// Warpgroup 0 is the producer: it gives up registers (setmaxnreg.dec) and
// one thread issues every TMA load, q once and then k and v of each
// 128-key tile into a ring of kWgStages stages; `full` barriers count the
// bytes in, `empty` barriers the 256 consumer threads out.  Warpgroups 1
// and 2 are consumers of 64 query rows each (setmaxnreg.inc): per tile,
// S = q k^T as D / 16 wgmma m64n128k16 with both operands in shared memory
// (k's rows are the K-major B operand as they lie), the online softmax in
// registers (softmax_step; the causal mask only on the diagonal tile), p
// packed to bf16 in registers as the A operand, and O += p v as 8 wgmma
// m64n{D}k16 with v's rows as the MN-major B operand (the transpose
// flag).  The producer loads the next tile while the consumers work on
// the current one, so the copies overlap the products; inside a consumer
// the products and the softmax take turns, and the two consumers overlap
// each other as the warp schedulers interleave them.  Tiles are
// 128-byte-swizzled boxes of 64 columns (sm90.cuh); q, k and v are read
// through 4-D tensor maps over (D, T, heads, B) built from the caller's
// strides.  Shared memory: q, and two stages of k and v (164,928 bytes at
// D = 128, 83,008 at D = 64): one block per SM.
template <int D>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                             const __grid_constant__ CUtensorMap k_map,
                             const __grid_constant__ CUtensorMap v_map,
                             __nv_bfloat16* __restrict__ o, int h,
                             int group, int tq, int tk, int causal,
                             float scale_log2) {
  using S = WgSmem<D>;
  constexpr int kSteps = D / 16;           // k-steps of q k^T
  constexpr int kN = D / 2;                // accumulator floats of O
  extern __shared__ uint8_t smem_raw[];
  // the swizzle repeats every 1024 bytes: tiles start on that boundary
  const uint32_t base = (sm90::smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base;
  const uint32_t k_s = base + S::kK;
  const uint32_t v_s = base + S::kV;
  const uint32_t q_full = base + S::kBar;
  const uint32_t k_full = q_full + 8;                   // + 8 stage
  const uint32_t v_full = k_full + 8 * kWgStages;
  const uint32_t empty = v_full + 8 * kWgStages;

  const int n_qt = tq / kWgBQ;
  const int qt = causal ? n_qt - 1 - static_cast<int>(blockIdx.x)
                        : static_cast<int>(blockIdx.x);   // heaviest first
  const int q0 = qt * kWgBQ;
  const int ih = blockIdx.y;
  const int ib = blockIdx.z;
  // causal: the key tiles up to the diagonal (tq == tk, aligned tiles)
  const int n_kt = causal ? qt + 1 : tk / kWgBK;

  if (threadIdx.x == 0) {
    sm90::mbar_init(q_full, 1);
    for (int st = 0; st < kWgStages; ++st) {
      sm90::mbar_init(k_full + 8 * st, 1);
      sm90::mbar_init(v_full + 8 * st, 1);
      sm90::mbar_init(empty + 8 * st, 2 * 128);
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // producer: one thread issues the loads; the rest of the group idles
    sm90::setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      const int ikv = ih / group;
      sm90::mbar_arrive_expect_tx(q_full, S::kTile);
#pragma unroll
      for (int c = 0; c < S::kBoxes; ++c)
        sm90::tma_load_4d(q_s + c * kBoxBytes, &q_map, q_full, c * kBoxCols,
                          q0, ih, ib);
      for (int kt = 0; kt < n_kt; ++kt) {
        const int st = kt % kWgStages;
        // stage st is free once the consumers released its previous round
        sm90::mbar_wait(empty + 8 * st, ((kt / kWgStages) & 1) ^ 1);
        sm90::mbar_arrive_expect_tx(k_full + 8 * st, S::kTile);
#pragma unroll
        for (int c = 0; c < S::kBoxes; ++c)
          sm90::tma_load_4d(k_s + st * S::kTile + c * kBoxBytes, &k_map,
                            k_full + 8 * st, c * kBoxCols, kt * kWgBK, ikv,
                            ib);
        sm90::mbar_arrive_expect_tx(v_full + 8 * st, S::kTile);
#pragma unroll
        for (int c = 0; c < S::kBoxes; ++c)
          sm90::tma_load_4d(v_s + st * S::kTile + c * kBoxBytes, &v_map,
                            v_full + 8 * st, c * kBoxCols, kt * kWgBK, ikv,
                            ib);
      }
    }
  } else {
    sm90::setmaxnreg_inc<232>();
    const int cw = wg - 1;                     // rows 64 cw .. 64 cw + 63
    const int tid = threadIdx.x - 128 * wg;
    const int lane = tid & 31;
    const int row0 = 64 * cw + 16 * (tid >> 5) + (lane >> 2);   // and + 8
    const int gc = 2 * (lane & 3);
    // this consumer's 64 rows of q: 64 rows x 128 bytes into each box
    const uint32_t q_c = q_s + cw * 64 * 128;

    float s[64];
    float acc[kN];
    float m[2] = {kNegInf, kNegInf};
    float l[2] = {0.0f, 0.0f};
#pragma unroll
    for (int i = 0; i < 64; ++i) s[i] = 0.0f;
#pragma unroll
    for (int i = 0; i < kN; ++i) acc[i] = 0.0f;

    sm90::mbar_wait(q_full, 0);
    for (int kt = 0; kt < n_kt; ++kt) {
      const int st = kt % kWgStages;
      const uint32_t parity = (kt / kWgStages) & 1;
      const uint32_t k_t = k_s + st * S::kTile;
      const uint32_t v_t = v_s + st * S::kTile;

      // S = q k^T: k-step j reads 16 columns, 32 j bytes into box j / 4
      sm90::mbar_wait(k_full + 8 * st, parity);
      sm90::fence_operands(s);
      sm90::wgmma_fence();
#pragma unroll
      for (int j = 0; j < kSteps; ++j) {
        const uint32_t off = (j / 4) * kBoxBytes + 32 * (j % 4);
        sm90::wgmma_ss_m64n128(s, sm90::sw128_desc(q_c + off, 16, 1024),
                               sm90::sw128_desc(k_t + off, 16, 1024),
                               j > 0);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_operands(s);

      if (causal && kt == n_kt - 1)
        softmax_step<true>(s, acc, m, l, scale_log2, row0, gc);
      else
        softmax_step<false>(s, acc, m, l, scale_log2, row0, gc);

      // p in bf16, in the A-operand layout: k-step kk is keys 16 kk ..
      // 16 kk + 15, the accumulator's 8-key groups 2 kk and 2 kk + 1
      uint32_t pa[8][4];
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        pa[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
        pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
        pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
        pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
      }

      // O += p v: k-step kk reads keys 16 kk .. (2048 kk bytes in); v's
      // column boxes lie kBoxBytes apart (LBO), its 8-key groups 1024
      sm90::mbar_wait(v_full + 8 * st, parity);
      sm90::fence_operands(acc);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        const uint64_t desc = sm90::sw128_desc(v_t + 2048 * kk, kBoxBytes,
                                               1024);
        if constexpr (D == 128)
          sm90::wgmma_rs_m64n128_tb(acc, pa[kk], desc);
        else
          sm90::wgmma_rs_m64n64_tb(acc, pa[kk], desc);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_operands(acc);
      sm90::mbar_arrive(empty + 8 * st);
    }

    // epilogue: the row sums over the quad, then acc / max(l, 1e-30)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      l[hf] += __shfl_xor_sync(kFull, l[hf], 1);
      l[hf] += __shfl_xor_sync(kFull, l[hf], 2);
      const float denom = fmaxf(l[hf], 1e-30f);
      const int qpos = q0 + row0 + 8 * hf;
      __nv_bfloat16* orow =
          o + ((static_cast<int64_t>(ib) * h + ih) * tq + qpos) * D + gc;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<uint32_t*>(orow + 8 * j) = pack_bf16(
            acc[4 * j + 2 * hf] / denom, acc[4 * j + 2 * hf + 1] / denom);
    }
  }
}

template <int D>
int launch_wgmma(const void* q, const void* k, const void* v, void* o,
                 int b, int h, int hkv, int tq, int tk, const long long* st,
                 int causal, float sm_scale, cudaStream_t stream) {
  if (tq % kWgBQ || tk % kWgBK || (causal && tq != tk))
    return cudaErrorInvalidValue;
  CUtensorMap maps[3];
  const void* ptrs[3] = {q, k, v};
  const int rows[3] = {tq, tk, tk};
  const int heads[3] = {h, hkv, hkv};
  for (int i = 0; i < 3; ++i) {
    const int err = sm90::encode_bf16_map(
        &maps[i], ptrs[i], D, rows[i], heads[i], b, st[3 * i + 2],
        st[3 * i + 1], st[3 * i], kBoxCols, kWgBK);
    if (err) return err;
  }
  auto kernel = flash_attention_wgmma_kernel<D>;
  static bool configured = false;   // once per instantiation (one device)
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        WgSmem<D>::kBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const dim3 grid(tq / kWgBQ, h, b);
  kernel<<<grid, kWgThreads, WgSmem<D>::kBytes, stream>>>(
      maps[0], maps[1], maps[2], static_cast<__nv_bfloat16*>(o), h, h / hkv,
      tq, tk, causal, sm_scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

int launch_bf16(int d, int dv, const void* q, const void* k,
                const void* v, void* o, int b, int h, int hkv, int tq,
                int tk, const long long* st, int causal, float sm_scale,
                cudaStream_t stream) {
  if (d == 32 && dv == 24)
    return launch<__nv_bfloat16, 32, 24>(q, k, v, o, b, h, hkv, tq, tk, st,
                                         causal, sm_scale, stream);
  if (d == kMlaD && dv == kMlaDv)
    return launch_mla(q, k, v, o, b, h, hkv, tq, tk, st, causal, sm_scale,
                      stream);
  if (d != dv) return cudaErrorInvalidValue;
  switch (d) {
    case 8:   // below one 16-wide step of the tensor-core product
      return launch<__nv_bfloat16, 8>(q, k, v, o, b, h, hkv, tq, tk, st,
                                      causal, sm_scale, stream);
    case 16:
      return launch_mma<16>(q, k, v, o, b, h, hkv, tq, tk, st, causal,
                            sm_scale, stream);
    case 32:
      return launch_mma<32>(q, k, v, o, b, h, hkv, tq, tk, st, causal,
                            sm_scale, stream);
    case 64:
      return launch_wgmma<64>(q, k, v, o, b, h, hkv, tq, tk, st, causal,
                              sm_scale, stream);
    case 128:
      return launch_wgmma<128>(q, k, v, o, b, h, hkv, tq, tk, st, causal,
                               sm_scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Launches on `stream` without synchronising; returns cudaGetLastError()
// (cudaErrorInvalidValue for an unbuilt (d, dv) pair, an unknown dtype, a
// head count that is not a multiple of the KV heads, or a grid too large;
// 0 when there is nothing to launch).  dtype 0 is float32, 1 bfloat16.
// d is q's and k's width, dv v's.  Strides are in elements: (batch, head,
// row) of q, then of k, then of v; o is contiguous [B, H, Tq, dv].
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int dtype, int b,
    int h, int hkv, int tq, int tk, int d, int dv, long long qsb,
    long long qsh, long long qst, long long ksb, long long ksh,
    long long kst, long long vsb, long long vsh, long long vst, int causal,
    float sm_scale, void* stream) {
  if (b <= 0 || h <= 0 || tq <= 0) return 0;
  if (hkv <= 0 || h % hkv || tk <= 0 || b > 65535 || h > 65535)
    return cudaErrorInvalidValue;
  const long long st[9] = {qsb, qsh, qst, ksb, ksh, kst, vsb, vsh, vst};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_f32(d, dv, q, k, v, o, b, h, hkv, tq, tk, st, causal,
                      sm_scale, s);
  if (dtype == 1)
    return launch_bf16(d, dv, q, k, v, o, b, h, hkv, tq, tk, st, causal,
                       sm_scale, s);
  return cudaErrorInvalidValue;
}
