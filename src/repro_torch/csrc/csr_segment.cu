// CSR segment-reduce for Hopper (sm_90a): the graph ops' gather-reduce.
//
// Replaces the Pallas TPU kernel src/repro/kernels/csr_segment.py::_kernel
// (wrapper csr_segment_reduce).  With the edges sorted by destination row
// (row_off[r] .. row_off[r + 1] are row r's edges, senders[e] the source of
// edge e) it computes, for every row r and feature column c,
//   out[r, c] = reduce over e in row r of x[senders[e], c]
// for reduce in {sum, min, max}, accumulating in float32 in the row's edge
// order.  A row with no edge gets 0; for min/max that is decided by the
// row's edge count, not by the value, so +-inf inputs pass through.
//
// What bounds it: bytes.  Every edge gathers one row of x (4 F bytes) at a
// data-dependent address and adds it into registers, one add per element,
// far below the card's float32 rate.  The least traffic is each input read
// once (senders, row_off, the distinct rows of x) and out written once.
//
// Design: one warp per (destination row, 128-column feature tile), four
// warps a block.  Lane l owns columns f0 + l + 32 k (k < 4), so each
// gathered row segment is read by one coalesced 128-byte request per k.
// The warp reads 32 senders at once (one per lane, coalesced) and passes
// each to the whole warp with a shuffle.  The row's result stays in
// registers and is written once, so nothing is carried between blocks and
// the blocks run in any order (the TPU kernel's sequential grid, its
// 128-row blocks and its one-hot row select are not needed).  Offsets into
// x and out are 64-bit.  A sender outside [0, n_src) is clamped into range
// and edge offsets into [0, n_edges], so bad input never reads outside its
// buffers.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;              // rows per block
constexpr int kPer = 4;                // columns per lane
constexpr int kTile = 32 * kPer;       // columns per warp
constexpr unsigned kFull = 0xffffffffu;

enum Reduce { kSum = 0, kMin = 1, kMax = 2 };

template <int R>
__device__ __forceinline__ float init() {
  const float inf = __int_as_float(0x7f800000);
  return R == kSum ? 0.0f : (R == kMin ? inf : -inf);
}

// NaN-propagating min / max (a NaN, once in the accumulator, stays)
template <int R>
__device__ __forceinline__ float combine(float acc, float v) {
  if (R == kSum) return acc + v;
  if (R == kMin) return (v < acc || v != v) ? v : acc;
  return (v > acc || v != v) ? v : acc;
}

template <int R>
__global__ void __launch_bounds__(32 * kWarps)
csr_segment_kernel(const int32_t* __restrict__ senders,
                   const int32_t* __restrict__ row_off,
                   const float* __restrict__ x,
                   float* __restrict__ out,
                   int64_t n_out, int64_t n_src, int64_t n_edges, int f) {
  const int lane = threadIdx.x & 31;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kWarps
                      + (threadIdx.x >> 5);
  if (row >= n_out) return;
  const int f0 = blockIdx.y * kTile;
  int64_t beg = __ldg(row_off + row);
  int64_t end = __ldg(row_off + row + 1);
  beg = beg < 0 ? 0 : (beg > n_edges ? n_edges : beg);
  end = end < beg ? beg : (end > n_edges ? n_edges : end);

  float acc[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) acc[k] = init<R>();

  for (int64_t base = beg; base < end; base += 32) {
    const int64_t e = base + lane;
    int32_t s = e < end ? __ldg(senders + e) : 0;
    s = s < 0 ? 0 : (s >= n_src ? static_cast<int32_t>(n_src - 1) : s);
    const int n = static_cast<int>(end - base < 32 ? end - base : 32);
#pragma unroll 4
    for (int j = 0; j < n; ++j) {
      const int64_t src = __shfl_sync(kFull, s, j);
      const float* xr = x + src * f;
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const int c = f0 + lane + 32 * k;
        if (c < f) acc[k] = combine<R>(acc[k], __ldg(xr + c));
      }
    }
  }
  const bool empty = end == beg;
  float* orow = out + row * f;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int c = f0 + lane + 32 * k;
    if (c < f) orow[c] = (R != kSum && empty) ? 0.0f : acc[k];
  }
}

}  // namespace

// Launches on `stream` without synchronising; returns cudaGetLastError()
// (cudaErrorInvalidValue for an unknown reduce or a grid too large, 0 when
// there is nothing to launch).
extern "C" int csr_segment_launch(const void* senders, const void* row_off,
                                  const void* x, void* out, long long n_out,
                                  long long n_src, long long n_edges, int f,
                                  int reduce, void* stream) {
  if (n_out <= 0 || f <= 0) return 0;
  const long long bx = (n_out + kWarps - 1) / kWarps;
  const int by = (f + kTile - 1) / kTile;
  if (bx > 0x7fffffffLL || by > 65535) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(bx), static_cast<unsigned>(by));
  const dim3 block(32 * kWarps);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* s = static_cast<const int32_t*>(senders);
  const auto* r = static_cast<const int32_t*>(row_off);
  const auto* xf = static_cast<const float*>(x);
  auto* o = static_cast<float*>(out);
  switch (reduce) {
    case kSum:
      csr_segment_kernel<kSum><<<grid, block, 0, st>>>(s, r, xf, o, n_out,
                                                      n_src, n_edges, f);
      break;
    case kMin:
      csr_segment_kernel<kMin><<<grid, block, 0, st>>>(s, r, xf, o, n_out,
                                                      n_src, n_edges, f);
      break;
    case kMax:
      csr_segment_kernel<kMax><<<grid, block, 0, st>>>(s, r, xf, o, n_out,
                                                      n_src, n_edges, f);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}
