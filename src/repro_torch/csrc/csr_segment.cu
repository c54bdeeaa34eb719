// CSR segment-reduce for Hopper (sm_90a): the graph ops' gather-reduce.
//
// Replaces the Pallas TPU kernel src/repro/kernels/csr_segment.py::_kernel
// (wrapper csr_segment_reduce).  With the edges sorted by destination row
// (row_off[r] .. row_off[r + 1] are row r's edges, senders[e] the source of
// edge e) it computes, for every row r and feature column c,
//   out[r, c] = reduce over e in row r of x[senders[e], c]
// for reduce in {sum, min, max}, accumulating in float32 in the row's edge
// order (sum), or exactly (min/max; NaN propagates).  A row with no edge
// gets 0; for min/max that is decided by the row's edge count, not by the
// value, so +-inf inputs pass through.  No atomics: every launch gives the
// same bits.
//
// What bounds it: bytes.  Every edge gathers one row of x (4 F bytes) at a
// data-dependent address and adds it into registers, one add per element,
// far below the card's float32 rate.  The least traffic is each input read
// once (senders, row_off, the distinct rows of x) and out written once; on
// uniformly random senders over an x larger than the L2 a gathered row is
// seldom found there again, so every edge's row read ("the gather scale")
// is what such data really costs.
//
// Why the first design (one warp per row and 128-column tile) reached 46%
// of that bound at minibatch_lg, F 602, one edge per row: each warp ran
// three dependent round trips (row_off, then senders, then the gather)
// before its 512 bytes moved, the 5 tile-warps of a row read the same
// row_off and senders again, the last tile left 30% of its lanes idle, and
// every load was a scalar 4 bytes.  An SM held about 11 KB of gathers in
// flight, where the memory's rate times its loaded latency asks for 20.
//
// This design (chosen by tools/csr_check.py's design runs, in PERF.md):
//  * A block takes 32 consecutive rows.  Each of its kWarps warps reads
//    their 33 offsets in one coalesced read (lane i row r0 + i), and they
//    split the rows by merge path: row i weighs 1 + its edges, and warp w
//    takes the rows whose prefix of weights falls in the w-th of kWarps
//    equal steps.  So a skewed run (GraphSAGE's padded batch: 94% of the
//    rows empty, the rest about 10 edges) spreads over the warps and the
//    blocks over the card, with no index read but the one; rows are never
//    split, so no atomics.  A warp's senders come 32 at a time into a
//    window of registers, the next 32 read ahead, so a gather waits on no
//    index but the first of each 32 edges.
//  * Wide rows (F / vec > 16): the warp walks its edges as one flat
//    stream, row after row, through a ring of up to kDepth slots in
//    shared memory (kRingBytes a warp) that cp.async fills D - 1 edges
//    ahead of the adds, across row boundaries: 8 rows in flight at F 100
//    and 128, and up to 8 warps an SM of them.  All 32 lanes share one
//    edge; vector column j of the row goes to lane j % 32, slot j / 32,
//    so a row is covered whole (a grid column of `slots` x 32 vectors;
//    the plan keeps a lane at 20 floats, so F 602 takes one column, F
//    1433 four).  4-byte vectors go to registers instead: a 4-byte
//    cp.async cost more than it hid (full_graph_sm 25.6 against 16.8 us).
//  * Vector loads and stores of `vec` floats: 16 bytes where F % 4 == 0
//    and x is 16-byte aligned, 8 where F is even, 4 otherwise (a row
//    slice of a larger tensor may start anywhere).
//  * Narrow rows (F / vec <= 16, as minhash's F 1 and molecule's F 32):
//    `lanes` lanes (a power of two) share an edge, so 32 / lanes edges of
//    a row are gathered at once; the groups are combined by shuffles in a
//    fixed tree, so the result does not depend on timing.
//  * An empty row is written with vector stores of 0 and no gather.  A
//    row's result stays in registers and is written once, with
//    evict-first stores (out is not read again by this kernel).
// Offsets into x and out are 64-bit.  A sender outside [0, n_src) is
// clamped into range and edge offsets into [0, n_edges], so bad input
// never reads outside its buffers.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

// Raises `kernel`'s dynamic shared memory to `bytes` on the current device,
// once per device: CUDA keeps the attribute per device, so a second card
// in the same process needs its own call.  `done` is the kernel's flag per
// device.
constexpr int kMaxDevices = 64;

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, bool (&done)[kMaxDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess) done[dev] = true;
  return err;
}

constexpr int kWarps = 8;          // warps a block of 32 rows
constexpr int kDepth = 8;          // most gathered rows in flight a warp
constexpr int kRingBytes = 4096;   // a warp's ring of them in shared memory
constexpr unsigned kFull = 0xffffffffu;

enum Reduce { kSum = 0, kMin = 1, kMax = 2 };

struct Args {
  const int32_t* senders;
  const int32_t* row_off;
  const float* x;
  float* out;
  long long n_out, n_src, n_edges;
  int f;
};

template <int V>
struct alignas(4 * V) Pack {
  float v[V];
};

template <int V>
__device__ __forceinline__ Pack<V> load(const float* p) {
  Pack<V> r;
  if constexpr (V == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    r.v[0] = t.x; r.v[1] = t.y; r.v[2] = t.z; r.v[3] = t.w;
  } else if constexpr (V == 2) {
    const float2 t = __ldg(reinterpret_cast<const float2*>(p));
    r.v[0] = t.x; r.v[1] = t.y;
  } else {
    r.v[0] = __ldg(p);
  }
  return r;
}

// evict-first stores: out is not read again here
template <int V>
__device__ __forceinline__ void store(float* p, const Pack<V>& a) {
  if constexpr (V == 4) {
    __stcs(reinterpret_cast<float4*>(p),
           make_float4(a.v[0], a.v[1], a.v[2], a.v[3]));
  } else if constexpr (V == 2) {
    __stcs(reinterpret_cast<float2*>(p), make_float2(a.v[0], a.v[1]));
  } else {
    __stcs(p, a.v[0]);
  }
}

// one vector of x into shared memory, asynchronously (16 bytes bypass L1)
template <int V>
__device__ __forceinline__ void cp_async(void* dst, const float* src) {
  const auto d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if constexpr (V == 4)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(d), "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n"
                 :: "r"(d), "l"(src), "n"(4 * V) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// waits until at most N of this thread's groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

template <int R, int V>
__device__ __forceinline__ Pack<V> init() {
  const float inf = __int_as_float(0x7f800000);
  Pack<V> a;
#pragma unroll
  for (int i = 0; i < V; ++i)
    a.v[i] = R == kSum ? 0.0f : (R == kMin ? inf : -inf);
  return a;
}

template <int V>
__device__ __forceinline__ Pack<V> zeros() {
  Pack<V> a;
#pragma unroll
  for (int i = 0; i < V; ++i) a.v[i] = 0.0f;
  return a;
}

// NaN-propagating min / max (a NaN, once in the accumulator, stays)
template <int R>
__device__ __forceinline__ float combine(float acc, float v) {
  if (R == kSum) return acc + v;
  if (R == kMin) return (v < acc || v != v) ? v : acc;
  return (v > acc || v != v) ? v : acc;
}

template <int R, int V>
__device__ __forceinline__ void combine(Pack<V>& acc, const Pack<V>& v) {
#pragma unroll
  for (int i = 0; i < V; ++i) acc.v[i] = combine<R>(acc.v[i], v.v[i]);
}

__device__ __forceinline__ int clamp_off(int32_t v, long long n_edges) {
  return static_cast<int>(v < 0 ? 0 : (v > n_edges ? n_edges : v));
}

// The block's rows r0 .. r0 + 31: lane i holds row r0 + i's clamped
// [beg, end); `nonempty` and `empty` are this warp's share of them, as
// lane bits.
struct Run {
  int beg, end;
  unsigned nonempty, empty;
};

// The block's offsets in one coalesced read (the same for all its warps),
// and this warp's rows: row i weighs 1 + its edges, and warp w takes the
// rows whose prefix of weights falls in [w K, (w + 1) K), K the block's
// weight over kWarps (its merge path of rows and edges cut in equal steps;
// a row is never split).  So skewed rows spread over the block's warps,
// and the blocks, 32 rows each, spread over the card.
__device__ __forceinline__ Run read_run(const Args& a, long long r0,
                                        int lane) {
  const int nrows = static_cast<int>(a.n_out - r0 < 32 ? a.n_out - r0 : 32);
  const int last = clamp_off(__ldg(a.row_off + r0 + nrows), a.n_edges);
  const bool live = lane < nrows;
  Run run;
  run.beg = live ? clamp_off(__ldg(a.row_off + r0 + lane), a.n_edges) : 0;
  const int next = __shfl_down_sync(kFull, run.beg, 1);
  run.end = lane == nrows - 1 ? last : next;
  run.end = run.end < run.beg ? run.beg : run.end;
  const long long weight = live ? 1LL + run.end - run.beg : 0;
  long long prefix = weight;           // inclusive, by a warp scan
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const long long up = __shfl_up_sync(kFull, prefix, off);
    if (lane >= off) prefix += up;
  }
  const long long step =
      (__shfl_sync(kFull, prefix, 31) + kWarps - 1) / kWarps;
  const long long lo = (threadIdx.x >> 5) * step;
  prefix -= weight;
  const unsigned mine = __ballot_sync(kFull, live && prefix >= lo
                                             && prefix < lo + step);
  run.nonempty = mine & __ballot_sync(kFull, run.end > run.beg);
  run.empty = mine & ~run.nonempty;
  return run;
}

// 64 consecutive senders in registers (lane j holds senders[base + j] and
// senders[base + 32 + j]); moving it by 32 reads the next 32 ahead.
struct Window {
  long long base = -(1LL << 40);
  int cur = 0, next = 0;

  __device__ __forceinline__ static int read(const Args& a, long long e) {
    return e < a.n_edges ? __ldg(a.senders + e) : 0;
  }
  // make [base, base + 32) hold `e` (warp-uniform)
  __device__ __forceinline__ void cover(const Args& a, long long e,
                                        int lane) {
    const long long d = e - base;
    if (d >= 0 && d < 32) return;
    if (d >= 32 && d < 64) {
      cur = next;
      base += 32;
    } else {
      base = e;
      cur = read(a, base + lane);
    }
    next = read(a, base + 32 + lane);
  }
  __device__ __forceinline__ static long long clamp(const Args& a,
                                                    long long s) {
    return s < 0 ? 0 : (s >= a.n_src ? a.n_src - 1 : s);
  }
  // the sender of edge e in [base, base + 32) (warp-uniform)
  __device__ __forceinline__ long long sender_of(const Args& a,
                                                 long long e) const {
    return clamp(a, __shfl_sync(kFull, cur, static_cast<int>(e - base)));
  }
  // the sender of edge e in [base, base + 64), each lane its own e
  __device__ __forceinline__ long long sender(const Args& a,
                                              long long e) const {
    const int d = static_cast<int>(e - base);
    const int lo = __shfl_sync(kFull, cur, d & 31);
    const int hi = __shfl_sync(kFull, next, d & 31);
    return clamp(a, d < 32 ? lo : hi);
  }
};

// The edge cursor over the warp's nonempty rows, in row then edge order
// (warp-uniform).
struct Cursor {
  unsigned rem;      // nonempty rows not finished, as lane bits
  int row = -1, e = 0, end = 0;

  __device__ __forceinline__ void enter(const Run& run) {
    if (rem) {
      row = __ffs(rem) - 1;
      e = __shfl_sync(kFull, run.beg, row);
      end = __shfl_sync(kFull, run.end, row);
    }
  }
  __device__ __forceinline__ bool done() const { return rem == 0; }
  __device__ __forceinline__ void advance(const Run& run) {
    if (++e == end) {
      rem &= rem - 1;
      enter(run);
    }
  }
};

// gathered rows in flight a warp: kRingBytes of them, 1 to kDepth
template <int V, int C>
__host__ __device__ constexpr int depth() {
  constexpr int d = kRingBytes / (C * 32 * 4 * V);
  return d < 1 ? 1 : (d > kDepth ? kDepth : d);
}

// 4-byte vectors (odd F, or an x not 8-byte aligned) are gathered into
// registers: a 4-byte cp.async costs more than it hides
template <int V>
__host__ __device__ constexpr bool in_registers() {
  return V == 1;
}

template <int V, int C>
__host__ __device__ constexpr int ring_bytes() {
  return in_registers<V>() ? 0 : kWarps * depth<V, C>() * C * 32 * 4 * V;
}

// Wide rows: all 32 lanes on one edge, C vectors of V floats a lane; the
// warp's edges, row after row, through a ring of D slots in shared memory
// that cp.async fills D - 1 edges ahead of the adds (in registers at V 1).
template <int R, int V, int C>
__global__ void __launch_bounds__(32 * kWarps)
csr_wide_kernel(const Args a) {
  constexpr int D = depth<V, C>();
  const int lane = threadIdx.x & 31;
  const long long r0 = static_cast<long long>(blockIdx.x) * 32;
  const Run run = read_run(a, r0, lane);
  const int wv = a.f / V;
  const int vc0 = blockIdx.y * 32 * C + lane;
  for (unsigned rows = run.empty; rows; rows &= rows - 1) {
    float* o = a.out + (r0 + __ffs(rows) - 1) * a.f;
#pragma unroll
    for (int k = 0; k < C; ++k)
      if (vc0 + 32 * k < wv) store<V>(o + (vc0 + 32 * k) * V, zeros<V>());
  }
  if (!run.nonempty) return;

  extern __shared__ __align__(16) unsigned char ring_raw[];
  // slot d, vector k of this lane: ring[(d * C + k) * 32]
  Pack<V>* ring = reinterpret_cast<Pack<V>*>(ring_raw)
                  + (threadIdx.x >> 5) * D * C * 32 + lane;
  Pack<V> regs[in_registers<V>() ? D : 1][C];
  Cursor cur{run.nonempty};
  cur.enter(run);
  Window win;
  int slot_row[D];
  Pack<V> acc[C];
  int row = -1;

  // gather the cursor's edge into slot d, and step the cursor
  auto issue = [&](int d) {
    slot_row[d] = cur.done() ? -1 : cur.row;
    if (!cur.done()) {
      win.cover(a, cur.e, lane);
      const float* xr = a.x + win.sender_of(a, cur.e) * a.f;
#pragma unroll
      for (int k = 0; k < C; ++k) {
        if (vc0 + 32 * k >= wv) continue;
        if constexpr (in_registers<V>())
          regs[d][k] = load<V>(xr + (vc0 + 32 * k) * V);
        else
          cp_async<V>(ring + (d * C + k) * 32, xr + (vc0 + 32 * k) * V);
      }
      cur.advance(run);
    }
    if constexpr (!in_registers<V>()) cp_async_commit();
  };
  auto flush = [&]() {
    float* o = a.out + (r0 + row) * a.f;
#pragma unroll
    for (int k = 0; k < C; ++k)
      if (vc0 + 32 * k < wv) store<V>(o + (vc0 + 32 * k) * V, acc[k]);
  };
  // add slot d into its row, writing the previous row out when it changes
  // (each lane reads back only what it copied: no barrier)
  auto consume = [&](int d) {
    if constexpr (!in_registers<V>()) cp_async_wait<D - 1>();
    if (slot_row[d] < 0) return;
    if (slot_row[d] != row) {
      if (row >= 0) flush();
      row = slot_row[d];
#pragma unroll
      for (int k = 0; k < C; ++k) acc[k] = init<R, V>();
    }
#pragma unroll
    for (int k = 0; k < C; ++k) {
      if (vc0 + 32 * k >= wv) continue;
      if constexpr (in_registers<V>()) combine<R, V>(acc[k], regs[d][k]);
      else combine<R, V>(acc[k], ring[(d * C + k) * 32]);
    }
  };

#pragma unroll
  for (int d = 0; d < D - 1; ++d) issue(d);
  for (;;) {
#pragma unroll
    for (int d = 0; d < D; ++d) {
      issue((d + D - 1) % D);
      consume(d);
    }
    if (cur.done() && slot_row[0] < 0) break;
  }
  flush();
}

// Narrow rows (F / V <= L): L lanes on one edge, 32 / L edges of a row at
// once, their groups combined by shuffles in a fixed tree.
template <int R, int V, int L>
__global__ void __launch_bounds__(32 * kWarps)
csr_narrow_kernel(const Args a) {
  constexpr int G = 32 / L;
  const int lane = threadIdx.x & 31;
  const long long r0 = static_cast<long long>(blockIdx.x) * 32;
  const Run run = read_run(a, r0, lane);
  const int wv = a.f / V;
  const int g = lane / L, vc = lane % L;
  // lane j zeroes column j % L of the (j / L)-th empty row: G rows at once
  for (unsigned rows = run.empty; rows;) {
    unsigned mine = rows;
    for (int i = 0; i < g && mine; ++i) mine &= mine - 1;
    if (mine && vc < wv)
      store<V>(a.out + (r0 + __ffs(mine) - 1) * a.f + vc * V, zeros<V>());
    for (int i = 0; i < G && rows; ++i) rows &= rows - 1;
  }

  Window win;
  for (unsigned rows = run.nonempty; rows; rows &= rows - 1) {
    const int i = __ffs(rows) - 1;
    const int beg = __shfl_sync(kFull, run.beg, i);
    const int end = __shfl_sync(kFull, run.end, i);
    Pack<V> acc = init<R, V>();
    for (long long base = beg; base < end; base += G) {
      win.cover(a, base, lane);
      const long long e = base + g;
      const long long s = win.sender(a, e);
      if (e < end && vc < wv)
        combine<R, V>(acc, load<V>(a.x + s * a.f + vc * V));
    }
#pragma unroll
    for (int off = 16; off >= L; off >>= 1) {
      Pack<V> other;
#pragma unroll
      for (int j = 0; j < V; ++j)
        other.v[j] = __shfl_xor_sync(kFull, acc.v[j], off);
      combine<R, V>(acc, other);
    }
    if (g == 0 && vc < wv) store<V>(a.out + (r0 + i) * a.f + vc * V, acc);
  }
}

template <int R, int V, int C>
cudaError_t wide(const Args& a, dim3 grid, cudaStream_t st) {
  constexpr int smem = ring_bytes<V, C>();
  if constexpr (smem > 48 * 1024) {
    static bool configured[kMaxDevices] = {};   // this instantiation's
    const cudaError_t err = allow_smem(csr_wide_kernel<R, V, C>, smem,
                                       configured);
    if (err != cudaSuccess) return err;
  }
  csr_wide_kernel<R, V, C><<<grid, 32 * kWarps, smem, st>>>(a);
  return cudaSuccess;
}

// cudaErrorInvalidValue for a plan the build does not hold, else the
// error of raising a wide ring's shared memory (cudaSuccess once launched)
template <int R, int V>
cudaError_t launch_vec(const Args& a, int slots, int lanes, dim3 grid,
                       cudaStream_t st) {
  const dim3 block(32 * kWarps);
  switch (lanes) {
    case 1: csr_narrow_kernel<R, V, 1><<<grid, block, 0, st>>>(a); break;
    case 2: csr_narrow_kernel<R, V, 2><<<grid, block, 0, st>>>(a); break;
    case 4: csr_narrow_kernel<R, V, 4><<<grid, block, 0, st>>>(a); break;
    case 8: csr_narrow_kernel<R, V, 8><<<grid, block, 0, st>>>(a); break;
    case 16: csr_narrow_kernel<R, V, 16><<<grid, block, 0, st>>>(a); break;
    case 32: break;
    default: return cudaErrorInvalidValue;
  }
  if (lanes < 32) return cudaSuccess;
  switch (slots) {
    case 1: return wide<R, V, 1>(a, grid, st);
    case 2: return wide<R, V, 2>(a, grid, st);
    case 3: return wide<R, V, 3>(a, grid, st);
    case 4: return wide<R, V, 4>(a, grid, st);
    case 6: return wide<R, V, 6>(a, grid, st);
    case 8: return wide<R, V, 8>(a, grid, st);
    case 10: return wide<R, V, 10>(a, grid, st);
    case 12: return wide<R, V, 12>(a, grid, st);
    default: return cudaErrorInvalidValue;
  }
}

template <int R>
cudaError_t launch_reduce(const Args& a, int vec, int slots, int lanes,
                          dim3 grid, cudaStream_t st) {
  switch (vec) {
    case 1: return launch_vec<R, 1>(a, slots, lanes, grid, st);
    case 2: return launch_vec<R, 2>(a, slots, lanes, grid, st);
    case 4: return launch_vec<R, 4>(a, slots, lanes, grid, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Launches on `stream` without synchronising; returns cudaGetLastError()
// (cudaErrorInvalidValue for an unknown reduce, a plan the build does not
// hold or the pointers do not allow, or a grid too large; the error of
// raising a wide ring's shared memory on this device; 0 when there is
// nothing to launch).  The plan (kernels/csr_segment.py::launch_plan):
// `vec` floats a load, `lanes` lanes an edge (32: a wide row, `slots`
// vectors a lane in each grid column).  A block covers 32 rows.
extern "C" int csr_segment_launch(const void* senders, const void* row_off,
                                  const void* x, void* out, long long n_out,
                                  long long n_src, long long n_edges, int f,
                                  int reduce, int vec, int slots, int lanes,
                                  void* stream) {
  if (n_out <= 0 || f <= 0) return 0;
  const auto align = static_cast<uintptr_t>(4 * vec);
  if ((vec != 1 && vec != 2 && vec != 4) || f % vec != 0
      || reinterpret_cast<uintptr_t>(x) % align != 0
      || reinterpret_cast<uintptr_t>(out) % align != 0 || slots < 1
      || (lanes < 32 && (slots != 1 || f / vec > lanes)))
    return cudaErrorInvalidValue;
  const long long bx = (n_out + 31) / 32;
  const long long cols = 32LL * slots;
  const long long by = lanes < 32 ? 1 : (f / vec + cols - 1) / cols;
  if (bx > 0x7fffffffLL || by > 65535) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(bx), static_cast<unsigned>(by));
  const Args a{static_cast<const int32_t*>(senders),
               static_cast<const int32_t*>(row_off),
               static_cast<const float*>(x), static_cast<float*>(out),
               n_out, n_src, n_edges, f};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  switch (reduce) {
    case kSum:
      err = launch_reduce<kSum>(a, vec, slots, lanes, grid, st);
      break;
    case kMin:
      err = launch_reduce<kMin>(a, vec, slots, lanes, grid, st);
      break;
    case kMax:
      err = launch_reduce<kMax>(a, vec, slots, lanes, grid, st);
      break;
    default: break;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
