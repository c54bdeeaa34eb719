// Node interning for Hopper (sm_90a): the router's intern_changes in one
// kernel.
//
// Replaces the JAX package's src/repro/dist/router.py::intern_changes: a
// batch pre-lookup (ht_find_batch) followed by a lax.scan (:305) of
// _intern_one / _intern_probe over the changes, u before v.  That is an XLA
// loop, not a Pallas kernel; in eager torch it would be thousands of
// launches a chunk, so it becomes one kernel, as the rebuild fold did
// (ht_rebuild.cu).  For each row r of a stacked block of R intern states it
// computes exactly what JAX computes for that row:
//   * the lanes are the endpoints in JAX's order u_0, v_0, u_1, v_1, ...;
//     a change is valid when uh >= 0 and vh >= 0; an invalid change touches
//     nothing (JAX probes key (0, 0), writes under ok = false and counts no
//     drop) and gets -1;
//   * a lane whose key the table held at entry takes val at its slot (the
//     pre-lookup: a find chain from (k1 ^ k2) & (cap - 1), prehashed, to the
//     key or the first EMPTY, at most cap slots);
//   * every other valid lane, in order, probes the table as it stands: a
//     hit takes the existing id (a repeat of a key interned by this call);
//     a miss with n_nodes < n_cap is inserted at the first EMPTY or TOMB
//     slot from its start (JAX's pass 2, its i < cap guard: the start when
//     there is none), l2h[n_nodes] = (hi, lo), and takes n_nodes++; a miss
//     at capacity adds one to n_dropped (a dropped repeat counts again) and
//     takes -1;
//   * u and v are -1 unless both endpoints of the change got an id.
// An insert only fills an EMPTY or TOMB slot, so an entry never moves and
// the value at a pre-found slot is the one the scan would read at that
// lane's turn.  (Only an insert into a table with no EMPTY and no TOMB slot
// would overwrite a live key; an intern table holds at most n_cap keys in
// at least 4 n_cap slots, so none is ever full.)
//
// Design: one block per row.
//   1. Every thread takes lanes of the row and walks its find chain against
//      the table at entry, one slot at a time; the result goes straight to
//      the output: the id of a pre-found lane, -1 for an invalid one, kNeed
//      for the rest.  No shared memory: the outputs are the scratch.
//   2. Warp 0 walks the lanes in order, 32 at a time; a ballot picks the
//      kNeed lanes, and each is resolved by the whole warp: 32 consecutive
//      slots of its chain a round (k1 and k2 loads in flight together), a
//      ballot for the chain end (the key or EMPTY) and one for the first
//      EMPTY or TOMB, lane 0 writing the insert and __syncwarp() making it
//      visible to the next lane's walk.  n_nodes and n_dropped live in
//      registers and are written once at the end.
//   3. The block rewrites both ids of a change to -1 where either is -1.
// Table reads are plain loads (never __ldg): the same kernel writes them.
//
// What bounds it: the bytes are small (the bucket words, the ids, one chain
// end a lane and 20 B an insert: a few µs at 3.35 TB/s), but step 2 is a
// chain of dependent reads: each novel key waits for its window (mostly an
// L1/L2 hit, since step 1 walked the same chain) and for the write of the
// key before it.  So the number of novel keys in the largest row sets the
// time; rows run side by side on their own SMs.  PERF.md has the times.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int32_t kEmpty = -1;
constexpr int32_t kTomb = -2;
constexpr int32_t kNeed = -2;  // an output lane step 2 must resolve
constexpr int kBlock = 1024;
constexpr unsigned kFull = 0xFFFFFFFFu;

struct Args {
  int32_t* k1;  // [R, cap] each
  int32_t* k2;
  int32_t* val;
  int32_t* l2h;        // [R, n_cap, 2]
  int32_t* n_nodes;    // [R]
  int32_t* n_dropped;  // [R]
  const int32_t* uh;   // [R, L] words, element strides (row, lane)
  const int32_t* ul;
  const int32_t* vh;
  const int32_t* vl;
  long long row_stride;
  long long lane_stride;
  int32_t* u;  // [R, L] contiguous
  int32_t* v;
  uint32_t cap;
  int32_t n_cap;
  int32_t lanes;  // L
};

__global__ void __launch_bounds__(kBlock) intern_kernel(const Args a) {
  const int r = blockIdx.x;
  const uint32_t mask = a.cap - 1u;
  int32_t* k1 = a.k1 + static_cast<long long>(r) * a.cap;
  int32_t* k2 = a.k2 + static_cast<long long>(r) * a.cap;
  int32_t* val = a.val + static_cast<long long>(r) * a.cap;
  int32_t* l2h = a.l2h + static_cast<long long>(r) * a.n_cap * 2;
  const long long row = static_cast<long long>(r) * a.row_stride;
  int32_t* const u = a.u + static_cast<long long>(r) * a.lanes;
  int32_t* const v = a.v + static_cast<long long>(r) * a.lanes;
  const int n_lanes = 2 * a.lanes;

  // 1. the pre-lookup against the table at entry
  for (int j = threadIdx.x; j < n_lanes; j += blockDim.x) {
    const int i = j >> 1, side = j & 1;
    const long long w = row + i * a.lane_stride;
    int32_t code = -1;
    if (a.uh[w] >= 0 && a.vh[w] >= 0) {
      const int32_t h1 = side ? a.vh[w] : a.uh[w];
      const int32_t h2 = side ? a.vl[w] : a.ul[w];
      uint32_t x = (static_cast<uint32_t>(h1) ^ static_cast<uint32_t>(h2)) &
                   mask;
      code = kNeed;
      for (uint32_t step = 0; step < a.cap; ++step) {
        const int32_t c = k1[x];
        if (c == kEmpty) break;
        if (c == h1 && k2[x] == h2) {
          code = val[x];
          break;
        }
        x = (x + 1u) & mask;
      }
    }
    (side ? v : u)[i] = code;
  }
  __syncthreads();

  // 2. the ordered tail: one warp, the novel keys in JAX's lane order
  if (threadIdx.x < 32) {
    const uint32_t lane = threadIdx.x;
    int32_t nn = a.n_nodes[r];
    int32_t nd = a.n_dropped[r];
    for (int base = 0; base < n_lanes; base += 32) {
      const int j = base + static_cast<int>(lane);
      const int32_t code = j < n_lanes ? ((j & 1) ? v : u)[j >> 1] : -1;
      unsigned need = __ballot_sync(kFull, code == kNeed);
      while (need) {
        const int jj = base + __ffs(static_cast<int>(need)) - 1;
        need &= need - 1u;
        const int i = jj >> 1, side = jj & 1;
        const long long w = row + i * a.lane_stride;
        const int32_t h1 = side ? a.vh[w] : a.uh[w];
        const int32_t h2 = side ? a.vl[w] : a.ul[w];
        const uint32_t start =
            (static_cast<uint32_t>(h1) ^ static_cast<uint32_t>(h2)) & mask;
        bool found = false;
        int32_t nid = -1;
        int64_t free_off = -1;  // first EMPTY or TOMB offset from start
        for (uint32_t off0 = 0; off0 < a.cap; off0 += 32u) {
          const uint32_t off = off0 + lane;
          const bool in = off < a.cap;
          const uint32_t x = (start + off) & mask;
          const int32_t c1 = in ? k1[x] : 0;
          const int32_t c2 = in ? k2[x] : 0;
          const bool hit = in && c1 == h1 && c2 == h2;
          const unsigned stops =
              __ballot_sync(kFull, in && (c1 == kEmpty || hit));
          const unsigned frees =
              __ballot_sync(kFull, in && (c1 == kEmpty || c1 == kTomb));
          if (free_off < 0 && frees)
            free_off = off0 + __ffs(static_cast<int>(frees)) - 1;
          if (stops) {
            const int s = __ffs(static_cast<int>(stops)) - 1;
            found = __shfl_sync(kFull, hit, s);
            if (found) nid = __shfl_sync(kFull, hit ? val[x] : 0, s);
            break;
          }
        }
        if (!found) {
          if (nn < a.n_cap) {
            const uint32_t slot =
                free_off >= 0
                    ? (start + static_cast<uint32_t>(free_off)) & mask
                    : start;
            if (lane == 0) {
              k1[slot] = h1;
              k2[slot] = h2;
              val[slot] = nn;
              l2h[2 * nn] = h1;
              l2h[2 * nn + 1] = h2;
            }
            nid = nn++;
          } else {
            ++nd;
          }
        }
        if (lane == 0) (side ? v : u)[i] = nid;
        __syncwarp();
      }
    }
    if (lane == 0) {
      a.n_nodes[r] = nn;
      a.n_dropped[r] = nd;
    }
  }
  __syncthreads();

  // 3. a change keeps its ids only when both endpoints got one
  for (int i = threadIdx.x; i < a.lanes; i += blockDim.x) {
    if (u[i] < 0 || v[i] < 0) {
      u[i] = -1;
      v[i] = -1;
    }
  }
}

}  // namespace

// Launches one block per row on `stream` without synchronising; returns
// cudaGetLastError(), or cudaErrorInvalidValue for a shape out of range
// (rows, lanes, a capacity that is not a power of two up to 2^30).
extern "C" int intern_launch(int rows, int lanes, unsigned cap, int n_cap,
                             void* k1, void* k2, void* val, void* l2h,
                             void* n_nodes, void* n_dropped, const void* uh,
                             const void* ul, const void* vh, const void* vl,
                             long long row_stride, long long lane_stride,
                             void* u, void* v, void* stream) {
  if (rows < 1 || rows > 65535 || lanes < 1 || lanes > (1 << 29) ||
      n_cap < 1 || cap == 0 || (cap & (cap - 1)) != 0 || cap > (1u << 30))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.k1 = static_cast<int32_t*>(k1);
  a.k2 = static_cast<int32_t*>(k2);
  a.val = static_cast<int32_t*>(val);
  a.l2h = static_cast<int32_t*>(l2h);
  a.n_nodes = static_cast<int32_t*>(n_nodes);
  a.n_dropped = static_cast<int32_t*>(n_dropped);
  a.uh = static_cast<const int32_t*>(uh);
  a.ul = static_cast<const int32_t*>(ul);
  a.vh = static_cast<const int32_t*>(vh);
  a.vl = static_cast<const int32_t*>(vl);
  a.row_stride = row_stride;
  a.lane_stride = lane_stride;
  a.u = static_cast<int32_t*>(u);
  a.v = static_cast<int32_t*>(v);
  a.cap = cap;
  a.n_cap = n_cap;
  a.lanes = lanes;
  intern_kernel<<<rows, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
