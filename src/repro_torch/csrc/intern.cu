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
//
// Why most of that scan is parallel.  An insert only fills an EMPTY or TOMB
// slot, so an entry never moves: a key found at entry keeps its slot and
// value.  Of the keys not found (in a table that interning and deletes
// made, every live key sits behind a chain with no EMPTY slot, so "not
// found" means "absent"), the distinct ones take n_nodes, n_nodes + 1, ...
// in order of first occurrence, the first n_cap - n_nodes of them are
// inserted and every occurrence of a later one is a drop: a dedup, a
// prefix sum and a reduction.  And only the slots need an order: key j of
// rank r goes to the first slot at or after f_j (its chain's first EMPTY
// or TOMB slot in the table at entry) that no key of lower rank took.  A
// key whose f_j no other key shares, and that no other key's walk passes,
// takes f_j at once.
//
// Design: one block of 1,024 threads per row, shared memory for one
// segment of up to kSeg endpoints (2,048 changes: a router chunk; a longer
// row runs its segments in turn, which is the same scan, since a segment's
// pre-lookups against the table its predecessors left find their inserts).
//   1. Every thread takes lanes of the row and walks its find chain
//      against the table at entry; the result goes straight to the output:
//      the id of a pre-found lane, -1 for an invalid one, kNeed for the
//      rest.
//   Then per segment:
//   2. a block scan compacts the segment's kNeed lanes, in lane order, into
//      shared entries (words, lane);
//   3. each entry walks its chain in the table as it stands: a hit (a key
//      an earlier segment inserted) takes its id; else f, the chain's first
//      EMPTY or TOMB slot (kNone: the table has none);
//   4. dedup: a shared open-addressing hash of the keys, whose slot keeps
//      the least entry (atomicMin) = the first occurrence;
//   5. ranks by a block scan of the first-occurrence flags; ids nn + rank
//      below the room, drops counted by a shared atomic;
//   6. groups: the inserted keys' f go into the shared hash (it is cleared
//      first); a key that shares its f with another, or has none, is
//      contended (a bitmap by rank);
//   7. one thread places the contended keys in rank order: from f, the
//      first slot that is free in the table and not the f of an uncontended
//      key of lower rank; passing the f of an uncontended key of higher
//      rank takes it from that key, which becomes contended.  Each place is
//      written to the table at once, so later walks see it, and the next
//      key of the same f walks on from the slot after it (what an earlier
//      key of its f passed stays unavailable).  Random keys leave a few
//      contended keys a segment;
//   8. every entry writes its id, every inserted key its l2h row, every
//      uncontended one its slot at f, in parallel.
//   A table that runs out of free slots (no EMPTY and no TOMB left: the
//   insert goes at the start, over a live key; an intern table holds at
//   most n_cap keys in 4 n_cap slots, so the router never makes one) stops
//   step 7 at the first rank with no slot: the lanes before that key's
//   first occurrence are committed and warp 0 runs the rest of the row in
//   order (JAX's scan, 32 chain slots a round by ballot).
//   9. The block rewrites both ids of a change to -1 where either is -1.
// Table reads are plain loads (never __ldg): the same kernel writes them.
//
// What bounds it: the bytes are small (the bucket words, the ids, a chain
// a lane and 20 B an insert: under 0.25 µs at 3.35 TB/s); the time is a
// fixed number of block-wide steps a segment, and all of a row's random
// loads and stores come from the one SM that holds its block.  At 1,024
// misses a row on an H100 (phase stamps, PERF.md): the pre-lookup about
// 6 µs, the compaction, walk and dedup 8, the ranks and groups 9, the
// walker 3, the writes 8.  Contended keys add one dependent walk each
// (64 keys on one start: 64 µs a call).  A cluster of blocks a row, the
// walks and writes spread over its SMs, is the next step.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int32_t kEmpty = -1;
constexpr int32_t kTomb = -2;
constexpr int32_t kNeed = -2;      // an output lane a segment must resolve
constexpr int kBlock = 1024;
constexpr int kWarps = kBlock / 32;
constexpr int kSeg = 4096;         // endpoints a segment
constexpr int kPer = kSeg / kBlock;  // entries a thread, consecutive
constexpr int kHash = 2 * kSeg;    // shared hash slots (a power of two)
constexpr int32_t kUnused = -1;    // an unused hash slot
constexpr int32_t kMulti = 1 << 30;  // hash entry flag: its f is contended
constexpr uint32_t kNone = 0xFFFFFFFFu;  // no free slot on the chain
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kMaxDevices = 64;

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

// One segment's entries (in lane order), its two hashes (one array, used
// in turn) and the scan scratch: 193 KB, one block an SM.
struct Smem {
  int32_t h1[kSeg];
  int32_t h2[kSeg];
  int32_t lane[kSeg];     // endpoint index j in the row
  uint32_t f[kSeg];       // first EMPTY or TOMB slot of the chain, or kNone
  int32_t rep[kSeg];      // first occurrence's entry; -1: found in the table
  int32_t rank[kSeg];     // a first occurrence's rank among the novel keys
  int32_t id[kSeg];       // the entry's id (or -1)
  int32_t by_rank[kSeg];  // the entry of each inserted rank
  int32_t hash[kHash];    // entry index (| kMulti), or kUnused
  uint32_t resume[kHash]; // step 7: where the next key of that f walks from
  uint32_t contended[kSeg / 32];  // bit r: rank r is placed by step 7
  int32_t warp_sums[kWarps];
  int32_t drops;
  int32_t stop;           // the rank step 7 found no slot for, or n_ins
};

__device__ __forceinline__ uint32_t mix(uint32_t a) {
  a ^= a >> 16;
  a *= 0x85EBCA6Bu;
  a ^= a >> 13;
  a *= 0xC2B2AE35u;
  a ^= a >> 16;
  return a;
}

__device__ __forceinline__ uint32_t key_hash(int32_t a, int32_t b) {
  return mix(static_cast<uint32_t>(a) * 0x9E3779B9u ^
             mix(static_cast<uint32_t>(b))) & (kHash - 1);
}

// Walks up to K find chains side by side, so that their loads overlap:
// chain k (when `live[k]`) from slot x[k] to its key (hit[k], x[k] its
// slot) or the first EMPTY slot, at most cap slots; free[k] gets the
// chain's first EMPTY or TOMB slot (kNone: none).
template <int K>
__device__ __forceinline__ void walk_chains(
    const int32_t* k1, const int32_t* k2, uint32_t mask, uint32_t cap,
    const int32_t (&h1)[K], const int32_t (&h2)[K], bool (&live)[K],
    uint32_t (&x)[K], bool (&hit)[K], uint32_t (&free)[K]) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    hit[k] = false;
    free[k] = kNone;
  }
  for (uint32_t step = 0; step < cap; ++step) {
    int32_t c[K], d[K];
#pragma unroll
    for (int k = 0; k < K; ++k) c[k] = live[k] ? k1[x[k]] : kEmpty;
#pragma unroll
    for (int k = 0; k < K; ++k)
      d[k] = live[k] && c[k] == h1[k] ? k2[x[k]] : ~h2[k];
    bool any = false;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (!live[k]) continue;
      if (free[k] == kNone && (c[k] == kEmpty || c[k] == kTomb))
        free[k] = x[k];
      if (c[k] == kEmpty || (c[k] == h1[k] && d[k] == h2[k])) {
        hit[k] = c[k] != kEmpty;
        live[k] = false;
        continue;
      }
      x[k] = (x[k] + 1u) & mask;
      any = true;
    }
    if (!any) break;
  }
}

__device__ __forceinline__ uint32_t start_of(int32_t h1, int32_t h2,
                                             uint32_t mask) {
  return (static_cast<uint32_t>(h1) ^ static_cast<uint32_t>(h2)) & mask;
}

// Exclusive prefix sum of one value a thread, in thread order; `total` gets
// the block's sum.  Every thread must call it.
__device__ int block_scan(int x, int* warp_sums, int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int inc = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, inc, o);
    if (lane >= o) inc += y;
  }
  if (lane == 31) warp_sums[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    int w = warp_sums[lane];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, w, o);
      if (lane >= o) w += y;
    }
    warp_sums[lane] = w;
  }
  __syncthreads();
  total = warp_sums[kWarps - 1];
  const int before = (warp ? warp_sums[warp - 1] : 0) + inc - x;
  __syncthreads();  // warp_sums is free again
  return before;
}

// The entry of the uncontended key whose f is `x`, or -1 (none, or its f
// is contended); `*where` gets the hash slot that names x, or -1.
__device__ int owner_of(const Smem& s, uint32_t x, int* where) {
  for (uint32_t h = mix(x) & (kHash - 1);; h = (h + 1) & (kHash - 1)) {
    const int32_t c = s.hash[h];
    if (c == kUnused) break;
    const int e = c & (kMulti - 1);
    if (s.f[e] == x) {
      *where = static_cast<int>(h);
      return (c & kMulti) ? -1 : e;
    }
  }
  *where = -1;
  return -1;
}

// The least set bit of the bitmap at or after `r`, or -1.
__device__ int next_rank(const uint32_t* bits, int r, int n) {
  if (r >= n) return -1;
  int w = r >> 5;
  uint32_t word = bits[w] & (kFull << (r & 31));
  const int words = (n + 31) >> 5;
  while (!word) {
    if (++w >= words) return -1;
    word = bits[w];
  }
  const int got = (w << 5) + __ffs(static_cast<int>(word)) - 1;
  return got < n ? got : -1;
}

__global__ void __launch_bounds__(kBlock) intern_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& s = *reinterpret_cast<Smem*>(smem_raw);
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
  const int t = threadIdx.x;

  // 1. the pre-lookup against the table at entry, kPer lanes a thread at
  // once (lanes j, j + kBlock, ...)
  for (int j0 = t; j0 < n_lanes; j0 += kPer * kBlock) {
    int32_t h1[kPer], h2[kPer];
    bool live[kPer], hit[kPer];
    uint32_t x[kPer], free[kPer];
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int j = j0 + k * kBlock;
      live[k] = false;
      if (j >= n_lanes) continue;
      const long long w = row + (j >> 1) * a.lane_stride;
      live[k] = a.uh[w] >= 0 && a.vh[w] >= 0;
      h1[k] = (j & 1) ? a.vh[w] : a.uh[w];
      h2[k] = (j & 1) ? a.vl[w] : a.ul[w];
      x[k] = start_of(h1[k], h2[k], mask);
    }
    bool valid[kPer];
#pragma unroll
    for (int k = 0; k < kPer; ++k) valid[k] = live[k];
    walk_chains<kPer>(k1, k2, mask, a.cap, h1, h2, live, x, hit, free);
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int j = j0 + k * kBlock;
      if (j < n_lanes)
        ((j & 1) ? v : u)[j >> 1] =
            hit[k] ? val[x[k]] : valid[k] ? kNeed : -1;
    }
  }
  int32_t nn = a.n_nodes[r];  // every thread keeps both counters
  int32_t nd = a.n_dropped[r];
  int serial_from = n_lanes;  // where warp 0 takes over (a full table)
  __syncthreads();

  for (int j0 = 0; j0 < n_lanes; j0 += kSeg) {
    // 2. compact the segment's kNeed lanes, in lane order
    int need = 0;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int j = j0 + kPer * t + k;
      need += j < n_lanes && ((j & 1) ? v : u)[j >> 1] == kNeed;
    }
    int n;
    int at = block_scan(need, s.warp_sums, n);
    if (n == 0) continue;  // uniform: every thread got the same n
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int j = j0 + kPer * t + k;
      if (j < n_lanes && ((j & 1) ? v : u)[j >> 1] == kNeed) {
        const long long w = row + (j >> 1) * a.lane_stride;
        s.h1[at] = (j & 1) ? a.vh[w] : a.uh[w];
        s.h2[at] = (j & 1) ? a.vl[w] : a.ul[w];
        s.lane[at] = j;
        ++at;
      }
    }
    for (int h = t; h < kHash; h += kBlock) s.hash[h] = kUnused;
    for (int w = t; w < kSeg / 32; w += kBlock) s.contended[w] = 0;
    if (t == 0) s.drops = 0;
    __syncthreads();

    // 3. the chain in the table as it stands; 4. dedup
    int slot[kPer];
    {
      int32_t h1[kPer], h2[kPer];
      bool live[kPer], hit[kPer];
      uint32_t x[kPer], free[kPer];
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const int e = kPer * t + k;
        live[k] = e < n;
        h1[k] = live[k] ? s.h1[e] : 0;
        h2[k] = live[k] ? s.h2[e] : 0;
        x[k] = start_of(h1[k], h2[k], mask);
      }
      walk_chains<kPer>(k1, k2, mask, a.cap, h1, h2, live, x, hit, free);
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const int e = kPer * t + k;
        slot[k] = -1;
        if (e >= n) continue;
        s.f[e] = free[k];
        s.rep[e] = -1;
        if (hit[k]) {
          s.id[e] = val[x[k]];
          continue;
        }
        for (uint32_t h = key_hash(h1[k], h2[k]);; h = (h + 1) & (kHash - 1)) {
          const int32_t c = atomicCAS(&s.hash[h], kUnused, e);
          if (c == kUnused) {
            slot[k] = static_cast<int>(h);
            break;
          }
          if (s.h1[c] == h1[k] && s.h2[c] == h2[k]) {
            atomicMin(&s.hash[h], e);
            slot[k] = static_cast<int>(h);
            break;
          }
        }
      }
    }
    __syncthreads();
    int first = 0;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int e = kPer * t + k;
      if (slot[k] >= 0) {
        s.rep[e] = s.hash[slot[k]];
        first += s.rep[e] == e;
      }
    }

    // 5. ranks, ids and drops
    int n_novel;
    int rk = block_scan(first, s.warp_sums, n_novel);
    const int room = a.n_cap > nn ? a.n_cap - nn : 0;
    const int n_ins = n_novel < room ? n_novel : room;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int e = kPer * t + k;
      if (slot[k] >= 0 && s.rep[e] == e) {
        s.rank[e] = rk;
        if (rk < n_ins) s.by_rank[rk] = e;
        ++rk;
      }
    }
    for (int h = t; h < kHash; h += kBlock) s.hash[h] = kUnused;
    __syncthreads();
    int drops = 0;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int e = kPer * t + k;
      if (slot[k] < 0) continue;
      const int q = s.rank[s.rep[e]];
      s.id[e] = q < n_ins ? nn + q : -1;
      drops += q >= n_ins;
      slot[k] = -1;
      // 6. an inserted key's f into the hash (every occurrence reads its
      // first's result, so only first occurrences go in)
      if (s.rep[e] != e || q >= n_ins) continue;
      const uint32_t x = s.f[e];
      if (x == kNone) {
        atomicOr(&s.contended[q >> 5], 1u << (q & 31));
        continue;
      }
      for (uint32_t h = mix(x) & (kHash - 1);; h = (h + 1) & (kHash - 1)) {
        const int32_t c = atomicCAS(&s.hash[h], kUnused, e);
        if (c == kUnused) {
          s.resume[h] = x;
          slot[k] = static_cast<int>(h);
          break;
        }
        if (s.f[c & (kMulti - 1)] == x) {
          atomicOr(&s.hash[h], kMulti);
          slot[k] = static_cast<int>(h);
          break;
        }
      }
    }
    if (drops) atomicAdd(&s.drops, drops);
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int e = kPer * t + k;
      if (slot[k] >= 0 && (s.hash[slot[k]] & kMulti)) {
        const int q = s.rank[e];
        atomicOr(&s.contended[q >> 5], 1u << (q & 31));
      }
    }
    __syncthreads();

    // 7. the contended keys, in rank order, by one thread
    if (t == 0) {
      int stop = n_ins;
      for (int q = next_rank(s.contended, 0, n_ins); q >= 0;
           q = next_rank(s.contended, q + 1, n_ins)) {
        const int e = s.by_rank[q];
        const int32_t h1 = s.h1[e], h2 = s.h2[e];
        uint32_t x = s.f[e];
        bool placed = false;
        if (x != kNone) {
          // the keys of one f come here in rank order, and a slot an
          // earlier one passed or took stays unavailable: resume there
          int mine;
          owner_of(s, x, &mine);
          x = s.resume[mine];
          for (uint32_t step = 0; step < a.cap; ++step) {
            const int32_t c = k1[x];
            if (c == kEmpty || c == kTomb) {
              int where;
              const int o = owner_of(s, x, &where);
              if (o < 0 || s.rank[o] > q) {
                if (o >= 0) {  // x was o's: o now walks after q
                  s.hash[where] |= kMulti;
                  s.contended[s.rank[o] >> 5] |= 1u << (s.rank[o] & 31);
                }
                k1[x] = h1;
                k2[x] = h2;
                val[x] = nn + q;
                s.resume[mine] = (x + 1u) & mask;
                placed = true;
                break;
              }
            }
            x = (x + 1u) & mask;
          }
        }
        if (!placed) {
          stop = q;
          break;
        }
      }
      s.stop = stop;
    }
    __syncthreads();

    // 8. ids, l2h and the uncontended slots
    const int stop = s.stop;
    const int cut = stop < n_ins ? s.lane[s.by_rank[stop]] : n_lanes;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int e = kPer * t + k;
      if (e >= n) continue;
      const int j = s.lane[e];
      if (j < cut) ((j & 1) ? v : u)[j >> 1] = s.id[e];
      if (s.rep[e] != e) continue;
      const int q = s.rank[e];
      if (q >= stop) continue;
      const int32_t h1 = s.h1[e], h2 = s.h2[e];
      l2h[2 * (nn + q)] = h1;
      l2h[2 * (nn + q) + 1] = h2;
      if (!(s.contended[q >> 5] & (1u << (q & 31)))) {
        const uint32_t x = s.f[e];
        k1[x] = h1;
        k2[x] = h2;
        val[x] = nn + q;
      }
    }
    nn += stop;
    if (stop < n_ins) {  // out of free slots: warp 0 goes on from `cut`
      serial_from = cut;
      __syncthreads();
      break;
    }
    nd += s.drops;
    __syncthreads();
  }

  // the rest of the row in order, for a table with no free slot left
  if (serial_from < n_lanes && t < 32) {
    const uint32_t lane = t;
    for (int base = serial_from & ~31; base < n_lanes; base += 32) {
      const int j = base + static_cast<int>(lane);
      const int32_t code =
          j >= serial_from && j < n_lanes ? ((j & 1) ? v : u)[j >> 1] : -1;
      unsigned need = __ballot_sync(kFull, code == kNeed);
      while (need) {
        const int jj = base + __ffs(static_cast<int>(need)) - 1;
        need &= need - 1u;
        const int i = jj >> 1, side = jj & 1;
        const long long w = row + i * a.lane_stride;
        const int32_t h1 = side ? a.vh[w] : a.uh[w];
        const int32_t h2 = side ? a.vl[w] : a.ul[w];
        const uint32_t start = start_of(h1, h2, mask);
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
            const int sl = __ffs(static_cast<int>(stops)) - 1;
            found = __shfl_sync(kFull, hit, sl);
            if (found) nid = __shfl_sync(kFull, hit ? val[x] : 0, sl);
            break;
          }
        }
        if (!found) {
          if (nn < a.n_cap) {
            const uint32_t at =
                free_off >= 0
                    ? (start + static_cast<uint32_t>(free_off)) & mask
                    : start;
            if (lane == 0) {
              k1[at] = h1;
              k2[at] = h2;
              val[at] = nn;
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
  }
  __syncthreads();
  if (t == 0) {
    a.n_nodes[r] = nn;
    a.n_dropped[r] = nd;
  }

  // 9. a change keeps its ids only when both endpoints got one
  for (int i = t; i < a.lanes; i += kBlock) {
    if (u[i] < 0 || v[i] < 0) {
      u[i] = -1;
      v[i] = -1;
    }
  }
}

}  // namespace

// Launches one block per row on `device` and `stream` without
// synchronising (the calling thread's current device is restored); returns
// cudaGetLastError(), or cudaErrorInvalidValue for a shape out of range
// (rows, lanes, a capacity that is not a power of two up to 2^30).
extern "C" int intern_launch(int device, int rows, int lanes, unsigned cap,
                             int n_cap, void* k1, void* k2, void* val,
                             void* l2h, void* n_nodes, void* n_dropped,
                             const void* uh, const void* ul, const void* vh,
                             const void* vl, long long row_stride,
                             long long lane_stride, void* u, void* v,
                             void* stream) {
  if (rows < 1 || rows > 65535 || lanes < 1 || lanes > (1 << 29) ||
      n_cap < 1 || cap == 0 || (cap & (cap - 1)) != 0 || cap > (1u << 30) ||
      device < 0 || device >= kMaxDevices)
    return static_cast<int>(cudaErrorInvalidValue);
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  static bool configured[kMaxDevices] = {};
  if (!configured[device]) {
    err = cudaFuncSetAttribute(intern_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(sizeof(Smem)));
    if (err == cudaSuccess) configured[device] = true;
  }
  if (err == cudaSuccess) {
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
    intern_kernel<<<rows, kBlock, sizeof(Smem),
                    static_cast<cudaStream_t>(stream)>>>(a);
    err = cudaGetLastError();
  }
  if (prev != device) cudaSetDevice(prev);
  return static_cast<int>(err);
}
