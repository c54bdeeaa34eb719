// Hash-table compaction for Hopper (sm_90a): ht_rebuild in one kernel.
//
// Replaces the JAX package's src/repro/core/engine/hashtable.py::ht_rebuild,
// a sequential lax.fori_loop of ht_set over the old slots (XLA; not a Pallas
// kernel).  The fold inserts every live entry (k1 >= 0) of the old table, in
// ascending order of its old slot, into a fresh table at the first slot from
// its home that is EMPTY or holds the same key (a fresh table has no
// tombstones, so that is exactly ht_set's upsert slot).  The layout depends
// on the insert order, so the contract is bitwise.
//
// Why the old table's runs are independent.  Call a run a maximal stretch of
// slots that are not EMPTY (live or TOMB).  Every table that ht_set,
// ht_delete and the probe kernel's upsert make keeps each live key at a slot
// p with no EMPTY slot in [home, p]: an insert takes a slot no later than
// the first EMPTY from home, and a slot never turns EMPTY again (a delete
// leaves TOMB).  So a run's keys are homed inside it, and of the keys homed
// in [y, e] (e the run's last slot) every one sits in [y, e]: there are no
// more of them than slots.  Linear probing without deletions then places
// them all inside [y, e] in the new table too, whatever the order, so no
// key of one run reaches another run's slots.  Each run is replayed on its
// own in the fold's order: ascending old slot, which for the run that wraps
// past slot cap - 1 means its low slots [0, ...) first.
//
// Design: tiles.  Block b takes the kTile slots from t0 = b * kTile and
// loads their k1, the slot before them and a halo of kHalo slots after
// them into shared memory with coalesced reads, and in the same pass the
// k2 and val of the live slots and each live key's home (the fmix32 of
// ht_probe.cu, or k1 ^ k2 when prehashed), a thread's loads in flight
// together.  A run belongs to the tile that holds its first slot, so a
// tile writes the slots from its first EMPTY or run start up to its last
// run's end (into the halo when that run crosses the tile's end); the run
// that crosses into it from the previous tile is the previous tile's.
// Then:
//   * the tile's run starts are listed (a warp's by one ballot);
//   * a run of up to 32 slots is replayed by one thread, a longer one by a
//     warp, in the fold's order: each key's home is checked to lie in
//     [run start, its slot] (else the status word gets kBroken and the
//     wrapper raises: the table was not made by this hashtable's
//     operations), and the key takes the first free offset at or after its
//     home's in a bitmap of the run's taken offsets: a register of the
//     thread; words in the warp's registers, the first free bit found by
//     a ballot.  Keys of
//     a table are distinct, so "its own key" never stops the walk.  No
//     placement reads device memory; the new slot records the old window
//     position it takes;
//   * the owned slots are written out, coalesced: EMPTY where nothing was
//     placed, else the recorded entry's k1, k2 and val.
// A table of at most kTile slots is one tile whose window is the whole
// table, read cyclically.  Two cases take a slow path through device
// memory, which is right but walks as the first design did: a run that
// starts in a tile and does not end inside its halo (a crafted table; at
// 70% load the longest run is about 200 slots), replayed with walks in the
// new table, and a table with no EMPTY slot, which is one run from slot 0
// (tile 0 finds it so); warp 0 of the owner takes either, 32 slots of a
// walk a round.
//
// What bounds it: the least traffic is a read of k1 (4 B a slot), of the
// k2/val sectors that hold a live key, and a write of 12 B a slot; at 70%
// load about 24 B a slot, 0.24 ms for 2^25 slots at the H100's 3.35 TB/s.
// The kernel reads k1 once more for each halo (kHalo / kTile) and takes
// about 3.4x the bound (PERF.md): a block's time is a chain of latencies
// (the loads, the run list, the replay, the writes, about 29 µs), and the
// replay is a serial chain a run, so the longest runs of a tile (a thread
// a short run, a warp a long one) set it; 5 blocks an SM (41,752 B of
// shared memory each) do not hide it.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int32_t kEmpty = -1;
constexpr int kBlock = 256;
constexpr int kTile = 2048;               // slots a block owns
constexpr int kHalo = 256;                // slots it reads past them
constexpr int kWin = kTile + kHalo;       // window positions 0 .. kWin - 1
// a warp's register planes of 1,024 offsets: enough for any run inside a
// window, or inside a one-tile table
constexpr int kPlanes = (kWin + 1023) / 1024;
constexpr int kLong = kTile / 33 + 1;     // most runs over 32 slots a tile
constexpr int kWarps = kBlock / 32;
constexpr unsigned kBroken = 1;  // a live key with an EMPTY in [home, slot]
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kNoPos = 0x7FFFFFFF;
constexpr int16_t kDead = -2;             // home[] of a tombstone

__device__ __forceinline__ uint32_t probe_start(uint32_t a, uint32_t b,
                                                uint32_t mask,
                                                bool prehashed) {
  if (prehashed) return (a ^ b) & mask;
  uint32_t h = a * 0x85EBCA6Bu;
  h ^= h >> 13;
  h += b * 0xC2B2AE35u;
  h ^= h >> 16;
  h *= 0x27D4EB2Fu;
  h ^= h >> 15;
  return h & mask;
}

struct Smem {
  int32_t k1[kWin + 1];   // window position p at index p + 1 (p >= -1)
  int32_t k2[kWin];
  int32_t val[kWin];
  int16_t home[kWin];     // a live key's home position (-1: outside the
                          // window), kDead at a tombstone
  int16_t src[kWin];      // the old position a new slot takes, or -1
  int16_t run[kTile];     // the tile's run starts, in no order
  int16_t long_at[kLong], long_len[kLong];  // its runs over 32 slots
  int lo, last_empty, end, full, runs, longs;  // see the kernel
};

// The slow path, for one run of `len` slots from slot s (len == cap: the
// table has no EMPTY slot), by one warp (every lane calls it): the run's
// slots cleared, then every live key in the fold's order at the first
// EMPTY slot from its home in the new table, 32 slots a round by ballot.
__device__ void replay_in_memory(const int32_t* k1, const int32_t* k2,
                                 const int32_t* val, uint32_t cap,
                                 bool prehashed, uint32_t s, uint32_t len,
                                 int32_t* nk1, int32_t* nk2, int32_t* nval,
                                 unsigned* status) {
  const uint32_t mask = cap - 1;
  const uint32_t lane = threadIdx.x & 31;
  const bool full = len == cap;
  for (uint32_t i = lane; i < len; i += 32) {
    const uint32_t x = (s + i) & mask;
    nk1[x] = kEmpty;
    nk2[x] = kEmpty;
    nval[x] = 0;
  }
  __syncwarp();
  const uint32_t split = s + len > cap ? cap - s : len;
  for (int pass = 0; pass < 2; ++pass) {
    const uint32_t lo = pass == 0 ? split : 0;
    const uint32_t hi = pass == 0 ? len : split;
    for (uint32_t i = lo; i < hi; ++i) {
      const uint32_t p = (s + i) & mask;
      const int32_t a = k1[p];
      if (a < 0) continue;  // a tombstone
      const int32_t b = k2[p];
      const uint32_t home = probe_start(static_cast<uint32_t>(a),
                                        static_cast<uint32_t>(b), mask,
                                        prehashed);
      if (!full && ((home - s) & mask) > i) {
        if (lane == 0) atomicOr(status, kBroken);
        return;
      }
      uint32_t x = home;
      for (uint32_t off0 = 0; off0 < cap; off0 += 32) {
        const uint32_t y = (home + off0 + lane) & mask;
        const int32_t c = off0 + lane < cap ? nk1[y] : a;
        const unsigned stop = __ballot_sync(
            kFull, off0 + lane < cap &&
                       (c == kEmpty || (c == a && nk2[y] == b)));
        if (stop) {
          x = (home + off0 + __ffs(static_cast<int>(stop)) - 1) & mask;
          break;
        }
      }
      if (lane == 0) {
        nk1[x] = a;
        nk2[x] = b;
        nval[x] = val[p];
      }
      __syncwarp();
    }
  }
}

// Replays a run of up to 32 slots at window position p (table slot s =
// t0 + p) by one thread, its taken offsets a register; positions are taken
// mod `wmask` + 1 (the window, or the whole table for a one-tile table).
__device__ void replay_run(Smem& sm, int p, int len, uint32_t s,
                           uint32_t cap, int wmask, unsigned* status) {
  const int split = s + len > cap ? static_cast<int>(cap - s) : len;
  const uint32_t in_run = len == 32 ? kFull : (1u << len) - 1u;
  uint32_t taken = 0;
  for (int n = 0; n < len; ++n) {
    // the fold's order: the offsets past the wrap [split, len) first
    const int i = n < len - split ? split + n : n - (len - split);
    const int wp = (p + i) & wmask;
    const int at = sm.home[wp];
    if (at == kDead) continue;
    const int h = at < 0 ? -1 : (at - p) & wmask;
    if (h < 0 || h > i) {
      atomicOr(status, kBroken);
      return;
    }
    const int o =
        __ffs(static_cast<int>(~taken & in_run & (kFull << h))) - 1;
    taken |= 1u << o;
    sm.src[(p + o) & wmask] = static_cast<int16_t>(wp);
  }
}

// Replays a run of more than 32 slots (window position p, table slot s)
// with the whole warp (every lane calls it): the slots' tombstone flags
// and homes read 32 at a time, then each live key in the fold's order
// takes the first untaken offset at or after its home's, found by a
// ballot over the run's taken offsets, kept in registers: offset
// 1,024 k + 32 lane + b is bit b of the lane's word k.
__device__ void replay_run_warp(Smem& sm, int p, int len, uint32_t s,
                                uint32_t cap, int wmask, unsigned* status) {
  const int lane = threadIdx.x & 31;
  const int split = s + len > cap ? static_cast<int>(cap - s) : len;
  uint32_t mine[kPlanes] = {};
  for (int n0 = 0; n0 < len; n0 += 32) {
    const int n = n0 + lane;
    int i = 0, wp = 0, h = 0;
    bool live = false;
    if (n < len) {
      i = n < len - split ? split + n : n - (len - split);
      wp = (p + i) & wmask;
      const int at = sm.home[wp];
      live = at != kDead;
      h = at < 0 ? -1 : (at - p) & wmask;
    }
    if (__ballot_sync(kFull, live && (h < 0 || h > i))) {
      if (lane == 0) atomicOr(status, kBroken);
      return;
    }
    const int packed = h << 16 | wp;  // both below 2^15
    // the live keys of these 32 slots, in the fold's order
    for (unsigned todo = __ballot_sync(kFull, live); todo;
         todo &= todo - 1u) {
      const int got = __shfl_sync(kFull, packed,
                                  __ffs(static_cast<int>(todo)) - 1);
      const int hk = got >> 16, hw = hk >> 5, src = got & 0xFFFF;
      int o = -1;
#pragma unroll
      for (int k = 0; k < kPlanes; ++k) {
        if (o >= 0) break;  // the same for every lane
        const int w = 32 * k + lane;
        const uint32_t free_bits =
            w < hw ? 0u : ~mine[k] & (w == hw ? kFull << (hk & 31) : kFull);
        const unsigned any = __ballot_sync(kFull, free_bits != 0);
        if (any) {
          const int f = __ffs(static_cast<int>(any)) - 1;
          o = ((32 * k + f) << 5) +
              __ffs(static_cast<int>(__shfl_sync(kFull, free_bits, f))) - 1;
          if (lane == f) mine[k] |= 1u << (o & 31);
        }
      }
      if (lane == 0) sm.src[(p + o) & wmask] = static_cast<int16_t>(src);
    }
  }
}

__global__ void __launch_bounds__(kBlock, 5)
ht_rebuild_kernel(const int32_t* __restrict__ k1,
                  const int32_t* __restrict__ k2,
                  const int32_t* __restrict__ val, uint32_t cap,
                  bool prehashed, int32_t* nk1, int32_t* nk2, int32_t* nval,
                  unsigned* status) {
  __shared__ Smem sm;
  const uint32_t mask = cap - 1;
  const int t = threadIdx.x;
  const bool one = cap <= kTile;  // one tile, the window the whole table
  const int tile = one ? static_cast<int>(cap) : kTile;
  const int win = one ? static_cast<int>(cap) : kWin;
  const int wmask = one ? static_cast<int>(mask) : 0x7FFFFFFF;
  const uint32_t t0 = blockIdx.x * static_cast<uint32_t>(kTile);

  // the window's k1, then k2, val and the home of its live slots: a
  // thread's loads all in flight at once, no barrier between the two
  constexpr int kLoads = (kWin + kBlock) / kBlock;
  int32_t c[kLoads];
#pragma unroll
  for (int n = 0; n < kLoads; ++n) {
    const int p = t - 1 + n * kBlock;
    c[n] = p < win ? k1[(t0 + p) & mask] : kEmpty;
  }
  int32_t b[kLoads], w[kLoads];
#pragma unroll
  for (int n = 0; n < kLoads; ++n) {
    const int p = t - 1 + n * kBlock;
    const bool live = p >= 0 && p < win && c[n] >= 0;
    b[n] = live ? k2[(t0 + p) & mask] : 0;
    w[n] = live ? val[(t0 + p) & mask] : 0;
  }
  bool filled = false;  // a slot of the tile is not EMPTY
#pragma unroll
  for (int n = 0; n < kLoads; ++n) {
    const int p = t - 1 + n * kBlock;
    if (p >= win) continue;
    sm.k1[p + 1] = c[n];
    if (p < 0 || c[n] == kEmpty) continue;
    filled |= p < tile;
    if (c[n] < 0) {
      sm.home[p] = kDead;
      continue;
    }
    sm.k2[p] = b[n];
    sm.val[p] = w[n];
    const uint32_t at = (probe_start(static_cast<uint32_t>(c[n]),
                                     static_cast<uint32_t>(b[n]), mask,
                                     prehashed) - t0) & mask;
    sm.home[p] = at < static_cast<uint32_t>(win) ? static_cast<int16_t>(at)
                                                 : int16_t{-1};
  }
  if (t == 0) {
    sm.lo = tile;
    sm.last_empty = -2;
    sm.end = kNoPos;
    sm.full = 0;
    sm.runs = 0;
    sm.longs = 0;
  }
  if (!__syncthreads_or(filled)) {
    // no run starts or ends in the tile (a sparse table's usual tile): it
    // owns its slots, all EMPTY in the new table too
    for (int p = t; p < tile; p += kBlock) {
      const uint32_t x = t0 + p;
      nk1[x] = kEmpty;
      nk2[x] = kEmpty;
      nval[x] = 0;
    }
    return;
  }

  // lo: the tile's first EMPTY slot or run start (before it lies the end
  // of the previous tile's run); last_empty: the tile's last EMPTY slot,
  // from position -1 (-2: none); end: the halo's first EMPTY slot.  A warp
  // takes 32 consecutive positions and one lane makes the shared atomics
  // (one word each: per slot they would serialise)
  const int lane = t & 31;
  for (int base = (t & ~31) - 1; base < win; base += kBlock) {
    const int p = base + lane;
    const bool empty = p < win && sm.k1[p + 1] == kEmpty;
    const int prev = one ? (p - 1) & wmask : p - 1;
    const unsigned starts = __ballot_sync(
        kFull, p >= 0 && p < tile && (empty || sm.k1[prev + 1] == kEmpty));
    const unsigned in_tile = __ballot_sync(kFull, empty && p < tile);
    const unsigned in_halo = __ballot_sync(kFull, empty && p >= tile);
    if (lane == 0) {
      if (starts)
        atomicMin(&sm.lo, base + __ffs(static_cast<int>(starts)) - 1);
      if (in_tile) atomicMax(&sm.last_empty, base + 31 - __clz(in_tile));
      if (in_halo)
        atomicMin(&sm.end, base + __ffs(static_cast<int>(in_halo)) - 1);
    }
  }
  __syncthreads();
  const int last_empty = sm.last_empty;
  int lo = one ? 0 : sm.lo, hi = tile;
  bool long_run = false;  // the tile's last run ends past the halo
  if (!one && sm.k1[tile] != kEmpty && last_empty > -2) {
    // the run through the tile's last slot starts in the tile
    if (sm.end != kNoPos) {
      hi = sm.end;
    } else {
      hi = last_empty + 1;
      long_run = true;
    }
  }
  // no EMPTY slot in the window: the table may have none at all (one run
  // from slot 0); tile 0 of a larger table looks through the rest of it
  bool full = false;
  if (last_empty == -2 && sm.end == kNoPos && (one || blockIdx.x == 0)) {
    if (t == 0) {
      int found = 0;
      for (uint32_t x = win; x + 1 < cap && !found; ++x)
        found = k1[x] == kEmpty;
      sm.full = !found;
    }
    __syncthreads();
    full = sm.full;
    if (full) lo = hi = tile;  // warp 0 walks it in device memory
  }

  // the run starts the tile owns, listed (a warp's at once), and the new
  // slots it owns cleared
  const int run_end = long_run ? hi : tile;  // the long run: the walk's
  for (int base = lo + (t & ~31); base < hi; base += kBlock) {
    const int p = base + lane;
    const int prev = one ? (p - 1) & wmask : p - 1;
    const bool start = p < run_end && sm.k1[p + 1] != kEmpty &&
                       sm.k1[prev + 1] == kEmpty;
    if (p < hi) sm.src[p] = -1;
    const unsigned got = __ballot_sync(kFull, start);
    int at = 0;
    if (lane == 0 && got) at = atomicAdd(&sm.runs, __popc(got));
    at = __shfl_sync(kFull, at, 0);
    if (start)
      sm.run[at + __popc(got & ((1u << lane) - 1u))] =
          static_cast<int16_t>(p);
  }
  __syncthreads();

  // a run of up to 32 slots a thread, the runs dealt out in turn; then a
  // longer one a warp
  if (!full) {
    for (int r = t; r < sm.runs; r += kBlock) {
      const int p = sm.run[r];
      int len = 1;
      while (len < win && sm.k1[((p + len) & wmask) + 1] != kEmpty) ++len;
      if (len <= 32) {
        replay_run(sm, p, len, (t0 + p) & mask, cap, wmask, status);
      } else {
        const int at = atomicAdd(&sm.longs, 1);
        sm.long_at[at] = static_cast<int16_t>(p);
        sm.long_len[at] = static_cast<int16_t>(len);
      }
    }
    __syncthreads();
    for (int r = t >> 5; r < sm.longs; r += kWarps) {
      const int p = sm.long_at[r];
      replay_run_warp(sm, p, sm.long_len[r], (t0 + p) & mask, cap, wmask,
                      status);
    }
  }
  if (t < 32 && (long_run || full)) {
    const uint32_t s0 = full ? 0 : (t0 + hi) & mask;
    uint32_t len = full ? cap : win - hi;
    if (!full)
      while (k1[(s0 + len) & mask] != kEmpty) ++len;
    replay_in_memory(k1, k2, val, cap, prehashed, s0, len, nk1, nk2, nval,
                     status);
  }
  __syncthreads();

  // the owned slots, written out
  for (int p = lo + t; p < hi; p += kBlock) {
    const uint32_t x = (t0 + p) & mask;
    const int q = sm.src[p];
    nk1[x] = q < 0 ? kEmpty : sm.k1[q + 1];
    nk2[x] = q < 0 ? kEmpty : sm.k2[q];
    nval[x] = q < 0 ? 0 : sm.val[q];
  }
}

}  // namespace

// Launches on `stream` without synchronising; returns cudaGetLastError()
// (cudaErrorInvalidValue for a capacity that is not a power of two up to
// 2^30).  `status` (one unsigned, zeroed by the caller) gets kBroken when a
// live key's chain from its home holds an EMPTY slot.
extern "C" int ht_rebuild_launch(const void* k1, const void* k2,
                                 const void* val, unsigned cap,
                                 int prehashed, void* nk1, void* nk2,
                                 void* nval, void* status, void* stream) {
  if (cap == 0 || (cap & (cap - 1)) != 0 || cap > (1u << 30))
    return cudaErrorInvalidValue;
  const unsigned blocks = cap <= kTile ? 1 : cap / kTile;
  ht_rebuild_kernel<<<blocks, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(k1), static_cast<const int32_t*>(k2),
      static_cast<const int32_t*>(val), cap, prehashed != 0,
      static_cast<int32_t*>(nk1), static_cast<int32_t*>(nk2),
      static_cast<int32_t*>(nval), static_cast<unsigned*>(status));
  return static_cast<int>(cudaGetLastError());
}
