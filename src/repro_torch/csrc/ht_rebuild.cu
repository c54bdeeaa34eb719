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
// own, by one thread, in the fold's order: ascending old slot, which for the
// run that wraps past slot cap - 1 means its low slots [0, ...) first.
//
// One thread per slot.  An EMPTY slot stays EMPTY (every new key lies inside
// an old run), so its thread writes it so.  The thread of a run's first slot
// writes EMPTY over the run's slots, then walks its live entries: each key's
// home (the fmix32 of ht_probe.cu, or k1 ^ k2 when prehashed), checked to
// lie in [run start, its slot] (else the status word gets kBroken and the
// wrapper raises: the table was not made by this hashtable's operations),
// then the fold's walk.  A run's slots are read and written by its thread
// alone, so no atomics and no ordering between threads are needed.  A table
// with no EMPTY slot is one run: the thread of slot 0 takes all of it.
//
// What bounds it: the least traffic is a read of k1 (4 B a slot), of the
// k2/val sectors that hold a live key, and a write of 12 B a slot; at 70%
// load about 24 B a slot, 0.24 ms for 2^25 slots at the H100's 3.35 TB/s.
// But a run's inserts are a chain of dependent reads: each walks from its
// home to the first EMPTY slot behind the keys already placed, so a run of
// R slots costs its thread up to about R^2 / 2 loads, mostly from L1/L2,
// and the longest run sets the kernel's time (PERF.md has the measured
// ones).  Making it faster (a bitmap of the run's free slots in registers,
// or a warp per long run) is later work.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int32_t kEmpty = -1;
constexpr int kBlock = 256;
constexpr unsigned kBroken = 1;  // a live key with an EMPTY in [home, slot]

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

__global__ void __launch_bounds__(kBlock)
ht_rebuild_kernel(const int32_t* __restrict__ k1,
                  const int32_t* __restrict__ k2,
                  const int32_t* __restrict__ val, uint32_t cap,
                  bool prehashed, int32_t* nk1, int32_t* nk2, int32_t* nval,
                  unsigned* status) {
  const uint32_t s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= cap) return;
  const uint32_t mask = cap - 1;
  if (k1[s] == kEmpty) {
    nk1[s] = kEmpty;
    nk2[s] = kEmpty;
    nval[s] = 0;
    return;
  }
  bool full = false;
  if (k1[(s - 1) & mask] != kEmpty) {  // not the first slot of its run...
    if (s != 0) return;
    for (uint32_t t = mask; t != 0; --t)  // ...unless no slot is EMPTY
      if (k1[t] == kEmpty) return;
    full = true;
  }
  uint32_t len = cap;
  if (!full)
    for (len = 1; k1[(s + len) & mask] != kEmpty; ++len) {
    }
  for (uint32_t i = 0; i < len; ++i) {
    const uint32_t x = (s + i) & mask;
    nk1[x] = kEmpty;
    nk2[x] = kEmpty;
    nval[x] = 0;
  }
  // offsets [split, len) are the low slots of a run that wraps past
  // cap - 1: the fold reaches them first
  const uint32_t split = s + len > cap ? cap - s : len;
  for (int pass = 0; pass < 2; ++pass) {
    const uint32_t lo = pass == 0 ? split : 0;
    const uint32_t hi = pass == 0 ? len : split;
    for (uint32_t i = lo; i < hi; ++i) {
      const uint32_t p = (s + i) & mask;
      const int32_t a = k1[p];
      if (a < 0) continue;  // a tombstone
      const int32_t b = k2[p];
      uint32_t x = probe_start(static_cast<uint32_t>(a),
                               static_cast<uint32_t>(b), mask, prehashed);
      if (!full && ((x - s) & mask) > i) {
        atomicOr(status, kBroken);
        return;
      }
      // the fold's walk; it stays inside the run (see above)
      for (uint32_t step = 0; step < cap; ++step) {
        const int32_t c = nk1[x];
        if (c == kEmpty || (c == a && nk2[x] == b)) break;
        x = (x + 1) & mask;
      }
      nk1[x] = a;
      nk2[x] = b;
      nval[x] = val[p];
    }
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
  const unsigned blocks = (cap + kBlock - 1) / kBlock;
  ht_rebuild_kernel<<<blocks, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(k1), static_cast<const int32_t*>(k2),
      static_cast<const int32_t*>(val), cap, prehashed != 0,
      static_cast<int32_t*>(nk1), static_cast<int32_t*>(nk2),
      static_cast<int32_t*>(nval), static_cast<unsigned*>(status));
  return static_cast<int>(cudaGetLastError());
}
