// Batched open-addressing hash-table probe for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/ht_probe.py::_probe_kernel
// (wrapper ht_probe_batch).  For each lane it walks one linear-probe chain
// from the fmix32 start slot of its key (k1 ^ k2 when prehashed), masked by
// cap - 1:
//   pass 1 (both modes): stop at the key or at EMPTY (-1);
//   pass 2 (insert mode, only when the key is absent): stop at the first
//          EMPTY or TOMB (-2);
// every chain ends within cap steps.  It writes the slot, the found flag
// and val[slot1], the value at the key's find-chain end.  The contract is
// bitwise: the probe sequence is the table layout.
//
// What bounds it: a dependent chain of global-memory loads.  Each probe
// step reads 8 B (k1, k2), the lane then reads 4 B of val and moves 17 B of
// queries and outputs, but the next load's address depends on the last
// load, so one lane runs at device-memory latency, not bandwidth.  The
// tables (2^25 slots x 12 B = 384 MiB for the full configuration's adj and
// epos) fit neither shared memory nor L2, so they stay in device memory
// and the key words are read through the read-only cache (__ldg).  The
// main path launches it with 1 to 16384 lanes; at 20-160 lanes the launch
// itself sets the time.
//
// Design: one thread per lane, and each thread leaves its own loop when its
// chain ends (the Pallas kernel runs one uniform masked loop per block
// instead: a TPU block has no per-lane control flow).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int32_t kEmpty = -1;
constexpr int32_t kTomb = -2;
constexpr int kThreads = 128;

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

__global__ void __launch_bounds__(kThreads)
ht_probe_kernel(const int32_t* __restrict__ tk1,
                const int32_t* __restrict__ tk2,
                const int32_t* __restrict__ tval,
                const int32_t* __restrict__ q1,
                const int32_t* __restrict__ q2,
                int32_t* __restrict__ slot_out,
                bool* __restrict__ found_out,
                int32_t* __restrict__ val_out,
                int n, uint32_t cap, bool insert, bool prehashed) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  const int32_t a = q1[lane];
  const int32_t b = q2[lane];
  const uint32_t mask = cap - 1u;
  const uint32_t start = probe_start(static_cast<uint32_t>(a),
                                     static_cast<uint32_t>(b), mask,
                                     prehashed);
  // pass 1: the key's chain ends at the key itself or at EMPTY
  uint32_t i = 0;
  for (; i < cap; ++i) {
    const uint32_t s = (start + i) & mask;
    const int32_t k = __ldg(tk1 + s);
    if (k == kEmpty || (k == a && __ldg(tk2 + s) == b)) break;
  }
  const uint32_t s1 = (start + i) & mask;
  const bool found = __ldg(tk1 + s1) == a && __ldg(tk2 + s1) == b;
  uint32_t slot = s1;
  if (insert && !found) {
    // pass 2 (upsert): the first free slot, EMPTY or TOMB
    uint32_t j = 0;
    for (; j < cap; ++j) {
      const int32_t k = __ldg(tk1 + ((start + j) & mask));
      if (k == kEmpty || k == kTomb) break;
    }
    slot = (start + j) & mask;
  }
  slot_out[lane] = static_cast<int32_t>(slot);
  found_out[lane] = found;
  val_out[lane] = __ldg(tval + s1);
}

}  // namespace

// Launches on `stream` without synchronising; returns cudaGetLastError().
extern "C" int ht_probe_launch(const void* tk1, const void* tk2,
                               const void* tval, const void* q1,
                               const void* q2, void* slot, void* found,
                               void* val, int n, unsigned int cap,
                               int insert, int prehashed, void* stream) {
  if (n > 0) {
    const int blocks = (n + kThreads - 1) / kThreads;
    ht_probe_kernel<<<blocks, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(tk1), static_cast<const int32_t*>(tk2),
        static_cast<const int32_t*>(tval), static_cast<const int32_t*>(q1),
        static_cast<const int32_t*>(q2), static_cast<int32_t*>(slot),
        static_cast<bool*>(found), static_cast<int32_t*>(val), n, cap,
        insert != 0, prehashed != 0);
  }
  return static_cast<int>(cudaGetLastError());
}
