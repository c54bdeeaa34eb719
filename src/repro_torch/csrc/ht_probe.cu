// Batched open-addressing hash-table probe for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/ht_probe.py::_probe_kernel
// (wrapper ht_probe_batch), and its stacked form under jax.vmap, where every
// replica's probes share one launch.  For each lane it walks one
// linear-probe chain from the fmix32 start slot of its key (k1 ^ k2 when
// prehashed), masked by cap - 1:
//   pass 1 (both modes): stop at the key or at EMPTY (-1);
//   pass 2 (insert mode, only when the key is absent): stop at the first
//          EMPTY or TOMB (-2);
// every chain ends within cap steps.  It writes the slot, the found flag
// and val[slot1], the value at the key's find-chain end.  The contract is
// bitwise: the probe sequence is the table layout.
//
// What bounds it: memory latency.  The tables (2^25 slots x 12 B = 384 MiB
// for the full configuration's adj and epos) fit neither shared memory nor
// L2, and a chain's next slot is only known to be needed once the last one
// was read, so a lane that reads one word at a time waits one device-memory
// round trip per word.  Every scattered 4-byte read also moves a whole
// 32-byte sector.  The main path launches it with 1 to 16384 lanes, where
// the launch and the longest chain of the batch set the time.  At 2^20
// lanes the scattered sectors set it instead, and reading k2 and val for
// the whole window (about 4 sectors a lane against about 2.5 for a lane
// that reads k2 and val only where needed) is what the one round trip
// costs there: from 2^14 to 2^18 lanes a job up, by table load, one
// thread per lane walking one word at a time is faster (PERF.md).
//
// Design:
//   * A tile of kTile threads (cg::tiled_partition) serves one lane.  Round
//     r reads the kTile slots of one window aligned to kTile words, one
//     word of k1, k2 and val per thread, all three loads in flight at once:
//     with kTile = 8 each array's window is one 32-byte sector.  The first
//     window starts at the chain start's aligned base and masks off the
//     slots before the start; they come back, at the chain's end, in the
//     window after the last whole one.  A ballot over the tile finds the
//     first slot, in probe order, where pass 1 stops.  A chain that ends in
//     its first window costs one round trip, not the three or four of a
//     lane that reads k1, then k2, then the chain end and val one by one.
//   * One pass serves both modes.  Pass 1's walk also notes the first TOMB
//     it passes; when the key is absent, pass 2's first EMPTY/TOMB slot is
//     that TOMB, else pass 1's EMPTY end, else (a chain that wrapped all of
//     cap with no EMPTY and no TOMB) the start.  The chain end's k1, k2 and
//     val stay in registers and come to the writing thread by shuffle.
//   * One launch serves up to kMaxJobs jobs, each its own table, queries,
//     outputs, cap and mode, passed by value in the parameter block:
//     blockIdx.y is the job, and a job with fewer lanes than the grid's x
//     extent leaves early.  A stacked [R, cap] table is R jobs.
//   * No TMA, no tensor cores and no shared memory: a probe is a scattered
//     walk, not a tile.
//
// kTile is fixed here, not a knob: PERF.md gives the times of 1, 16 and 32
// threads per lane that it was chosen over (tools/probe_check.py --tiles).
#include <cooperative_groups.h>
#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int32_t kEmpty = -1;
constexpr int32_t kTomb = -2;
constexpr int kTile = 8;                    // threads per lane
constexpr int kBlock = 256;                 // threads per block
constexpr int kLanesPerBlock = kBlock / kTile;
constexpr int kMaxJobs = 48;                // 48 x 80 B fits 4 KB of params

// One probe batch; the layout is kernels/ht_probe.py's _JOB struct.
struct Job {
  const int32_t* k1;
  const int32_t* k2;
  const int32_t* val;
  const int32_t* q1;
  const int32_t* q2;
  int32_t* slot;
  uint8_t* found;
  int32_t* val_out;
  uint32_t cap;
  int32_t n;
  uint32_t insert;
  uint32_t prehashed;
};
static_assert(sizeof(Job) == 80, "Job must match the host's 80-byte struct");

template <int N>
struct Jobs {
  Job job[N];
};

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

// __grid_constant__: the job is read from the parameter bank by
// blockIdx.y, with no copy of the whole array to local memory.
template <int N>
__global__ void __launch_bounds__(kBlock)
ht_probe_kernel(const __grid_constant__ Jobs<N> jobs) {
  const Job& job = jobs.job[blockIdx.y];
  const int lane = blockIdx.x * kLanesPerBlock + threadIdx.x / kTile;
  if (lane >= job.n) return;  // the whole tile leaves together
  const auto tile = cg::tiled_partition<kTile>(cg::this_thread_block());
  const uint32_t t = tile.thread_rank();

  const int32_t a = job.q1[lane];
  const int32_t b = job.q2[lane];
  const uint32_t cap = job.cap;
  const uint32_t mask = cap - 1u;
  const uint32_t start = probe_start(static_cast<uint32_t>(a),
                                     static_cast<uint32_t>(b), mask,
                                     job.prehashed != 0);
  // chain offset o lives at window position head + o; windows of kTile
  // positions from the aligned base, head + cap positions in all
  const uint32_t head = start & (kTile - 1u);
  const uint32_t base = start - head;
  const uint32_t rounds = (head + cap + kTile - 1u) / kTile;

  bool tomb_seen = false;
  uint32_t tomb_slot = 0;
  int32_t val_at_start = 0;  // thread `head` of round 0 holds tval[start]
  uint32_t slot1 = start;
  bool found = false;
  int32_t val1 = 0;
  bool stopped = false;
  for (uint32_t r = 0; r < rounds; ++r) {
    const uint32_t pos = r * kTile + t;
    const bool valid = pos >= head && pos - head < cap;
    const uint32_t s = (base + pos) & mask;
    const int32_t k1 = __ldg(job.k1 + s);
    const int32_t k2 = __ldg(job.k2 + s);
    const int32_t v = __ldg(job.val + s);
    if (r == 0) val_at_start = v;
    const unsigned stops =
        tile.ballot(valid && (k1 == kEmpty || (k1 == a && k2 == b)));
    unsigned tombs = tile.ballot(valid && k1 == kTomb);
    if (stops) {
      const int src = __ffs(static_cast<int>(stops)) - 1;
      tombs &= (1u << src) - 1u;  // only the TOMBs before the chain end
      const int32_t e1 = tile.shfl(k1, src);
      const int32_t e2 = tile.shfl(k2, src);
      val1 = tile.shfl(v, src);
      slot1 = (base + r * kTile + src) & mask;
      found = e1 == a && e2 == b;
      stopped = true;
    }
    if (tombs && !tomb_seen) {
      tomb_seen = true;
      tomb_slot =
          (base + r * kTile + __ffs(static_cast<int>(tombs)) - 1u) & mask;
    }
    if (stopped) break;
  }
  if (!stopped) {
    // no EMPTY and no key in all cap slots: the chain ends at the start,
    // where the key is not (offset 0 would have stopped)
    val1 = tile.shfl(val_at_start, static_cast<int>(head));
  }
  if (t == 0) {
    const uint32_t slot =
        (job.insert && !found && tomb_seen) ? tomb_slot : slot1;
    job.slot[lane] = static_cast<int32_t>(slot);
    job.found[lane] = found;
    job.val_out[lane] = val1;
  }
}

template <int N>
cudaError_t launch(const void* jobs, int njobs, int max_n,
                   cudaStream_t stream) {
  Jobs<N> params;
  std::memset(&params, 0, sizeof(params));
  std::memcpy(params.job, jobs, sizeof(Job) * njobs);
  const dim3 grid((max_n + kLanesPerBlock - 1) / kLanesPerBlock, njobs);
  ht_probe_kernel<N><<<grid, kBlock, 0, stream>>>(params);
  return cudaGetLastError();
}

}  // namespace

// Launches `njobs` jobs (an array of Job, at most kMaxJobs) on `stream`
// without synchronising; `max_n` is the largest job's lane count.  Returns
// cudaGetLastError(), or cudaErrorInvalidValue for a job count out of range.
// The parameter block is sized to the job count's class (1, 8 or kMaxJobs).
extern "C" int ht_probe_launch(const void* jobs, int njobs, int max_n,
                               void* stream) {
  if (njobs < 1 || njobs > kMaxJobs || max_n < 1 ||
      max_n > (1 << 30))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  if (njobs == 1) return static_cast<int>(launch<1>(jobs, njobs, max_n, s));
  if (njobs <= 8) return static_cast<int>(launch<8>(jobs, njobs, max_n, s));
  return static_cast<int>(launch<kMaxJobs>(jobs, njobs, max_n, s));
}

extern "C" int ht_probe_max_jobs() { return kMaxJobs; }
