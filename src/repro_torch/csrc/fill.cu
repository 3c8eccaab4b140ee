// A hand-written Hopper kernel for the variable-k capacity fill of the
// device slot loop (src/repro_torch/core/scan_engine.py): each slot, for
// every cell b of a batch, walk the candidate rows in a fixed order and take
// each one whose request still fits the cell's capacity,
//
//     order: the forced candidates in row order, then the unforced
//            candidates in row order;
//     used = 0; take[r] = used + kreq[r] <= m_cap[b]; if taken, used += kreq[r]
//
// a row that does not fit is skipped and the walk goes on ("continue").
// Rows of one cell ask for different k where their k_min differs, or where
// carbonflex-scale asks for k_up in clean slots, so the fill cannot be the
// cumsum prefix the uniform-k path uses.
//
// Replaces no Pallas kernel: the JAX scan engine walks the candidates in a
// lax.scan over the rows of a stable argsort key
// (src/repro/core/scan_engine.py:469-488, `fill`), one scalar step per row.
//
// Design: two routes, one block per cell each (kernels/fill.py::plan).
// Both read every candidate's request in a parallel pass and reduce their
// minimum (a warp min, one value per warp in shared memory, folded by warp
// 0): the walk stops once the capacity left is below it, since no
// candidate can fit any more.  The walk itself runs in rounds over a group
// of up to 32 candidates in walk order: the lanes drop the rows whose
// request exceeds the capacity left (they can never fit: used only grows),
// take an inclusive warp prefix (__shfl_up_sync) of the requests of the
// rows left, and commit every row before the first that overflows at once;
// that row is skipped and the round repeats on the rows after it with the
// new `used`.  Each round commits or drops at least one row.
//
// "compact" (capacity_fill_compact_kernel, the default).  All threads zero
// the cell's take row, keep each candidate's request in shared memory at
// its row and record each 32-row chunk's ballots of forced and unforced
// candidates; warp 0 scans their counts into offsets, and every warp
// writes each candidate's row index at its place in the walk order (forced
// by row, then unforced by row).  Warp 0 then walks that list in dense
// groups of 32: ~candidates / 32 groups a cell instead of 2 x chunks.
//
// "chunked" (capacity_fill_kernel, the first design).  Warp 0 walks the
// chunks themselves, the forced pass first: an empty chunk costs one
// shared-memory read, a chunk with candidates at least one round.
//
// Integer arithmetic only, so the kernels are exact by construction; they
// need requests >= 0.
//
// What bounds it on an H100: neither bytes nor operations.  It reads cand
// and forced (one byte each per row), the requests of the candidate rows
// (8 bytes each) and writes take (one byte per row): ~11 bytes a row, 4.3 MB
// at 64 cells x 6144 rows, 1.3 us at 3.35 TB/s.  The walk is serial within a
// cell: a few dependent shuffles per chunk with candidates, so its time is
// latency: the rounds, one per group or chunk and one per overflow.
//
// Plain C interface (loaded with ctypes); each entry point returns the
// cudaError_t of its launch, 0 on success.  Nothing here allocates or
// synchronises: the caller owns every buffer and the stream.

#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int THREADS = 256;           // the chunked kernel's block
constexpr int WARPS = THREADS / 32;
constexpr int COMPACT_THREADS = 1024;  // the compact kernel's block
constexpr int COMPACT_WARPS = COMPACT_THREADS / 32;
// The compact kernel's shared memory a row (request, list entry) and a
// chunk (two ballots, two offsets): plan's ROW_BYTES and CHUNK_BYTES.
constexpr int ROW_BYTES = 10;
constexpr int CHUNK_BYTES = 16;
constexpr int SMEM_LIMIT = 48 * 1024;   // above it a launch opts in
constexpr unsigned int FULL = 0xffffffffu;
constexpr int COMPACT = 0, CHUNKED = 1;   // kernels/fill.py::ROUTES

__device__ __forceinline__ long long warp_min(long long v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v = min(v, __shfl_xor_sync(FULL, v, d));
  return v;
}

__device__ __forceinline__ long long warp_inclusive_sum(long long v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const long long u = __shfl_up_sync(FULL, v, d);
    if (lane >= d) v += u;
  }
  return v;
}

// Warp 0's rounds over one group: lane `lane` holds request k, live where
// its bit of `live` is set.  Returns whether this lane's row was taken;
// `used` (the same in every lane) grows by what was taken.  Stops early
// once the capacity left is below k_floor.
__device__ __forceinline__ bool rounds(unsigned int live, long long k, long long cap,
                                       long long k_floor, int lane, long long& used) {
  bool taken = false;
  while (true) {
    live &= __ballot_sync(FULL, k <= cap - used);
    if (!live) return taken;
    const bool mine = (live >> lane) & 1u;
    const long long pre = warp_inclusive_sum(mine ? k : 0, lane);
    const unsigned int over = __ballot_sync(FULL, mine && used + pre > cap);
    // the live lanes before the first overflow commit
    const unsigned int commit = live & (over ? (over & (0u - over)) - 1u : FULL);
    taken |= (commit >> lane) & 1u;
    if (commit) used += __shfl_sync(FULL, pre, 31 - __clz(commit));
    if (!over) return taken;
    live &= ~((over & (0u - over)) * 2u - 1u);   // skip the overflowing row
    if (cap - used < k_floor) return taken;
  }
}

// cand, forced, take: (rows, n) bytes; kreq (rows, n) int64; m_cap (rows,)
// int64.  Dynamic shared memory: 2 * ceil(n / 32) chunk masks.
__global__ void __launch_bounds__(THREADS)
capacity_fill_kernel(const unsigned char* __restrict__ cand,
                     const unsigned char* __restrict__ forced,
                     const long long* __restrict__ kreq,
                     const long long* __restrict__ m_cap, int n,
                     unsigned char* __restrict__ take) {
  extern __shared__ unsigned int masks[];   // [pass * chunks + chunk]
  __shared__ long long warp_floor[WARPS];   // each warp's smallest request
  const int chunks = (n + 31) >> 5;
  const long long base = (long long)blockIdx.x * n;
  const unsigned char* c = cand + base;
  const unsigned char* f = forced + base;
  const long long* k_row = kreq + base;
  unsigned char* out = take + base;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  for (int r = threadIdx.x; r < n; r += THREADS) out[r] = 0;
  long long least = LLONG_MAX;               // this lane's smallest request
  for (int ch = warp; ch < chunks; ch += WARPS) {
    const int r = (ch << 5) + lane;
    const bool is_cand = r < n && c[r] != 0;
    const bool is_forced = is_cand && f[r] != 0;
    if (is_cand) least = min(least, k_row[r]);
    const unsigned int m_forced = __ballot_sync(FULL, is_forced);
    const unsigned int m_free = __ballot_sync(FULL, is_cand && !is_forced);
    if (lane == 0) {
      masks[ch] = m_forced;
      masks[chunks + ch] = m_free;
    }
  }
  least = warp_min(least);
  if (lane == 0) warp_floor[warp] = least;
  __syncthreads();
  if (warp != 0) return;

  // no candidate asks for less than k_floor (LLONG_MAX: there is none)
  const long long k_floor = warp_min(lane < WARPS ? warp_floor[lane] : LLONG_MAX);
  const long long cap = m_cap[blockIdx.x];
  long long used = 0;                        // the same in every lane
  for (int i = 0; i < 2 * chunks; ++i) {     // the forced pass, then the rest
    if (cap - used < k_floor) return;        // nothing can fit any more
    unsigned int live = masks[i];
    if (!live) continue;
    const int r = ((i < chunks ? i : i - chunks) << 5) + lane;
    const long long k = (live >> lane) & 1u ? k_row[r] : 0;
    while (true) {
      live &= __ballot_sync(FULL, k <= cap - used);
      if (!live) break;
      const bool mine = (live >> lane) & 1u;
      const long long pre = warp_inclusive_sum(mine ? k : 0, lane);
      const unsigned int over = __ballot_sync(FULL, mine && used + pre > cap);
      // the live lanes before the first overflow commit
      const unsigned int commit = live & (over ? (over & (0u - over)) - 1u : FULL);
      if ((commit >> lane) & 1u) out[r] = 1;
      if (commit) used += __shfl_sync(FULL, pre, 31 - __clz(commit));
      if (!over) break;
      live &= ~((over & (0u - over)) * 2u - 1u);   // skip the overflowing row
      if (cap - used < k_floor) return;
    }
  }
}

// Warp 0: exclusive offsets of the `count` chunk ballots' set bits, in
// order (each lane sums a segment, one warp scan), and their total.
__device__ void scan_ballots(const unsigned int* masks, int count, unsigned int* offs,
                             int* total, int lane) {
  const int per = (count + 31) >> 5;
  const int lo = min(lane * per, count), hi = min(lo + per, count);
  int sum = 0;
  for (int j = lo; j < hi; ++j) sum += __popc(masks[j]);
  int incl = sum;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int t = __shfl_up_sync(FULL, incl, d);
    if (lane >= d) incl += t;
  }
  int run = incl - sum;
  for (int j = lo; j < hi; ++j) {
    offs[j] = run;
    run += __popc(masks[j]);
  }
  if (lane == 31) *total = incl;
}

// Dynamic shared memory: k[n] (8 bytes, at each candidate's row),
// masks[2 * chunks], offs[2 * chunks] (4), list[n] (2): ROW_BYTES * n +
// CHUNK_BYTES * chunks bytes.
__global__ void __launch_bounds__(COMPACT_THREADS)
capacity_fill_compact_kernel(const unsigned char* __restrict__ cand,
                             const unsigned char* __restrict__ forced,
                             const long long* __restrict__ kreq,
                             const long long* __restrict__ m_cap, int n,
                             unsigned char* __restrict__ take) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ long long warp_floor[COMPACT_WARPS];
  __shared__ int s_total;
  const int chunks = (n + 31) >> 5;
  long long* s_k = reinterpret_cast<long long*>(smem);
  unsigned int* masks = reinterpret_cast<unsigned int*>(s_k + n);
  unsigned int* offs = masks + 2 * chunks;
  unsigned short* s_list = reinterpret_cast<unsigned short*>(offs + 2 * chunks);
  const long long base = (long long)blockIdx.x * n;
  const unsigned char* c = cand + base;
  const unsigned char* f = forced + base;
  const long long* k_row = kreq + base;
  unsigned char* out = take + base;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  long long least = LLONG_MAX;               // this lane's smallest request
  for (int ch = warp; ch < chunks; ch += COMPACT_WARPS) {
    const int r = (ch << 5) + lane;
    const bool is_cand = r < n && c[r] != 0;
    const bool is_forced = is_cand && f[r] != 0;
    if (r < n) out[r] = 0;
    if (is_cand) {
      const long long k = k_row[r];
      s_k[r] = k;
      least = min(least, k);
    }
    const unsigned int m_forced = __ballot_sync(FULL, is_forced);
    const unsigned int m_free = __ballot_sync(FULL, is_cand && !is_forced);
    if (lane == 0) {
      masks[ch] = m_forced;
      masks[chunks + ch] = m_free;
    }
  }
  least = warp_min(least);
  if (lane == 0) warp_floor[warp] = least;
  __syncthreads();
  if (warp == 0) scan_ballots(masks, 2 * chunks, offs, &s_total, lane);
  __syncthreads();
  // The walk list: each candidate's row at its place in the walk order.
  for (int j = warp; j < 2 * chunks; j += COMPACT_WARPS) {
    const unsigned int m = masks[j];
    if ((m >> lane) & 1u)
      s_list[offs[j] + __popc(m & ((1u << lane) - 1u))] =
          (unsigned short)(((j < chunks ? j : j - chunks) << 5) + lane);
  }
  __syncthreads();
  if (warp != 0) return;

  // no candidate asks for less than k_floor (LLONG_MAX: there is none)
  const long long k_floor = warp_min(lane < COMPACT_WARPS ? warp_floor[lane] : LLONG_MAX);
  const long long cap = m_cap[blockIdx.x];
  const int total = s_total;
  long long used = 0;                        // the same in every lane
  for (int g = 0; g < total; g += 32) {      // dense groups of the list
    if (cap - used < k_floor) return;        // nothing can fit any more
    const int i = g + lane;
    const int r = i < total ? s_list[i] : 0;
    const long long k = i < total ? s_k[r] : 0;
    const unsigned int live = total - g >= 32 ? FULL : (1u << (total - g)) - 1u;
    if (rounds(live, k, cap, k_floor, lane, used)) out[r] = 1;
  }
}

// The floor of a call: an empty kernel on the same grid and shared memory.
__global__ void __launch_bounds__(THREADS) capacity_fill_floor_kernel() {}
__global__ void __launch_bounds__(COMPACT_THREADS) capacity_fill_compact_floor_kernel() {}

// Dynamic shared memory of a route for n rows (kernels/fill.py::plan): the
// compact kernel's requests and walk list, the chunked kernel's two ballot
// masks a chunk; -1 for an unknown route.
long long smem_bytes(int route, int n) {
  const long long chunks = (n + 31) / 32;
  if (route == COMPACT) return (long long)ROW_BYTES * n + CHUNK_BYTES * chunks;
  if (route == CHUNKED) return 2 * chunks * (long long)sizeof(unsigned int);
  return -1;
}

// Above SMEM_LIMIT a kernel's dynamic shared memory needs the opt-in.
template <typename K>
cudaError_t opt_in(K kernel, size_t smem) {
  if (smem <= SMEM_LIMIT) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace

extern "C" {

long long capacity_fill_smem(int route, int n) { return smem_bytes(route, n); }

// One launch of route's kernel, one block per cell, with `smem` bytes of
// dynamic shared memory as kernels/fill.py::plan sizes it.  cand, forced
// (rows, n) bool/uint8, kreq (rows, n) int64, m_cap (rows,) int64,
// row-major; take (rows, n) bool (0 or 1), written in full.
int capacity_fill(int route, const unsigned char* cand, const unsigned char* forced,
                  const long long* kreq, const long long* m_cap, long long rows, int n,
                  size_t smem, unsigned char* take, void* stream) {
  if (rows <= 0 || n <= 0) return 0;
  const long long need = smem_bytes(route, n);
  if (need < 0 || (long long)smem < need) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (route == COMPACT) {
    const cudaError_t err = opt_in(capacity_fill_compact_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    capacity_fill_compact_kernel<<<(unsigned int)rows, COMPACT_THREADS, smem, s>>>(
        cand, forced, kreq, m_cap, n, take);
  } else {
    capacity_fill_kernel<<<(unsigned int)rows, THREADS, smem, s>>>(cand, forced, kreq,
                                                                   m_cap, n, take);
  }
  return (int)cudaGetLastError();
}

// An empty kernel launched as route's kernel is: the floor of a call.
int capacity_fill_floor(int route, long long rows, size_t smem, void* stream) {
  if (rows <= 0) return 0;
  if (smem_bytes(route, 1) < 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (route == COMPACT) {
    const cudaError_t err = opt_in(capacity_fill_compact_floor_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    capacity_fill_compact_floor_kernel<<<(unsigned int)rows, COMPACT_THREADS, smem, s>>>();
  } else {
    capacity_fill_floor_kernel<<<(unsigned int)rows, THREADS, smem, s>>>();
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
