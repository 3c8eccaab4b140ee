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
// Design.  One block per cell.  All threads first zero the cell's take row
// and record, per 32-row chunk, the ballot of its forced candidates and of
// its unforced ones in shared memory.  Warp 0 then walks the chunks, the
// forced pass first: an empty chunk costs one shared-memory read.  For a
// chunk with candidates, the lanes drop the rows whose request exceeds the
// capacity left (they can never fit: used only grows), take an inclusive
// warp prefix (__shfl_up_sync) of the requests of the rows left, and commit
// every row before the first that overflows at once; that row is skipped
// and the round repeats on the rows after it with the new `used`.  Each
// round commits or drops at least one row.  The same parallel pass reads
// every candidate's request and reduces their minimum (a warp min, one
// value per warp in shared memory, folded by warp 0): the walk stops once
// the capacity left is below it, since no candidate can fit any more.
// Integer arithmetic only, so the kernel is exact by construction; it needs
// requests >= 0.
//
// What bounds it on an H100: neither bytes nor operations.  It reads cand
// and forced (one byte each per row), the requests of the candidate rows
// (8 bytes each) and writes take (one byte per row): ~11 bytes a row, 4.3 MB
// at 64 cells x 6144 rows, 1.3 us at 3.35 TB/s.  The walk is serial within a
// cell: a few dependent shuffles per chunk with candidates, so its time is
// latency, and the launch (~2-5 us) is most of a call.
//
// Plain C interface (loaded with ctypes); each entry point returns the
// cudaError_t of its launch, 0 on success.  Nothing here allocates or
// synchronises: the caller owns every buffer and the stream.

#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr unsigned int FULL = 0xffffffffu;

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

// The floor of a call: an empty kernel on the same grid and shared memory.
__global__ void __launch_bounds__(THREADS) capacity_fill_floor_kernel() {}

int launch_config(long long rows, int n, unsigned int* blocks, size_t* smem) {
  if (rows <= 0 || n <= 0) return 0;
  *blocks = (unsigned int)rows;
  *smem = 2 * (size_t)((n + 31) / 32) * sizeof(unsigned int);
  return 1;
}

}  // namespace

extern "C" {

// cand, forced (rows, n) bool/uint8, kreq (rows, n) int64, m_cap (rows,)
// int64, row-major; take (rows, n) bool (0 or 1), written in full.
int capacity_fill(const unsigned char* cand, const unsigned char* forced,
                  const long long* kreq, const long long* m_cap, long long rows,
                  int n, unsigned char* take, void* stream) {
  unsigned int blocks;
  size_t smem;
  if (!launch_config(rows, n, &blocks, &smem)) return 0;
  capacity_fill_kernel<<<blocks, THREADS, smem, (cudaStream_t)stream>>>(
      cand, forced, kreq, m_cap, n, take);
  return (int)cudaGetLastError();
}

int capacity_fill_floor(long long rows, int n, void* stream) {
  unsigned int blocks;
  size_t smem;
  if (!launch_config(rows, n, &blocks, &smem)) return 0;
  capacity_fill_floor_kernel<<<blocks, THREADS, smem, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

}  // extern "C"
