// Hand-written Hopper kernels for the knowledge-base lookup (paper §4.3,
// Algorithm 2): squared Euclidean distances from a query to every case
// row, fused with the top-k selection, in full fp32 on the CUDA cores.
//
// Replaces the TPU kernels of src/repro/kernels/knn.py:
//   knn_topk_f32        <- _dist_kernel        (pallas_call at knn.py:64,
//                          called via squared_distances / knn_topk)
//   knn_topk_batch_f32  <- _dist_kernel_batch  (pallas_call at knn.py:115,
//                          called via knn_topk_batch)
// The TPU versions write the whole distance vector/matrix to HBM and leave
// top-k to lax.top_k; here the distances never leave the SM: each launch
// returns the k nearest (sqrt distance, index) pairs, ascending, ties to the
// lower index (as lax.top_k breaks them).
//
// What bounds them on an H100: at the main path's shapes (N <= 8 windows x
// 168 slots = 1344 cases, D = 13 features) the case matrix is 70 KB, about
// 21 ns of HBM traffic at 3.35 TB/s, and the arithmetic is ~35 kFLOP.  A
// single-query lookup is therefore bound by launch latency and the host
// round trip, not by bytes or operations; the design keeps it to one launch
// for N <= TILE_ROWS and does no padding (the Pallas kernel padded D to 128
// lanes and N to 256-row blocks).  The batch kernel reuses each staged
// case tile across BATCH_WARPS queries.
//
// fp32 with fmaf, never TF32: KnowledgeBase.query_batch promises agreement
// with query to a few ulps.  Distances are computed directly as sum (x-q)^2,
// so they differ from the norm-expansion (||q||^2 + ||x||^2 - 2 q.x) of the
// plain batch version by that version's cancellation error, about
// eps_f32 * (||q||^2 + ||x||^2) in d2.
//
// Plain C interface (loaded with ctypes); every entry point returns the
// cudaError_t of its launches, 0 on success.  Nothing here allocates or
// synchronises: the caller owns every buffer and the stream.

#include <cuda_runtime.h>

#include <climits>
#include <cmath>

namespace {

constexpr int KMAX = 8;                 // largest k supported
constexpr int THREADS = 256;
constexpr int ROWS_PER_THREAD = 8;
constexpr int TILE_ROWS = THREADS * ROWS_PER_THREAD;  // rows per block, single query
constexpr int MAX_D = 256;
constexpr int BATCH_WARPS = THREADS / 32;  // queries per block, batch (one per warp)
constexpr int SMEM_BUDGET = 48 * 1024;     // static-launch shared-memory limit

// (d, i) orders before (e, j): smaller distance, then lower index.
__device__ __forceinline__ bool before(float d, int i, float e, int j) {
  return d < e || (d == e && i < j);
}

__device__ __forceinline__ void list_init(float (&ld)[KMAX], int (&li)[KMAX]) {
#pragma unroll
  for (int s = 0; s < KMAX; ++s) {
    ld[s] = INFINITY;
    li[s] = INT_MAX;
  }
}

// Insert (d, i) into the ascending register list; the last entry falls off.
// NaN distances never compare before anything and are dropped.
__device__ __forceinline__ void list_insert(float (&ld)[KMAX], int (&li)[KMAX],
                                            float d, int i) {
#pragma unroll
  for (int s = 0; s < KMAX; ++s) {
    if (before(d, i, ld[s], li[s])) {
      const float td = ld[s];
      const int ti = li[s];
      ld[s] = d;
      li[s] = i;
      d = td;
      i = ti;
    }
  }
}

__device__ __forceinline__ void list_pop(float (&ld)[KMAX], int (&li)[KMAX]) {
#pragma unroll
  for (int s = 0; s < KMAX - 1; ++s) {
    ld[s] = ld[s + 1];
    li[s] = li[s + 1];
  }
  ld[KMAX - 1] = INFINITY;
  li[KMAX - 1] = INT_MAX;
}

// Lexicographic (d, i) minimum across the warp; every lane gets the result.
__device__ __forceinline__ void warp_min(float& d, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float od = __shfl_xor_sync(0xffffffffu, d, off);
    const int oi = __shfl_xor_sync(0xffffffffu, i, off);
    if (before(od, oi, d, i)) {
      d = od;
      i = oi;
    }
  }
}

// The k smallest (d, i) pairs over every thread's list, ascending, into
// res_d/res_i (shared memory).  k rounds of a block-wide argmin over the
// list heads; the thread holding the winner pops it.  Indices of real rows
// are unique, so exactly one thread pops (padding entries are identical and
// only win once the real rows are exhausted).
__device__ void block_select(float (&ld)[KMAX], int (&li)[KMAX], int k,
                             float* res_d, int* res_i) {
  __shared__ float wd_s[BATCH_WARPS + 1];
  __shared__ int wi_s[BATCH_WARPS + 1];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int r = 0; r < k; ++r) {
    float d = ld[0];
    int i = li[0];
    warp_min(d, i);
    if (lane == 0) {
      wd_s[warp] = d;
      wi_s[warp] = i;
    }
    __syncthreads();
    if (warp == 0) {
      d = lane < BATCH_WARPS ? wd_s[lane] : INFINITY;
      i = lane < BATCH_WARPS ? wi_s[lane] : INT_MAX;
      warp_min(d, i);
      if (lane == 0) {
        wd_s[BATCH_WARPS] = d;
        wi_s[BATCH_WARPS] = i;
        res_d[r] = d;
        res_i[r] = i;
      }
    }
    __syncthreads();
    if (ld[0] == wd_s[BATCH_WARPS] && li[0] == wi_s[BATCH_WARPS]) list_pop(ld, li);
  }
}

// Kernel 1, pass 1: block b scans rows [b * TILE_ROWS, (b + 1) * TILE_ROWS)
// with the query in shared memory, each thread keeping its own top-KMAX in
// registers, then reduces them to the block's k best.  With one block the
// result is final (sqrt distances, int64 indices); otherwise it goes to the
// partial buffers for knn_merge_kernel.
__global__ void __launch_bounds__(THREADS)
knn_rows_kernel(const float* __restrict__ cases, const float* __restrict__ query,
                int n, int d, int k, float* __restrict__ part_d,
                int* __restrict__ part_i, float* __restrict__ out_dist,
                long long* __restrict__ out_idx) {
  __shared__ float q_s[MAX_D];
  __shared__ float res_d[KMAX];
  __shared__ int res_i[KMAX];
  for (int c = threadIdx.x; c < d; c += THREADS) q_s[c] = query[c];
  __syncthreads();

  float ld[KMAX];
  int li[KMAX];
  list_init(ld, li);
  const int row0 = blockIdx.x * TILE_ROWS;
  const int row1 = min(n, row0 + TILE_ROWS);
  for (int r = row0 + threadIdx.x; r < row1; r += THREADS) {
    const float* x = cases + static_cast<size_t>(r) * d;
    float acc = 0.f;
    for (int c = 0; c < d; ++c) {
      const float diff = x[c] - q_s[c];
      acc = fmaf(diff, diff, acc);
    }
    list_insert(ld, li, acc, r);
  }
  block_select(ld, li, k, res_d, res_i);

  const int t = threadIdx.x;
  if (t < k) {
    if (gridDim.x == 1) {
      out_dist[t] = sqrtf(fmaxf(res_d[t], 0.f));
      out_idx[t] = res_i[t];
    } else {
      part_d[blockIdx.x * k + t] = res_d[t];
      part_i[blockIdx.x * k + t] = res_i[t];
    }
  }
}

// Kernel 1, pass 2 (only when N > TILE_ROWS): one block merges the m = blocks
// x k partial candidates into the final k.
__global__ void __launch_bounds__(THREADS)
knn_merge_kernel(const float* __restrict__ part_d, const int* __restrict__ part_i,
                 int m, int k, float* __restrict__ out_dist,
                 long long* __restrict__ out_idx) {
  __shared__ float res_d[KMAX];
  __shared__ int res_i[KMAX];
  float ld[KMAX];
  int li[KMAX];
  list_init(ld, li);
  for (int j = threadIdx.x; j < m; j += THREADS) list_insert(ld, li, part_d[j], part_i[j]);
  block_select(ld, li, k, res_d, res_i);
  const int t = threadIdx.x;
  if (t < k) {
    out_dist[t] = sqrtf(fmaxf(res_d[t], 0.f));
    out_idx[t] = res_i[t];
  }
}

// Kernel 2: a block owns BATCH_WARPS queries, one per warp, and loops over
// the case base in chunks of `chunk` rows staged in shared memory (coalesced
// loads, each row reused by every warp of the block).  Lane j of a warp
// takes rows j, j + 32, ... of the chunk and keeps a running top-KMAX in
// registers; k rounds of warp_min then give the query's k nearest.  Rows
// are stored with an odd stride so the 32 lanes read 32 distinct banks.
__global__ void __launch_bounds__(THREADS)
knn_batch_kernel(const float* __restrict__ cases, const float* __restrict__ queries,
                 int n, int d, int nq, int k, int chunk,
                 float* __restrict__ out_dist, long long* __restrict__ out_idx) {
  extern __shared__ float smem[];
  const int ds = d | 1;
  float* q_s = smem;                       // BATCH_WARPS x ds
  float* x_s = smem + BATCH_WARPS * ds;    // chunk x ds
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int q0 = blockIdx.x * BATCH_WARPS;

  for (int e = threadIdx.x; e < BATCH_WARPS * d; e += THREADS) {
    const int w = e / d;
    const int c = e - w * d;
    const int qi = q0 + w;
    q_s[w * ds + c] = qi < nq ? queries[static_cast<size_t>(qi) * d + c] : 0.f;
  }

  float ld[KMAX];
  int li[KMAX];
  list_init(ld, li);
  const float* qv = q_s + warp * ds;
  for (int base = 0; base < n; base += chunk) {
    const int rows = min(chunk, n - base);
    __syncthreads();  // the previous chunk is consumed (and q_s is written)
    const float* src = cases + static_cast<size_t>(base) * d;
    for (int e = threadIdx.x; e < rows * d; e += THREADS) {
      const int r = e / d;
      x_s[r * ds + (e - r * d)] = src[e];
    }
    __syncthreads();
    for (int r = lane; r < rows; r += 32) {
      const float* xv = x_s + r * ds;
      float acc = 0.f;
      for (int c = 0; c < d; ++c) {
        const float diff = xv[c] - qv[c];
        acc = fmaf(diff, diff, acc);
      }
      list_insert(ld, li, acc, base + r);
    }
  }

  const int qi = q0 + warp;
  for (int r = 0; r < k; ++r) {
    float wd = ld[0];
    int wi = li[0];
    warp_min(wd, wi);
    if (ld[0] == wd && li[0] == wi) list_pop(ld, li);
    if (lane == 0 && qi < nq) {
      out_dist[static_cast<size_t>(qi) * k + r] = sqrtf(fmaxf(wd, 0.f));
      out_idx[static_cast<size_t>(qi) * k + r] = wi;
    }
  }
}

int batch_chunk(int d) {
  const int ds = d | 1;
  int chunk = SMEM_BUDGET / (4 * ds) - BATCH_WARPS;
  chunk = chunk > 256 ? 256 : chunk;
  return chunk - chunk % 32;
}

}  // namespace

extern "C" {

int knn_max_k() { return KMAX; }
int knn_max_d() { return MAX_D; }

// Blocks of pass 1 for n rows; the caller sizes the partial buffers as
// blocks * k when this exceeds 1 (pass 2 runs only then).
int knn_topk_blocks(int n) { return (n + TILE_ROWS - 1) / TILE_ROWS; }

// One query: cases (n, d) row-major, query (d,) -> out_dist (k,) float32,
// out_idx (k,) int64, ascending.
int knn_topk_f32(const float* cases, const float* query, int n, int d, int k,
                 float* part_d, int* part_i, float* out_dist, long long* out_idx,
                 void* stream) {
  if (n < 1 || d < 1 || d > MAX_D || k < 1 || k > KMAX || k > n)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = knn_topk_blocks(n);
  if (blocks > 1 && (part_d == nullptr || part_i == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  knn_rows_kernel<<<blocks, THREADS, 0, s>>>(cases, query, n, d, k, part_d, part_i,
                                             out_dist, out_idx);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || blocks == 1) return static_cast<int>(err);
  knn_merge_kernel<<<1, THREADS, 0, s>>>(part_d, part_i, blocks * k, k, out_dist,
                                         out_idx);
  return static_cast<int>(cudaGetLastError());
}

// A batch: cases (n, d), queries (nq, d) -> out_dist (nq, k) float32,
// out_idx (nq, k) int64, each row ascending.
int knn_topk_batch_f32(const float* cases, const float* queries, int n, int d, int nq,
                       int k, float* out_dist, long long* out_idx, void* stream) {
  if (n < 1 || d < 1 || d > MAX_D || nq < 1 || k < 1 || k > KMAX || k > n)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int chunk = batch_chunk(d);
  const size_t smem = static_cast<size_t>(BATCH_WARPS + chunk) * (d | 1) * sizeof(float);
  const int blocks = (nq + BATCH_WARPS - 1) / BATCH_WARPS;
  knn_batch_kernel<<<blocks, THREADS, smem, s>>>(cases, queries, n, d, nq, k, chunk,
                                                 out_dist, out_idx);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
