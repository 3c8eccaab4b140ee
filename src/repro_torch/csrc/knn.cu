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
//   knn_topk_f32 and knn_lookup_f32 launch knn_query_kernel (and, past
//   QROWS rows, knn_query_merge_kernel); knn_topk_batch_f32 launches
//   knn_batch_kernel.
//
// What bounds them on an H100: at the main path's shapes (N <= 8 windows x
// 168 slots = 1344 cases, D = 13 features) the case matrix is 70 KB, about
// 21 ns of HBM traffic at 3.35 TB/s, and the arithmetic is ~35 kFLOP.  A
// single-query lookup is therefore bound by latency: the launch, the host
// round trip, and the chain inside the kernel.  knn_query_kernel keeps the
// round trip to one launch and one write back: the query arrives as a
// launch parameter (no copy to the card), and knn_lookup_f32 has the kernel
// write the k (float64 distance, int64 index) pairs straight into mapped
// pinned host memory, then waits for the stream once.  Inside, one block of
// QTHREADS stages up to QROWS rows into shared memory with 16-byte
// asynchronous copies (cp.async, all in flight at once), each thread keeps
// a k-slot list (k is a template argument) of its rows, each warp selects
// its k best by k warp_min rounds with no block barrier, and warp 0 merges
// the warps' candidates: two barriers in all.  Larger bases take more
// blocks and a merge launch.  The
// batch kernel reuses each staged case tile across BATCH_WARPS queries.
//
// fp32 with fmaf, never TF32: KnowledgeBase.query_batch promises agreement
// with query to a few ulps.  Distances are computed directly as sum (x-q)^2,
// so they differ from the norm-expansion (||q||^2 + ||x||^2 - 2 q.x) of the
// plain batch version by that version's cancellation error, about
// eps_f32 * (||q||^2 + ||x||^2) in d2.
//
// Plain C interface (loaded with ctypes); every entry point returns the
// cudaError_t of its launches, 0 on success.  Nothing here allocates, and
// only knn_lookup_f32 synchronises (its stream, once): the caller owns
// every buffer and the stream.

#include <cuda_runtime.h>

#include <climits>
#include <cmath>

namespace {

constexpr int KMAX = 8;                 // largest k supported
constexpr int THREADS = 256;              // the batch kernel
constexpr int MAX_D = 256;
constexpr int BATCH_WARPS = THREADS / 32;  // queries per block, batch (one per warp)
constexpr int SMEM_BUDGET = 48 * 1024;     // static-launch shared-memory limit

// (d, i) orders before (e, j): smaller distance, then lower index.
__device__ __forceinline__ bool before(float d, int i, float e, int j) {
  return d < e || (d == e && i < j);
}

template <int L>
__device__ __forceinline__ void list_init(float (&ld)[L], int (&li)[L]) {
#pragma unroll
  for (int s = 0; s < L; ++s) {
    ld[s] = INFINITY;
    li[s] = INT_MAX;
  }
}

// Insert (d, i) into the ascending register list; the last entry falls off.
// NaN distances never compare before anything and are dropped.
template <int L>
__device__ __forceinline__ void list_insert(float (&ld)[L], int (&li)[L], float d, int i) {
#pragma unroll
  for (int s = 0; s < L; ++s) {
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

template <int L>
__device__ __forceinline__ void list_pop(float (&ld)[L], int (&li)[L]) {
#pragma unroll
  for (int s = 0; s < L - 1; ++s) {
    ld[s] = ld[s + 1];
    li[s] = li[s + 1];
  }
  ld[L - 1] = INFINITY;
  li[L - 1] = INT_MAX;
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

// --- one query ------------------------------------------------------------------

constexpr int QTHREADS = 512;
constexpr int QWARPS = QTHREADS / 32;
constexpr int QROWS = 2048;            // rows a block takes at most
constexpr int QSMEM = 196608;          // shared memory for its tile at most

struct Query {                         // the query as a launch parameter
  float v[MAX_D];
};

struct Pair {                          // one neighbour as the host reads it
  double dist;
  long long idx;
};

// Rows per block at feature dim d: as many as the tile holds, a multiple of
// 4 (so every block's tile starts on a 16-byte boundary), at most QROWS.
int query_rows(int d) {
  const int r = QSMEM / (4 * d);
  return (r < QROWS ? r : QROWS) / 4 * 4;
}

// The k smallest (d, i) pairs over the block's lists, ascending: each warp
// takes its K best by K warp_min rounds (lane s keeps round s), writes them
// to shared memory, and after one barrier warp 0 merges the QWARPS sorted
// candidate lists the same way.  Returns pair s in lane s of warp 0.
template <int K>
__device__ __forceinline__ void block_topk(float (&ld)[K], int (&li)[K], float& out_d,
                                           int& out_i) {
  __shared__ float cd_s[QWARPS * K];
  __shared__ int ci_s[QWARPS * K];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float my_d = INFINITY;
  int my_i = INT_MAX;
#pragma unroll
  for (int s = 0; s < K; ++s) {
    float d = ld[0];
    int i = li[0];
    warp_min(d, i);
    if (ld[0] == d && li[0] == i) list_pop(ld, li);
    if (lane == s) {
      my_d = d;
      my_i = i;
    }
  }
  if (lane < K) {
    cd_s[warp * K + lane] = my_d;
    ci_s[warp * K + lane] = my_i;
  }
  __syncthreads();
  if (warp != 0) return;
#pragma unroll
  for (int s = 0; s < K; ++s) {
    ld[s] = lane < QWARPS ? cd_s[lane * K + s] : INFINITY;
    li[s] = lane < QWARPS ? ci_s[lane * K + s] : INT_MAX;
  }
#pragma unroll
  for (int s = 0; s < K; ++s) {
    float d = ld[0];
    int i = li[0];
    warp_min(d, i);
    if (ld[0] == d && li[0] == i) list_pop(ld, li);
    if (lane == s) {
      out_d = d;
      out_i = i;
    }
  }
}

// Lane s of warp 0 writes neighbour s: to the host record when there is
// one, else to the distance and index arrays.
__device__ __forceinline__ void write_neighbour(int s, float d2, int i,
                                                float* __restrict__ out_dist,
                                                long long* __restrict__ out_idx,
                                                Pair* out_rec) {
  const float dist = sqrtf(fmaxf(d2, 0.f));
  if (out_rec != nullptr) {
    out_rec[s] = Pair{(double)dist, (long long)i};
  } else {
    out_dist[s] = dist;
    out_idx[s] = i;
  }
}

// Block b takes rows [b * rows, (b + 1) * rows): the query (from `query`
// in device memory, else from the launch parameter q) and the rows into
// shared memory, distances, the block's K best.  With one block the result
// is final; otherwise it goes to part_d/part_i for the merge.  D is the
// feature dim when known at compile time (the main path's 13), 0 to read
// it from d.
template <int K, int D>
__global__ void __launch_bounds__(QTHREADS)
knn_query_kernel(const float* __restrict__ cases, const __grid_constant__ Query q,
                 const float* __restrict__ query, int n, int d, int rows,
                 float* __restrict__ part_d, int* __restrict__ part_i,
                 float* __restrict__ out_dist, long long* __restrict__ out_idx,
                 Pair* out_rec) {
  extern __shared__ __align__(16) float x_s[];
  __shared__ float q_s[MAX_D];
  if (D) d = D;
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * rows;
  const int cnt = min(rows, n - row0);
  for (int c = tid; c < d; c += QTHREADS) q_s[c] = query != nullptr ? query[c] : q.v[c];
  const float* src = cases + static_cast<size_t>(row0) * d;
  const int total = cnt * d;
  int e = tid;
  if ((reinterpret_cast<size_t>(src) & 15) == 0) {
    // 16-byte asynchronous copies, all in flight at once: one latency.
    const int vec = total >> 2;
    for (; e < vec; e += QTHREADS)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                       static_cast<unsigned>(__cvta_generic_to_shared(x_s + 4 * e))),
                   "l"(src + 4 * e));
    asm volatile("cp.async.wait_all;\n" ::);
    e = 4 * vec + tid;
  }
  for (; e < total; e += QTHREADS) x_s[e] = src[e];
  __syncthreads();

  float ld[K];
  int li[K];
  list_init(ld, li);
  for (int r = tid; r < cnt; r += QTHREADS) {
    const float* xv = x_s + r * d;
    float acc = 0.f;
    if (D) {
#pragma unroll
      for (int c = 0; c < D; ++c) {
        const float diff = xv[c] - q_s[c];
        acc = fmaf(diff, diff, acc);
      }
    } else {
      for (int c = 0; c < d; ++c) {
        const float diff = xv[c] - q_s[c];
        acc = fmaf(diff, diff, acc);
      }
    }
    list_insert(ld, li, acc, row0 + r);
  }
  float d2;
  int i;
  block_topk(ld, li, d2, i);
  const int lane = tid & 31;
  if (tid < 32 && lane < K) {
    if (gridDim.x == 1) {
      write_neighbour(lane, d2, i, out_dist, out_idx, out_rec);
    } else {
      part_d[blockIdx.x * K + lane] = d2;
      part_i[blockIdx.x * K + lane] = i;
    }
  }
}

// Past QROWS rows: one block merges the m = blocks x K partial candidates.
template <int K>
__global__ void __launch_bounds__(QTHREADS)
knn_query_merge_kernel(const float* __restrict__ part_d, const int* __restrict__ part_i,
                       int m, float* __restrict__ out_dist,
                       long long* __restrict__ out_idx, Pair* out_rec) {
  float ld[K];
  int li[K];
  list_init(ld, li);
  for (int j = threadIdx.x; j < m; j += QTHREADS) list_insert(ld, li, part_d[j], part_i[j]);
  float d2;
  int i;
  block_topk(ld, li, d2, i);
  const int lane = threadIdx.x & 31;
  if (threadIdx.x < 32 && lane < K) write_neighbour(lane, d2, i, out_dist, out_idx, out_rec);
}

template <int K, int D>
cudaError_t launch_query(const float* cases, const Query& q, const float* query, int n,
                         int d, float* part_d, int* part_i, float* out_dist,
                         long long* out_idx, Pair* out_rec, cudaStream_t s) {
  static bool ready = false;             // the tile's shared memory, set once
  if (!ready) {
    cudaError_t err = cudaFuncSetAttribute(
        knn_query_kernel<K, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, QSMEM);
    if (err != cudaSuccess) return err;
    ready = true;
  }
  const int rows = query_rows(d);
  const int blocks = (n + rows - 1) / rows;
  const size_t smem = static_cast<size_t>(min(rows, n)) * d * sizeof(float);
  knn_query_kernel<K, D><<<blocks, QTHREADS, smem, s>>>(
      cases, q, query, n, d, rows, part_d, part_i, out_dist, out_idx, out_rec);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || blocks == 1) return err;
  knn_query_merge_kernel<K><<<1, QTHREADS, 0, s>>>(part_d, part_i, blocks * K, out_dist,
                                                   out_idx, out_rec);
  return cudaGetLastError();
}

template <int K>
cudaError_t launch_query_k(const float* cases, const Query& q, const float* query, int n,
                           int d, float* part_d, int* part_i, float* out_dist,
                           long long* out_idx, Pair* out_rec, cudaStream_t s) {
  return d == 13 ? launch_query<K, 13>(cases, q, query, n, d, part_d, part_i, out_dist,
                                       out_idx, out_rec, s)
                 : launch_query<K, 0>(cases, q, query, n, d, part_d, part_i, out_dist,
                                      out_idx, out_rec, s);
}

cudaError_t launch_one(const float* cases, const Query& q, const float* query, int n,
                       int d, int k, float* part_d, int* part_i, float* out_dist,
                       long long* out_idx, Pair* out_rec, cudaStream_t s) {
  if (n < 1 || d < 1 || d > MAX_D || k < 1 || k > KMAX || k > n)
    return cudaErrorInvalidValue;
  const int blocks = (n + query_rows(d) - 1) / query_rows(d);
  if (blocks > 1 && (part_d == nullptr || part_i == nullptr)) return cudaErrorInvalidValue;
  switch (k) {
#define KNN_K(K) \
    case K: return launch_query_k<K>(cases, q, query, n, d, part_d, part_i, out_dist, \
                                     out_idx, out_rec, s);
    KNN_K(1) KNN_K(2) KNN_K(3) KNN_K(4) KNN_K(5) KNN_K(6) KNN_K(7) KNN_K(8)
#undef KNN_K
  }
  return cudaErrorInvalidValue;
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

// Blocks of knn_query_kernel for n rows at dim d; the caller sizes the
// partial buffers as blocks * k when this exceeds 1 (the merge runs only
// then).
int knn_topk_blocks(int n, int d) {
  return d < 1 || d > MAX_D ? -1 : (n + query_rows(d) - 1) / query_rows(d);
}

// One query in device memory: cases (n, d) row-major, query (d,) ->
// out_dist (k,) float32, out_idx (k,) int64, ascending.
int knn_topk_f32(const float* cases, const float* query, int n, int d, int k,
                 float* part_d, int* part_i, float* out_dist, long long* out_idx,
                 void* stream) {
  static const Query none{};
  if (query == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_one(cases, none, query, n, d, k, part_d, part_i,
                                     out_dist, out_idx, nullptr,
                                     static_cast<cudaStream_t>(stream)));
}

// One query in host memory, the per-slot lookup: the d floats of query_host
// go to the kernel as its launch parameter, the k (float64 distance, int64
// index) pairs come back into out_rec (the device address of mapped pinned
// host memory), and the call returns once the stream has finished.
int knn_lookup_f32(const float* cases, const float* query_host, int n, int d, int k,
                   float* part_d, int* part_i, void* out_rec, void* stream) {
  if (query_host == nullptr || out_rec == nullptr || d < 1 || d > MAX_D)
    return static_cast<int>(cudaErrorInvalidValue);
  Query q;
  for (int c = 0; c < d; ++c) q.v[c] = query_host[c];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_one(cases, q, nullptr, n, d, k, part_d, part_i, nullptr, nullptr,
                               static_cast<Pair*>(out_rec), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaStreamSynchronize(s));
}

// The device address of pinned host memory (for knn_lookup_f32's record).
int knn_device_pointer(void* host, void** device) {
  return static_cast<int>(cudaHostGetDevicePointer(device, host, 0));
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
