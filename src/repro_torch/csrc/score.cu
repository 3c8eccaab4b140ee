// Hand-written Hopper kernels for the oracle's score matrix (Algorithm 1,
// lines 2-5): for (job, scale) entries j with marginal throughput marg[j]
// and admissible window [t_start[j], t_end[j]), and slots t with carbon
// intensity ci[t],
//
//     out[j, t] = marg[j] / max(ci[t], 1e-9f)   if t_start[j] <= t < t_end[j]
//               = 0                             otherwise.
//
// Replaces the TPU kernel of src/repro/kernels/score.py:
//   score_matrix  <- _score_kernel (pallas_call at score.py:46, the kernel
//                    body at score.py:22), tiled (256, 128) over a grid
//                    padded to whole tiles.
//
// What bounds it on an H100: bytes.  It reads 12 J + 4 T bytes and writes
// 4 J T, one IEEE division per element (67 TFLOP/s of fp32 is far away): at
// the oracle's shapes (6944 x 168, 6800 x 552) 4.7-15 MB, 1.4-4.5 us at
// 3.35 TB/s; a memset of the same output takes 2.0 and 4.6 us of device
// time on an H100, its launch and ramp included.  The previous kernel
// (score_flat_kernel, PR 14, kept as the yardstick) gives each element a
// thread over the flat index: a 64-bit division g / T (a software routine of
// tens of instructions), four loads and a 4-byte store per element; it is
// bound by its instructions, 0.9-1.2 TB/s.  score_rows_kernel removes the
// per-element index division and stores 16 bytes at a time:
//   - a block owns `bj` whole rows (8, or fewer where that leaves fewer than
//     2 x 132 blocks: kernels/score.py::plan) and 128 threads; thread i
//     takes the row's float4s i, i + 128, ... of the tile, its (row, column)
//     stepped by additions from one division at the start;
//   - T is a multiple of 4, so every row starts on a 16-byte boundary and
//     no float4 straddles two rows: ci[t .. t+3] comes in as one float4, the
//     row's marg, t_start and t_end once per float4 (L1 hits), the window
//     test on 32-bit indices, and the four scores go out as one float4.
// Many small blocks keep the SMs' warps issuing, so the divisions overlap
// the stores.  The tile design of the recommendation (a block computes its
// rows into shared memory, then one thread stores the tile with one bulk
// copy) measured slower than the flat kernel at T = 168: computing a whole
// tile before its one store exposes the division (5.0 us, 2.8 us storing
// zeros); pipelining the tile in 4-row bulk stores gained at T = 552 only.
// score_columns_kernel takes the other shapes (T not a multiple of 4, or
// rows longer than ROW_FLOATS): a block per row and column tile, four
// columns a thread, stored as one float4 from the row's first 16-byte
// boundary, the up to 3 columns before it and after the last whole float4
// by plain stores.
//
// Numerics: the division is __fdiv_rn (IEEE round-to-nearest, as PyTorch's
// and XLA's float32 division), never a reciprocal times marg, and the clamp
// is written so that a NaN intensity stays NaN (as torch.clamp_min keeps
// it), so every kernel equals the plain PyTorch version exactly.
//
// Plain C interface (loaded with ctypes); every entry point returns the
// cudaError_t of its launch, 0 on success.  Nothing here allocates or
// synchronises: the caller owns every buffer and the stream.  The launch
// arithmetic (route, rows a block, grid) comes from kernels/score.py::plan;
// the entries check that it is consistent.

#include <cuda_runtime.h>

namespace {

constexpr int ROW_THREADS = 128;        // the rows kernel: threads
constexpr int ROW_FLOATS = 4096;        // its rows at most
constexpr int COLUMN_THREADS = 256;     // the columns kernel: threads (4 columns each)
constexpr int FLAT_THREADS = 256;       // the previous kernel: threads

__device__ __forceinline__ float score(float marg, float c, int t, int t0, int t1) {
  const float den = c < 1e-9f ? 1e-9f : c;   // max(c, 1e-9f), NaN kept
  return (t >= t0 && t < t1) ? __fdiv_rn(marg, den) : 0.0f;
}

// Block b owns rows [b bj, b bj + bj) (fewer in the last block); T % 4 == 0.
__global__ void __launch_bounds__(ROW_THREADS)
score_rows_kernel(const float* __restrict__ marg, const float* __restrict__ ci,
                  const int* __restrict__ t_start, const int* __restrict__ t_end, int J, int T,
                  int bj, float* __restrict__ out) {
  const int T4 = T >> 2;                    // float4s a row
  const int j0 = blockIdx.x * bj;
  const int total = min(bj, J - j0) * T4;
  int e = threadIdx.x;
  int r = e / T4, c = e - r * T4;           // this thread's first float4: row, column
  const int dr = ROW_THREADS / T4, dc = ROW_THREADS - dr * T4;
  for (; e < total; e += ROW_THREADS) {
    const int t = 4 * c, j = j0 + r;
    const float4 cv = *reinterpret_cast<const float4*>(ci + t);
    const float m = marg[j];
    const int t0 = t_start[j], t1 = t_end[j];
    float4 o;
    o.x = score(m, cv.x, t, t0, t1);
    o.y = score(m, cv.y, t + 1, t0, t1);
    o.z = score(m, cv.z, t + 2, t0, t1);
    o.w = score(m, cv.w, t + 3, t0, t1);
    *reinterpret_cast<float4*>(out + static_cast<size_t>(j) * T + t) = o;
    c += dc;
    r += dr;
    if (c >= T4) {
      c -= T4;
      ++r;
    }
  }
}

// Block (j, y): row j, float4s [y COLUMN_THREADS, (y + 1) COLUMN_THREADS)
// counted from the row's first 16-byte boundary; block (j, 0) also stores
// the columns before that boundary and after the last whole float4.
__global__ void __launch_bounds__(COLUMN_THREADS)
score_columns_kernel(const float* __restrict__ marg, const float* __restrict__ ci,
                     const int* __restrict__ t_start, const int* __restrict__ t_end, int T,
                     float* __restrict__ out) {
  const int j = blockIdx.x;
  const float m = marg[j];
  const int t0 = t_start[j], t1 = t_end[j];
  float* row = out + static_cast<size_t>(j) * T;
  const int head = min(static_cast<int>((16 - (reinterpret_cast<size_t>(row) & 15)) & 15) / 4, T);
  const int vecs = (T - head) / 4;
  const int v = blockIdx.y * COLUMN_THREADS + threadIdx.x;
  if (v < vecs) {
    const int t = head + 4 * v;
    float4 o;
    o.x = score(m, ci[t], t, t0, t1);
    o.y = score(m, ci[t + 1], t + 1, t0, t1);
    o.z = score(m, ci[t + 2], t + 2, t0, t1);
    o.w = score(m, ci[t + 3], t + 3, t0, t1);
    *reinterpret_cast<float4*>(row + t) = o;
  }
  if (blockIdx.y == 0 && threadIdx.x < 8) {
    const int t = threadIdx.x < 4 ? threadIdx.x : head + 4 * vecs + threadIdx.x - 4;
    if (threadIdx.x < 4 ? t < head : t < T) row[t] = score(m, ci[t], t, t0, t1);
  }
}

// The previous kernel (PR 14): one thread per element over the flat index.
__global__ void __launch_bounds__(FLAT_THREADS)
score_flat_kernel(const float* __restrict__ marg, const float* __restrict__ ci,
                  const int* __restrict__ t_start, const int* __restrict__ t_end,
                  long long total, int T, float* __restrict__ out) {
  const long long g = (long long)blockIdx.x * FLAT_THREADS + threadIdx.x;
  if (g >= total) return;
  const int j = (int)(g / T);
  const int t = (int)(g - (long long)j * T);
  out[g] = score(marg[j], ci[t], t, t_start[j], t_end[j]);
}

// Launched as a route's kernel is, doing nothing: what a launch of that
// shape costs the card.
__global__ void score_floor_kernel() {}

bool valid(int J, int T) { return J >= 1 && T >= 1; }

}  // namespace

extern "C" {

// marg (J,) float32, ci (T,) float32, t_start/t_end (J,) int32; out (J, T)
// float32 row-major, ci and out 16-byte aligned.  Rows route (T a multiple
// of 4, at most ROW_FLOATS): `bj` rows a block, `blocks` blocks.
int score_rows(const float* marg, const float* ci, const int* t_start, const int* t_end, int J,
               int T, int bj, int blocks, float* out, void* stream) {
  if (!valid(J, T) || T % 4 != 0 || T > ROW_FLOATS || bj < 1 || blocks != (J + bj - 1) / bj ||
      (reinterpret_cast<size_t>(ci) & 15) != 0 || (reinterpret_cast<size_t>(out) & 15) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  score_rows_kernel<<<blocks, ROW_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      marg, ci, t_start, t_end, J, T, bj, out);
  return static_cast<int>(cudaGetLastError());
}

// Columns route: a grid of J x `tiles` blocks of COLUMN_THREADS, tiles of
// 4 COLUMN_THREADS columns covering each row's whole float4s.
int score_columns(const float* marg, const float* ci, const int* t_start, const int* t_end,
                  int J, int T, int tiles, float* out, void* stream) {
  if (!valid(J, T) || tiles < 1 || tiles > 65535 ||
      static_cast<long long>(tiles) * 4 * COLUMN_THREADS < T - 3)
    return static_cast<int>(cudaErrorInvalidValue);
  score_columns_kernel<<<dim3(J, tiles), COLUMN_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      marg, ci, t_start, t_end, T, out);
  return static_cast<int>(cudaGetLastError());
}

// The previous kernel: `blocks` blocks of FLAT_THREADS over the J T elements.
int score_flat(const float* marg, const float* ci, const int* t_start, const int* t_end, int J,
               int T, long long blocks, float* out, void* stream) {
  const long long total = (long long)J * T;
  if (!valid(J, T) || blocks != (total + FLAT_THREADS - 1) / FLAT_THREADS ||
      blocks > 2147483647ll)
    return static_cast<int>(cudaErrorInvalidValue);
  score_flat_kernel<<<(unsigned int)blocks, FLAT_THREADS, 0, (cudaStream_t)stream>>>(
      marg, ci, t_start, t_end, total, T, out);
  return static_cast<int>(cudaGetLastError());
}

// An empty kernel on a grid of blocks_x x blocks_y blocks of `threads`.
int score_floor(int blocks_x, int blocks_y, int threads, void* stream) {
  if (blocks_x < 1 || blocks_y < 1 || blocks_y > 65535 || threads < 1 || threads > 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  score_floor_kernel<<<dim3(blocks_x, blocks_y), threads, 0,
                       static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
