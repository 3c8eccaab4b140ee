// Hand-written Hopper kernel for the oracle's score matrix (Algorithm 1,
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
// Here one thread computes one output element over the flat (J, T) index,
// so no padding is needed and any J, T works; the row's three scalars hit
// L1 across a warp and ci[t] is read coalesced.
//
// What bounds it on an H100: bytes.  It reads 12 J + 4 T bytes and writes
// 4 J T, one IEEE division per element (67 TFLOP/s of fp32 is far away):
// at the oracle's shapes (a few thousand pairs x 168..552 slots) a few MB,
// a few microseconds at 3.35 TB/s, so a launch costs about as much.
//
// Numerics: the division is __fdiv_rn (IEEE round-to-nearest, as PyTorch's
// and XLA's float32 division), the clamp propagates a NaN as max does, so
// the kernel equals the plain PyTorch version exactly.
//
// Plain C interface (loaded with ctypes); the entry point returns the
// cudaError_t of its launch, 0 on success.  Nothing here allocates or
// synchronises: the caller owns every buffer and the stream.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
score_matrix_kernel(const float* __restrict__ marg, const float* __restrict__ ci,
                    const int* __restrict__ t_start, const int* __restrict__ t_end,
                    long long total, int T, float* __restrict__ out) {
  const long long g = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (g >= total) return;
  const int j = (int)(g / T);
  const int t = (int)(g - (long long)j * T);
  const float c = ci[t];
  const float d = c < 1e-9f ? 1e-9f : c;
  out[g] = (t >= t_start[j] && t < t_end[j]) ? __fdiv_rn(marg[j], d) : 0.0f;
}

}  // namespace

extern "C" {

// marg (J,) float32, ci (T,) float32, t_start/t_end (J,) int32; out (J, T)
// float32 row-major.
int score_matrix(const float* marg, const float* ci, const int* t_start,
                 const int* t_end, int J, int T, float* out, void* stream) {
  const long long total = (long long)J * T;
  if (total == 0) return 0;
  const unsigned int blocks = (unsigned int)((total + THREADS - 1) / THREADS);
  score_matrix_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      marg, ci, t_start, t_end, total, T, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
