// Hand-written Hopper kernel for the greedy pass of the offline oracle
// (Algorithm 1, src/repro_torch/core/oracle.py, backend="device"): walk the
// pre-sorted (job, slot, scale) entries in order and take each one that
//
//     work[j] < len[j] - 1e-9f                       (job j not yet done)
//     && alloc[j, t] == (k == kmin[j] ? 0 : k - 1)   (incremental consistency)
//     && used[t] + add <= capacity                   (add = kmin[j] or 1)
//
// setting alloc[j, t] = k, used[t] += add, work[j] += (k == kmin[j] ? 1 : g).
//
// Replaces no Pallas kernel: it is the counterpart of the JAX package's
// jitted lax.fori_loop pass, _greedy_jax (src/repro/core/oracle.py:177),
// with the same int32 indices, int32 alloc/used and float32 work and
// lengths, so its results equal that pass bit for bit.
//
// What bounds it on an H100: neither bytes nor operations but the serial
// chain.  Entry i reads what entry i-1 wrote, so one thread walks the
// entries in order, one dependent chain of loads and compares per entry.
// The design shortens each link: used, kmin, the thresholds len - 1e-9f and
// work live in shared memory; the other warps stage the next batch of
// entries into shared memory while warp 0's first lane walks the current
// one, so the walker never waits on device memory for an entry; only
// alloc (n x horizon int32, up to ~1 MB on the oracle's paths) stays in
// device memory, where it sits in L2.  Once every job is done, every later
// entry fails its first test, so the walk stops there: the results are
// identical, and the number of entries walked comes back to the caller.
//
// Numerics: the add and the threshold are __fadd_rn / __fsub_rn, IEEE
// round-to-nearest, never contracted or approximated (the build has no
// --use_fast_math).
//
// Plain C interface (loaded with ctypes); the entry point returns the
// cudaError_t of its launch, 0 on success.  Nothing here allocates or
// synchronises: the caller owns every buffer and the stream.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;      // warp 0 walks (lane 0), warps 1..7 stage
constexpr int STAGERS = THREADS - 32;
constexpr int STAGE = 2048;       // entries per staged batch (32 KB)
constexpr int SMEM_MAX = 232448 - 64;  // a block's shared memory, less the statics

struct Stage {
  int j[STAGE];
  int t[STAGE];
  int k[STAGE];
  float g[STAGE];
};

constexpr int STATE_OFFSET = 2 * (int)sizeof(Stage);

__global__ void __launch_bounds__(THREADS)
greedy_pass_kernel(const int* __restrict__ j_idx, const int* __restrict__ t_idx,
                   const int* __restrict__ k_val, const float* __restrict__ gain,
                   const int* __restrict__ kmin, const float* __restrict__ lengths,
                   int n_entries, int n, int horizon, int capacity,
                   int* alloc, int* __restrict__ used_out,
                   float* __restrict__ work_out, int* __restrict__ walked_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  Stage* stage = reinterpret_cast<Stage*>(smem);
  int* s_used = reinterpret_cast<int*>(smem + STATE_OFFSET);   // [horizon]
  int* s_kmin = s_used + horizon;                              // [n]
  float* s_thr = reinterpret_cast<float*>(s_kmin + n);         // [n]
  float* s_work = s_thr + n;                                   // [n]
  __shared__ int s_unfinished;
  __shared__ int s_walked;                   // < 0: entry -1 - s_walked is bad

  const int tid = threadIdx.x;
  if (tid == 0) {
    s_unfinished = 0;
    s_walked = 0;
  }
  const long long cells = (long long)n * horizon;
  for (long long c = tid; c < cells; c += THREADS) alloc[c] = 0;
  for (int t = tid; t < horizon; t += THREADS) s_used[t] = 0;
  int mine = 0;
  for (int j = tid; j < n; j += THREADS) {
    const float thr = __fsub_rn(lengths[j], 1e-9f);
    s_kmin[j] = kmin[j];
    s_thr[j] = thr;
    s_work[j] = 0.0f;
    mine += 0.0f < thr;
  }
  __syncthreads();
  if (mine) atomicAdd(&s_unfinished, mine);
  for (int i = tid; i < min(STAGE, n_entries); i += THREADS) {
    stage[0].j[i] = j_idx[i];
    stage[0].t[i] = t_idx[i];
    stage[0].k[i] = k_val[i];
    stage[0].g[i] = gain[i];
  }
  __syncthreads();

  const int batches = (n_entries + STAGE - 1) / STAGE;
  for (int b = 0; b < batches; ++b) {
    if (s_unfinished == 0 || s_walked < 0) break;    // uniform: read after a barrier
    const int lo = b * STAGE;
    if (tid == 0) {
      const Stage& s = stage[b & 1];
      const int cnt = min(STAGE, n_entries - lo);
      int unfinished = s_unfinished;
      int walked = lo + cnt;
      for (int i = 0; i < cnt; ++i) {
        const int j = s.j[i];
        const int t = s.t[i];
        if ((unsigned)j >= (unsigned)n || (unsigned)t >= (unsigned)horizon) {
          walked = -1 - (lo + i);
          break;
        }
        const float w = s_work[j];
        const float thr = s_thr[j];
        if (!(w < thr)) continue;                    // job already done
        const int k = s.k[i];
        const int km = s_kmin[j];
        const bool base = k == km;
        int* a = alloc + (long long)j * horizon + t;
        if (*a != (base ? 0 : k - 1)) continue;      // incremental consistency
        const int add = base ? km : 1;
        if (s_used[t] + add > capacity) continue;    // capacity exceeded
        *a = k;
        s_used[t] += add;
        const float nw = __fadd_rn(w, base ? 1.0f : s.g[i]);
        s_work[j] = nw;
        if (!(nw < thr) && --unfinished == 0) {
          walked = lo + i + 1;                       // every job done
          break;
        }
      }
      s_unfinished = unfinished;
      s_walked = walked;
    } else if (tid >= 32 && b + 1 < batches) {
      Stage& s = stage[(b + 1) & 1];
      const int nlo = lo + STAGE;
      const int cnt = min(STAGE, n_entries - nlo);
      for (int i = tid - 32; i < cnt; i += STAGERS) {
        s.j[i] = j_idx[nlo + i];
        s.t[i] = t_idx[nlo + i];
        s.k[i] = k_val[nlo + i];
        s.g[i] = gain[nlo + i];
      }
    }
    __syncthreads();
  }

  for (int t = tid; t < horizon; t += THREADS) used_out[t] = s_used[t];
  for (int j = tid; j < n; j += THREADS) work_out[j] = s_work[j];
  if (tid == 0) walked_out[0] = s_walked;
}

}  // namespace

extern "C" {

// The largest horizon + 3 * n the shared-memory state can hold.
int greedy_pass_max_state() { return (SMEM_MAX - STATE_OFFSET) / 4; }

// j_idx, t_idx, k_val (E,) int32 and gain (E,) float32 in greedy order;
// kmin (n,) int32 and lengths (n,) float32; outputs alloc (n, horizon)
// int32 row-major, used (horizon,) int32, work (n,) float32 and walked (1,)
// int32: the entries walked before every job was done (E if some job never
// was), or -1 - i when entry i holds an index out of range.
int greedy_pass(const int* j_idx, const int* t_idx, const int* k_val,
                const float* gain, const int* kmin, const float* lengths,
                int n_entries, int n, int horizon, int capacity, int* alloc,
                int* used, float* work, int* walked, void* stream) {
  if (horizon + 3LL * n > greedy_pass_max_state()) return (int)cudaErrorInvalidValue;
  const int smem = STATE_OFFSET + 4 * (horizon + 3 * n);
  cudaError_t err = cudaFuncSetAttribute(
      greedy_pass_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  greedy_pass_kernel<<<1, THREADS, smem, (cudaStream_t)stream>>>(
      j_idx, t_idx, k_val, gain, kmin, lengths, n_entries, n, horizon,
      capacity, alloc, used, work, walked);
  return (int)cudaGetLastError();
}

}  // extern "C"
