// A hand-written Hopper kernel for the DAG dependency gating of the device
// slot loop (src/repro_torch/core/scan_engine.py): each slot, for every
// cell b of a batch and every row c,
//
//     dec[b, c] = #{predecessors p of row c : fin[b, p]}
//
// the number of row c's predecessors that finished in that slot.  The
// engine subtracts it from c's live in-degree and releases c when that
// reaches zero.
//
// Replaces the TPU kernel of src/repro/kernels/gating.py: _gating_kernel
// (pallas_call at gating.py:90, called via dep_decrement_pallas), and the
// jnp forms the JAX scan engine calls in its place (dep_decrement /
// dep_decrement_gather, scan_engine.py:507-511).  One kernel,
// dep_release_csr_kernel, does both jobs:
//   - given pred, the slot step's release: with dec it computes what the
//     engine does with dec in the same step, pred2 = pred - dec and
//     pending = (dec > 0) & (pred2 == 0) & arrived (the JAX scan engine's
//     jnp ops after its decrement, scan_engine.py:513-514), so one launch
//     is the step's release and dec never reaches memory;
//   - without pred, dec alone (the reference's dep_decrement).
// The Pallas kernel tiles the edge list over a sequential grid whose steps
// all scatter-add into one output block held in VMEM; that relies on the
// grid running in order on one core.  On the H100 blocks run in parallel
// in no order, so the contraction is transposed instead: one thread per
// (cell, row) sums fin over that row's predecessor segment of a CSR by
// child (built once per program on the host and shared by every cell of a
// batch).  No atomics, so the counts are exact and the same on every run,
// and each warp writes 32 neighbouring int32 counts.
//
// What bounds it on an H100: bytes.  The decrement reads fin once (B*n
// bytes), the CSR ((n + 1 + E) index words) and writes dec (4*B*n bytes);
// it does one add per edge and cell.  At the device slot loop's shape for
// one cell (n = 6144 rows, E = 5924 edges, int32 indices) that is ~79 KB, ~24 ns at 3.35 TB/s: a launch costs more than the work.  What
// a slot step pays is the host's dispatch of each launch and eager op
// around it (~10-25 us each), so the release folds the four ops that
// consume dec into the one launch.
// In-degrees are small (at most 4 on the path's traces), so a thread's
// loop is short and fin's gathers hit L1/L2.
//
// Plain C interface (loaded with ctypes); the entry point returns the
// cudaError_t of its launch, 0 on success.  Nothing here allocates or
// synchronises: the caller owns every buffer and the stream.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

// One thread per (cell, row) g: s = the row's finished predecessors; out =
// pred - s and pending as above, or out = s when pred is null (the same for
// the whole launch, so the branch never diverges).
__global__ void __launch_bounds__(THREADS)
dep_release_csr_kernel(const unsigned char* __restrict__ fin,
                       const unsigned char* __restrict__ arrived,
                       const int* __restrict__ pred, const int* __restrict__ ptr,
                       const int* __restrict__ idx, long long total, int n,
                       int* __restrict__ out,
                       unsigned char* __restrict__ pending_out) {
  const long long g = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (g >= total) return;
  const int c = (int)(g % n);
  const unsigned char* f = fin + (g - c);      // this cell's fin row
  const int hi = ptr[c + 1];
  int s = 0;
  for (int j = ptr[c]; j < hi; ++j) s += f[idx[j]] != 0;
  if (!pred) {
    out[g] = s;
    return;
  }
  const int p2 = pred[g] - s;
  out[g] = p2;
  pending_out[g] = s > 0 && p2 == 0 && arrived[g] != 0;
}

}  // namespace

extern "C" {

// fin and arrived (rows, n) uint8/bool, pred (rows, n) int32, row-major;
// ptr (n + 1,) and idx (E,) int32; outputs out (rows, n) int32 (pred2) and
// pending_out (rows, n) bool (0 or 1).  With pred null, arrived and
// pending_out are not read or written and out is dec.
int dep_release_csr(const unsigned char* fin, const unsigned char* arrived,
                    const int* pred, const int* ptr, const int* idx, long long rows,
                    int n, int* out, unsigned char* pending_out, void* stream) {
  const long long total = rows * (long long)n;
  if (total == 0) return 0;
  const unsigned int blocks = (unsigned int)((total + THREADS - 1) / THREADS);
  dep_release_csr_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      fin, arrived, pred, ptr, idx, total, n, out, pending_out);
  return (int)cudaGetLastError();
}

}  // extern "C"
