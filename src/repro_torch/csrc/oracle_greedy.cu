// Hand-written Hopper kernels for the greedy pass of the offline oracle
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
// chain.  Entry i reads what entry i-1 wrote, so warp 0 walks the entries
// in order while warps 1..7 stage the next batch of STAGE entries into
// shared memory; one barrier per batch.  The entries arrive packed, one
// int4 (j, t, k, bits of the float32 gain) each.
//
// Two walkers, chosen by shape (kernels/oracle_greedy.py::plan):
//
// - greedy_smem_kernel ("smem"): the whole state in shared memory: alloc as
//   uint8 (scales up to 255), per-job (threshold, work) as one float2, used.
//   alloc[j, t] is only ever read or written for t in job j's admissible
//   window [t0_j, t1_j) (the oracle builds entries only there), so alloc is
//   laid out by job window: job j's cells sit at b_j + t, b_j = off_j - t0_j,
//   off_j the exclusive prefix sum of the widths, sum_j (t1_j - t0_j) bytes
//   in all (without windows every job's window is the whole horizon).  A
//   552-slot oracle span of ~425 jobs then needs ~14 KB instead of ~234 KB.
//   An entry outside its job's window is a bad entry, as one out of range.
//   The stagers turn each entry into a 16-byte record of everything that
//   does not depend on the walk (the alloc cell, j and t, k, add, the
//   expected previous value, the gain to add), so the walk never reads
//   kmin.  Most entries are not taken (a learning window takes ~2 % of
//   them), and a serial loop pays its whole per-iteration latency for each
//   of them.  So warp 0 decides 32 entries at once, each lane on the state
//   as the round found it; only the entries that are taken go through a
//   serial commit, which every lane applies to its own copy of the state
//   before it decides again (see the walker).  alloc is written back to the
//   int32 output once, at the end.
// - greedy_pass_kernel ("l2"): a serial walker (lane 0 of warp 0 walks),
//   for shapes whose alloc does not fit beside the stages even laid out by
//   window: used, kmin, thresholds and work in shared memory, alloc (int32,
//   dense) in device memory, where it sits in L2, read and written in the
//   middle of the chain.  Given windows, its stagers turn an entry outside
//   its job's window into a bad one, so both walkers report the same.
//
// Once every job is done, every later entry fails its first test, so both
// walks stop there: the results are identical, and the number of entries
// walked comes back to the caller.
//
// Numerics: the add and the threshold are __fadd_rn / __fsub_rn, IEEE
// round-to-nearest, never contracted or approximated (the build has no
// --use_fast_math).
//
// Plain C interface (loaded with ctypes); the entry point returns the
// cudaError_t of its launch, 0 on success.  Nothing here allocates or
// synchronises: the caller owns every buffer and the stream.

#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int THREADS = 256;      // warp 0 walks (lane 0), warps 1..7 stage
constexpr int STAGERS = THREADS - 32;
constexpr int STAGE = 2048;       // entries per staged batch
constexpr int SMEM_MAX = 232448 - 64;  // a block's shared memory, less the statics
constexpr int ROUTE_SMEM = 0;
constexpr int ROUTE_L2 = 1;
constexpr int SCALE_MAX = 255;    // the largest scale a uint8 alloc holds

// --- "l2": alloc in device memory ---------------------------------------------

struct Stage {
  int j[STAGE];
  int t[STAGE];
  int k[STAGE];
  float g[STAGE];
};

constexpr int L2_STATE_OFFSET = 2 * (int)sizeof(Stage);

// Job j's window [t0, t1) clamped to 0 <= t0 <= t1 <= horizon (the whole
// horizon without windows), packed as t0 | t1 << 16 (no route's state fits a
// block at 2^16 slots or more).
__device__ __forceinline__ unsigned job_window(const int* __restrict__ windows, int j,
                                               int horizon) {
  if (!windows) return (unsigned)horizon << 16;
  const int t0 = min(max(windows[2 * j], 0), horizon);
  const int t1 = min(max(windows[2 * j + 1], t0), horizon);
  return (unsigned)t0 | (unsigned)t1 << 16;
}

__device__ __forceinline__ bool in_window(unsigned w, int t) {
  return t >= (int)(w & 0xFFFF) && t < (int)(w >> 16);
}

__device__ __forceinline__ void stage_l2(Stage& s, const int4* __restrict__ e,
                                         int cnt, int first, int stride,
                                         const int* __restrict__ windows, int n,
                                         int horizon) {
  for (int i = first; i < cnt; i += stride) {
    const int4 v = e[i];
    const bool outside = windows && (unsigned)v.x < (unsigned)n &&
                         !in_window(job_window(windows, v.x, horizon), v.y);
    s.j[i] = outside ? -1 : v.x;                 // -1: a bad entry
    s.t[i] = v.y;
    s.k[i] = v.z;
    s.g[i] = __int_as_float(v.w);
  }
}

__global__ void __launch_bounds__(THREADS)
greedy_pass_kernel(const int4* __restrict__ entries, const int* __restrict__ kmin,
                   const float* __restrict__ lengths, const int* __restrict__ windows,
                   int n_entries, int n, int horizon, int capacity, int /*cells*/,
                   int* alloc, int* __restrict__ used_out,
                   float* __restrict__ work_out, int* __restrict__ walked_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  Stage* stage = reinterpret_cast<Stage*>(smem);
  int* s_used = reinterpret_cast<int*>(smem + L2_STATE_OFFSET);  // [horizon]
  int* s_kmin = s_used + horizon;                                // [n]
  float* s_thr = reinterpret_cast<float*>(s_kmin + n);           // [n]
  float* s_work = s_thr + n;                                     // [n]
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
  stage_l2(stage[0], entries, min(STAGE, n_entries), tid, THREADS, windows, n, horizon);
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
      const int nlo = lo + STAGE;
      stage_l2(stage[(b + 1) & 1], entries + nlo, min(STAGE, n_entries - nlo),
               tid - 32, STAGERS, windows, n, horizon);
    }
    __syncthreads();
  }

  for (int t = tid; t < horizon; t += THREADS) used_out[t] = s_used[t];
  for (int j = tid; j < n; j += THREADS) work_out[j] = s_work[j];
  if (tid == 0) walked_out[0] = s_walked;
}

// --- "smem": the whole state in shared memory ---------------------------------

// One staged record (int4): x = the alloc cell b_j + t, or INT_MIN when the entry is bad (then y = z = 0, a
// safe address); y = j | t << 16; z = k | add << 8 | prev << 16 (prev
// signed: a non-base entry of scale 0 expects -1, which no cell holds); w =
// the bits of the float32 added to work when the entry is taken (1.0f for a
// base entry).
constexpr int SMEM_STAGE_BYTES = 2 * STAGE * 16;
constexpr unsigned FULL = 0xffffffffu;

__host__ __device__ constexpr int round16(long long x) { return (int)((x + 15) / 16 * 16); }

// Shared memory of the smem route: two record stages, float2 (threshold,
// work), kmin, the base b_j and the packed window per job, used per slot,
// and the uint8 alloc laid out by window (cells bytes, at least one: a bad
// entry's speculative read lands on byte 0).  It fits a block only below
// 2^16 slots, so t fits the 16 bits records and windows give it.
__host__ __device__ constexpr long long smem_route_bytes(int n, int horizon,
                                                         long long cells) {
  return (long long)SMEM_STAGE_BYTES + 20LL * n + 4LL * horizon +
         round16(cells > 0 ? cells : 1);
}

// The per-job layout read by the stagers: kmin, the base b_j and the packed
// window.
struct Jobs {
  const int* kmin;
  const int* base;
  const unsigned* window;
};

__device__ __forceinline__ int4 make_record(int4 e, Jobs s, int n, int horizon) {
  const int j = e.x, t = e.y, k = e.z;
  if ((unsigned)j >= (unsigned)n || (unsigned)t >= (unsigned)horizon ||
      (unsigned)k > (unsigned)SCALE_MAX || !in_window(s.window[j], t))
    return make_int4(INT_MIN, 0, 0, 0);
  const int km = s.kmin[j];
  const bool base = k == km;
  const int add = base ? km : 1;                   // <= k <= 255 when base
  const unsigned prev = base ? 0u : (unsigned)(k - 1);
  return make_int4(s.base[j] + t,
                   (int)((unsigned)j | (unsigned)t << 16),
                   (int)((unsigned)k | (unsigned)add << 8 | prev << 16),
                   base ? __float_as_int(1.0f) : e.w);
}

__device__ __forceinline__ void stage_records(int4* rec, const int4* __restrict__ e,
                                              int cnt, int first, int stride, Jobs s,
                                              int n, int horizon) {
  for (int i = first; i < cnt; i += stride)
    rec[i] = make_record(e[i], s, n, horizon);
}

// The window layout, by all THREADS threads: each takes a run of jobs, the
// runs' widths are scanned across the block, and each job gets its base
// and packed window.  A job whose cells would pass `cells` (the bytes the
// caller sized) gets an empty window, so nothing is written past them and
// its entries become bad ones.
__device__ void layout_windows(const int* __restrict__ windows, int n, int horizon,
                               int cells, int* s_base, unsigned* s_window) {
  __shared__ int s_part[THREADS / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int per = (n + THREADS - 1) / THREADS;
  const int lo = min(n, tid * per), hi = min(n, lo + per);
  int sum = 0;
  for (int j = lo; j < hi; ++j) {
    const unsigned w = job_window(windows, j, horizon);
    sum += (int)(w >> 16) - (int)(w & 0xFFFF);
  }
  int scan = sum;                                  // inclusive, within the warp
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(FULL, scan, d);
    if (lane >= d) scan += v;
  }
  if (lane == 31) s_part[warp] = scan;
  __syncthreads();
  int off = scan - sum;
  for (int w = 0; w < warp; ++w) off += s_part[w];
  for (int j = lo; j < hi; ++j) {
    const unsigned w = job_window(windows, j, horizon);
    const int t0 = (int)(w & 0xFFFF), width = (int)(w >> 16) - t0;
    const bool fits = off + width <= cells;
    s_base[j] = off - t0;
    s_window[j] = fits ? w : (unsigned)t0 | (unsigned)t0 << 16;
    off += width;
  }
}

// Lanes above q.
__device__ __forceinline__ unsigned above(int q) { return q >= 31 ? 0u : FULL << (q + 1); }

__global__ void __launch_bounds__(THREADS)
greedy_smem_kernel(const int4* __restrict__ entries, const int* __restrict__ kmin,
                   const float* __restrict__ lengths, const int* __restrict__ windows,
                   int n_entries, int n, int horizon, int capacity, int cells,
                   int* __restrict__ alloc_out, int* __restrict__ used_out,
                   float* __restrict__ work_out, int* __restrict__ walked_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  int4* stage = reinterpret_cast<int4*>(smem);                   // 2 x STAGE records
  float2* s_job = reinterpret_cast<float2*>(smem + SMEM_STAGE_BYTES);  // [n] (thr, work)
  int* s_kmin = reinterpret_cast<int*>(s_job + n);               // [n]
  int* s_base = s_kmin + n;                                      // [n]
  unsigned* s_window = reinterpret_cast<unsigned*>(s_base + n);  // [n]
  int* s_used = reinterpret_cast<int*>(s_window + n);            // [horizon]
  unsigned char* s_alloc = reinterpret_cast<unsigned char*>(s_used + horizon);
  __shared__ int s_unfinished;
  __shared__ int s_walked;                   // < 0: entry -1 - s_walked is bad

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  if (tid == 0) {
    s_unfinished = 0;
    s_walked = 0;
  }
  layout_windows(windows, n, horizon, cells, s_base, s_window);
  const int alloc_bytes = round16(cells > 0 ? cells : 1);
  for (int c = tid; c < alloc_bytes / 4; c += THREADS)
    reinterpret_cast<int*>(s_alloc)[c] = 0;
  for (int t = tid; t < horizon; t += THREADS) s_used[t] = 0;
  int mine = 0;
  for (int j = tid; j < n; j += THREADS) {
    const float thr = __fsub_rn(lengths[j], 1e-9f);
    s_kmin[j] = kmin[j];
    s_job[j] = make_float2(thr, 0.0f);
    mine += 0.0f < thr;
  }
  __syncthreads();
  if (mine) atomicAdd(&s_unfinished, mine);
  const Jobs jobs{s_kmin, s_base, s_window};
  stage_records(stage, entries, min(STAGE, n_entries), tid, THREADS, jobs, n,
                        horizon);
  __syncthreads();

  const int batches = (n_entries + STAGE - 1) / STAGE;
  for (int b = 0; b < batches; ++b) {
    if (s_unfinished == 0 || s_walked < 0) break;    // uniform: read after a barrier
    const int lo = b * STAGE;
    if (tid < 32) {
      // Warp 0 walks in rounds of 32 entries, one per lane; each lane loads
      // its entry's state as the round finds it.  The first entry of the
      // round that its lane would take (or that is bad) is where the serial
      // pass first writes: every entry before it fails a test on a state
      // nothing changed.  That entry is committed; every lane then applies
      // the commit to its own copy of the state (the work of the job, the
      // cell, the used count of the slot), decides again, and the next
      // entry to take is found the same way.  So only the entries that are
      // taken stand on the serial chain.
      const int4* rec = stage + (b & 1) * STAGE;
      const int cnt = min(STAGE, n_entries - lo);
      int unfinished = s_unfinished;
      int walked = lo + cnt;
      for (int pos = 0; pos < cnt; pos += 32) {
        const bool live = pos + lane < cnt;
        const int4 r = live ? rec[pos + lane] : make_int4(0, 0, 0, 0);
        const int j = r.y & 0xFFFF;
        const int t = (unsigned)r.y >> 16;
        const float2 js = s_job[j];
        float w = js.y;
        int a = s_alloc[r.x & INT_MAX];
        int u = s_used[t];
        const int add = (r.z >> 8) & 0xFF;
        const int prev = r.z >> 16;
        const bool bad = live && r.x < 0;
        const bool ok = live && !bad;
        const unsigned bads = __ballot_sync(FULL, bad);
        unsigned from = FULL;
        bool stop = false;
        for (;;) {
          const bool take = ok && w < js.x && a == prev && u <= capacity - add;
          const unsigned takes = __ballot_sync(FULL, take);
          const unsigned cand = (takes | bads) & from;
          if (!cand) break;
          const int q = __ffs(cand) - 1;
          if (!(takes >> q & 1)) {                     // a bad entry
            walked = -1 - (lo + pos + q);
            stop = true;
            break;
          }
          const float nw = __fadd_rn(w, __int_as_float(r.w));
          const int nu = u + add;
          if (lane == q) {
            s_alloc[r.x] = (unsigned char)(r.z & 0xFF);
            s_used[t] = nu;
            s_job[j].y = nw;
          }
          const int jtq = __shfl_sync(FULL, r.y, q);
          const int kq = __shfl_sync(FULL, r.z & 0xFF, q);
          const int nuq = __shfl_sync(FULL, nu, q);
          const float nwq = __shfl_sync(FULL, nw, q);
          const int done = __shfl_sync(FULL, (int)!(nw < js.x), q);
          if (j == (jtq & 0xFFFF)) w = nwq;
          if (r.y == jtq) a = kq;
          if (t == (int)((unsigned)jtq >> 16)) u = nuq;
          if (done && --unfinished == 0) {
            walked = lo + pos + q + 1;                 // every job done
            stop = true;
            break;
          }
          from = above(q);
        }
        __syncwarp();                                  // commits seen by the next round
        if (stop) break;
      }
      if (lane == 0) {
        s_unfinished = unfinished;
        s_walked = walked;
      }
    } else if (b + 1 < batches) {
      const int nlo = lo + STAGE;
      stage_records(stage + ((b + 1) & 1) * STAGE, entries + nlo,
                            min(STAGE, n_entries - nlo), tid - 32, STAGERS, jobs, n,
                            horizon);
    }
    __syncthreads();
  }

  // alloc back to the dense int32 output, one row per warp, 0 outside the
  // job's window.
  for (int j = tid >> 5; j < n; j += THREADS / 32) {
    const unsigned win = s_window[j];
    const unsigned char* src = s_alloc + s_base[j];
    int* row = alloc_out + (long long)j * horizon;
    for (int t = lane; t < horizon; t += 32) {
      int v = 0;
      if (in_window(win, t)) v = src[t];
      row[t] = v;
    }
  }
  for (int t = tid; t < horizon; t += THREADS) used_out[t] = s_used[t];
  for (int j = tid; j < n; j += THREADS) work_out[j] = s_job[j].y;
  if (tid == 0) walked_out[0] = s_walked;
}

}  // namespace

extern "C" {

int greedy_stage() { return STAGE; }
int greedy_smem_max() { return SMEM_MAX; }

// Dynamic shared memory a route needs for n jobs x horizon slots (on the
// smem route with alloc laid out by window in cells bytes), or -1 when it
// does not fit a block.
int greedy_smem_bytes(int route, int n, int horizon, long long cells) {
  const long long bytes = route == ROUTE_SMEM
      ? smem_route_bytes(n, horizon, cells)
      : (long long)L2_STATE_OFFSET + 4LL * (horizon + 3LL * n);
  return bytes <= SMEM_MAX && n >= 0 && horizon > 0 && cells >= 0 ? (int)bytes : -1;
}

// entries (E, 4) int32 rows (j, t, k, bits of the float32 gain) in greedy
// order, 16-byte aligned; kmin (n,) int32 and lengths (n,) float32;
// windows (n, 2) int32 rows (t0, t1), each job's admissible window, or
// null (every job's window the whole horizon), with cells the sum of their
// clamped widths (n * horizon without windows); outputs alloc (n, horizon)
// int32 row-major (0 outside each window), used (horizon,) int32, work (n,)
// float32 and walked (1,) int32: the entries walked before every job was done (E if
// some job never was), or -1 - i when entry i holds an index out of range
// or a slot outside its job's window (on the smem route also a scale
// outside 0..255).  route 0 is "smem", 1 "l2".
int greedy_pass(int route, const int* entries, const int* kmin, const float* lengths,
                const int* windows, int n_entries, int n, int horizon, int capacity,
                long long cells, int* alloc, int* used, float* work, int* walked,
                void* stream) {
  if (route != ROUTE_SMEM && route != ROUTE_L2) return (int)cudaErrorInvalidValue;
  const int smem = greedy_smem_bytes(route, n, horizon, cells);
  if (smem < 0 || n_entries < 0 || (reinterpret_cast<size_t>(entries) & 15))
    return (int)cudaErrorInvalidValue;
  auto kernel = route == ROUTE_L2 ? greedy_pass_kernel : greedy_smem_kernel;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<1, THREADS, smem, (cudaStream_t)stream>>>(
      reinterpret_cast<const int4*>(entries), kmin, lengths, windows, n_entries, n,
      horizon, capacity, route == ROUTE_SMEM ? (int)cells : 0, alloc, used, work, walked);
  return (int)cudaGetLastError();
}

}  // extern "C"
