// A hand-written Hopper kernel for the placement and capacity walk of the
// geo-distributed slot loop (src/repro_torch/core/scan_engine.py, the geo
// program): each slot, for every cell b of a batch, resolve what the cell's
// geo policy (geo-static, geo-greedy or geo-flex) decides for its candidate
// rows, in FCFS order (the forced candidates by row, then the unforced ones
// by row), exactly as the reference's sequential walk does:
//
//   - a started row may migrate (suspend, move to the region `best`, charge
//     the move) when moving beats staying by the policy's margin;
//   - a row that has never run and has no region yet is placed in the first
//     region of its preference order with room (geo-greedy: the slot's CI
//     order; geo-flex: the row's mean forecast over its estimated run);
//   - a row runs at k_min in its region when that region still has room
//     (geo-flex: and the slot is among the region's cleanest, or the row is
//     forced), and `used[region] += k_min`.
//
// Replaces no Pallas kernel: the JAX scan engine resolves the step with
// `_geo_resolve_walk`, a lax.scan over every row in key order, or with
// `_geo_resolve_uniform`, a fill-key fixpoint under a lax.while_loop whose
// rounds depend on the data (src/repro/core/scan_engine.py:751-1002); the
// reference pins the two as bit-identical.  The fixpoint is the TPU's way
// around a serial scan; here one warp walks instead, for uniform and mixed
// k_min alike.
//
// Design.  One block per cell.  Phase 1, all threads, one row at a time:
// copy the row's state to the outputs, and for a started candidate compute
// the migration rule, which reads only the row (its region is fixed once it
// has started): `can`, `stay`, `move` per region, `best`, `do_mig`.  A
// migrating row is finished there.  Each 32-row chunk records the ballot of
// its forced and of its unforced candidates that did not migrate.  Phase 2,
// warp 0 walks those chunks, forced pass first: each lane loads its row and
// (geo-flex) sorts its own preference order in registers, then the lanes
// take turns in row order to decide placement and fit against `used` in
// shared memory and write the row's results.
//
// Exactness.  The host policies compute in separate IEEE float64
// operations (src/repro/core/geo.py:156-165, :248-259); nvcc would contract
// `a*b + c` into one fma, so every product and sum of the migration rule is
// written with __dmul_rn / __dadd_rn: `e_run = ec * h`, `stay = ci * e_run`
// (geo-flex: `means[r, hi] * e_run`), `move = ci * e_run + mig_e * ci` and
// `stay * margin_c`.  `h = max(1, ceil(rem))` is float64; geo-flex clips
// `hp` to the lookahead and gates its migration on
// `hm = min(lookahead - mig_slots, max(1, ceil(rem))) >= 1`.  Argmin ties
// take the first region, with move = +inf at the row's own region; the
// preference order is a stable sort, so equal means keep the lower index.
// geo-flex places a newly placed row even when the slot is not eligible to
// run it (placement does not depend on eligibility).  Rows that are not
// candidates leave every output as it was.  `thresh_eps` carries the
// policy's +1e-9: the test is `ci_now[r] <= thresh_eps[r]`.
//
// What bounds it on an H100: neither bytes nor operations.  It reads ~70
// bytes a row (flags, remaining, slack, regions, counters and the row
// constants) and writes ~35, and the slot's tables (R regions x lookahead
// means, one block per migration length): tens of KB a call.  The walk is
// serial within a cell, a few dependent shared-memory reads per candidate,
// so its time is latency and the launch.
//
// Plain C interface (loaded with ctypes); each entry point returns the
// cudaError_t of its launch, 0 on success.  Nothing here allocates or
// synchronises: the caller owns every buffer and the stream.

#include <cuda_runtime.h>

#include <math.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_REGIONS = 16;
constexpr unsigned int FULL = 0xffffffffu;
constexpr int STATIC = 0, GREEDY = 1, FLEX = 2;

}  // namespace

// Every pointer is row-major and contiguous: row arrays (cells, n), the
// per-cell arrays (cells, regions) or (cells,), means (cells, regions,
// lookahead), movemeans (cells, mig_vals, regions, lookahead).  Flags are
// bytes (0 or 1).  The tables a kind does not read may be null.
struct GeoArgs {
  const unsigned char* cand;
  const unsigned char* forced;
  const double* rem;
  const long long* slack;
  const unsigned char* started;
  const unsigned char* placed;
  const long long* pol_region;
  const long long* eng_region;
  const long long* mig_left;
  const long long* moves;
  const long long* kmin;
  const double* ec;
  const double* mig_e;
  const long long* mig_slots;
  const long long* mig_idx;
  const long long* caps;
  const double* margin_c;
  const long long* max_moves;
  const double* ci_now;
  const long long* clean_order;
  const double* thresh_eps;
  const double* means;
  const double* movemeans;
  unsigned char* take;
  unsigned char* placed_out;
  long long* pol_out;
  long long* eng_out;
  long long* mig_left_out;
  long long* moves_out;
  unsigned char* mig_now;
  long long cells;
  int n;
  int regions;
  int lookahead;
  int mig_vals;
  int kind;
};

namespace {

// Phase 1's migration rule for a started candidate row in region `r`:
// true (and `best`) when the row moves.
__device__ bool migrates(const GeoArgs& a, long long cell, long long row, int r,
                         const double* ci, int* best) {
  const long long ms = a.mig_slots[row];
  const double rv = a.rem[row];
  bool can = a.moves[row] < a.max_moves[cell] && a.slack[row] > ms + 1 &&
             rv > (double)ms;
  const int R = a.regions, H = a.lookahead;
  double e_run, stay;
  const double* mm = nullptr;
  int hi = 0;
  if (a.kind == GREEDY) {
    const double h = fmax(1.0, ceil(rv));
    e_run = __dmul_rn(a.ec[row], h);
    stay = __dmul_rn(ci[r], e_run);
  } else {
    const double hm = fmin((double)(H - ms), fmax(1.0, ceil(rv)));
    can = can && hm >= 1.0;
    long long h1 = (long long)hm - 1;
    hi = (int)(h1 < 0 ? 0 : (h1 > H - 1 ? H - 1 : h1));
    e_run = __dmul_rn(a.ec[row], hm);
    stay = __dmul_rn(a.means[(cell * R + r) * H + hi], e_run);
    mm = a.movemeans + ((cell * a.mig_vals + a.mig_idx[row]) * R) * H + hi;
  }
  if (!can) return false;
  const double stay_m = __dmul_rn(stay, a.margin_c[cell]);
  const double mig_e = a.mig_e[row];
  double best_v = INFINITY;
  int b = 0;
  for (int i = 0; i < R; ++i) {
    double v;
    if (i == r) {
      v = INFINITY;
    } else {
      const double unit = a.kind == GREEDY ? ci[i] : mm[i * H];
      v = __dadd_rn(__dmul_rn(unit, e_run), __dmul_rn(mig_e, ci[i]));
    }
    if (i == 0 || v < best_v) {   // first index of the smallest
      best_v = v;
      b = i;
    }
  }
  *best = b;
  return best_v < stay_m;
}

__global__ void __launch_bounds__(THREADS) geo_walk_kernel(const GeoArgs a) {
  extern __shared__ unsigned int masks[];   // [pass * chunks + chunk]
  __shared__ long long s_used[MAX_REGIONS];
  __shared__ long long s_caps[MAX_REGIONS];
  __shared__ double s_ci[MAX_REGIONS];
  __shared__ double s_thresh[MAX_REGIONS];
  __shared__ int s_order[MAX_REGIONS];
  const long long cell = blockIdx.x;
  const int n = a.n, R = a.regions, H = a.lookahead;
  const int chunks = (n + 31) >> 5;
  const long long base = cell * n;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  if ((int)threadIdx.x < R) {
    s_used[threadIdx.x] = 0;
    s_caps[threadIdx.x] = a.caps[cell * R + threadIdx.x];
    s_ci[threadIdx.x] = a.ci_now ? a.ci_now[cell * R + threadIdx.x] : 0.0;
    s_thresh[threadIdx.x] = a.thresh_eps ? a.thresh_eps[cell * R + threadIdx.x] : 0.0;
    s_order[threadIdx.x] = a.clean_order ? (int)a.clean_order[cell * R + threadIdx.x] : 0;
  }
  __syncthreads();

  // Phase 1: copy the state; settle the migrating rows.
  for (int ch = warp; ch < chunks; ch += WARPS) {
    const int i = (ch << 5) + lane;
    const long long row = base + i;
    bool walk = false, is_forced = false;
    if (i < n) {
      const bool c = a.cand[row] != 0;
      const bool strt = a.started[row] != 0;
      bool placed = a.placed[row] != 0;
      long long polr = a.pol_region[row], engr = a.eng_region[row];
      long long migl = a.mig_left[row], mv = a.moves[row];
      bool mig = false;
      if (c && strt && a.kind != STATIC) {
        // greedy: a started row the policy has not placed adopts its region
        const int r = (int)(a.kind == GREEDY && placed ? polr : engr);
        int best;
        if (migrates(a, cell, row, r, s_ci, &best)) {
          mig = true;
          placed = true;
          polr = engr = best;
          migl = a.mig_slots[row];
          mv += 1;
        }
      }
      a.take[row] = 0;
      a.mig_now[row] = mig;
      a.placed_out[row] = placed;
      a.pol_out[row] = polr;
      a.eng_out[row] = engr;
      a.mig_left_out[row] = migl;
      a.moves_out[row] = mv;
      walk = c && !mig;
      is_forced = a.forced[row] != 0;
    }
    const unsigned int m_forced = __ballot_sync(FULL, walk && is_forced);
    const unsigned int m_free = __ballot_sync(FULL, walk && !is_forced);
    if (lane == 0) {
      masks[ch] = m_forced;
      masks[chunks + ch] = m_free;
    }
  }
  __syncthreads();
  if (warp != 0) return;

  // Phase 2: warp 0 walks the other candidates in key order.
  for (int j = 0; j < 2 * chunks; ++j) {
    const unsigned int live = masks[j];
    if (!live) continue;
    const int i = ((j < chunks ? j : j - chunks) << 5) + lane;
    const long long row = base + i;
    const bool mine = (live >> lane) & 1u;
    long long k = 0, polr = 0, engr = 0;
    bool strt = false, placed = false, forced = false, search = false;
    unsigned long long pref = 0;       // geo-flex: 4 bits a region, in order
    if (mine) {
      k = a.kmin[row];
      strt = a.started[row] != 0;
      placed = a.placed[row] != 0;
      forced = a.forced[row] != 0;
      polr = a.pol_region[row];
      engr = a.eng_region[row];
      if (a.kind == GREEDY && strt && !placed) polr = engr;   // adoption
      search = a.kind != STATIC && !strt && !placed;
      if (search && a.kind == FLEX) {
        const double h = fmin((double)H, fmax(1.0, ceil(a.rem[row])));
        long long h1 = (long long)h - 1;
        const int col = (int)(h1 < 0 ? 0 : (h1 > H - 1 ? H - 1 : h1));
        const double* m = a.means + cell * R * H + col;
        int ord[MAX_REGIONS];
        for (int q = 0; q < R; ++q) {   // stable insertion sort by mean
          int p = q;
          while (p > 0 && m[ord[p - 1] * H] > m[q * H]) {
            ord[p] = ord[p - 1];
            --p;
          }
          ord[p] = q;
        }
        for (int q = R - 1; q >= 0; --q) pref = (pref << 4) | (unsigned)ord[q];
      }
    }
    for (unsigned int turn = live; turn; turn &= turn - 1) {
      if (lane == __ffs(turn) - 1) {
        int r;
        bool newly = false;
        if (a.kind == STATIC) {
          r = (int)engr;
        } else if (a.kind == FLEX && strt) {
          r = (int)engr;
        } else {
          r = (int)polr;
          if (search) {
            for (int q = 0; q < R; ++q) {
              const int c = a.kind == GREEDY ? s_order[q] : (int)((pref >> (4 * q)) & 15u);
              if (s_used[c] + k <= s_caps[c]) {
                r = c;
                newly = true;
                break;
              }
            }
          }
        }
        const bool elig = a.kind != FLEX || forced || s_ci[r] <= s_thresh[r];
        const bool placeable = a.kind == STATIC || strt || placed || newly;
        const bool run = placeable && elig && s_used[r] + k <= s_caps[r];
        if (run) s_used[r] += k;
        a.take[row] = run;
        if (a.kind != STATIC) {
          a.placed_out[row] = placed || (strt && a.kind == GREEDY) || newly;
          if (!(a.kind == FLEX && strt)) a.pol_out[row] = r;
          if (run && !strt) a.eng_out[row] = r;
        }
      }
      __syncwarp();
    }
  }
}

// The floor of a call: an empty kernel on the same grid and shared memory.
__global__ void __launch_bounds__(THREADS) geo_walk_floor_kernel() {}

int launch_config(long long cells, int n, int regions, unsigned int* blocks,
                  size_t* smem) {
  if (cells <= 0 || n <= 0) return 0;
  if (regions < 1 || regions > MAX_REGIONS) return -1;
  *blocks = (unsigned int)cells;
  *smem = 2 * (size_t)((n + 31) / 32) * sizeof(unsigned int);
  return 1;
}

}  // namespace

extern "C" {

int geo_walk(const GeoArgs* args, void* stream) {
  unsigned int blocks;
  size_t smem;
  const int ok = launch_config(args->cells, args->n, args->regions, &blocks, &smem);
  if (ok <= 0) return ok < 0 ? (int)cudaErrorInvalidValue : 0;
  geo_walk_kernel<<<blocks, THREADS, smem, (cudaStream_t)stream>>>(*args);
  return (int)cudaGetLastError();
}

int geo_walk_floor(long long cells, int n, int regions, void* stream) {
  unsigned int blocks;
  size_t smem;
  const int ok = launch_config(cells, n, regions, &blocks, &smem);
  if (ok <= 0) return ok < 0 ? (int)cudaErrorInvalidValue : 0;
  geo_walk_floor_kernel<<<blocks, THREADS, smem, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

}  // extern "C"
