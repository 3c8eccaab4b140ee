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
// Design: two routes, one block per cell each (kernels/geo_walk.py::plan).
//
// "compact" (geo_walk_compact_kernel, the default).  Stage, all threads,
// one row a thread at a time: copy the row's state to the outputs and
// settle the migration rule, which reads only the row (its region is fixed
// once it has started): `can`, `stay`, `move` per region, `best`,
// `do_mig`; a migrating row is finished there.  Each row still to be walked
// leaves a record in shared memory at its row: its k_min, a word (its fixed
// region, or for a geo-flex row to be placed each region's rank in its
// preference order, 4 bits a region, from a stable sort of the means column
// by its owner thread) and its flags.  Each 32-row chunk's forced and
// unforced ballots go to shared memory; warp 0 scans their counts into
// offsets, and every warp writes each walked row's index at its place in
// the walk order (forced by row, then unforced by row).  Walk, warp 0:
// lane r holds region r's capacity left, its eligibility this slot and
// (geo-greedy) its rank in the cell's CI order, in registers.  Per
// candidate of the list (its record read a candidate ahead, the list two
// ahead), each lane tests `k <= left`; a row to be placed goes to the lane
// with room of the lowest rank (one __reduce_min_sync), any other row to
// the lane of its fixed region; that lane decides `run` (room, and geo-flex
// eligibility or forced), subtracts k and stores the result (run, newly
// placed, the region) into the row's flags.  No ballot, shuffle or
// shared-memory round trip stays in the chain.  After the walk every warp
// writes its rows' take, placement and regions.
//
// "chunked" (geo_walk_kernel, the first design).  Phase 1 as above,
// without records; each chunk records its two ballots.  Phase 2, warp 0
// visits every chunk, forced pass first: each lane loads its row and
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
// serial within a cell, so its time is the latency of one candidate's
// chain times the candidates, and the launch: the chunked kernel's chain
// is ~10 dependent shared-memory reads and a lane's turn (186 ns a
// candidate on an H100), the compact kernel's one warp reduction and a few
// integer operations.
//
// Plain C interface (loaded with ctypes); each entry point returns the
// cudaError_t of its launch, 0 on success.  Nothing here allocates or
// synchronises: the caller owns every buffer and the stream.

#include <cuda_runtime.h>

#include <math.h>

namespace {

constexpr int THREADS = 256;           // the chunked kernel's block
constexpr int WARPS = THREADS / 32;
constexpr int COMPACT_THREADS = 1024;  // the compact kernel's block
constexpr int COMPACT_WARPS = COMPACT_THREADS / 32;
// The compact kernel's shared memory a row (request, region or order word,
// list entry, flags) and a chunk (two ballots, two offsets): plan's
// ROW_BYTES and CHUNK_BYTES.
constexpr int ROW_BYTES = 20;
constexpr int CHUNK_BYTES = 16;
constexpr int SMEM_LIMIT = 48 * 1024;   // above it a launch opts in
// A compact record's flags: a row to be placed; eligible whatever the slot
// (not geo-flex, or forced); eng_region follows the region when it runs
// (not started, not geo-static).  The walk adds: it runs; it was placed now;
// the region it was placed in (bits 8-11).
constexpr unsigned int F_SEARCH = 1, F_ELIG = 2, F_ENG = 4, F_RUN = 8, F_NEWLY = 16;
constexpr unsigned int NO_RANK = 16;   // a region the walk cannot place the row in
constexpr int MAX_REGIONS = 16;
constexpr unsigned int FULL = 0xffffffffu;
constexpr int STATIC = 0, GREEDY = 1, FLEX = 2;
constexpr int COMPACT = 0, CHUNKED = 1;   // kernels/geo_walk.py::ROUTES

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

// A geo-flex row's preference: the regions sorted stably by the means
// column of its estimated run (the order the reference's stable sort
// gives), returned as each region's rank in that order, 4 bits a region
// (region r's rank in bits 4r..4r+3).
__device__ unsigned long long flex_ranks(const GeoArgs& a, long long cell, long long row) {
  const int R = a.regions, H = a.lookahead;
  const double h = fmin((double)H, fmax(1.0, ceil(a.rem[row])));
  const long long h1 = (long long)h - 1;
  const int col = (int)(h1 < 0 ? 0 : (h1 > H - 1 ? H - 1 : h1));
  const double* m = a.means + cell * R * H + col;
  unsigned long long order = 0;   // the order itself, first preferred lowest
  for (int q = 0; q < R; ++q) {   // insertion sort on the packed order
    const double mq = m[q * H];
    int p = q;
    while (p > 0 && m[((order >> (4 * (p - 1))) & 15u) * H] > mq) --p;
    const unsigned long long low = order & ((1ull << (4 * p)) - 1);
    const unsigned long long high = p < 15 ? (order >> (4 * p)) << (4 * (p + 1)) : 0;
    order = low | high | ((unsigned long long)q << (4 * p));
  }
  unsigned long long ranks = 0;
  for (int q = 0; q < R; ++q) ranks |= (unsigned long long)q << (4 * ((order >> (4 * q)) & 15u));
  return ranks;
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

// Dynamic shared memory: k[n], word[n] (8 bytes each), masks[2 * chunks],
// offs[2 * chunks] (4), list[n], flags[n] (2); ROW_BYTES * n + CHUNK_BYTES
// * chunks bytes.
__global__ void __launch_bounds__(COMPACT_THREADS) geo_walk_compact_kernel(const GeoArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ double s_ci[MAX_REGIONS];
  __shared__ int s_total;
  const long long cell = blockIdx.x;
  const int n = a.n, R = a.regions;
  const int chunks = (n + 31) >> 5;
  long long* s_k = reinterpret_cast<long long*>(smem);
  unsigned long long* s_word = reinterpret_cast<unsigned long long*>(s_k + n);
  unsigned int* masks = reinterpret_cast<unsigned int*>(s_word + n);
  unsigned int* offs = masks + 2 * chunks;
  unsigned short* s_list = reinterpret_cast<unsigned short*>(offs + 2 * chunks);
  unsigned short* s_flags = s_list + n;
  const long long base = cell * n;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  if ((int)threadIdx.x < R) s_ci[threadIdx.x] = a.ci_now ? a.ci_now[cell * R + threadIdx.x] : 0.0;
  __syncthreads();

  // Stage: copy the state, settle the migrating rows, record the others.
  for (int ch = warp; ch < chunks; ch += COMPACT_WARPS) {
    const int i = (ch << 5) + lane;
    const long long row = base + i;
    bool walk = false, is_forced = false;
    if (i < n) {
      const bool c = a.cand[row] != 0;
      const bool strt = a.started[row] != 0;
      const bool placed = a.placed[row] != 0;
      const long long polr = a.pol_region[row], engr = a.eng_region[row];
      int best = 0;
      const bool mig = c && strt && a.kind != STATIC &&
                       migrates(a, cell, row, (int)(a.kind == GREEDY && placed ? polr : engr),
                                s_ci, &best);
      is_forced = a.forced[row] != 0;
      walk = c && !mig;
      a.mig_now[row] = mig;
      a.mig_left_out[row] = mig ? a.mig_slots[row] : a.mig_left[row];
      a.moves_out[row] = a.moves[row] + (mig ? 1 : 0);
      // greedy: a started row the policy has not placed adopts its region
      const bool adopt = walk && a.kind == GREEDY && strt && !placed;
      a.placed_out[row] = placed || mig || adopt;
      a.pol_out[row] = mig ? best : (adopt ? engr : polr);
      a.eng_out[row] = mig ? best : engr;
      if (walk) {
        const bool search = a.kind != STATIC && !strt && !placed;
        s_k[i] = a.kmin[row];
        s_word[i] = search ? (a.kind == FLEX ? flex_ranks(a, cell, row) : 0ull)
                           : (unsigned long long)(a.kind == STATIC || (a.kind == FLEX && strt) ||
                                                          adopt ? engr : polr);
        s_flags[i] = (unsigned short)((search ? F_SEARCH : 0u) |
                                      (a.kind != FLEX || is_forced ? F_ELIG : 0u) |
                                      (a.kind != STATIC && !strt ? F_ENG : 0u));
      } else {
        a.take[row] = 0;
      }
    }
    const unsigned int m_forced = __ballot_sync(FULL, walk && is_forced);
    const unsigned int m_free = __ballot_sync(FULL, walk && !is_forced);
    if (lane == 0) {
      masks[ch] = m_forced;
      masks[chunks + ch] = m_free;
    }
  }
  __syncthreads();
  if (warp == 0) scan_ballots(masks, 2 * chunks, offs, &s_total, lane);
  __syncthreads();
  // The walk list: each walked row's index at its place in the walk order.
  for (int j = warp; j < 2 * chunks; j += COMPACT_WARPS) {
    const unsigned int m = masks[j];
    if ((m >> lane) & 1u)
      s_list[offs[j] + __popc(m & ((1u << lane) - 1u))] =
          (unsigned short)(((j < chunks ? j : j - chunks) << 5) + lane);
  }
  __syncthreads();

  if (warp == 0) {
    // Walk: lane r holds region r's capacity left, its eligibility this
    // slot and (geo-greedy) its rank in the cell's CI order.
    const bool in_r = lane < R;
    long long left = in_r ? a.caps[cell * R + lane] : 0;
    const bool elig = a.kind != FLEX || (in_r && s_ci[lane] <= a.thresh_eps[cell * R + lane]);
    unsigned int greedy_rank = NO_RANK;
    if (a.kind == GREEDY) {
      const long long ord = in_r ? a.clean_order[cell * R + lane] : -1;
      for (int q = R - 1; q >= 0; --q)   // the first place region `lane` holds
        if (__shfl_sync(FULL, ord, q) == lane) greedy_rank = q;
    }
    const int total = s_total;
    // The list read two ahead, its records one ahead of the candidate.
    int row = total > 0 ? s_list[0] : 0;
    int row_next = total > 1 ? s_list[1] : 0;
    long long k = s_k[row];
    unsigned long long w = s_word[row];
    unsigned int fl = s_flags[row];
    // Branch-free, so that the next candidates' loads and ranks fill the
    // chain's latency: a row to be placed goes to the lane with room of the
    // lowest rank, any other row to its region's lane if that has room.
#pragma unroll 4
    for (int i = 0; i < total; ++i) {
      const int row_after = i + 2 < total ? s_list[i + 2] : 0;
      const long long k_next = s_k[row_next];
      const unsigned long long w_next = s_word[row_next];
      const unsigned int fl_next = s_flags[row_next];
      const bool search = fl & F_SEARCH;
      const unsigned int rank =
          a.kind == GREEDY ? greedy_rank : (unsigned int)((w >> (4 * (lane & 15))) & 15u);
      const bool may_run = elig || (fl & F_ELIG);
      const bool fits = in_r && k <= left;
      const unsigned int key = search && fits ? rank : NO_RANK;
      const unsigned int least = __reduce_min_sync(FULL, key);   // every lane
      const bool mine = search ? key < NO_RANK && key == least
                               : fits && (long long)lane == (long long)w;
      const bool run = mine && may_run;
      if (mine)
        s_flags[row] = (unsigned short)(fl | (search ? F_NEWLY | ((unsigned int)lane << 8) : 0u) |
                                        (run ? F_RUN : 0u));
      if (run) left -= k;
      row = row_next;
      row_next = row_after;
      k = k_next;
      w = w_next;
      fl = fl_next;
    }
  }
  __syncthreads();

  // Write-out: the walked rows' take, and what the walk placed or ran.
  for (int ch = warp; ch < chunks; ch += COMPACT_WARPS) {
    const int i = (ch << 5) + lane;
    if (((masks[ch] | masks[chunks + ch]) >> lane) & 1u) {
      const long long row = base + i;
      const unsigned int fl = s_flags[i];
      const int r = (fl >> 8) & 15u;
      a.take[row] = (fl & F_RUN) != 0;
      if (fl & F_NEWLY) {
        a.placed_out[row] = 1;
        a.pol_out[row] = r;
      }
      if ((fl & F_RUN) && (fl & F_ENG))
        a.eng_out[row] = (fl & F_SEARCH) ? (long long)r : (long long)s_word[i];
    }
  }
}

// The floor of a call: an empty kernel on the same grid and shared memory.
__global__ void __launch_bounds__(THREADS) geo_walk_floor_kernel() {}
__global__ void __launch_bounds__(COMPACT_THREADS) geo_walk_compact_floor_kernel() {}

// Dynamic shared memory of a route for n rows (kernels/geo_walk.py::plan):
// the compact kernel's records, the chunked kernel's two ballot masks a
// chunk; -1 for an unknown route.
long long smem_bytes(int route, int n) {
  const long long chunks = (n + 31) / 32;
  if (route == COMPACT) return (long long)ROW_BYTES * n + CHUNK_BYTES * chunks;
  if (route == CHUNKED) return 2 * chunks * (long long)sizeof(unsigned int);
  return -1;
}

// Above 48 KB a kernel's dynamic shared memory needs the opt-in.
template <typename K>
cudaError_t opt_in(K kernel, size_t smem) {
  if (smem <= SMEM_LIMIT) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace

extern "C" {

long long geo_walk_smem(int route, int n) { return smem_bytes(route, n); }

// One launch of route's kernel, one block per cell, with `smem` bytes of
// dynamic shared memory as kernels/geo_walk.py::plan sizes it.
int geo_walk(int route, const GeoArgs* args, size_t smem, void* stream) {
  if (args->cells <= 0 || args->n <= 0) return 0;
  const long long need = smem_bytes(route, args->n);
  if (args->regions < 1 || args->regions > MAX_REGIONS || need < 0 || (long long)smem < need)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const unsigned int blocks = (unsigned int)args->cells;
  if (route == COMPACT) {
    const cudaError_t err = opt_in(geo_walk_compact_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    geo_walk_compact_kernel<<<blocks, COMPACT_THREADS, smem, s>>>(*args);
  } else {
    geo_walk_kernel<<<blocks, THREADS, smem, s>>>(*args);
  }
  return (int)cudaGetLastError();
}

// An empty kernel launched as route's kernel is: the floor of a call.
int geo_walk_floor(int route, long long cells, size_t smem, void* stream) {
  if (cells <= 0) return 0;
  if (smem_bytes(route, 1) < 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (route == COMPACT) {
    const cudaError_t err = opt_in(geo_walk_compact_floor_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    geo_walk_compact_floor_kernel<<<(unsigned int)cells, COMPACT_THREADS, smem, s>>>();
  } else {
    geo_walk_floor_kernel<<<(unsigned int)cells, THREADS, smem, s>>>();
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
