// Hand-written Hopper kernels for causal GQA attention with an online
// softmax (flash attention, forward only), the attention of the LM prefill.
//
// Replaces the TPU kernel of src/repro/kernels/flash_attention.py:
//   gqa_flash_fwd, gqa_flash_wgmma,
//   gqa_flash_tiled                 <- _flash_kernel  (pallas_call at
//       flash_attention.py:94, called via gqa_flash, from models/common.py
//       attention when attention_backend="pallas")
//
// Semantics, as the TPU kernel and kernels/ref.py::flash_attention_ref:
// q (B, Sq, Hq, D), k/v (B, Sk, Hkv, D), query head h reads KV head
// h / (Hq / Hkv); scores q.k / sqrt(D) in fp32, masked unless
// causal_offset + q_row >= k_row (and k_row < Sk); softmax over the keys;
// out = acc / max(l, 1e-30) in the input dtype.  As the TPU kernel, which
// casts to fp32 in its body, they take any head dim (here 1 <= D <= 256)
// and bf16, fp16 or fp32 (the wrapper runs fp64 on fp32 copies).
//
// The TPU kernel transposed q/k/v to (B, H, S, D), padded S to its 128-row
// blocks and carried (m, l, acc) in scratch across a sequential KV grid
// axis.  Here each block owns a tile of query rows of one head and loops
// over the key tiles itself, (m, l, acc) in registers, reading q/k/v in the
// model's (B, S, H, D) layout through their strides.  The loop stops after
// the last tile any row of the block can see: the tiles it skips would
// contribute exactly 0.  Four kernels, routed by dtype and D alone (the
// wrapper, kernels/flash_attention.py, picks one; the fourth only on
// request):
//
//   flash_wgmma_kernel (bf16 and fp16, every D in [1, 256]; every model
//     config's 16-bit head dim and the example trainers'): the Hopper
//     design.  One block owns 128 query rows of one head and runs
//     three warpgroups.  Warpgroup 0 is the producer: it gives up registers
//     (setmaxnreg 40) and one thread issues TMA loads, 4-D tensor maps over
//     (B, S, H, D) with 128-byte swizzle and boxes of 128 rows x 64 bf16
//     (D = 128 takes two), which zero-fill rows past Sq and Sk: Q once, then
//     K and V tiles of 128 keys into a ring of shared-memory stages (2 at
//     D = 128, 3 at D = 64), each with full (K, V) and empty mbarriers.
//     Warpgroups 1 and 2 are the consumers (setmaxnreg 232), 64 query rows
//     each: S = Q K^T with wgmma m64n128k16 (Q and K from shared memory,
//     both K-major), the online softmax in registers with scale * log2(e)
//     folded into one FMA before ex2.approx.ftz, masking only tiles that
//     cross the diagonal or the end of K, P rounded to bf16 in registers
//     (the accumulator layout of a 64 x 16 slice of S is wgmma's register-A
//     layout), O += P V with wgmma m64nDk16 (V from shared memory, MN-major
//     through the transpose bit), then the stage is released.  The two
//     consumers take turns to issue their S products (ping-pong on named
//     barriers), so that one's softmax runs while the other's products hold
//     the tensor cores.  Given an lse pointer, the epilogue also stores each
//     row's log-sum-exp, which the backward's wgmma route reads (the serving
//     path passes none; the output is the same).  Blocks take the heaviest
//     query tiles first (grid
//     (Hq, B, Sq tiles), the tile index reversed), so the light causal tiles
//     fill the tail.  D = 112 (zamba2-7b's shared attention: d_model 3584
//     over 32 heads) runs the D = 128 instantiation: the tensor maps keep D
//     = 112 as their innermost extent, so the second box of each row reaches
//     past it and TMA fills its columns 112..127 with zeros (they add
//     nothing to q.k, and V's give output columns that are not stored); the
//     softmax scale is 1/sqrt(112), and the epilogue stores 112 columns a
//     row, so no store reaches the next head.  The products do 128/112 =
//     1.14x the work the function needs.  Every other head dim of the route
//     runs the same way with D taken at run time on tiles as wide as the
//     least multiple of 64 that holds it (instantiations <64, 0, T>, <128,
//     0, T>, <192, 0, T>, <256, 0, T>; bf16 at 64, 112 and 128 keep their
//     own), fp16 through the .f16 forms of wgmma and FLOAT16 tensor maps.
//     At a D off a multiple of 8 (33, 100, 250) a contiguous 16-bit tensor
//     has rows whose byte stride TMA refuses (not a multiple of 16): the
//     wrapper copies each such input into a buffer of rows ceil(D / 8) * 8
//     wide and hands in its [..., :D] view, whose maps keep extent D, so TMA
//     zero-fills columns D.. as at D 112; the epilogue guards every store by
//     column.  Past width 128 (D in (128, 256], Gemma-2-9B's 256 among them) O takes
//     D/2 = 96 or 128 fp32 registers a thread, so the K/V tiles hold 64 keys
//     (S 32 floats, P 16 registers): S = Q K^T is m64n64k16 over D/16 steps,
//     O += P V m64nDk16 (n192 or n256) over 4 steps, V read MN-major across
//     its 3 or 4 column boxes, and every TMA box is 64 rows (Q takes two a
//     column box).  Shared memory: Q 48 or 64 KiB, stages of 48 or 64 KiB, 3
//     stages at 192 and 2 at 256 (197,712 and 197,688 bytes).  Registers:
//     ptxas gives each thread only what the launch does, 168 at 384 threads
//     (three warps on each SM sub-partition), whatever setmaxnreg adds later,
//     and at width 256 O, S and P need ~190: that instantiation runs the two
//     consumer warpgroups alone (256 threads, 188 registers, no spill), and
//     consumer 1's first thread issues the TMA loads, Q and the first
//     stages before the loop and tile j + 1 into tile j - 1's stage in its
//     turn j, which the ping-pong order puts after both consumers released
//     tile j - 1 (hopper.cuh, Roles).  Width 192 fits 168 registers and
//     keeps the producer warpgroup.  At D <= 32 (the example trainers of
//     repro_torch.examples.train_carbon_aware: D 16 in the tiny preset, 32
//     in the 10m one) the tiles are 16 or 32 columns wide (hopper.cuh,
//     tile_of and Swz): one box a row, as wide as the tile, under the 32-
//     or 64-byte swizzle, wgmma descriptors of the same layout (S = Q K^T
//     in 1 or 2 k-steps, O += P V at N 16 or 32), K/V tiles of 128 keys in
//     a ring 4 deep (16 KB a stage at 32).  There the products are small
//     beside the softmax: one ex2 a score at the special-function units'
//     ~3.9 T/s is 0.034 ms at B 4, S 2048, 16 x 8 heads, twice the
//     products' 0.017 ms at 989 TFLOP/s; what a tile costs is its
//     exponentials and its barriers, waits and turns.  So the narrow tiles
//     run without the producer warpgroup, as width 256 does, two blocks an
//     SM (O, S and P of 128 keys fit the 128 registers a thread that
//     leaves, 103-110 used, no spill): four consumer warpgroups an SM hide
//     each other's waits, where the producer layout's one block runs two
//     (0.068 against 0.096 ms at that shape on an H100, both on this code:
//     scripts/kernel_splits.py narrow; the mma.sync kernel below 0.24 ms).
//   flash_mma_kernel<T, DP> (bf16 and fp16 on request, any D, the
//     yardstick of the Hopper kernel, kernel="mma_sync"): 4 warps,
//     each owning 16 of 64 query rows, mma.sync m16n8k16 (.bf16 or .f16);
//     K and V tiles of 64 keys stream into two shared-memory buffers, the
//     next tile loading while the block computes on the current one;
//     ldmatrix reads K's fragments and, transposing, V's.  D runs on the
//     least padded width DP of 16, 32, 64, 128, 256 that holds it, tile
//     columns D..DP-1 zero; its loops step over DP in slices of 16.  Where D
//     and the strides are multiples of 8 elements the tiles come by 16-byte
//     cp.async (zero-filled past D), else element by element.  Tile rows of
//     DP + 8 elements keep each 8 x 8 matrix's rows 16-byte aligned and in
//     distinct banks.  At DP 256, Q's fragments (64 registers) beside the
//     128-float output would pass 255 registers a thread, so Q stays in
//     shared memory (169 KB in all) and is read at each product.  Given an
//     lse pointer it stores each row's log-sum-exp (m + ln l), as the
//     Hopper kernel does; the output is the same either way.
//   flash_tiled_kernel<J> (fp32 at every D, fp64 on fp32 copies; the route
//     "fp32"): register micro-tiles on the CUDA cores' FMA pipe (no TF32, so
//     the result stays within 2e-5 of the fp32 reference), building blocks
//     in f32_tiles.cuh.  16 x 16 threads; up to width 128 a block owns 128
//     query rows and each thread 8 rows of S, P and O: of S 8 keys of a
//     128-key tile up to width 112 (keys tx + 16j), 4 of a 64-key tile at
//     128; of O J columns (tx + 16j, J = ceil(D / 16) slots).  Past width
//     128 a block owns 64 rows and a thread 4 x 4 scores, so that O's 4 J
//     floats fit beside S.  Q, K and V lie in shared memory row by row
//     (rows 16 J + 4 floats apart, zero from D on), so S = Q K^T reads a
//     thread's rows and keys as 128-bit loads (its rows a broadcast over
//     the half warp): 4 loads for 64 FMAs a column at 8 x 8, over the least
//     multiple of 8 that holds D (104 at D 100, not 128).  K and V tiles come
//     by cp.async (16-byte where D, the strides and the starts allow it,
//     else 4-byte zero-filled) into one buffer each, in turns: V_j under
//     S_j, K_{j+1} under O += P_j V_j; P^T passes to the same half warp
//     through one shared buffer of 64 keys, chunk by chunk (only a half
//     warp reads what it writes there, so __syncwarp orders it), which is
//     what leaves room for 128-key tiles.  Heaviest query tiles first; a
//     warp skips a tile none of its rows sees.  Given an lse pointer it
//     stores each row's log-sum-exp (m + ln l) for the backward's "tiled"
//     route; the output is the same either way.  211,968 bytes of shared
//     memory at D 100, 217,088 at width 256.
//   flash_f32_kernel<DP> (the first design of fp32, on the same padded
//     widths as mma.sync; only on request, kernel="fp32_simple", the
//     yardstick of the tiled kernel): 16x16 threads, each owning a 4x4 block
//     of scores and 4 rows x DP/16 columns of the output, operands read one
//     32-bit word at a time from shared memory; element loads, so any
//     stride; 214 KB of shared memory at DP 256; writes no LSE.
//
// What bounds it on an H100: at the prefill shape of llama3-8b (B=4,
// S=2048, Hq=32, Hkv=8, D=128) one call does 4*B*Hq*D*(S(S+1)/2) = 137 GFLOP
// and must move 168 MB, so it is bound by the tensor cores (0.139 ms at
// 989 TFLOP/s) far above the bytes (0.050 ms at 3.35 TB/s); at zamba2-7b's
// forward (B=4, S=2048, Hq=Hkv=32, D=112) 120.3 GFLOP (0.122 ms), for which
// the D = 128 tiles run 137.4 GFLOP of products.  Only wgmma
// reaches the tensor cores' full rate; mma.sync reached 14 % of it.  In the
// Hopper kernel the K/V tiles still cross from L2 once per 128 query rows
// (1.1 GB per prefill call), and the softmax is not overlapped with the
// same consumer's products: each consumer runs S, softmax and P V in
// series, and only the other consumer's products fill the gap.  At D 256
// (B 4, S 2048, Hq 16, Hkv 8: 137.5 GFLOP, 0.139 ms at 989 TFLOP/s) the
// mma.sync kernel reached 10 % of that bound on an H100 80GB HBM3 at 700 W
// (1.33 ms; SDPA 0.25 ms), the 256-wide Hopper kernel 46 % (0.300 ms): its
// tiles of 64 keys halve the product per barrier and per softmax pass.  The
// fp32 kernels are bound by the 67 TFLOP/s of fp32 FMA (at B 4, S 2048, Hq
// 16, Hkv 8, D 100: 53.7 GFLOP, 0.802 ms); flash_f32_kernel's loops read 8
// shared words for 16 FMAs and ran at 0.27 of that bound, the tiled
// kernel's S loop 4 128-bit loads for 64.  Issuing
// tile j's S product before tile j-1's P V product (FlashAttention-3's
// intra-warpgroup overlap) keeps S, O and P live at once, and ptxas then
// spills P and serialises every wgmma, which made it slower.
//
// Plain C interface (loaded with ctypes); the entry points return the
// cudaError_t of the launch, 0 on success (gqa_flash_wgmma: a negative
// value is the CUresult of encoding a tensor map, negated).
// Nothing here allocates or synchronises.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "f32_tiles.cuh"
#include "hopper.cuh"

namespace {

constexpr int BQ = 64;            // query rows per block
constexpr int BK = 64;            // keys per tile
constexpr float NEG = -1e30f;

struct Strides {                  // element strides of the B, S, H dims
  long long b, s, h;
};

// Tiles of KEYS keys that the block of ROWS query rows starting at row q0
// needs: up to the last key its last valid row can see.
template <int ROWS = BQ, int KEYS = BK>
__device__ __forceinline__ int kv_tiles(int q0, int sq, int sk, int offset) {
  const long long last_row = min(q0 + ROWS, sq) - 1;
  const long long visible = min(static_cast<long long>(sk), offset + last_row + 1);
  return static_cast<int>((visible + KEYS - 1) / KEYS);
}

// --- bf16 and fp16: mma.sync on the tensor cores ---------------------------

// The padded widths of the mma.sync and fp32 kernels: a head dim d runs on
// the least DP >= d (a multiple of 16), its columns d..DP-1 loaded as zeros.
__host__ __device__ constexpr int padded_dim(int d) {
  return d <= 16 ? 16 : d <= 32 ? 32 : d <= 64 ? 64 : d <= 128 ? 128 : 256;
}

// At DP <= 128 Q lives in registers as A fragments (DP/16 x 4 a thread); at
// DP 256 that and the 128-float output would pass the 255 registers a
// thread may hold, so Q stays in shared memory and its fragments are read
// from there at each product.
template <int DP>
__host__ __device__ constexpr bool q_in_registers() {
  return DP <= 128;
}

template <int DP>
constexpr size_t mma_smem_bytes() {          // K and V, two buffers each (and Q at DP 256)
  return sizeof(uint16_t) * (4 + (q_in_registers<DP>() ? 0 : 1)) * BK * (DP + 8);
}

// Fragment layout of m16n8k16 (lane = 4 * g + t): A holds rows g and g + 8,
// columns 2t, 2t + 1 and 2t + 8, 2t + 9; B holds k rows 2t, 2t + 1 and
// 2t + 8, 2t + 9 of column g; C holds rows g (c0, c1) and g + 8 (c2, c3),
// columns 2t, 2t + 1.  K and V tiles are both stored row-major (key, d):
// plain ldmatrix gives K's B fragments for S = Q K^T, .trans gives V's for
// O = P V.  Tile rows are padded to DP + 8 elements, so the eight 16-byte
// rows of each 8x8 matrix fall in distinct banks.  T is bf16 or fp16; the
// head dim d <= DP, columns d..DP-1 of every tile zero (they add nothing to
// q.k, and give output columns that are not stored).  With `lse` each
// row's log-sum-exp of its scaled scores, m + ln(l), goes to lse (B, Hq, Sq)
// in fp32 (the "mma" backward, the yardstick, reads it, or the Hopper
// forward's); nullptr stores nothing, and the output is the same either way.
template <typename T, int DP>
__global__ void __launch_bounds__(128)
flash_mma_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, float* __restrict__ lse, int sq, int sk, int hq, int group,
                 int offset, int d, bool vec, Strides qs, Strides ks, Strides vs, float scale) {
  constexpr int KS = DP + 8;       // row stride of every tile, in elements
  constexpr bool QREG = q_in_registers<DP>();
  extern __shared__ __align__(16) unsigned char flash_smem[];
  T* kbuf = reinterpret_cast<T*>(flash_smem);     // 2 x BK x KS
  T* vbuf = kbuf + 2 * BK * KS;                   // 2 x BK x KS
  T* qbuf = QREG ? kbuf : vbuf + 2 * BK * KS;     // BQ x KS

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + (h / group) * ks.h;
  const T* vb = v + b * vs.b + (h / group) * vs.h;

  // Q tile -> shared memory (rows past Sq and columns past d are zero) ->
  // A fragments, or (DP 256) kept there.
  load_rows<T, DP>(qbuf, qb, q0, BQ, sq, qs.s, d, vec);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  const T* qrow = qbuf + (warp * 16 + g) * KS + 2 * t;
  uint32_t qa[QREG ? DP / 16 : 1][4];
  if constexpr (QREG) {
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      qa[kk][0] = ld32(qrow + kk * 16);
      qa[kk][1] = ld32(qrow + 8 * KS + kk * 16);
      qa[kk][2] = ld32(qrow + kk * 16 + 8);
      qa[kk][3] = ld32(qrow + 8 * KS + kk * 16 + 8);
    }
    __syncthreads();               // Q is in registers; its buffer is free
  }

  // Rows [64 tile, 64 tile + 64) of K and V into buffer `buf`, zero past Sk.
  auto load_tile = [&](int tile, int buf) {
    load_rows<T, DP>(kbuf + buf * BK * KS, kb, tile * BK, BK, sk, ks.s, d, vec);
    load_rows<T, DP>(vbuf + buf * BK * KS, vb, tile * BK, BK, sk, vs.s, d, vec);
    cp_async_commit();
  };

  float acc[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};
  const int row = q0 + warp * 16 + g;                  // rows row and row + 8
  const long long qpos = static_cast<long long>(offset) + row;
  const long long warp_first = static_cast<long long>(offset) + q0 + warp * 16;
  const int n_tiles = kv_tiles(q0, sq, sk, offset);
  // ldmatrix row of this lane: K fragments take keys 0-7 / 8-15 of two
  // n-tiles at columns +0 / +8; V fragments the reverse.
  const int k_row = (lane & 7) + ((lane >> 4) << 3), k_col = ((lane >> 3) & 1) * 8;
  const int v_row = (lane & 7) + (((lane >> 3) & 1) << 3), v_col = (lane >> 4) * 8;

  load_tile(0, 0);
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * BK, buf = tile & 1;
    if (tile + 1 < n_tiles) {      // the next tile streams in under this one
      load_tile(tile + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* kt = kbuf + buf * BK * KS;
    const T* vt = vbuf + buf * BK * KS;

    // S = Q K^T for this warp's 16 rows x 64 keys.
    float s[BK / 8][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      uint32_t a[4];
      if constexpr (QREG) {
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = qa[kk][i];
      } else {
        a[0] = ld32(qrow + kk * 16);
        a[1] = ld32(qrow + 8 * KS + kk * 16);
        a[2] = ld32(qrow + kk * 16 + 8);
        a[3] = ld32(qrow + 8 * KS + kk * 16 + 8);
      }
#pragma unroll
      for (int np = 0; np < BK / 16; ++np) {
        uint32_t kf[4];
        ldmatrix_x4(kf, kt + (np * 16 + k_row) * KS + kk * 16 + k_col);
        mma_16816<T>(s[2 * np], a, kf[0], kf[1]);
        mma_16816<T>(s[2 * np + 1], a, kf[2], kf[3]);
      }
    }

    // Scale, mask, online softmax; element e of a C fragment is row
    // row + 8 * (e >> 1), key k0 + 8n + 2t + (e & 1).  Only tiles that
    // cross the diagonal or the end of K need the mask.
    const bool full = k0 + BK <= sk && k0 + BK - 1 <= warp_first;
    float mx[2] = {NEG, NEG};
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + n * 8 + 2 * t + (e & 1);
        const bool live = full || (qpos + 8 * (e >> 1) >= key && key < sk);
        s[n][e] = live ? s[n][e] * scale : NEG;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
      }
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      corr[r] = expf(m[r] - m_new);
      m[r] = m_new;
      l[r] *= corr[r];             // per-thread partial sums, summed at the end
    }
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = expf(s[n][e] - m[e >> 1]);
        l[e >> 1] += s[n][e];
      }
    }
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      acc[n][0] *= corr[0];
      acc[n][1] *= corr[0];
      acc[n][2] *= corr[1];
      acc[n][3] *= corr[1];
    }

    // O += P V: two adjacent C fragments of S are one A fragment of P.
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t pa[4] = {pack2<T>(s[2 * kk][0], s[2 * kk][1]),
                              pack2<T>(s[2 * kk][2], s[2 * kk][3]),
                              pack2<T>(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack2<T>(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < DP / 16; ++dp) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, vt + (kk * 16 + v_row) * KS + dp * 16 + v_col);
        mma_16816<T>(acc[2 * dp], pa, vf[0], vf[1]);
        mma_16816<T>(acc[2 * dp + 1], pa, vf[2], vf[3]);
      }
    }
    __syncthreads();               // every warp is done with this buffer
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int orow = row + 8 * r;
    if (orow < sq) {
      const float den = fmaxf(l[r], 1e-30f);
      T* op = o + ((static_cast<long long>(b) * sq + orow) * hq + h) * d;
#pragma unroll
      for (int n = 0; n < DP / 8; ++n)
        if (8 * n < d)
          store2<T>(op, 8 * n + 2 * t, d, acc[n][2 * r] / den, acc[n][2 * r + 1] / den);
      if (lse != nullptr && t == 0)
        lse[(static_cast<long long>(b) * hq + h) * sq + orow] = m[r] + logf(l[r]);
    }
  }
}

// --- fp32: FMA on the CUDA cores ---------------------------------------------

constexpr int F32_THREADS = 256;  // 16 x 16: ty = tid / 16, tx = tid % 16

template <int DP>
constexpr size_t f32_smem_bytes() {
  return sizeof(float) * (static_cast<size_t>(BQ + 2 * BK) * (DP + 1) + BQ * (BK + 1));
}

// Thread (ty, tx) owns score rows ty + 16i and keys tx + 16j (i, j < 4), and
// output rows ty + 16i, columns tx + 16j (j < DP/16).  Tiles are stored with
// odd row strides, so the column reads of 16 lanes hit 16 distinct banks.
// The head dim d <= DP: tile columns d..DP-1 are zeros, and the loads read
// one element each, so no stride or start need be aligned.
template <int DP>
__global__ void __launch_bounds__(F32_THREADS)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int sq, int sk,
                 int hq, int group, int offset, int d, Strides qs, Strides ks, Strides vs,
                 float scale) {
  constexpr int DS = DP + 1;
  constexpr int PS = BK + 1;
  constexpr int DJ = DP / 16;
  extern __shared__ float smem[];
  float* qt = smem;                // BQ x DS
  float* kt = qt + BQ * DS;        // BK x DS
  float* vt = kt + BK * DS;        // BK x DS
  float* pt = vt + BK * DS;        // BQ x PS

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const float* qb = q + b * qs.b + h * qs.h;
  const float* kb = k + b * ks.b + (h / group) * ks.h;
  const float* vb = v + b * vs.b + (h / group) * vs.h;

  for (int e = tid; e < BQ * DP; e += F32_THREADS) {
    const int r = e / DP, c = e % DP;
    qt[r * DS + c] = q0 + r < sq && c < d ? qb[(q0 + r) * qs.s + c] : 0.f;
  }

  float acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  float m[4] = {NEG, NEG, NEG, NEG}, l[4] = {0.f, 0.f, 0.f, 0.f};
  const int n_tiles = kv_tiles(q0, sq, sk, offset);

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * BK;
    __syncthreads();               // the last tile is consumed (and Q is staged)
    for (int e = tid; e < BK * DP; e += F32_THREADS) {
      const int r = e / DP, c = e % DP;
      const bool in = k0 + r < sk && c < d;
      kt[r * DS + c] = in ? kb[(k0 + r) * ks.s + c] : 0.f;
      vt[r * DS + c] = in ? vb[(k0 + r) * vs.s + c] : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int c = 0; c < d; ++c) {
      float a[4], bk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qt[(ty + 16 * i) * DS + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) bk[j] = kt[(tx + 16 * j) * DS + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], bk[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long long qpos = static_cast<long long>(offset) + q0 + ty + 16 * i;
      float mx = NEG;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + tx + 16 * j;
        s[i][j] = qpos >= key && key < sk ? s[i][j] * scale : NEG;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      m[i] = m_new;
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        pt[(ty + 16 * i) * PS + tx + 16 * j] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * corr + rs;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float p[4], vv[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = pt[(ty + 16 * i) * PS + kk];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vv[j] = vt[kk * DS + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(p[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int orow = q0 + ty + 16 * i;
    if (orow < sq) {
      const float den = fmaxf(l[i], 1e-30f);
      float* op = o + ((static_cast<long long>(b) * sq + orow) * hq + h) * d;
#pragma unroll
      for (int j = 0; j < DJ; ++j)
        if (tx + 16 * j < d) op[tx + 16 * j] = acc[i][j] / den;
    }
  }
}

template <typename T, int DP>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* o, float* lse,
                       dim3 grid, int sq, int sk, int hq, int group, int offset, int d, bool vec,
                       Strides qs, Strides ks, Strides vs, float scale, cudaStream_t stream) {
  const size_t smem = mma_smem_bytes<DP>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_mma_kernel<T, DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  flash_mma_kernel<T, DP><<<grid, 128, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, sq, sk, hq, group, offset, d, vec, qs, ks, vs, scale);
  return cudaGetLastError();
}

// The mma.sync kernel (dtype 1 bf16, 2 fp16; each row's LSE into `lse`
// unless null) or the fp32 kernel (dtype 0) on tiles DP wide for head dim
// d <= DP.
template <int DP>
cudaError_t launch(int dtype, const void* q, const void* k, const void* v, void* o, float* lse,
                   int b, int sq, int sk, int hq, int hkv, int d, int offset, bool vec,
                   Strides qs, Strides ks, Strides vs, cudaStream_t stream) {
  const dim3 grid((sq + BQ - 1) / BQ, hq, b);
  const float scale = 1.0f / sqrtf(static_cast<float>(d));
  const int group = hq / hkv;
  if (dtype == 1)
    return launch_mma<__nv_bfloat16, DP>(q, k, v, o, lse, grid, sq, sk, hq, group, offset, d,
                                         vec, qs, ks, vs, scale, stream);
  if (dtype == 2)
    return launch_mma<__half, DP>(q, k, v, o, lse, grid, sq, sk, hq, group, offset, d, vec, qs,
                                  ks, vs, scale, stream);
  const size_t smem = f32_smem_bytes<DP>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_f32_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  flash_f32_kernel<DP><<<grid, F32_THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), sq, sk, hq, group, offset, d, qs,
      ks, vs, scale);
  return cudaGetLastError();
}

// --- fp32: register-tiled FMA on the CUDA cores (the "tiled" route) ----------

// One block per (ROWS query rows, query head, batch), heaviest tiles first;
// 16 x 16 threads (f32_tiles.cuh), thread (ty, tx) owning query rows q0 + RT
// ty + i (i < RT) of S, P and O, keys k0 + tx + 16 j (j < CT) of S, and
// output columns tx + 16 j (j < J).  Q stays in shared memory; K and V
// tiles of KEYS keys come by cp.async into one buffer each, in turn: V_j
// while S_j is computed, K_{j + 1} while O += P_j V_j is.  S = Q K^T over
// width(d) columns, the online softmax in the log2 domain (each row's max
// over its half warp by shuffles; per-thread partial sums, summed at the
// end), P^T through shared memory to the same half warp in chunks of 64
// keys (xty_chunks: up to width 112 tiles of 128 keys, 8 x 8 scores a
// thread), O += P V over the tile's keys, the exponentials by ex2.approx.ftz (3 % faster than exp2f,
// equal bits at D 100: scripts/kernel_splits.py tiled).  A warp skips a
// tile none of its 2 RT rows sees, and masks only tiles that cross the
// diagonal or the end of K.  With `lse` each
// row's log-sum-exp m + ln l goes to lse (B, Hq, Sq) in fp32, as
// flash_mma_kernel's, for the backward's "tiled" route; the output is the
// same either way.  `vec`: d, every stride and the starts allow 16-byte
// copies.
template <int J>
__global__ void __launch_bounds__(tiled::FwdTiles<J>::THREADS, tiled::FwdTiles<J>::BLOCKS)
flash_tiled_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
                   int sq, int sk, int hq, int group, int offset, int d, bool vec, Strides qs,
                   Strides ks, Strides vs, float scale_log2) {
  using L = tiled::FwdTiles<J>;
  constexpr int RT = L::RT, CT = L::CT, ROWS = L::ROWS, KEYS = L::KEYS, RS = L::RS,
                PS = L::PS, NCH = L::NCH;
  extern __shared__ __align__(16) float tiled_smem[];
  float* qt = tiled_smem + L::Q;
  float* kt = tiled_smem + L::K;
  float* vt = tiled_smem + L::V;
  float* pt = tiled_smem + L::P;

  const int tid = threadIdx.x, ty = tid / tiled::TX, tx = tid % tiled::TX, warp = tid / 32;
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * ROWS;   // heaviest query tiles first
  const float* qb = q + b * qs.b + h * qs.h;
  const float* kb = k + b * ks.b + (h / group) * ks.h;
  const float* vb = v + b * vs.b + (h / group) * vs.h;
  const int w = tiled::width(d);
  const int n_tiles = kv_tiles<ROWS, KEYS>(q0, sq, sk, offset);

  tiled::load_tile<J>(qt, qb, q0, ROWS, sq, qs.s, d, vec);
  tiled::load_tile<J>(kt, kb, 0, KEYS, sk, ks.s, d, vec);
  cp_async_commit();

  const int a0 = RT * ty;                                // the thread's first row in the block
  const long long pos0 = static_cast<long long>(offset) + q0 + a0;
  const int wr0 = q0 + 2 * RT * warp;                    // the warp's rows: wr0 .. wr0 + 2 RT - 1
  const long long w_first = static_cast<long long>(offset) + wr0;
  const long long w_last = static_cast<long long>(offset) + min(wr0 + 2 * RT, sq) - 1;
  float acc[RT][J], m[RT], l[RT];
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    m[i] = tiled::NEG, l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < J; ++j) acc[i][j] = 0.f;
  }

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * KEYS;
    cp_async_wait<0>();
    __syncthreads();               // K_j is in; every warp is done with V_{j - 1}
    tiled::load_tile<J>(vt, vb, k0, KEYS, sk, vs.s, d, vec);
    cp_async_commit();
    const bool active = wr0 < sq && k0 <= w_last;
    float s[RT][CT];              // S, then P
    if (active) {
      tiled::abt<RT, CT, RS>(s, qt + a0 * RS, kt + tx * RS, w);
      const bool full = k0 + KEYS <= sk && k0 + KEYS - 1 <= w_first;
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        float mx = m[i];
#pragma unroll
        for (int j = 0; j < CT; ++j) {
          const int key = k0 + tx + 16 * j;
          s[i][j] = full || (key < sk && pos0 + i >= key) ? s[i][j] * scale_log2 : tiled::NEG;
          mx = fmaxf(mx, s[i][j]);
        }
        mx = tiled::max16(mx);
        const float corr = hopper::exp2_ftz(m[i] - mx);
        m[i] = mx;
        l[i] *= corr;
#pragma unroll
        for (int j = 0; j < CT; ++j) {
          s[i][j] = hopper::exp2_ftz(s[i][j] - mx);
          l[i] += s[i][j];
        }
#pragma unroll
        for (int j = 0; j < J; ++j) acc[i][j] *= corr;
      }
    }
    cp_async_wait<0>();
    __syncthreads();               // V_j is in; every warp is done with K_j
    if (tile + 1 < n_tiles) tiled::load_tile<J>(kt, kb, k0 + KEYS, KEYS, sk, ks.s, d, vec);
    cp_async_commit();
    if (active) tiled::xty_chunks<RT, CT, J, NCH, PS, RS>(acc, s, pt, vt + tx, tx, a0);
  }

#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const float sum = tiled::sum16(l[i]);
    const int row = q0 + a0 + i;
    if (row < sq) {
      const float den = fmaxf(sum, 1e-30f);
      float* op = o + ((static_cast<long long>(b) * sq + row) * hq + h) * d;
#pragma unroll
      for (int j = 0; j < J; ++j)
        if (tx + 16 * j < d) op[tx + 16 * j] = acc[i][j] / den;
      // m is the row's max of its scores in the log2 domain (times
      // scale_log2), l its sum of 2^(s scale_log2 - m) = e^(s scale - m ln 2)
      if (lse != nullptr && tx == 0)
        lse[(static_cast<long long>(b) * hq + h) * sq + row] = (m[i] + log2f(sum)) * tiled::LN2;
    }
  }
}

template <int J>
cudaError_t launch_tiled(const float* q, const float* k, const float* v, float* o, float* lse,
                         dim3 grid, size_t smem, int sq, int sk, int hq, int hkv, int offset,
                         int d, bool vec, Strides qs, Strides ks, Strides vs, cudaStream_t stream) {
  using L = tiled::FwdTiles<J>;
  if (smem != L::SMEM || grid.z != static_cast<unsigned>((sq + L::ROWS - 1) / L::ROWS))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_tiled_kernel<J>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  flash_tiled_kernel<J><<<grid, L::THREADS, smem, stream>>>(
      q, k, v, o, lse, sq, sk, hq, hq / hkv, offset, d, vec, qs, ks, vs,
      tiled::LOG2E / sqrtf(static_cast<float>(d)));
  return cudaGetLastError();
}

// --- bf16 on Hopper: wgmma fed by TMA, one producer and two consumers --------

namespace hopper {

constexpr int ROWS = 128;          // query rows per block, 64 per consumer warpgroup

constexpr int KEYS = 128;          // keys per K/V tile up to width 128
constexpr int WIDE_KEYS = 64;      // past it, where O takes D/2 = 96 or 128 floats a thread
// and S (64 floats at 128 keys) and P (32 registers) would not fit beside it
// in a wide consumer's 224 registers.  The keys of a K/V tile at tile width d:
__host__ __device__ constexpr int keys_of(int d) { return d > 128 ? WIDE_KEYS : KEYS; }

// Shared memory, from a 1024-byte aligned base (every swizzle repeats
// within 8 rows, at most 1024 bytes): Q (ROWS rows), the K ring, the V ring
// (KEYS rows a stage), then the mbarriers q_full, k_full[STAGES],
// v_full[STAGES], empty[STAGES].  A tile's column boxes (Swz: one at widths
// 16 and 32, D / 64 past them) lie one after another, each its rows of
// W::ROW swizzled bytes; TMA fills them by boxes of KEYS rows (Q by ROWS /
// KEYS).  The ring is as deep as 227 KB allows, at most 4 (the narrow
// tiles: 16 KB a stage at width 32, two blocks an SM).
template <int D>
struct Layout {
  using W = Swz<D>;
  static constexpr int KEYS = keys_of(D);
  static constexpr int BOXES = D / W::COLS;            // column boxes per tile
  static constexpr int STAGES = D <= NARROW ? 4 : D == 64 || D == 192 ? 3 : 2;
  static constexpr uint32_t Q_BOX = ROWS * W::ROW;     // Q: from one column box to the next
  static constexpr uint32_t KV_BOX = KEYS * W::ROW;    // K and V: the same
  static constexpr uint32_t Q_TILE = BOXES * Q_BOX;
  static constexpr uint32_t KV_TILE = BOXES * KV_BOX;
  static constexpr uint32_t Q = 0;
  static constexpr uint32_t K = Q + Q_TILE;
  static constexpr uint32_t V = K + STAGES * KV_TILE;
  static constexpr uint32_t BARS = V + STAGES * KV_TILE;
  static constexpr size_t SMEM = 1024 + BARS + 8 * (1 + 3 * STAGES);   // 1024: alignment slack
};

// S = Q K^T (issued, not waited for): D/16 steps of 16 along D, each 32
// bytes into a swizzled row of Q's and K's boxes (the hardware applies the
// swizzle); 8-row groups W::GROUP bytes apart (the SBO).
template <int D, typename T>
__device__ __forceinline__ void qk(float (&s)[keys_of(D) / 2], uint32_t q, uint32_t k) {
  using L = Layout<D>;
  using W = Swz<D>;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int box = kk / W::KSTEPS, at = (kk % W::KSTEPS) * 32;
    const uint64_t a = W::desc(q + box * L::Q_BOX + at, 16, W::GROUP);
    const uint64_t b = W::desc(k + box * L::KV_BOX + at, 16, W::GROUP);
    if (kk == 0)
      wgmma_ss<L::KEYS, true, T>(s, a, b);
    else
      wgmma_ss<L::KEYS, false, T>(s, a, b);
  }
  wgmma_commit();
}

// O += P V (issued, not waited for): KEYS/16 steps of 16 keys, each 16 rows
// (16 W::ROW bytes) into V's boxes; N = D spans the D / W::COLS boxes,
// KV_BOX apart (the LBO).
template <int D, typename T>
__device__ __forceinline__ void pv(float (&acc)[D / 2], const uint32_t (&p)[keys_of(D) / 4],
                                   uint32_t v) {
  using L = Layout<D>;
  using W = Swz<D>;
#pragma unroll
  for (int kk = 0; kk < L::KEYS / 16; ++kk)
    wgmma_rs<D, T>(acc, p + 4 * kk, W::desc(v + kk * 16 * W::ROW, L::KV_BOX, W::GROUP));
  wgmma_commit();
}

// Mask S (only tiles that cross the diagonal or the end of K), then the
// online softmax in the log2 domain: s becomes 2^(s * scale_log2 - m *
// scale_log2) with m the new row max, l the per-thread partial row sums
// (summed at the end), corr what O must be scaled by.  KEYS keys a tile.
template <int KEYS>
__device__ __forceinline__ void softmax(float (&s)[KEYS / 2], float (&m)[2], float (&l)[2],
                                        float (&corr)[2], int k0, int sk, long long qpos,
                                        long long first, int t, float scale_log2) {
  if (!(k0 + KEYS <= sk && k0 + KEYS - 1 <= first)) {
#pragma unroll
    for (int i = 0; i < KEYS / 2; ++i) {
      const int key = k0 + 8 * (i >> 2) + 2 * t + (i & 1);
      if (!(key < sk && qpos + 8 * ((i >> 1) & 1) >= key)) s[i] = NEG;
    }
  }
  float mx[2] = {m[0], m[1]}, ms[2];
#pragma unroll
  for (int i = 0; i < KEYS / 2; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    corr[r] = exp2_ftz((m[r] - mx[r]) * scale_log2);
    m[r] = mx[r];
    ms[r] = mx[r] * scale_log2;
    l[r] *= corr[r];
  }
#pragma unroll
  for (int i = 0; i < KEYS / 2; ++i) {
    s[i] = exp2_ftz(fmaf(s[i], scale_log2, -ms[(i >> 1) & 1]));
    l[(i >> 1) & 1] += s[i];
  }
}

// Accumulator layout of wgmma m64nNk16 (warp w of the warpgroup, lane =
// 4g + t): element i is row 16w + g + 8 * ((i >> 1) & 1), column
// 8 * (i >> 2) + 2t + (i & 1).  Register-A layout of a 64 x 16 bf16 slice:
// four pairs, (g, 2t), (g + 8, 2t), (g, 2t + 8), (g + 8, 2t + 8), which are
// elements 8kk + 0..7 of the accumulator of S for key slice kk.  D is the
// tiles' width, DO <= D the head dim: the output's row length and the
// columns stored; DO = 0 takes the head dim from `dh` at run time (a
// multiple of 8 in [least_dim(D), D]: (D - 64, D] from width 64 on, 8 or 16
// at width 16, 24 or 32 at 32).  T is bf16 or fp16.  With `lse` each row's
// log-sum-exp of its scaled scores, m * scale + ln(l), goes to lse (B, Hq,
// Sq) in fp32 for the backward; nullptr stores nothing, and the output is
// the same either way.  DO = -1 takes any head dim in [least_dim(D), D]
// (the wrapper's staged inputs at a head dim off a multiple of 8: 5, 33,
// 100, 250) and guards every store by column (hopper.cuh, store2): the last chunk of
// 8 columns is then partial, and at an odd head dim the pairs are not
// 4-byte aligned.  The multiples of 8 keep instantiations without those
// guards (a separate instantiation: the guards, compiled into them, cost
// 3-6 % of their time on an H100).
template <int D, int DO = D, typename T = __nv_bfloat16>
__global__ void __launch_bounds__(RolesOf<D>::THREADS, RolesOf<D>::BLOCKS)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap, T* __restrict__ o,
                   float* __restrict__ lse, int sq, int sk, int hq, int group, int offset,
                   int dh, float scale_log2) {
  using L = Layout<D>;
  using W = Swz<D>;
  using R = RolesOf<D>;
  constexpr int S = L::STAGES, KEYS = L::KEYS;
  extern __shared__ unsigned char hopper_smem[];
  const uint32_t base = (smem_addr(hopper_smem) + 1023) & ~1023u;
  const uint32_t bars = base + L::BARS;
  const uint32_t q_full = bars;
  auto k_full = [bars](int s) { return bars + 8 * (1 + s); };
  auto v_full = [bars](int s) { return bars + 8 * (1 + S + s); };
  auto empty = [bars](int s) { return bars + 8 * (1 + 2 * S + s); };

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * ROWS;   // heaviest query tiles first
  const int n_tiles = kv_tiles<ROWS, KEYS>(q0, sq, sk, offset);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(empty(s), 2 * 128);    // every consumer thread releases the stage
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Q, then tile j's K and V into its stage once the stage is free: TMA
  // counts the whole box, rows past Sq or Sk included (they land as zeros).
  const int hk = h / group;
  auto load_q = [&] {
    mbar_expect(q_full, L::Q_TILE);
    for (int x = 0; x < L::BOXES; ++x)
      for (int y = 0; y < ROWS / KEYS; ++y)      // boxes of KEYS rows
        tma_load(base + L::Q + x * L::Q_BOX + y * KEYS * W::ROW, qmap, q_full, x * W::COLS, h,
                 q0 + y * KEYS, b);
  };
  auto load_kv = [&](int j) {
    const int s = j % S;
    mbar_wait(empty(s), ((j / S) & 1) ^ 1);    // round 0 finds every stage free
    mbar_expect(k_full(s), L::KV_TILE);
    for (int x = 0; x < L::BOXES; ++x)
      tma_load(base + L::K + s * L::KV_TILE + x * L::KV_BOX, kmap, k_full(s), x * W::COLS, hk,
               j * KEYS, b);
    mbar_expect(v_full(s), L::KV_TILE);
    for (int x = 0; x < L::BOXES; ++x)
      tma_load(base + L::V + s * L::KV_TILE + x * L::KV_BOX, vmap, v_full(s), x * W::COLS, hk,
               j * KEYS, b);
  };
  // The loader of the layouts without a producer (the widest and the
  // narrow tiles): consumer 1's first thread, which loads Q and the first S
  // tiles here and tile j + S - 1 in its turn j (below).
  constexpr int LOADER = 128;

  if (R::producer()) {
    // Producer: one thread keeps the ring full.
    R::producer_regs();
    if (threadIdx.x == 0) {
      load_q();
      for (int j = 0; j < n_tiles; ++j) load_kv(j);
    }
  } else {
    R::consumer_regs();
    const int c = R::consumer();                     // which 64 rows of the block
    const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const int row = q0 + 64 * c + 16 * warp + g;     // this thread's rows: row, row + 8
    const long long qpos = static_cast<long long>(offset) + row;
    const long long first = static_cast<long long>(offset) + q0 + 64 * c;
    const uint32_t qa = base + L::Q + c * 64 * W::ROW;

    float s[KEYS / 2];    // S for KEYS keys, then P in fp32
    float acc[D / 2];     // O
    uint32_t p[KEYS / 4]; // P in bf16 pairs: the A fragments of the KEYS / 16 key slices
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};

    // The two consumers take turns to issue their S products (ping-pong, on
    // named barrier 1 + c: consumer c's turn), so that one's softmax runs
    // while the other's products hold the tensor cores.  Each has n_tiles
    // turns; consumer 0 goes first.
    float corr[2];
    if (R::WIDE && threadIdx.x == LOADER) {
      load_q();
      for (int j = 0; j < min(S, n_tiles); ++j) load_kv(j);
    }
    if constexpr (R::WIDE) __syncwarp();   // the loader's warp, converged for wgmma
    mbar_wait(q_full, 0);
    if (c == 1) bar_arrive_consumers(1);
    for (int j = 0; j < n_tiles; ++j) {
      const int st = j % S;
      const uint32_t parity = (j / S) & 1;
      mbar_wait(k_full(st), parity);
      bar_sync_consumers(1 + c);
      // Consumer 1's turn j comes after consumer 0 issued its S of tile j,
      // so after both released tile j - 1: its stage takes tile j + S - 1.
      if (R::WIDE && threadIdx.x == LOADER && j >= 1 && j + S - 1 < n_tiles)
        load_kv(j + S - 1);
      if constexpr (R::WIDE) __syncwarp();
      wgmma_fence();
      qk<D, T>(s, qa, base + L::K + st * L::KV_TILE);
      if (c == 0 || j + 1 < n_tiles) bar_arrive_consumers(2 - c);
      wgmma_wait<0>();
      pin(s);
      softmax<KEYS>(s, m, l, corr, j * KEYS, sk, qpos, first, t, scale_log2);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] *= corr[(i >> 1) & 1];
#pragma unroll
      for (int i = 0; i < KEYS / 4; ++i) p[i] = pack2<T>(s[2 * i], s[2 * i + 1]);
      mbar_wait(v_full(st), parity);
      pin(acc);
      pin(p);
      wgmma_fence();
      pv<D, T>(acc, p, base + L::V + st * L::KV_TILE);
      wgmma_wait<0>();
      pin(acc);
      pin(p);
      mbar_arrive(empty(st));
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      const int orow = row + 8 * r;
      if (orow < sq) {
        const float inv = 1.f / fmaxf(l[r], 1e-30f);
        const int dcols = DO > 0 ? DO : dh;
        if constexpr (DO < 0) {             // any head dim: each column guarded
          T* op = o + ((static_cast<long long>(b) * sq + orow) * hq + h) * dcols;
#pragma unroll
          for (int n = 0; n < D / 8; ++n)
            if (8 * n < dcols)
              store2<T>(op, 8 * n + 2 * t, dcols, acc[4 * n + 2 * r] * inv,
                        acc[4 * n + 2 * r + 1] * inv);
        } else {
          T* op = o + ((static_cast<long long>(b) * sq + orow) * hq + h) * dcols + 2 * t;
#pragma unroll
          for (int n = 0; n < D / 8; ++n)   // columns 8n + 2t, +1 < the head dim
            if (8 * n < dcols)
              *reinterpret_cast<uint32_t*>(op + n * 8) =
                  pack2<T>(acc[4 * n + 2 * r] * inv, acc[4 * n + 2 * r + 1] * inv);
        }
        // m is the row's max of the unscaled scores and l its sum of
        // 2^((s - m) * scale_log2) = e^((s - m) * scale), so the natural
        // LSE of s * scale is (m * scale_log2 + log2(l)) * ln 2.
        if (lse != nullptr && t == 0)
          lse[(static_cast<long long>(b) * hq + h) * sq + orow] =
              (m[r] * scale_log2 + log2f(l[r])) * 0.6931471805599453f;
      }
    }
  }
}

// The Hopper kernel on tiles D wide for head dim DO (DO = D, or 112 on D =
// 128; DO = 0: the head dim dh, a multiple of 8, in [least_dim(D), D]; DO =
// -1: any dh there), T bf16 or fp16.
template <int D, int DO = D, typename T = __nv_bfloat16>
cudaError_t launch(const CUtensorMap (&maps)[3], void* o, float* lse, int sq, int sk, int hq,
                   int hkv, int dh, int offset, dim3 grid, size_t smem, cudaStream_t stream) {
  static_assert(DO <= 0 || (DO <= D && DO % 16 == 0 && DO >= least_dim(D)),
                "DO: a head dim of D's tiles");
  if (DO > 0 ? dh != DO : ((DO == 0 && dh % 8 != 0) || dh > D || dh < least_dim(D)))
    return cudaErrorInvalidValue;
  if (smem != Layout<D>::SMEM) return cudaErrorInvalidValue;
  using R = RolesOf<D>;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, flash_wgmma_kernel<D, DO, T>);
  if (err != cudaSuccess) return err;
  if (!R::launchable(attr.numRegs)) return cudaErrorLaunchOutOfResources;
  err = cudaFuncSetAttribute(flash_wgmma_kernel<D, DO, T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const float scale_log2 = 1.4426950408889634f / sqrtf(static_cast<float>(dh));
  flash_wgmma_kernel<D, DO, T><<<grid, R::THREADS, smem, stream>>>(
      maps[0], maps[1], maps[2], static_cast<T*>(o), lse, sq, sk, hq, hq / hkv, offset, dh,
      scale_log2);
  return cudaGetLastError();
}

// The run-time head dim's instantiations: tiles tile_of(d) wide (16, 32,
// 64, 128, 192 or 256), DO 0 (d a multiple of 8) or -1 (any d: the guarded
// stores).
template <int DO, typename T>
int by_tile(const CUtensorMap (&tm)[3], void* o, float* lse, int sq, int sk, int hq, int hkv,
            int d, int offset, dim3 grid, size_t smem, cudaStream_t s) {
  switch (tile_of(d)) {
    case 16:
      return static_cast<int>(launch<16, DO, T>(tm, o, lse, sq, sk, hq, hkv, d, offset, grid,
                                                smem, s));
    case 32:
      return static_cast<int>(launch<32, DO, T>(tm, o, lse, sq, sk, hq, hkv, d, offset, grid,
                                                smem, s));
    case 64:
      return static_cast<int>(launch<64, DO, T>(tm, o, lse, sq, sk, hq, hkv, d, offset, grid,
                                                smem, s));
    case 128:
      return static_cast<int>(launch<128, DO, T>(tm, o, lse, sq, sk, hq, hkv, d, offset, grid,
                                                 smem, s));
    case 192:
      return static_cast<int>(launch<192, DO, T>(tm, o, lse, sq, sk, hq, hkv, d, offset, grid,
                                                 smem, s));
    default:
      return static_cast<int>(launch<256, DO, T>(tm, o, lse, sq, sk, hq, hkv, d, offset, grid,
                                                 smem, s));
  }
}

}  // namespace hopper

}  // namespace

extern "C" {

// dtype 0 = float32, 1 = bfloat16, 2 = float16.  q (b, sq, hq, d), k/v (b,
// sk, hkv, d) with unit stride along d and the given element strides along
// b, s, h; o (b, sq, hq, d) contiguous.  1 <= d <= 256, on the least padded
// width of 16, 32, 64, 128, 256 that holds it; hq a multiple of hkv,
// causal_offset >= 0.  The grid must be the kernels' (ceil(sq / 64), hq, b),
// as the wrapper plans it.  The 16-bit kernels copy 16 bytes at a time where
// d, the strides and the starts allow it, else element by element; given
// `lse` ((b, hq, sq) float32), they also store each row's log-sum-exp, as
// the Hopper kernel does (flash_f32_kernel, the first fp32 design, takes
// none; gqa_flash_tiled is fp32's route).  Both run only on request, the
// yardsticks of the Hopper and tiled kernels.
int gqa_flash_fwd(int dtype, const void* q, const void* k, const void* v, void* o, float* lse,
                  int b, int sq, int sk, int hq, int hkv, int d, int causal_offset,
                  long long q_sb, long long q_ss, long long q_sh, long long k_sb,
                  long long k_ss, long long k_sh, long long v_sb, long long v_ss,
                  long long v_sh, int grid_x, int grid_y, int grid_z, void* stream) {
  if (b < 1 || sq < 1 || sk < 1 || hkv < 1 || hq % hkv != 0 || causal_offset < 0 ||
      b > 65535 || hq > 65535 || dtype < 0 || dtype > 2 || d < 1 || d > 256 ||
      grid_x != (sq + BQ - 1) / BQ || grid_y != hq || grid_z != b ||
      (dtype == 0 && lse != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh}, vs{v_sb, v_ss, v_sh};
  const long long strides[9] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh};
  bool vec = d % 8 == 0;
  for (long long st : strides) vec = vec && st % 8 == 0;
  for (const void* ptr : {q, k, v}) vec = vec && reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (padded_dim(d)) {
    case 16:
      return static_cast<int>(launch<16>(dtype, q, k, v, o, lse, b, sq, sk, hq, hkv, d,
                                         causal_offset, vec, qs, ks, vs, s));
    case 32:
      return static_cast<int>(launch<32>(dtype, q, k, v, o, lse, b, sq, sk, hq, hkv, d,
                                         causal_offset, vec, qs, ks, vs, s));
    case 64:
      return static_cast<int>(launch<64>(dtype, q, k, v, o, lse, b, sq, sk, hq, hkv, d,
                                         causal_offset, vec, qs, ks, vs, s));
    case 128:
      return static_cast<int>(launch<128>(dtype, q, k, v, o, lse, b, sq, sk, hq, hkv, d,
                                          causal_offset, vec, qs, ks, vs, s));
    default:
      return static_cast<int>(launch<256>(dtype, q, k, v, o, lse, b, sq, sk, hq, hkv, d,
                                          causal_offset, vec, qs, ks, vs, s));
  }
}

// The "tiled" route (fp32).  q (b, sq, hq, d), k/v (b, sk, hkv, d) with unit
// stride along d and the given element strides along b, s, h; o (b, sq, hq,
// d) contiguous; lse, when not null, (b, hq, sq) float32: each row's
// log-sum-exp for the backward's "tiled" route.  1 <= d <= 256, on J =
// ceil(d / 16) accumulator slots (flash_tiled_kernel<J>); hq a multiple of
// hkv, causal_offset >= 0.  The grid must be (hq, b, ceil(sq / R)), R the
// block's query rows (128 up to d 128, 64 past it), `smem` the kernel's
// dynamic shared memory.  Tiles come by 16-byte cp.async where d, the
// strides and the starts allow it, else by 4-byte cp.async.
int gqa_flash_tiled(const void* q, const void* k, const void* v, void* o, float* lse, int b,
                    int sq, int sk, int hq, int hkv, int d, int causal_offset, long long q_sb,
                    long long q_ss, long long q_sh, long long k_sb, long long k_ss,
                    long long k_sh, long long v_sb, long long v_ss, long long v_sh, int grid_x,
                    int grid_y, int grid_z, long long smem, void* stream) {
  if (b < 1 || sq < 1 || sk < 1 || hkv < 1 || hq % hkv != 0 || causal_offset < 0 ||
      b > 65535 || hq > 65535 || d < 1 || d > 256 || grid_x != hq || grid_y != b ||
      grid_z < 1 || grid_z > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh}, vs{v_sb, v_ss, v_sh};
  const long long strides[9] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh};
  bool vec = d % 4 == 0;
  for (long long st : strides) vec = vec && st % 4 == 0;
  for (const void* ptr : {q, k, v}) vec = vec && reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
  const dim3 grid(grid_x, grid_y, grid_z);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(tiled::with_slots(tiled::slots(d), [&](auto j) {
    return launch_tiled<decltype(j)::value>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), lse, grid,
        static_cast<size_t>(smem), sq, sk, hq, hkv, causal_offset, d, vec, qs, ks, vs, s);
  }));
}

// dtype 1 = bfloat16, 2 = float16.  q (b, sq, hq, d), k/v (b, sk, hkv, d),
// 1 <= d <= 256, through the Hopper kernel: bf16 at d 64,
// 112 and 128 on instantiations of their own (d = 112 on the d = 128
// tiles), every other d on the tiles 16, 32, 64, 128, 192 or 256 wide
// (hopper::tile_of(d)) with the head dim taken at run time; o (b,
// sq, hq, d) contiguous; lse, when not null, (b, hq, sq) float32: each
// row's log-sum-exp for the backward.  TMA needs byte strides that are
// multiples of 16, so at a d off a multiple of 8 the wrapper hands in views
// of copies whose rows are ceil(d / 8) * 8 wide.  `maps` holds, for q, k and v in
// turn, eleven numbers: the tensor map's dims (d, h, s, b), its byte
// strides along h, s and b, and its box (w, 1, R, 1), w 16, 32 or 64 (the
// tiles' width up to 64), R the keys of a K/V tile (128 up to d 128, else
// 64).  The grid is (hq, b, ceil(sq / 128));
// `smem` the kernel's dynamic shared memory.
int gqa_flash_wgmma(int dtype, const void* q, const void* k, const void* v, void* o,
                    float* lse, int b, int sq, int sk, int hq, int hkv, int d,
                    int causal_offset, const unsigned long long* maps, int grid_x, int grid_y,
                    int grid_z, long long smem, void* stream) {
  using hopper::ROWS;
  if (b < 1 || sq < 1 || sk < 1 || hkv < 1 || hq % hkv != 0 || causal_offset < 0 ||
      grid_x != hq || grid_y != b || grid_z != (sq + ROWS - 1) / ROWS || b > 65535 ||
      grid_z > 65535 || (dtype != 1 && dtype != 2) || d < 1 || d > 256)
    return static_cast<int>(cudaErrorInvalidValue);
  const void* ptrs[3] = {q, k, v};
  CUtensorMap tm[3];
  const int err = hopper::encode_maps(tm, ptrs, 3, maps, d, hopper::keys_of(d), dtype == 2);
  if (err != 0) return err;
  const dim3 grid(grid_x, grid_y, grid_z);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t sm = static_cast<size_t>(smem);
  if (dtype == 2)
    return d % 8 != 0 ? hopper::by_tile<-1, __half>(tm, o, lse, sq, sk, hq, hkv, d,
                                                   causal_offset, grid, sm, s)
                      : hopper::by_tile<0, __half>(tm, o, lse, sq, sk, hq, hkv, d,
                                                  causal_offset, grid, sm, s);
  switch (d) {
    case 64:
      return static_cast<int>(hopper::launch<64>(tm, o, lse, sq, sk, hq, hkv, d, causal_offset,
                                                 grid, sm, s));
    case 112:
      return static_cast<int>(hopper::launch<128, 112>(tm, o, lse, sq, sk, hq, hkv, d,
                                                       causal_offset, grid, sm, s));
    case 128:
      return static_cast<int>(hopper::launch<128>(tm, o, lse, sq, sk, hq, hkv, d, causal_offset,
                                                  grid, sm, s));
  }
  return d % 8 != 0 ? hopper::by_tile<-1, __nv_bfloat16>(tm, o, lse, sq, sk, hq, hkv, d,
                                                        causal_offset, grid, sm, s)
                    : hopper::by_tile<0, __nv_bfloat16>(tm, o, lse, sq, sk, hq, hkv, d,
                                                       causal_offset, grid, sm, s);
}

}  // extern "C"
