// Hand-written Hopper kernels for the backward pass of causal GQA attention:
// the gradient of csrc/flash_attention.cu's forward (gqa_flash), so that the
// port's default attention trains on kernels.
//
// Replaces: nothing of the TPU package is a kernel here.  Its Pallas
// gqa_flash (src/repro/kernels/flash_attention.py:94, _flash_kernel) has no
// gradient (jax.grad through it raises); the reference trains with XLA's
// autodiff of chunked_attention (src/repro/models/common.py:255-303), and
// these kernels compute that gradient.
//
// Semantics, as kernels/flash_attention.py::gqa_flash_bwd_plain: q (B, Sq,
// Hq, D), k/v (B, Sk, Hkv, D), o and dO (B, Sq, Hq, D), all contiguous;
// query head h reads KV head h / (Hq / Hkv); key j is live for row i when
// causal_offset + i >= j and j < Sk; scale = 1/sqrt(D).  With
// P = softmax(q.k * scale) over the live keys, in fp32:
//   dV = P^T dO,  dP = dO V^T,  D_i = sum_d dO_i,d O_i,d,
//   dS = P o (dP - D),  dQ = dS K * scale,  dK = dS^T Q * scale,
// dK and dV summed over the Hq / Hkv query heads of their KV head.
// Outputs are written in the inputs' dtype (float32, bfloat16 or float16;
// the wrapper runs float64 on fp32 copies), at any head dim 1 <= D <= 256.
// Two routes, picked by dtype and D alone
// (kernels/flash_attention.py::bwd_route), and two more on request:
//
// "wgmma" (bf16 and fp16 at every D in [1, 256], where the forward's route
// is the Hopper kernel; every model config that trains in bf16, and the
// example trainers), namespace wg.  The forward's flash_wgmma_kernel writes each row's
// LSE, so P = exp(S * scale - LSE) needs no statistics pass.  Two kernels,
// each a TMA producer warpgroup (one thread issuing 4-D tensor-map loads
// with 128-byte swizzle, boxes of 64 rows x 64 bf16) and two wgmma consumer
// warpgroups, launched in this order:
//   flash_bwd_dq_wgmma_kernel: one block per (128 query rows, query head,
//     batch), heaviest tiles first.  It first takes D_i of its rows from
//     device memory (written to fp32 scratch for the next kernel); then per
//     ring stage of 64 keys (32 past width 128) S = Q K^T and dP = dO V^T
//     (m64n64k16 or m64n32k16, both operands in shared memory), P and dS =
//     P (dP - D_i) in registers, dS rounded to bf16 as wgmma's register-A
//     operand, dQ += dS K (K read MN-major); dQ * scale stored once in bf16.
//   flash_bwd_dkdv_wgmma_kernel: one block per (64 keys, KV head, batch); K
//     and V loaded once; the ring brings Q and dO of every 64-row query tile
//     of the group's heads that sees the block's keys, with those rows' LSE
//     and D_i (staged by producer warp 1).  The consumers split the outputs:
//     consumer 0 takes S^T = K Q^T from shared memory and P^T in registers,
//     hands P^T (fp32) to consumer 1 through shared memory and runs dV +=
//     P^T dO; consumer 1 takes dP^T = V dO^T, dS^T = P^T (dP^T - D_i) and
//     runs dK += dS^T Q (P^T and dS^T as bf16 register-A operands, dO and Q
//     read MN-major).  Holding dK and dV of 64 keys in one warpgroup (128
//     fp32 a thread) beside S^T and dP^T spilled under ptxas, which then
//     serialised the wgmma; split, each consumer holds 64.  dK * scale and
//     dV are stored once.  Summing the group inside the block keeps GQA
//     free of atomics: each output element has one writer and each sum one
//     order, so two runs give equal bits.
// Every 16-bit multiple of 8 in (32, 128] but bf16 64 and 128 (their own
// instantiations) runs the head-dim kernels (by_width): the same two kernels
// with every product at the head's own width W = ceil(D / 16) * 16 on the
// tiles 64 or 128 wide (Products<W, W, true>: S, dP and their transposes in
// W / 16 k-steps, TMA's zero columns past W skipped; dQ += dS K, dV += P^T
// dO and dK += dS^T Q at N = W, W / 2 accumulators a thread), their blocks
// in the L2 order (l2_unit): dQ a group of KV heads whose K and V fit a
// quarter of L2 at a time, dK/dV a group whose query heads' Q and dO do
// (kernels/flash_attention.py::plan_bwd; one group of every KV head is the
// grid's order).  Their gradients equal the whole-tile pair's bit for bit,
// which stays by name (route="wgmma_tile", the yardstick; at bf16 D 112 the
// D = 128 kernels storing 112 columns).  On an H100 80GB HBM3 at 700 W
// (scripts/kernel_splits.py widths): at internvl2-2b's train shape in bf16
// D 96 the pair 0.603 against 0.677 ms of device time (the products 0.611,
// dK/dV's 0.379 -> 0.335 the most); at zamba2-7b's layout in bf16 D 112
// 1.088 against 1.307, where the L2 order does the work (the products
// alone 1.298: dK/dV reads each head's Q and dO once a key tile, 117 MB a
// wave in the grid's order).  At a D off a multiple of 8 the
// tensor maps read views of copies of q, k, v and dO whose rows are
// ceil(D / 8) * 8 wide (a contiguous 16-bit row of D elements has a byte
// stride TMA refuses), the D_i pass o and the staged dO element by
// element, and every store is guarded by column.  Every other D of the
// route runs on tiles as wide as the least multiple of 64 that holds it (or
// 16 or 32), the tiles' whole width with D taken at run time
// (instantiations <16 ... 256, 0 or -1, T>; fp16 through .f16 wgmma).  Past width 128 (D in (128,
// 256]) each consumer's dQ, dK or dV takes 96 or 128 fp32 registers a
// thread, and Q and dO of the dQ kernel's 128 rows take 96 or 128 KiB:
//   dQ keeps its 128 rows a block (two consumers of 64, Q and dO resident)
//     and takes K/V tiles of 32 keys (S and dP m64n32k16, dQ += dS K over 2
//     steps of 16 keys), 4 stages at 192 and 3 at 256 (197,704 and 230,456
//     bytes).  64 query rows a block with two 64-key stages would have left
//     one consumer per block idle or split the keys between the two and
//     summed dQ across them, and would have read K and V from L2 twice as
//     often.
//   dK/dV keeps its 64 keys a block and 64-row Q/dO tiles, with 3 stages at
//     192 and 2 at 256 (231,992 and 231,464 bytes, the P^T buffers in fp32
//     as the narrow kernels').
// Every TMA box is then 32 rows.  Every such head dim, a multiple of 8 or
// staged, runs the wide pair (Wide, by_wide): both kernels in the L2 order
// (l2_unit; dQ kv_group's KV heads a group, dK/dV rows_group's), at width
// 256 the producer layout with 240 registers a consumer thread (hopper.cuh,
// Roles: the SASS names up to R189-R230 in dQ and R203 in dK/dV under the
// launch's 168, 0 spills), and at width 192 dQ's K/V tiles of 64 keys (S
// and dP m64n64k16, dQ += dS K over 4 steps, 2 stages, 197,672 bytes).
// Their gradients equal the yardsticks' bit for bit at width 256; at 192
// dK and dV do, and dQ sums each row in another order.  The whole-tile pair
// in the grid's order stays by name (route="wgmma_tile", the yardstick):
// at width 256 the two consumer warpgroups alone (256 threads; 196 and 225
// registers): in dQ, consumer 0's first thread issues the loads, tile j +
// STAGES - 1 at the top of its turn j once consumer 1 has released tile
// j - 1 (consumer 0's rows see fewer keys and run ahead); in dK/dV,
// consumer 1's first warp (lane 0 the TMA loads, every lane the LSE and
// D_i) fills tile j - 1's stage once consumer 0's P^T of tile j is in,
// which it wrote after releasing tile j - 1.  At internvl2-2b's train
// shape with 16 query heads over 8 KV heads (B 4, S 2304) on an H100 80GB
// HBM3 at 700 W (scripts/kernel_splits.py wide, device time in turns):
// bf16 D 256 1.3929 against the yardstick's 1.6460 ms (dQ 0.6526 against
// 0.7489, dK/dV 0.7104 against 0.9044; the producer in the grid's order
// 1.4034, the L2 order without it 1.7233; SDPA's backward ~1.52); bf16 D
// 192 0.9905 against 1.1067 (dQ 0.4032 against 0.5242; dK/dV 0.5707 in the
// L2 order, 0.5446 in the grid's).
// At D <= 32 (train_carbon_aware's tiny preset, D 16, and 10m, D 32) the
// tiles are 16 or 32 columns wide (hopper.cuh, Swz: boxes as wide as the
// tile under the 32- or 64-byte swizzle, descriptors of that layout, dQ +=
// dS K and dK/dV's products at N 16 or 32).  There one exponential a score
// in each kernel (0.069 ms at B 4, S 2048, 16 x 8 heads at ~3.9 T/s) sets
// the floor, not the seven products (0.043 ms), and a tile's cost is its
// exponentials, waits and barriers: the narrow kernels run without the
// producer warpgroup, two blocks an SM (RolesOf), four consumer
// warpgroups an SM hiding each other's waits; in 128 registers a thread
// (dQ at 128, dK/dV 107-111, no spill) the 64-key dQ tiles and 64-row
// dK/dV tiles stay (S and dP of 64 keys beside dS and dQ; twice the keys
// or rows would pass 128).  The pair took 0.285 ms there on an H100 (dQ
// 0.127, dK/dV 0.157), the producer layout's 0.355, the mma pair below
// 0.539 (scripts/kernel_splits.py narrow and mma).
// Rows past Sq add nothing: their Q and dO land as zeros and their LSE and
// D_i are taken as 0, so dS and P^T dO vanish there; tiles that cross the
// diagonal or the end of K are masked.
//
// "mma" (only on request, route="mma": bf16 and fp16 at D <= 32, the
// yardstick of the narrow wgmma kernels), namespace mm.  It reads the forward's LSE (either forward writes one), so no
// statistics pass: two kernels of 4 warps on mma.sync m16n8k16 (.bf16 or .f16), tiles
// of 64 rows and 64 keys with rows of DP + 8 elements (DP 16 or 32, the
// columns past D zero), launched in this order:
//   flash_bwd_dq_mma_kernel: one block per (64 query rows, query head,
//     batch), heaviest tiles first; D_i of its rows (written to fp32 scratch
//     for the next kernel); Q as A fragments in registers, dO's read from
//     shared memory; per K/V tile of 64 keys (double-buffered cp.async) S =
//     Q K^T and dP = dO V^T,
//     P and dS in registers, dQ += dS K (K read by ldmatrix .trans).
//   flash_bwd_dkdv_mma_kernel: one block per (64 keys, KV head, batch); K
//     and V as A fragments; per 64-row query tile of the group's heads that
//     sees its keys (double-buffered, with the rows' LSE and D_i) S^T = K
//     Q^T, dP^T = V dO^T, dV += P^T dO, dK += dS^T Q, the group summed in
//     the block (no atomics: equal bits run to run).
// P and dS are rounded to the inputs' type where the wgmma kernels round
// them.  Seven products on the tensor cores where the fma route runs eight
// on the CUDA cores' fp32 FMA, in two launches instead of three.
//
// "tiled" (fp32 at every D, fp64 on fp32 copies), namespace tl, on the
// register micro-tiles of f32_tiles.cuh (16 x 16 threads, every product
// fp32 FMA on the CUDA cores, no TF32).  The forward's flash_tiled_kernel
// writes each row's LSE, so no statistics pass: two kernels, launched in
// this order, over tiles whose rows lie 16 J + 4 floats apart (J = ceil(D
// / 16) accumulator slots of 16 columns, columns past D zero), their
// S-like products over the least multiple of 8 that holds D:
//   flash_bwd_dq_tiled_kernel<J>: one block per (128 query rows, 64 past
//     width 128; query head, batch), heaviest tiles first; D_i of its rows
//     (written to fp32 scratch for the next kernel), Q and dO resident; per
//     key tile of 64 keys (32 where shared memory runs out: width 128 and
//     past 192) K and V in one buffer each, K_j loading under dP = dO V_j^T,
//     V_{j+1} under S = Q K_j^T, P, dS and dQ += dS K_j, dS^T through shared
//     memory to the same half warp.  Each thread owns 8 rows x 4 keys of S
//     and dP (4 x 4, or 8 x 2 and 4 x 2 at 32 keys) and 8 (4) rows x J
//     columns of dQ.
//   flash_bwd_dkdv_tiled_kernel<J>: one block per (128 keys up to width
//     112, 64 at 128, 32 past it; KV head, batch); K and V resident; per
//     query head of the group and query tile of 64 rows (32 where shared
//     memory runs out) that sees the block's keys, Q (two buffers, the next
//     tile's with its rows' LSE and D_i loading under this one) and dO (one
//     buffer, the next loading under dK += dS^T Q): S^T = K Q^T and P^T in
//     registers, dV += P^T dO, then dP^T = V dO^T and dS^T in registers,
//     dK += dS^T Q, P^T and dS^T passing to the same half warp through one
//     shared buffer in chunks of 32 rows.  Each thread owns 8
//     keys x 4 rows of the scores (4 x 4 at width 128, 2 x 2 past it) and
//     as many keys x J columns of dK and dV.  The group is summed inside
//     the block: no atomics, equal bits run to run.
// Seven products in two launches where the fma route runs eight in three.
//
// "fma" (only on request: any shape, the yardstick of the other routes):
// the first design's three kernels, on the forward's padded widths DP of 16, 32, 64, 128, 256
// (tile columns past D zero), in this order:
//   flash_bwd_stats_kernel: one block per (query tile, query head, batch):
//     each row's log-sum-exp LSE = m + log(l), streamed over the row's live
//     key tiles with an online max, and D_i; both fp32 into (B, Hq, Sq)
//     scratch (it reads no forward's LSE).
//   flash_bwd_dkdv_kernel: one block per (key tile, KV head, batch).  K and
//     V of its 64 keys stay in shared memory; it loops over the group's
//     query heads and, for each, the query tiles that can see its keys,
//     recomputing P = exp(S * scale - LSE) and dS, and accumulates dV and
//     dK in registers, the group summed inside the block as above.
//   flash_bwd_dq_kernel: one block per (query tile, query head, batch),
//     looping over the key tiles its rows can see: dQ += dS K.  Heaviest
//     (last) query tiles first.
// All three use 16 x 16 threads, thread (ty, tx) owning a 4 x 4 block of
// scores (rows ty + 16i, columns tx + 16j) and 4 rows x D/16 columns of its
// accumulators; tiles are 64 x 64, staged in shared memory as fp32 with odd
// row strides, and every product is fp32 FMA on the CUDA cores (16-bit inputs
// are widened on load).  At DP 256 the tiles are 32 x 32 (2 x 2 scores a
// thread): 64-row fp32 tiles of 257 floats would take the dK/dV kernel to 297
// KB of shared memory; this halves the reuse of every shared-memory read, and
// at internvl2-2b's train shape at D 256 the route took 55.7 ms on an H100
// 80GB HBM3 at 700 W, against SDPA's backward's 1.46 ms and the wgmma
// route's 1.67 ms (the route no 16-bit call takes by default any more).  Rows past Sq and keys past Sk load as zeros and are
// masked; nothing past them is stored.
//
// What bounds it on an H100: at internvl2-2b's training shape (B=4,
// Sq=Sk=2304, Hq=16, Hkv=8, D=128, bf16) the function needs five products,
// 5 * 2*B*Hq*D*(S(S+1)/2) = 217.5 GFLOP: 0.220 ms at the tensor cores' 989
// TFLOP/s, far above its bytes (~0.03 ms).  The wgmma route runs seven
// (dQ: S, dP, dQ; dK/dV: S, dP, dV, dK), 304.5 GFLOP, 0.308 ms: the two
// recomputed products are the price of determinism.  At D 256 the
// function's five products are 435.1 GFLOP (0.440 ms) and the route's seven
// 609.1.  In fp32 (B 4, S 2304, Hq 16, Hkv 8, D 100) the five products are
// 169.9 GFLOP, 2.536 ms at the 67 TFLOP/s of fp32 FMA; the tiled route's
// seven at width 104 247.4 GFLOP.  One kernel over key
// tiles would need dQ summed across blocks: fp32 atomics (runs would
// differ) or per-key-tile partials, sum_j (2304 - 128j) * B*Hq*D*4 bytes =
// 717 MB a call, whose write and read (~0.43 ms at 3.35 TB/s) cost twice
// the function's bound.  Each consumer runs its products, then its
// exponentials, then its second products in series; the other consumer's
// work fills the gaps.  The fma route runs eight products (the stats
// pass's Q K^T; dK/dV and dQ each recompute S and dP) on the fp32 pipe (67
// TFLOP/s peak), reading each operand from shared memory.
//
// Plain C interface (loaded with ctypes); each entry point returns the
// cudaError_t of its launch, 0 on success (gqa_flash_bwd_wgmma: a negative
// value is the CUresult of encoding a tensor map, negated).  Nothing here
// allocates or synchronises.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "f32_tiles.cuh"
#include "hopper.cuh"

namespace {

constexpr int BQ = 64;             // query rows per tile
constexpr int BK = 64;             // keys per tile
constexpr int THREADS = 256;       // 16 x 16: ty = tid / 16, tx = tid % 16
constexpr int PS = BK + 1;         // row stride of the score tiles (64-row tiles)
constexpr float NEG = -1e30f;

struct Dims {
  int sq, sk, hq, group, offset, d;   // d: the head dim, at most the tiles' width DP
  float scale;
};

// The padded widths the fma kernels run on: a head dim d on the least DP
// >= d (a multiple of 16); tile columns d..DP-1 are zeros.
__host__ __device__ constexpr int padded_dim(int d) {
  return d <= 16 ? 16 : d <= 32 ? 32 : d <= 64 ? 64 : d <= 128 ? 128 : 256;
}

// Rows (and keys) of a tile at width DP: 64, or 32 at DP 256, where fp32
// tiles of 64 rows x 257 would take 297 KB of shared memory in the dK/dV
// kernel.  Thread (ty, tx) of 16 x 16 owns RI = R / 16 rows or keys.
template <int DP>
__host__ __device__ constexpr int tile_rows() {
  return DP > 128 ? 32 : BQ;
}
static_assert(tile_rows<128>() + 1 == PS, "64-row tiles: score rows of PS floats");

// Tiles of KEYS keys that the ROWS query rows starting at row q0 need: up
// to the last key their last valid row can see.
template <int ROWS = BQ, int KEYS = BK>
__device__ __forceinline__ int kv_tiles(int q0, int sq, int sk, int offset) {
  const long long last_row = min(q0 + ROWS, sq) - 1;
  const long long visible = min(static_cast<long long>(sk), offset + last_row + 1);
  return static_cast<int>((visible + KEYS - 1) / KEYS);
}

// rows [r0, r0 + R) of one head of a (B, S, H, d) tensor -> fp32 tile with
// row stride DP + 1; rows at or past `rows` and columns at or past d are zero.
template <typename T, int DP, int R>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int r0, int rows,
                                          long long row_stride, int d) {
  for (int e = threadIdx.x; e < R * DP; e += THREADS) {
    const int r = e / DP, c = e % DP;
    dst[r * (DP + 1) + c] = r0 + r < rows && c < d ? to_f(src[(r0 + r) * row_stride + c]) : 0.f;
  }
}

// Sum over the 16 lanes of a half warp (the 16 tx of one ty).
__device__ __forceinline__ float sum16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ float max16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

// --- (a) row statistics ------------------------------------------------------

template <typename T, int DP>
constexpr size_t stats_smem_bytes() {
  return sizeof(float) * static_cast<size_t>(2 * tile_rows<DP>()) * (DP + 1);
}

template <typename T, int DP>
__global__ void __launch_bounds__(THREADS)
flash_bwd_stats_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ o, const T* __restrict__ dout,
                       float* __restrict__ lse, float* __restrict__ dvec, Dims dm) {
  constexpr int R = tile_rows<DP>(), RI = R / 16;
  constexpr int DS = DP + 1;
  extern __shared__ float smem[];
  float* qt = smem;                // R x DS
  float* kt = qt + R * DS;         // R x DS
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int q0 = blockIdx.x * R, h = blockIdx.y, b = blockIdx.z;
  const int hkv = dm.hq / dm.group, d = dm.d;
  const long long q_rs = static_cast<long long>(dm.hq) * d, k_rs = static_cast<long long>(hkv) * d;
  const T* qb = q + static_cast<long long>(b) * dm.sq * q_rs + h * d;
  const T* kb = k + static_cast<long long>(b) * dm.sk * k_rs + (h / dm.group) * d;

  load_tile<T, DP, R>(qt, qb, q0, dm.sq, q_rs, d);
  float m[RI], l[RI];
#pragma unroll
  for (int i = 0; i < RI; ++i) m[i] = NEG, l[i] = 0.f;
  const int n_tiles = kv_tiles<R, R>(q0, dm.sq, dm.sk, dm.offset);
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * R;
    __syncthreads();               // the last tile is consumed (and Q is staged)
    load_tile<T, DP, R>(kt, kb, k0, dm.sk, k_rs, d);
    __syncthreads();
    float s[RI][RI] = {};
#pragma unroll 8
    for (int c = 0; c < d; ++c) {
      float a[RI], bk[RI];
#pragma unroll
      for (int i = 0; i < RI; ++i) a[i] = qt[(ty + 16 * i) * DS + c];
#pragma unroll
      for (int j = 0; j < RI; ++j) bk[j] = kt[(tx + 16 * j) * DS + c];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < RI; ++j) s[i][j] = fmaf(a[i], bk[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const long long qpos = static_cast<long long>(dm.offset) + q0 + ty + 16 * i;
      float mx = NEG;
#pragma unroll
      for (int j = 0; j < RI; ++j) {
        const int key = k0 + tx + 16 * j;
        s[i][j] = qpos >= key && key < dm.sk ? s[i][j] * dm.scale : NEG;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], max16(mx));
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < RI; ++j) rs += expf(s[i][j] - m_new);
      l[i] = l[i] * expf(m[i] - m_new) + sum16(rs);
      m[i] = m_new;
    }
  }

  // D_i = sum_d dO_i,d O_i,d: lane tx takes columns tx + 16j.
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int row = q0 + ty + 16 * i;
    float acc = 0.f;
    if (row < dm.sq) {
      const long long base = (static_cast<long long>(b) * dm.sq + row) * q_rs + h * d;
      for (int c = tx; c < d; c += 16) acc = fmaf(to_f(dout[base + c]), to_f(o[base + c]), acc);
    }
    acc = sum16(acc);
    if (tx == 0 && row < dm.sq) {
      const long long at = (static_cast<long long>(b) * dm.hq + h) * dm.sq + row;
      lse[at] = m[i] + logf(l[i]);
      dvec[at] = acc;
    }
  }
}

// --- (b) dK and dV -----------------------------------------------------------

template <typename T, int DP>
constexpr size_t dkdv_smem_bytes() {
  constexpr size_t r = tile_rows<DP>();
  return sizeof(float) * (4 * r * (DP + 1) + 2 * r * (r + 1) + 2 * r);
}

// Thread (ty, tx): keys ty + 16i; query rows tx + 16j of the transposed
// score tiles; dK/dV columns tx + 16j.
template <typename T, int DP>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ dvec,
                      T* __restrict__ dk, T* __restrict__ dv, Dims dm) {
  constexpr int R = tile_rows<DP>(), RI = R / 16, RS = R + 1;
  constexpr int DS = DP + 1;
  constexpr int DJ = DP / 16;
  extern __shared__ float smem[];
  float* kt = smem;                // R x DS
  float* vt = kt + R * DS;         // R x DS
  float* qt = vt + R * DS;         // R x DS
  float* dot = qt + R * DS;        // R x DS
  float* pt = dot + R * DS;        // R x RS: P^T
  float* dst = pt + R * RS;        // R x RS: dS^T
  float* lse_s = dst + R * RS;     // R
  float* dv_s = lse_s + R;         // R

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int k0 = blockIdx.x * R, hk = blockIdx.y, b = blockIdx.z;
  const int hkv = dm.hq / dm.group, d = dm.d;
  const long long q_rs = static_cast<long long>(dm.hq) * d, k_rs = static_cast<long long>(hkv) * d;
  const long long kv_off = static_cast<long long>(b) * dm.sk * k_rs + hk * d;
  load_tile<T, DP, R>(kt, k + kv_off, k0, dm.sk, k_rs, d);
  load_tile<T, DP, R>(vt, v + kv_off, k0, dm.sk, k_rs, d);

  float acc_k[RI][DJ], acc_v[RI][DJ];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc_k[i][j] = acc_v[i][j] = 0.f;

  // The first row that sees key k0: offset + row >= k0.
  const long long first_row = max(0LL, static_cast<long long>(k0) - dm.offset);
  const int n_q = (dm.sq + R - 1) / R;
  const int first_tile = first_row >= dm.sq ? n_q : static_cast<int>(first_row / R);
  for (int hg = 0; hg < dm.group; ++hg) {
    const int h = hk * dm.group + hg;
    const long long q_off = static_cast<long long>(b) * dm.sq * q_rs + h * d;
    const float* lse_h = lse + (static_cast<long long>(b) * dm.hq + h) * dm.sq;
    const float* dv_h = dvec + (static_cast<long long>(b) * dm.hq + h) * dm.sq;
    for (int qtile = first_tile; qtile < n_q; ++qtile) {
      const int q0 = qtile * R;
      __syncthreads();             // the last tile's P^T, dS^T, Q, dO are consumed
      load_tile<T, DP, R>(qt, q + q_off, q0, dm.sq, q_rs, d);
      load_tile<T, DP, R>(dot, dout + q_off, q0, dm.sq, q_rs, d);
      if (tid < R) {
        const bool in = q0 + tid < dm.sq;
        lse_s[tid] = in ? lse_h[q0 + tid] : 0.f;
        dv_s[tid] = in ? dv_h[q0 + tid] : 0.f;
      }
      __syncthreads();

      // S^T = K Q^T and dP^T = V dO^T, R keys x R rows.
      float st[RI][RI] = {}, dpt[RI][RI] = {};
#pragma unroll 4
      for (int c = 0; c < d; ++c) {
        float ka[RI], va[RI], qb[RI], db[RI];
#pragma unroll
        for (int i = 0; i < RI; ++i) {
          ka[i] = kt[(ty + 16 * i) * DS + c];
          va[i] = vt[(ty + 16 * i) * DS + c];
        }
#pragma unroll
        for (int j = 0; j < RI; ++j) {
          qb[j] = qt[(tx + 16 * j) * DS + c];
          db[j] = dot[(tx + 16 * j) * DS + c];
        }
#pragma unroll
        for (int i = 0; i < RI; ++i)
#pragma unroll
          for (int j = 0; j < RI; ++j) {
            st[i][j] = fmaf(ka[i], qb[j], st[i][j]);
            dpt[i][j] = fmaf(va[i], db[j], dpt[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const int key = k0 + ty + 16 * i;
#pragma unroll
        for (int j = 0; j < RI; ++j) {
          const int r = tx + 16 * j;
          const bool live = q0 + r < dm.sq && key < dm.sk &&
                            static_cast<long long>(dm.offset) + q0 + r >= key;
          const float p = live ? expf(st[i][j] * dm.scale - lse_s[r]) : 0.f;
          pt[(ty + 16 * i) * RS + r] = p;
          dst[(ty + 16 * i) * RS + r] = p * (dpt[i][j] - dv_s[r]);
        }
      }
      __syncthreads();

      // dV += P^T dO, dK += dS^T Q.
#pragma unroll 4
      for (int r = 0; r < R; ++r) {
        float pa[RI], sa[RI], dob[DJ], qv[DJ];
#pragma unroll
        for (int i = 0; i < RI; ++i) {
          pa[i] = pt[(ty + 16 * i) * RS + r];
          sa[i] = dst[(ty + 16 * i) * RS + r];
        }
#pragma unroll
        for (int j = 0; j < DJ; ++j) {
          dob[j] = dot[r * DS + tx + 16 * j];
          qv[j] = qt[r * DS + tx + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < RI; ++i)
#pragma unroll
          for (int j = 0; j < DJ; ++j) {
            acc_v[i][j] = fmaf(pa[i], dob[j], acc_v[i][j]);
            acc_k[i][j] = fmaf(sa[i], qv[j], acc_k[i][j]);
          }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int key = k0 + ty + 16 * i;
    if (key < dm.sk) {
      const long long base = kv_off + key * k_rs;
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        if (tx + 16 * j < d) {
          dk[base + tx + 16 * j] = from_f<T>(acc_k[i][j] * dm.scale);
          dv[base + tx + 16 * j] = from_f<T>(acc_v[i][j]);
        }
      }
    }
  }
}

// --- (c) dQ ------------------------------------------------------------------

template <typename T, int DP>
constexpr size_t dq_smem_bytes() {
  constexpr size_t r = tile_rows<DP>();
  return sizeof(float) * (4 * r * (DP + 1) + r * (r + 1));
}

// Thread (ty, tx): rows ty + 16i; keys tx + 16j; dQ columns tx + 16j.
template <typename T, int DP>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ dvec, T* __restrict__ dq, Dims dm) {
  constexpr int R = tile_rows<DP>(), RI = R / 16, RS = R + 1;
  constexpr int DS = DP + 1;
  constexpr int DJ = DP / 16;
  extern __shared__ float smem[];
  float* qt = smem;                // R x DS
  float* dot = qt + R * DS;        // R x DS
  float* kt = dot + R * DS;        // R x DS
  float* vt = kt + R * DS;         // R x DS
  float* ds = vt + R * DS;         // R x RS

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * R, h = blockIdx.y, b = blockIdx.z;
  const int hkv = dm.hq / dm.group, d = dm.d;
  const long long q_rs = static_cast<long long>(dm.hq) * d, k_rs = static_cast<long long>(hkv) * d;
  const long long q_off = static_cast<long long>(b) * dm.sq * q_rs + h * d;
  const long long kv_off = static_cast<long long>(b) * dm.sk * k_rs + (h / dm.group) * d;
  load_tile<T, DP, R>(qt, q + q_off, q0, dm.sq, q_rs, d);
  load_tile<T, DP, R>(dot, dout + q_off, q0, dm.sq, q_rs, d);
  float lse_r[RI], dv_r[RI];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int row = q0 + ty + 16 * i;
    const long long at = (static_cast<long long>(b) * dm.hq + h) * dm.sq + row;
    lse_r[i] = row < dm.sq ? lse[at] : 0.f;
    dv_r[i] = row < dm.sq ? dvec[at] : 0.f;
  }

  float acc[RI][DJ];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;

  const int n_tiles = kv_tiles<R, R>(q0, dm.sq, dm.sk, dm.offset);
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * R;
    __syncthreads();               // the last tile's K and dS are consumed (Q, dO staged)
    load_tile<T, DP, R>(kt, k + kv_off, k0, dm.sk, k_rs, d);
    load_tile<T, DP, R>(vt, v + kv_off, k0, dm.sk, k_rs, d);
    __syncthreads();

    float s[RI][RI] = {}, dp[RI][RI] = {};
#pragma unroll 4
    for (int c = 0; c < d; ++c) {
      float qa[RI], da[RI], kb[RI], vb[RI];
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        qa[i] = qt[(ty + 16 * i) * DS + c];
        da[i] = dot[(ty + 16 * i) * DS + c];
      }
#pragma unroll
      for (int j = 0; j < RI; ++j) {
        kb[j] = kt[(tx + 16 * j) * DS + c];
        vb[j] = vt[(tx + 16 * j) * DS + c];
      }
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < RI; ++j) {
          s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
          dp[i][j] = fmaf(da[i], vb[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int row = q0 + ty + 16 * i;
      const long long qpos = static_cast<long long>(dm.offset) + row;
#pragma unroll
      for (int j = 0; j < RI; ++j) {
        const int key = k0 + tx + 16 * j;
        const bool live = row < dm.sq && key < dm.sk && qpos >= key;
        const float p = live ? expf(s[i][j] * dm.scale - lse_r[i]) : 0.f;
        ds[(ty + 16 * i) * RS + tx + 16 * j] = p * (dp[i][j] - dv_r[i]);
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < R; ++kk) {
      float sa[RI], kv[DJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) sa[i] = ds[(ty + 16 * i) * RS + kk];
#pragma unroll
      for (int j = 0; j < DJ; ++j) kv[j] = kt[kk * DS + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(sa[i], kv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row < dm.sq) {
      const long long base = q_off + row * q_rs;
#pragma unroll
      for (int j = 0; j < DJ; ++j)
        if (tx + 16 * j < d) dq[base + tx + 16 * j] = from_f<T>(acc[i][j] * dm.scale);
    }
  }
}

// --- launches ----------------------------------------------------------------

enum Kernel { STATS = 0, DKDV = 1, DQ = 2 };

template <typename T, int DP>
size_t smem_bytes(int which) {
  return which == STATS ? stats_smem_bytes<T, DP>()
         : which == DKDV ? dkdv_smem_bytes<T, DP>()
                         : dq_smem_bytes<T, DP>();
}

template <typename Fn>
cudaError_t prepare(Fn kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

struct Args {
  const void *q, *k, *v, *o, *dout;
  float *lse, *dvec;
  void *dq, *dk, *dv;
};

template <typename T, int DP>
cudaError_t launch(int which, const Args& a, Dims dm, dim3 grid, size_t smem,
                   cudaStream_t stream) {
  if (smem != smem_bytes<T, DP>(which)) return cudaErrorInvalidValue;
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  cudaError_t err;
  if (which == STATS) {
    if ((err = prepare(flash_bwd_stats_kernel<T, DP>, smem)) != cudaSuccess) return err;
    flash_bwd_stats_kernel<T, DP><<<grid, THREADS, smem, stream>>>(
        q, k, static_cast<const T*>(a.o), dout, a.lse, a.dvec, dm);
  } else if (which == DKDV) {
    if ((err = prepare(flash_bwd_dkdv_kernel<T, DP>, smem)) != cudaSuccess) return err;
    flash_bwd_dkdv_kernel<T, DP><<<grid, THREADS, smem, stream>>>(
        q, k, v, dout, a.lse, a.dvec, static_cast<T*>(a.dk), static_cast<T*>(a.dv), dm);
  } else {
    if ((err = prepare(flash_bwd_dq_kernel<T, DP>, smem)) != cudaSuccess) return err;
    flash_bwd_dq_kernel<T, DP><<<grid, THREADS, smem, stream>>>(
        q, k, v, dout, a.lse, a.dvec, static_cast<T*>(a.dq), dm);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int which, int d, const Args& a, Dims dm, dim3 grid, size_t smem,
                     cudaStream_t stream) {
  switch (padded_dim(d)) {
    case 16: return launch<T, 16>(which, a, dm, grid, smem, stream);
    case 32: return launch<T, 32>(which, a, dm, grid, smem, stream);
    case 64: return launch<T, 64>(which, a, dm, grid, smem, stream);
    case 128: return launch<T, 128>(which, a, dm, grid, smem, stream);
    default: return launch<T, 256>(which, a, dm, grid, smem, stream);
  }
}

// --- bf16 on Hopper: wgmma fed by TMA, the LSE from the forward --------------

namespace wg {

using namespace hopper;

constexpr int BOX_ROWS = 64;       // rows of a TMA box; a dQ consumer's rows
constexpr int DQ_ROWS = 128;       // dQ: query rows per block, 64 per consumer
constexpr int DQ_KEYS = 64;        // dQ: keys per tile
constexpr int KV_KEYS = 64;        // dK/dV: keys per block
constexpr int KV_ROWS = 64;        // dK/dV: query rows per tile
constexpr int STAGES = 4;          // depth of either kernel's ring
// Past width 128 (tiles 192 and 256 wide): dQ's K/V tiles of 32 keys, so
// that Q and dO of 128 rows (128 KiB at 256) leave room for three stages,
// and every TMA box 32 rows high.
constexpr int WIDE_DQ_KEYS = 32;
constexpr int WIDE_BOX_ROWS = 32;
constexpr float LOG2E = 1.4426950408889634f;

// The tiling of the kernels on tiles D wide: TMA boxes' rows, dQ's keys per
// tile, and each ring's depth, what fits 227 KB (at most STAGES).  The
// narrow tiles (16 and 32 wide: hopper.cuh, RolesOf) run two blocks an SM,
// 128 registers a thread: a dQ consumer holds S and dP of 64 keys (64
// floats) beside dS (16) and dQ (at most 16), a dK/dV consumer S^T of 64
// rows (32) beside P^T (16) and its output, so the 64-key and 64-row tiles
// stay; twice their keys or rows would pass the 128 registers.
template <int D>
struct Tiling {
  static constexpr int BOX_ROWS = D > 128 ? WIDE_BOX_ROWS : wg::BOX_ROWS;
  static constexpr int DQ_KEYS = D > 128 ? WIDE_DQ_KEYS : wg::DQ_KEYS;
  static constexpr int DQ_STAGES = D == 256 ? 3 : STAGES;
  static constexpr int KV_STAGES = D == 256 ? 2 : D == 192 ? 3 : STAGES;
};

// A tile of R rows by D columns in shared memory: D / Swz<D>::COLS column
// boxes (one at widths 16 and 32), each R rows of Swz<D>::ROW swizzled
// bytes, filled by boxes of Tiling<D>::BOX_ROWS rows.
template <int D, int R>
struct Tile {
  static constexpr uint32_t BOX_STRIDE = R * Swz<D>::ROW;   // from one column box to the next
  static constexpr uint32_t BYTES = (D / Swz<D>::COLS) * BOX_STRIDE;
};

// Shared memory of the dQ kernel, from a 1024-byte aligned base: Q and dO
// (128 rows), the K ring and the V ring (KEYS keys a stage: the tiles' own,
// Tiling<D>::DQ_KEYS, or the wide kernels', hopper::wide_dq_keys), then the
// mbarriers q_full, kv_full[STAGES], empty[STAGES].  At other keys than the
// tiles' own the ring is as deep as 227 KB allows (2 at width 192 and 64
// keys).
template <int D, int KEYS_ = Tiling<D>::DQ_KEYS>
struct DqLayout {
  static constexpr int KEYS = KEYS_;
  using Rows = Tile<D, DQ_ROWS>;
  using Keys = Tile<D, KEYS>;
  static constexpr int STAGES =
      KEYS == Tiling<D>::DQ_KEYS
          ? Tiling<D>::DQ_STAGES
          : (232448 - 1024 - 2 * Rows::BYTES - 8) / (2 * Keys::BYTES + 16) < wg::STAGES
                ? (232448 - 1024 - 2 * Rows::BYTES - 8) / (2 * Keys::BYTES + 16)
                : wg::STAGES;
  static constexpr uint32_t Q = 0;
  static constexpr uint32_t DOUT = Q + Rows::BYTES;
  static constexpr uint32_t K = DOUT + Rows::BYTES;
  static constexpr uint32_t V = K + STAGES * Keys::BYTES;
  static constexpr uint32_t BARS = V + STAGES * Keys::BYTES;
  static constexpr size_t SMEM = 1024 + BARS + 8 * (1 + 2 * STAGES);
  static_assert(STAGES >= 2 && SMEM <= 232448, "a ring within a block's shared memory");
};

// Shared memory of the dK/dV kernel: K and V (64 keys), the Q ring and the
// dO ring (64 query rows a stage), each stage's 64 LSEs then 64 D_i, two
// buffers of P^T (64 x 64 fp32), then the mbarriers kv_full,
// q_full[STAGES], empty[STAGES].
template <int D>
struct KvLayout {
  static constexpr int STAGES = Tiling<D>::KV_STAGES;
  using Keys = Tile<D, KV_KEYS>;
  using Rows = Tile<D, KV_ROWS>;
  static constexpr uint32_t K = 0;
  static constexpr uint32_t V = K + Keys::BYTES;
  static constexpr uint32_t Q = V + Keys::BYTES;
  static constexpr uint32_t DOUT = Q + STAGES * Rows::BYTES;
  static constexpr uint32_t STATS = DOUT + STAGES * Rows::BYTES;
  static constexpr uint32_t STAT_FLOATS = 2 * KV_ROWS;      // a stage's LSEs and D_i
  static constexpr uint32_t P = STATS + STAGES * STAT_FLOATS * 4;
  static constexpr uint32_t P_BYTES = KV_KEYS * KV_ROWS * 4;  // one buffer of P^T
  static constexpr uint32_t BARS = P + 2 * P_BYTES;
  static constexpr size_t SMEM = 1024 + BARS + 8 * (1 + 2 * STAGES);
};

// Rows [r0, r0 + R) of head h of batch b into a tile at `dst`: one TMA box
// per BOX_ROWS rows and column box, all counted against `bar`.  Rows past S
// and columns past the head dim land as zeros.
template <int D, int R>
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap& map, uint32_t bar,
                                          int h, int r0, int b) {
  using W = Swz<D>;
  constexpr int BR = Tiling<D>::BOX_ROWS;
#pragma unroll
  for (int x = 0; x < D / W::COLS; ++x)
#pragma unroll
    for (int y = 0; y < R / BR; ++y)
      tma_load(dst + x * Tile<D, R>::BOX_STRIDE + y * BR * W::ROW, map, bar, x * W::COLS, h,
               r0 + y * BR, b);
}

// acc (64 x N, fp32) = A B^T over the tiles' first QK columns (issued, not
// committed): A's 64 rows at `a` and B's N rows at `b`, both K-major in
// tiles D wide whose column boxes are A_STRIDE and B_STRIDE bytes apart;
// QK/16 steps of 16 columns, each 32 bytes into a swizzled row (the qk
// pattern of the forward).  Columns QK.. are TMA's zeros, so they are skipped.
template <int D, uint32_t A_STRIDE, uint32_t B_STRIDE, typename T, int N = 64, int QK = D>
__device__ __forceinline__ void ss_product(float (&acc)[N / 2], uint32_t a, uint32_t b) {
  using W = Swz<D>;
  wgmma_ss<N, true, T>(acc, W::desc(a, 16, W::GROUP), W::desc(b, 16, W::GROUP));
#pragma unroll
  for (int kk = 1; kk < QK / 16; ++kk) {
    const int box = kk / W::KSTEPS, at = (kk % W::KSTEPS) * 32;
    wgmma_ss<N, false, T>(acc, W::desc(a + box * A_STRIDE + at, 16, W::GROUP),
                          W::desc(b + box * B_STRIDE + at, 16, W::GROUP));
  }
}

// acc (64 x N, fp32) += A B (issued, not committed): A 64 x K in registers
// (four bf16x2 a slice of 16 along the product), B the K rows at `b` of a
// tile D wide whose column boxes are B_STRIDE apart, read MN-major through
// the transpose bit (the pv pattern of the forward), its first N columns.
template <int D, uint32_t B_STRIDE, typename T, int K = 64, int N = D>
__device__ __forceinline__ void rs_product(float (&acc)[N / 2], const uint32_t (&a)[K / 4],
                                           uint32_t b) {
  using W = Swz<D>;
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk)
    wgmma_rs<N, T>(acc, a + 4 * kk, W::desc(b + kk * 16 * W::ROW, B_STRIDE, W::GROUP));
}

// A block of the L2 order (a 1-D grid): the heads of group_kv KV heads, one
// group after another (the last may hold fewer), in a group its tiles in
// walk order (the k-th of `tiles`), each tile's blocks KV head by KV head,
// the `group` heads of one KV head side by side: dQ walks (query head,
// query tile), group the query heads a KV head; dK/dV walks (KV head, key
// tile), group 1.  Then the blocks in flight read the K and V (dQ) or the
// Q and dO (dK/dV) of one group's heads, which
// kernels/flash_attention.py::plan_bwd sizes to a share of L2.  One group of
// every KV head is the grid's order.  heads: Hq (dQ) or Hkv (dK/dV).
struct Unit {
  int h, b, k;
};
__device__ __forceinline__ Unit l2_unit(int tiles, int heads, int group, int group_kv) {
  const int i = blockIdx.x;
  const int full = group_kv * group * tiles;            // the blocks of a whole group
  const int kv0 = i / full * group_kv;                  // the group's first KV head
  const int kvs = gridDim.x / (group * tiles);          // B * Hkv
  const int n = min(group_kv, kvs - kv0) * group;       // the group's heads
  const int r = i % full;
  const int kv = kv0 + r % n / group;
  const int hkv = heads / group;
  return {kv % hkv * group + r % group, kv / hkv, r / n};
}

// Arrive on `bar` once this thread's earlier cp.async copies have landed
// (the barrier's count already holds this arrival).
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}

template <int STAGES>
__device__ __forceinline__ void init_ring(uint32_t first, uint32_t full_count, uint32_t bars) {
  mbar_init(first, 1);
  for (int s = 0; s < STAGES; ++s) {
    mbar_init(bars + 8 * (1 + s), full_count);
    mbar_init(bars + 8 * (1 + STAGES + s), 2 * 128);   // every consumer thread releases it
  }
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Accumulator layout of wgmma m64nNk16 (warp w of the warpgroup, lane =
// 4g + t): element i is row 16w + g + 8 * ((i >> 1) & 1), column
// 8 * (i >> 2) + 2t + (i & 1); elements 2i, 2i + 1 of a 64 x 64 tile are
// one bf16x2 of the register-A layout, and 8kk..8kk + 7 the A fragment of
// the kk-th 16 columns.  dQ: one block per (128 query rows, query head,
// batch), heaviest tiles first.  The consumers first take D_i = dO_i . O_i
// of their rows from device memory (fp32, written to `dvec` for the dK/dV
// kernel) while TMA brings Q, dO and the first K/V tiles; then per tile of
// KEYS keys (64, or 32 past width 128) S = Q K^T and dP = dO V^T from shared
// memory, P = 2^(S scale_log2
// - LSE log2 e) and dS = P (dP - D_i) in registers, dS rounded to bf16,
// dQ += dS K with K read MN-major.  D is the tiles' width, DO <= D the head
// dim (columns 112..127 of every tile are zeros at DO = 112); DO = 0 takes
// it from `dh` at run time (a multiple of 8 in (D - 64, D]), DO = -1 any dh
// there (TMA reads the staged copies of q, k, v and dO, the D_i pass o and
// the staged dO element by element, and every store is guarded by column: hopper.cuh, store2; separate instantiations, so that the
// multiples of 8 keep their unguarded code).  T is bf16 or fp16.  P
// (hopper.cuh, Products) sets S's and dP's k-steps (P::QK / 16), dQ's N
// (P::PV) and the block order: the grid's, or with P::L2 the L2 order
// (l2_unit, group_kv KV heads a group).
template <int D, int DO = D, typename T = __nv_bfloat16, class P = Products<D, D, false>>
__global__ void __launch_bounds__(RolesOf<D, P>::THREADS, RolesOf<D, P>::BLOCKS)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                          const __grid_constant__ CUtensorMap kmap,
                          const __grid_constant__ CUtensorMap vmap,
                          const __grid_constant__ CUtensorMap domap, const T* __restrict__ o,
                          const T* __restrict__ dout, const float* __restrict__ lse,
                          float* __restrict__ dvec, T* __restrict__ dq, int sq, int sk, int hq,
                          int group, int offset, int dh, float scale_log2, float scale,
                          int group_kv) {
  using L = DqLayout<D, P::KEYS ? P::KEYS : Tiling<D>::DQ_KEYS>;
  using R = RolesOf<D, P>;
  constexpr int KEYS = L::KEYS, STAGES = L::STAGES, PV = P::PV;
  extern __shared__ unsigned char bwd_smem[];
  const uint32_t base = (smem_addr(bwd_smem) + 1023) & ~1023u;
  const uint32_t bars = base + L::BARS;
  const uint32_t q_full = bars;
  auto kv_full = [bars](int s) { return bars + 8 * (1 + s); };
  auto empty = [bars](int s) { return bars + 8 * (1 + STAGES + s); };

  int h = blockIdx.x, b = blockIdx.y;
  int q0 = (gridDim.z - 1 - blockIdx.z) * DQ_ROWS;   // heaviest query tiles first
  if constexpr (P::L2) {
    const int tiles = (sq + DQ_ROWS - 1) / DQ_ROWS;
    const Unit u = l2_unit(tiles, hq, group, group_kv);
    h = u.h;
    b = u.b;
    q0 = (tiles - 1 - u.k) * DQ_ROWS;
  }
  const int n_tiles = kv_tiles<DQ_ROWS, KEYS>(q0, sq, sk, offset);
  if (threadIdx.x == 0) init_ring<STAGES>(q_full, 1, bars);
  __syncthreads();

  // Q and dO, then tile j's K and V into its stage once the stage is free.
  const int hk = h / group;
  auto load_rows = [&] {
    mbar_expect(q_full, 2 * L::Rows::BYTES);
    load_tile<D, DQ_ROWS>(base + L::Q, qmap, q_full, h, q0, b);
    load_tile<D, DQ_ROWS>(base + L::DOUT, domap, q_full, h, q0, b);
  };
  auto load_kv = [&](int j) {
    const int s = j % STAGES;
    mbar_wait(empty(s), ((j / STAGES) & 1) ^ 1);     // round 0 finds every stage free
    mbar_expect(kv_full(s), 2 * L::Keys::BYTES);
    load_tile<D, KEYS>(base + L::K + s * L::Keys::BYTES, kmap, kv_full(s), hk, j * KEYS, b);
    load_tile<D, KEYS>(base + L::V + s * L::Keys::BYTES, vmap, kv_full(s), hk, j * KEYS, b);
  };
  if (R::WIDE && threadIdx.x == 0) {      // the loader without a producer: consumer 0's first thread
    load_rows();
    for (int j = 0; j < min(STAGES, n_tiles); ++j) load_kv(j);
  }
  if constexpr (R::WIDE) __syncwarp();

  if (R::producer()) {
    R::producer_regs();
    if (threadIdx.x == 0) {
      load_rows();
      for (int j = 0; j < n_tiles; ++j) load_kv(j);
    }
  } else {
    R::consumer_regs();
    const int c = R::consumer();                     // which 64 rows of the block
    const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const int row0 = q0 + 64 * c + 16 * warp;        // this warp's 16 rows
    const int row = row0 + g;                        // this thread's rows: row, row + 8
    const long long stat = (static_cast<long long>(b) * hq + h) * sq;

    // D_i of the warp's 16 rows, 128 columns at a time: lane l holds columns
    // c0 + 4l..c0 + 4l + 3 of a row.  o is contiguous (rows of the head dim);
    // dO is what its tensor map reads, rows ceil(dh / 8) * 8 wide.  At a head
    // dim that is a multiple of 8 both are dh wide and a row's 4 columns are
    // 8 bytes of o and of dO, loaded without a branch, so all 16 rows' issue
    // before the sums: rows past Sq re-read the last row, lanes past the
    // head dim its last columns, and both add 0.  At any head dim (DO = -1:
    // 33, 250) o's rows may start off 8 bytes: one element at a time,
    // columns past the head dim skipped.
    const int dcols = DO > 0 ? DO : dh;
    float di[2] = {0.f, 0.f}, part[16];
#pragma unroll
    for (int r = 0; r < 16; ++r) part[r] = 0.f;
    if constexpr (DO >= 0) {
#pragma unroll
      for (int c0 = 0; c0 < D; c0 += 128) {
        uint2 ov[16], dov[16];
        const int col = c0 + min(4 * lane, dcols - c0 - 4);
#pragma unroll
        for (int r = 0; r < 16; ++r) {
          const long long at =
              ((static_cast<long long>(b) * sq + min(row0 + r, sq - 1)) * hq + h) * dcols + col;
          ov[r] = *reinterpret_cast<const uint2*>(o + at);
          dov[r] = *reinterpret_cast<const uint2*>(dout + at);
        }
#pragma unroll
        for (int r = 0; r < 16; ++r) {
          const float2 u0 = unpack2<T>(ov[r].x), u1 = unpack2<T>(ov[r].y);
          const float2 w0 = unpack2<T>(dov[r].x), w1 = unpack2<T>(dov[r].y);
          const float sum = fmaf(u0.x, w0.x, fmaf(u0.y, w0.y, fmaf(u1.x, w1.x, u1.y * w1.y)));
          if (row0 + r < sq && c0 + 4 * lane < dcols) part[r] += sum;
        }
      }
    } else {
#pragma unroll
      for (int c0 = 0; c0 < D; c0 += 128) {
#pragma unroll
        for (int r = 0; r < 16; ++r) {
          const long long at =
              (static_cast<long long>(b) * sq + min(row0 + r, sq - 1)) * hq + h;
          float sum = 0.f;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = c0 + 4 * lane + e;
            if (col < dcols)
              sum = fmaf(to_f(o[at * dcols + col]), to_f(dout[at * ((dcols + 7) & ~7) + col]),
                         sum);
          }
          if (row0 + r < sq) part[r] += sum;
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      float sum = part[r];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (r == g) di[0] = sum;
      if (r == g + 8) di[1] = sum;
      if (lane == 0 && row0 + r < sq) dvec[stat + row0 + r] = sum;
    }
    // Rows past Sq take LSE 0: their Q, dO and D_i are zeros, so dS = 0.
    float lse2[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) lse2[r] = row + 8 * r < sq ? lse[stat + row + 8 * r] * LOG2E : 0.f;

    float acc[PV / 2];    // dQ: its first PV columns
#pragma unroll
    for (int i = 0; i < PV / 2; ++i) acc[i] = 0.f;
    const uint32_t qa = base + L::Q + c * 64 * Swz<D>::ROW;
    const uint32_t da = base + L::DOUT + c * 64 * Swz<D>::ROW;
    const long long first = static_cast<long long>(offset) + q0 + 64 * c;   // first row's position
    const long long qpos = static_cast<long long>(offset) + row;
    mbar_wait(q_full, 0);
    for (int j = 0; j < n_tiles; ++j) {
      const int st = j % STAGES;
      const int k0 = j * KEYS;
      // The wide kernels' loader fills the stage of tile j - 1 with tile j +
      // STAGES - 1 once consumer 1 has released it too (consumer 0, whose
      // rows see fewer keys, runs ahead, so it waits rather than consumer 1).
      if (R::WIDE && threadIdx.x == 0 && j >= 1 && j + STAGES - 1 < n_tiles)
        load_kv(j + STAGES - 1);
      if constexpr (R::WIDE) __syncwarp();   // the loader's warp, converged for wgmma
      mbar_wait(kv_full(st), (j / STAGES) & 1);
      if (k0 > first + 63) {          // no row of this consumer sees a key of the tile
        mbar_arrive(empty(st));
        continue;
      }
      const uint32_t kt = base + L::K + st * L::Keys::BYTES;
      float s[KEYS / 2], dp[KEYS / 2];
      wgmma_fence();
      ss_product<D, L::Rows::BOX_STRIDE, L::Keys::BOX_STRIDE, T, KEYS, P::QK>(s, qa, kt);
      ss_product<D, L::Rows::BOX_STRIDE, L::Keys::BOX_STRIDE, T, KEYS, P::QK>(
          dp, da, base + L::V + st * L::Keys::BYTES);
      wgmma_commit();
      wgmma_wait<0>();
      pin(s);
      pin(dp);
      // Only tiles that cross the diagonal or the end of K are masked.
      const bool masked = !(k0 + KEYS <= sk && k0 + KEYS - 1 <= first);
      uint32_t ds[KEYS / 4];
#pragma unroll
      for (int i = 0; i < KEYS / 4; ++i) {
        const int r = i & 1;
        float p0 = exp2_ftz(fmaf(s[2 * i], scale_log2, -lse2[r]));
        float p1 = exp2_ftz(fmaf(s[2 * i + 1], scale_log2, -lse2[r]));
        if (masked) {
          const int key = k0 + 8 * (i >> 1) + 2 * t;
          const long long pos = qpos + 8 * r;
          if (!(key < sk && pos >= key)) p0 = 0.f;
          if (!(key + 1 < sk && pos >= key + 1)) p1 = 0.f;
        }
        ds[i] = pack2<T>(p0 * (dp[2 * i] - di[r]), p1 * (dp[2 * i + 1] - di[r]));
      }
      pin(acc);
      pin(ds);
      wgmma_fence();
      rs_product<D, L::Keys::BOX_STRIDE, T, KEYS, PV>(acc, ds, kt);
      wgmma_commit();
      wgmma_wait<0>();
      pin(acc);
      pin(ds);
      mbar_arrive(empty(st));
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int orow = row + 8 * r;
      if (orow < sq) {
        if constexpr (DO < 0) {           // any head dim: each column guarded
          T* op = dq + ((static_cast<long long>(b) * sq + orow) * hq + h) * dcols;
#pragma unroll
          for (int n = 0; n < PV / 8; ++n)
            if (8 * n < dcols)
              store2<T>(op, 8 * n + 2 * t, dcols, acc[4 * n + 2 * r] * scale,
                        acc[4 * n + 2 * r + 1] * scale);
        } else {
          T* op = dq + ((static_cast<long long>(b) * sq + orow) * hq + h) * dcols + 2 * t;
#pragma unroll
          for (int n = 0; n < PV / 8; ++n)  // columns 8n + 2t, +1 < the head dim
            if (8 * n < dcols)
              *reinterpret_cast<uint32_t*>(op + n * 8) =
                  pack2<T>(acc[4 * n + 2 * r] * scale, acc[4 * n + 2 * r + 1] * scale);
        }
      }
    }
  }
}

// dK/dV: one block per (64 keys, KV head, batch), the first key tiles (which
// the most rows see) first.  K and V come once by TMA; the ring brings, for
// each query head of the group and each 64-row query tile that sees the
// block's first key, Q and dO by TMA, and its rows' LSE and D_i, which
// producer warp 1 (at width 256 consumer 1's first warp) copies with
// cp.async (rows past Sq as zeros: their Q and dO are zeros too, so P^T dO
// and dS^T = P^T (dP^T - D_i) vanish there).
// The two consumers split the outputs, so each holds one 64 x D accumulator:
// consumer 0 takes S^T = K Q^T, P^T in registers (masked where the tile
// crosses the diagonal), hands P^T in fp32 to consumer 1 through shared
// memory (two buffers, thread to thread in the accumulator layout, named
// barriers 1 + buf (full) and 3 + buf (empty)), and runs dV += P^T dO;
// consumer 1 takes dP^T = V dO^T, dS^T = P^T (dP^T - D_i), and runs dK +=
// dS^T Q; P^T and dS^T enter as bf16 register-A operands, dO and Q are read
// MN-major.  Each dK/dV element has one writer and its sum one order.  D,
// DO (0: `dh` at run time), T and P (S^T's and dP^T's k-steps, dV's and
// dK's N, the order: with P::L2 group_kv KV heads a group, their key tiles
// first to last) as in the dQ kernel.
template <int D, int DO = D, typename T = __nv_bfloat16, class P = Products<D, D, false>>
__global__ void __launch_bounds__(RolesOf<D, P>::THREADS, RolesOf<D, P>::BLOCKS)
flash_bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                            const __grid_constant__ CUtensorMap kmap,
                            const __grid_constant__ CUtensorMap vmap,
                            const __grid_constant__ CUtensorMap domap,
                            const float* __restrict__ lse, const float* __restrict__ dvec,
                            T* __restrict__ dk, T* __restrict__ dv, int sq, int sk, int hq,
                            int group, int offset, int dh, float scale_log2, float scale,
                            int group_kv) {
  using L = KvLayout<D>;
  using R = RolesOf<D, P>;
  constexpr int STAGES = L::STAGES, PV = P::PV;
  extern __shared__ unsigned char bwd_smem[];
  const uint32_t base = (smem_addr(bwd_smem) + 1023) & ~1023u;
  unsigned char* const aligned = bwd_smem + (base - smem_addr(bwd_smem));
  const float* const stats = reinterpret_cast<const float*>(aligned + L::STATS);
  float4* const pex = reinterpret_cast<float4*>(aligned + L::P);
  const uint32_t bars = base + L::BARS;
  const uint32_t kv_full = bars;
  auto q_full = [bars](int s) { return bars + 8 * (1 + s); };
  auto empty = [bars](int s) { return bars + 8 * (1 + STAGES + s); };

  int hk = blockIdx.x, b = blockIdx.y;
  int k0 = blockIdx.z * KV_KEYS;
  if constexpr (P::L2) {
    const Unit u = l2_unit((sk + KV_KEYS - 1) / KV_KEYS, hq / group, 1, group_kv);
    hk = u.h;
    b = u.b;
    k0 = u.k * KV_KEYS;
  }
  // Query tiles from the one holding the first row that sees key k0
  // (offset + row >= k0): every one of them sees it.
  const long long first_row = max(0LL, static_cast<long long>(k0) - offset);
  const int n_q = (sq + KV_ROWS - 1) / KV_ROWS;
  const int t0 = first_row >= sq ? n_q : static_cast<int>(first_row / KV_ROWS);
  const int per_head = n_q - t0;
  const int n_tiles = group * per_head;
  if (threadIdx.x == 0) init_ring<STAGES>(kv_full, 1 + 32, bars);   // q_full: TMA, 32 lanes
  __syncthreads();

  // K and V; then stage j's Q and dO (one thread) and its rows' LSE and D_i
  // (a warp's lanes) once the stage is free.
  auto load_kv = [&] {
    mbar_expect(kv_full, 2 * L::Keys::BYTES);
    load_tile<D, KV_KEYS>(base + L::K, kmap, kv_full, hk, k0, b);
    load_tile<D, KV_KEYS>(base + L::V, vmap, kv_full, hk, k0, b);
  };
  auto load_rows = [&](int j, bool tma, int lane) {
    const int s = j % STAGES;
    const int h = hk * group + j / per_head, r0 = (t0 + j % per_head) * KV_ROWS;
    mbar_wait(empty(s), ((j / STAGES) & 1) ^ 1);
    if (tma) {
      mbar_expect(q_full(s), 2 * L::Rows::BYTES);
      load_tile<D, KV_ROWS>(base + L::Q + s * L::Rows::BYTES, qmap, q_full(s), h, r0, b);
      load_tile<D, KV_ROWS>(base + L::DOUT + s * L::Rows::BYTES, domap, q_full(s), h, r0, b);
    }
    if (lane >= 0) {
      const long long stat = (static_cast<long long>(b) * hq + h) * sq;
      const uint32_t st = smem_addr(stats + s * L::STAT_FLOATS);
      for (int i = lane; i < KV_ROWS; i += 32) {
        const bool in = r0 + i < sq;    // rows past Sq land as zeros
        const long long at = stat + (in ? r0 + i : 0);
        cp_async4(st + 4 * i, lse + at, in);
        cp_async4(st + 4 * (KV_ROWS + i), dvec + at, in);
      }
      cp_async_arrive(q_full(s));  // q_full counts this lane once its copies land
    }
  };
  // The wide kernels' loader: consumer 1's first warp (its lane 0 the TMA
  // loads), which fills the first stages here and stage j - 1 in its turn j.
  constexpr int LOADER = 128;
  const bool loader = R::WIDE && threadIdx.x >= LOADER && threadIdx.x < LOADER + 32;
  if (loader) {
    if (threadIdx.x == LOADER) load_kv();
    for (int j = 0; j < min(STAGES, n_tiles); ++j)
      load_rows(j, threadIdx.x == LOADER, threadIdx.x - LOADER);
  }
  if constexpr (R::WIDE) __syncwarp();

  if (R::producer()) {
    // Thread 0 issues the TMA loads, warp 1 copies the LSE and D_i.
    R::producer_regs();
    if (threadIdx.x == 0) {
      load_kv();
      for (int j = 0; j < n_tiles; ++j) load_rows(j, true, -1);
    } else if (threadIdx.x >= 32 && threadIdx.x < 64) {
      for (int j = 0; j < n_tiles; ++j) load_rows(j, false, threadIdx.x - 32);
    }
  } else {
    R::consumer_regs();
    const int c = R::consumer();                     // 0: P^T and dV; 1: dS^T and dK
    const int tid = threadIdx.x & 127;
    const int warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int key = k0 + 16 * warp + g;              // this thread's keys: key, key + 8

    float acc[PV / 2];                               // dV (consumer 0) or dK (consumer 1)
#pragma unroll
    for (int i = 0; i < PV / 2; ++i) acc[i] = 0.f;
    const uint32_t a_op = base + (c == 0 ? L::K : L::V);
    mbar_wait(kv_full, 0);
    for (int j = 0; j < n_tiles; ++j) {
      const int st = j % STAGES, buf = j & 1;
      const int first = offset + (t0 + j % per_head) * KV_ROWS;   // the tile's first position
      mbar_wait(q_full(st), (j / STAGES) & 1);
      const uint32_t qt = base + L::Q + st * L::Rows::BYTES;
      const uint32_t dot = base + L::DOUT + st * L::Rows::BYTES;
      float s[32];                                   // S^T (consumer 0) or dP^T (consumer 1)
      wgmma_fence();
      ss_product<D, L::Keys::BOX_STRIDE, L::Rows::BOX_STRIDE, T, 64, P::QK>(s, a_op,
                                                                          c == 0 ? qt : dot);
      wgmma_commit();
      wgmma_wait<0>();
      pin(s);
      const float* lse_rows = stats + st * L::STAT_FLOATS;
      float4* const pt = pex + buf * (L::P_BYTES / 16) + tid;   // [8][128] float4
      uint32_t a[16];                                // P^T or dS^T, bf16 pairs
      if (c == 0) {
        const bool masked = first < k0 + KV_KEYS - 1;   // some row misses a key
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          const int col = 8 * (i >> 1) + 2 * t;      // rows col, col + 1 of the tile
          const float2 l2 = *reinterpret_cast<const float2*>(lse_rows + col);
          float p0 = exp2_ftz(fmaf(s[2 * i], scale_log2, -LOG2E * l2.x));
          float p1 = exp2_ftz(fmaf(s[2 * i + 1], scale_log2, -LOG2E * l2.y));
          if (masked) {
            const int kr = key + 8 * (i & 1);
            if (first + col < kr) p0 = 0.f;
            if (first + col + 1 < kr) p1 = 0.f;
          }
          s[2 * i] = p0;
          s[2 * i + 1] = p1;
          a[i] = pack2<T>(p0, p1);
        }
        if (j >= 2) bar_sync_consumers(3 + buf);    // consumer 1 has read this buffer
#pragma unroll
        for (int m = 0; m < 8; ++m)
          pt[m * 128] = make_float4(s[4 * m], s[4 * m + 1], s[4 * m + 2], s[4 * m + 3]);
        bar_arrive_consumers(1 + buf);
      } else {
        const float* di = lse_rows + KV_ROWS;
        bar_sync_consumers(1 + buf);                 // consumer 0's P^T is in the buffer
#pragma unroll
        for (int m = 0; m < 8; ++m) {
          const float4 p = pt[m * 128];
          const float2 d0 = *reinterpret_cast<const float2*>(di + 8 * m + 2 * t);
          a[2 * m] = pack2<T>(p.x * (s[4 * m] - d0.x), p.y * (s[4 * m + 1] - d0.y));
          a[2 * m + 1] = pack2<T>(p.z * (s[4 * m + 2] - d0.x), p.w * (s[4 * m + 3] - d0.y));
        }
        if (j + 2 < n_tiles) bar_arrive_consumers(3 + buf);
        // Consumer 0 wrote this P^T after it released tile j - 1, and so
        // did this consumer: that stage takes tile j + STAGES - 1.
        if (loader && j >= 1 && j + STAGES - 1 < n_tiles)
          load_rows(j + STAGES - 1, threadIdx.x == LOADER, threadIdx.x - LOADER);
        if constexpr (R::WIDE) __syncwarp();   // the loader's warp, converged for wgmma
      }
      pin(acc);
      pin(a);
      wgmma_fence();
      rs_product<D, L::Rows::BOX_STRIDE, T, 64, PV>(acc, a, c == 0 ? dot : qt);
      wgmma_commit();
      wgmma_wait<0>();
      pin(acc);
      pin(a);
      mbar_arrive(empty(st));
    }

    const int hkv = hq / group;
    const int dcols = DO > 0 ? DO : dh;
    const float mul = c == 0 ? 1.f : scale;
    T* const out = c == 0 ? dv : dk;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int kr = key + 8 * r;
      if (kr < sk) {
        if constexpr (DO < 0) {           // any head dim: each column guarded
          T* op = out + ((static_cast<long long>(b) * sk + kr) * hkv + hk) * dcols;
#pragma unroll
          for (int n = 0; n < PV / 8; ++n)
            if (8 * n < dcols)
              store2<T>(op, 8 * n + 2 * t, dcols, acc[4 * n + 2 * r] * mul,
                        acc[4 * n + 2 * r + 1] * mul);
        } else {
          T* op = out + ((static_cast<long long>(b) * sk + kr) * hkv + hk) * dcols + 2 * t;
#pragma unroll
          for (int n = 0; n < PV / 8; ++n)  // columns 8n + 2t, +1 < the head dim
            if (8 * n < dcols)
              *reinterpret_cast<uint32_t*>(op + n * 8) =
                  pack2<T>(acc[4 * n + 2 * r] * mul, acc[4 * n + 2 * r + 1] * mul);
        }
      }
    }
  }
}

enum Kernel { DQ = 0, DKDV = 1 };

template <int D, class P>
size_t smem_bytes(int which) {
  return which == DQ ? DqLayout<D, P::KEYS ? P::KEYS : Tiling<D>::DQ_KEYS>::SMEM
                     : KvLayout<D>::SMEM;
}

template <class R, typename Fn>
cudaError_t prepare(Fn kernel, size_t smem) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  if (!R::launchable(attr.numRegs)) return cudaErrorLaunchOutOfResources;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

struct Args {
  const void *o, *dout;
  const float* lse;
  float* dvec;
  void *dq, *dk, *dv;
};

// The kernel `which` on tiles D wide for head dim DO (DO = 0: dh, a
// multiple of 8, in [least_dim(D), D] and within the products' width; DO =
// -1: any dh there), T bf16 or fp16, its products and block order P; the L2
// order's KV heads a group group_kv (0 in the grid's order).
template <int D, int DO = D, typename T = __nv_bfloat16, class P = Products<D, D, false>>
cudaError_t launch(int which, const CUtensorMap (&maps)[4], const Args& a, int sq, int sk,
                   int hq, int hkv, int dh, int offset, dim3 grid, size_t smem,
                   cudaStream_t stream, int group_kv = 0) {
  static_assert(DO <= 0 || (DO <= D && DO % 16 == 0 && DO >= least_dim(D)),
                "DO: a head dim of D's tiles");
  static_assert(P::QK == P::PV && P::QK <= D &&
                    (DO > 0 ? P::QK >= DO : DO == 0 ? P::QK > least_dim(D) : P::QK == D),
                "the products span the head dim, within the tiles");
  if (DO > 0 ? dh != DO
             : ((DO == 0 && dh % 8 != 0) || dh > P::QK || dh < least_dim(D)))
    return cudaErrorInvalidValue;
  if (smem != smem_bytes<D, P>(which) || P::L2 != (group_kv > 0)) return cudaErrorInvalidValue;
  const float scale = 1.0f / sqrtf(static_cast<float>(dh));
  const float scale_log2 = scale * LOG2E;
  using R = RolesOf<D, P>;
  constexpr int THREADS = R::THREADS;
  cudaError_t err;
  if (which == DQ) {
    if ((err = prepare<R>(flash_bwd_dq_wgmma_kernel<D, DO, T, P>, smem)) != cudaSuccess)
      return err;
    flash_bwd_dq_wgmma_kernel<D, DO, T, P><<<grid, THREADS, smem, stream>>>(
        maps[0], maps[1], maps[2], maps[3], static_cast<const T*>(a.o),
        static_cast<const T*>(a.dout), a.lse, a.dvec, static_cast<T*>(a.dq), sq, sk, hq,
        hq / hkv, offset, dh, scale_log2, scale, group_kv);
  } else {
    if ((err = prepare<R>(flash_bwd_dkdv_wgmma_kernel<D, DO, T, P>, smem)) != cudaSuccess)
      return err;
    flash_bwd_dkdv_wgmma_kernel<D, DO, T, P><<<grid, THREADS, smem, stream>>>(
        maps[0], maps[1], maps[2], maps[3], a.lse, a.dvec, static_cast<T*>(a.dk),
        static_cast<T*>(a.dv), sq, sk, hq, hq / hkv, offset, dh, scale_log2, scale, group_kv);
  }
  return cudaGetLastError();
}

// The run-time head dim's instantiations: tiles tile_of(d) wide (16, 32,
// 64, 128, 192 or 256), DO 0 (d a multiple of 8) or -1 (any d: the guarded
// stores, element loads in D_i).
template <int DO, typename T>
int by_tile(int which, const CUtensorMap (&tm)[4], const Args& a, int sq, int sk, int hq,
            int hkv, int d, int offset, dim3 grid, size_t smem, cudaStream_t s) {
  switch (tile_of(d)) {
    case 16:
      return static_cast<int>(launch<16, DO, T>(which, tm, a, sq, sk, hq, hkv, d, offset, grid,
                                                smem, s));
    case 32:
      return static_cast<int>(launch<32, DO, T>(which, tm, a, sq, sk, hq, hkv, d, offset, grid,
                                                smem, s));
    case 64:
      return static_cast<int>(launch<64, DO, T>(which, tm, a, sq, sk, hq, hkv, d, offset, grid,
                                                smem, s));
    case 128:
      return static_cast<int>(launch<128, DO, T>(which, tm, a, sq, sk, hq, hkv, d, offset,
                                                 grid, smem, s));
    case 192:
      return static_cast<int>(launch<192, DO, T>(which, tm, a, sq, sk, hq, hkv, d, offset,
                                                 grid, smem, s));
    default:
      return static_cast<int>(launch<256, DO, T>(which, tm, a, sq, sk, hq, hkv, d, offset,
                                                 grid, smem, s));
  }
}

// The head-dim kernels: a head dim d, a multiple of 8 in (32, 128], with
// every product at W = ceil(d / 16) * 16 (S, dP and their transposes in W /
// 16 k-steps; dQ, dK and dV at N = W) on the tiles 64 or 128 wide, in the L2
// order (group_kv > 0 KV heads a group; one group of every KV head is the
// grid's order), T bf16 or fp16.
template <typename T>
int by_width(int which, const CUtensorMap (&tm)[4], const Args& a, int sq, int sk, int hq,
             int hkv, int d, int offset, dim3 grid, size_t smem, cudaStream_t s, int group_kv) {
  switch ((d + 15) / 16 * 16) {
    case 48:
      return static_cast<int>(launch<64, 0, T, Products<48, 48, true>>(
          which, tm, a, sq, sk, hq, hkv, d, offset, grid, smem, s, group_kv));
    case 64:
      return static_cast<int>(launch<64, 0, T, Products<64, 64, true>>(
          which, tm, a, sq, sk, hq, hkv, d, offset, grid, smem, s, group_kv));
    case 80:
      return static_cast<int>(launch<128, 0, T, Products<80, 80, true>>(
          which, tm, a, sq, sk, hq, hkv, d, offset, grid, smem, s, group_kv));
    case 96:
      return static_cast<int>(launch<128, 0, T, Products<96, 96, true>>(
          which, tm, a, sq, sk, hq, hkv, d, offset, grid, smem, s, group_kv));
    case 112:
      return static_cast<int>(launch<128, 0, T, Products<112, 112, true>>(
          which, tm, a, sq, sk, hq, hkv, d, offset, grid, smem, s, group_kv));
    case 128:
      return static_cast<int>(launch<128, 0, T, Products<128, 128, true>>(
          which, tm, a, sq, sk, hq, hkv, d, offset, grid, smem, s, group_kv));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The wide kernels (hopper::Wide, flash_attention.cu's): a head dim d in
// (128, 256] on the tiles 192 or 256 wide, DO 0 (d a multiple of 8) or -1
// (any d), T bf16 or fp16, dQ's K/V tiles of wide_dq_keys(D) keys, at width
// 256 a producer warpgroup, both kernels in the L2 order (group_kv > 0 KV
// heads a group).
template <int D>
using Wide = Products<D, D, true, wide_dq_keys(D), (D > 192 ? 240 : 0)>;
template <int DO, typename T>
int by_wide(int which, const CUtensorMap (&tm)[4], const Args& a, int sq, int sk, int hq,
            int hkv, int d, int offset, dim3 grid, size_t smem, cudaStream_t s, int group_kv) {
  if (tile_of(d) == 192)
    return static_cast<int>(launch<192, DO, T, Wide<192>>(which, tm, a, sq, sk, hq, hkv, d,
                                                          offset, grid, smem, s, group_kv));
  return static_cast<int>(launch<256, DO, T, Wide<256>>(which, tm, a, sq, sk, hq, hkv, d, offset,
                                                        grid, smem, s, group_kv));
}

}  // namespace wg

// --- bf16 and fp16 at D <= 32: mma.sync, the LSE from flash_mma_kernel -------

namespace mm {

constexpr int ROWS = 64;           // dQ: query rows per block; dK/dV: query rows per tile
constexpr int KEYS = 64;           // dQ: keys per tile; dK/dV: keys per block
constexpr int WARPS = 4;           // 16 rows (dQ) or 16 keys (dK/dV) a warp
constexpr float LOG2E = 1.4426950408889634f;
using hopper::exp2_ftz;

// Shared memory: tiles of 64 rows of DP + 8 16-bit elements (as the
// forward's flash_mma_kernel: each 8 x 8 matrix's rows 16-byte aligned and
// in distinct banks).  dQ: Q, dO, two buffers each of K and V; dK/dV: K, V,
// two buffers each of Q and dO, then each buffer's 64 LSEs and 64 D_i.
template <int DP>
__host__ __device__ constexpr size_t dq_smem_bytes() {
  return sizeof(uint16_t) * 6 * ROWS * (DP + 8);
}
template <int DP>
__host__ __device__ constexpr size_t dkdv_smem_bytes() {
  return dq_smem_bytes<DP>() + sizeof(float) * 2 * 2 * ROWS;
}

// The A fragments (m16n8k16) of rows r0..r0 + 15 of a tile: DP / 16 slices
// of 16 columns, lane 4g + t holding rows g, g + 8 and columns 2t, 2t + 1,
// 2t + 8, 2t + 9 of each.
template <typename T, int DP>
__device__ __forceinline__ void a_frags(uint32_t (&a)[DP / 16][4], const T* tile, int r0,
                                        int lane) {
  constexpr int KS = DP + 8;
  const T* p = tile + (r0 + (lane >> 2)) * KS + 2 * (lane & 3);
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    a[kk][0] = ld32(p + kk * 16);
    a[kk][1] = ld32(p + 8 * KS + kk * 16);
    a[kk][2] = ld32(p + kk * 16 + 8);
    a[kk][3] = ld32(p + 8 * KS + kk * 16 + 8);
  }
}

// c (16 x 64, fp32 C fragments: c[n] the 8 columns 8n..8n + 7) = A B^T over
// DP: A in fragments, B the 64 rows of `tile` read by plain ldmatrix (the
// forward's S = Q K^T).
template <typename T, int DP>
__device__ __forceinline__ void abt(float (&c)[8][4], const uint32_t (&a)[DP / 16][4],
                                    const T* tile, int lane) {
  constexpr int KS = DP + 8;
  const int row = (lane & 7) + ((lane >> 4) << 3), col = ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int n = 0; n < 8; ++n) c[n][0] = c[n][1] = c[n][2] = c[n][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t f[4];
      ldmatrix_x4(f, tile + (np * 16 + row) * KS + kk * 16 + col);
      mma_16816<T>(c[2 * np], a[kk], f[0], f[1]);
      mma_16816<T>(c[2 * np + 1], a[kk], f[2], f[3]);
    }
  }
}

// acc (16 x DP) += X B: X (16 x 64) the C fragments x rounded to T (two
// adjacent C fragments are one A fragment), B the 64 rows of `tile` along
// the product, read by ldmatrix .trans (the forward's O += P V).
template <typename T, int DP>
__device__ __forceinline__ void xb(float (&acc)[DP / 8][4], const float (&x)[8][4],
                                   const T* tile, int lane) {
  constexpr int KS = DP + 8;
  const int row = (lane & 7) + (((lane >> 3) & 1) << 3), col = (lane >> 4) * 8;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint32_t xa[4] = {pack2<T>(x[2 * kk][0], x[2 * kk][1]),
                            pack2<T>(x[2 * kk][2], x[2 * kk][3]),
                            pack2<T>(x[2 * kk + 1][0], x[2 * kk + 1][1]),
                            pack2<T>(x[2 * kk + 1][2], x[2 * kk + 1][3])};
#pragma unroll
    for (int dp = 0; dp < DP / 16; ++dp) {
      uint32_t f[4];
      ldmatrix_x4_trans(f, tile + (kk * 16 + row) * KS + dp * 16 + col);
      mma_16816<T>(acc[2 * dp], xa, f[0], f[1]);
      mma_16816<T>(acc[2 * dp + 1], xa, f[2], f[3]);
    }
  }
}

// dQ: one block per (64 query rows, query head, batch), heaviest tiles
// first; warp w owns rows 16w..16w + 15.  D_i = dO_i . O_i of its rows from
// device memory (fp32, written to `dvec` for the dK/dV kernel) while Q, dO
// and the first K/V tile come by cp.async; Q then stays in registers as A
// fragments, dO's are read from shared memory at each tile (held beside Q,
// S, dP and dQ they took ptxas to 128 registers and a 12-byte spill at DP
// 32).  Per tile of 64 keys (the next one loading into the other
// buffer): S = Q K^T and dP = dO V^T, P = 2^(S scale_log2 - LSE log2 e), 0
// where masked, dS = P (dP - D_i) rounded to T, dQ += dS K.  A warp skips a
// tile none of its rows sees.  Element e of a C fragment n is row g + 8 (e
// >> 1), key 8n + 2t + (e & 1) of the tile.
template <typename T, int DP>
__global__ void __launch_bounds__(WARPS * 32)
flash_bwd_dq_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ o,
                        const T* __restrict__ dout, const float* __restrict__ lse,
                        float* __restrict__ dvec, T* __restrict__ dq, Dims dm, bool vec) {
  constexpr int KS = DP + 8;
  extern __shared__ __align__(16) unsigned char mma_smem[];
  T* qbuf = reinterpret_cast<T*>(mma_smem);      // ROWS x KS
  T* dobuf = qbuf + ROWS * KS;                    // ROWS x KS
  T* kbuf = dobuf + ROWS * KS;                    // 2 x KEYS x KS
  T* vbuf = kbuf + 2 * KEYS * KS;                 // 2 x KEYS x KS

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * ROWS, h = blockIdx.y, b = blockIdx.z;
  const int hkv = dm.hq / dm.group, d = dm.d;
  const long long q_rs = static_cast<long long>(dm.hq) * d, k_rs = static_cast<long long>(hkv) * d;
  const long long q_off = static_cast<long long>(b) * dm.sq * q_rs + h * d;
  const long long kv_off = static_cast<long long>(b) * dm.sk * k_rs + (h / dm.group) * d;
  const int n_tiles = kv_tiles<ROWS, KEYS>(q0, dm.sq, dm.sk, dm.offset);
  auto load_kv = [&](int tile, int buf) {
    load_rows<T, DP>(kbuf + buf * KEYS * KS, k + kv_off, tile * KEYS, KEYS, dm.sk, k_rs, d, vec);
    load_rows<T, DP>(vbuf + buf * KEYS * KS, v + kv_off, tile * KEYS, KEYS, dm.sk, k_rs, d, vec);
  };
  load_rows<T, DP>(qbuf, q + q_off, q0, ROWS, dm.sq, q_rs, d, vec);
  load_rows<T, DP>(dobuf, dout + q_off, q0, ROWS, dm.sq, q_rs, d, vec);
  load_kv(0, 0);
  cp_async_commit();

  // D_i: lane l sums columns 16 (l & 1) .. + 15 (below d) of row l >> 1 of
  // the warp's 16, the lane pair's sums added; lanes 2g and 2g + 16 hold rows
  // g and g + 8.
  const long long stat = (static_cast<long long>(b) * dm.hq + h) * dm.sq;
  const int row0 = q0 + 16 * warp;
  float part = 0.f;
  const int rr = row0 + (lane >> 1);
  if (rr < dm.sq) {
    const long long at = q_off + rr * q_rs;
    for (int c = 16 * (lane & 1); c < min(d, 16 * (lane & 1) + 16); ++c)
      part = fmaf(to_f(o[at + c]), to_f(dout[at + c]), part);
  }
  part += __shfl_xor_sync(0xffffffffu, part, 1);
  if ((lane & 1) == 0 && rr < dm.sq) dvec[stat + rr] = part;
  const float di[2] = {__shfl_sync(0xffffffffu, part, 2 * g),
                       __shfl_sync(0xffffffffu, part, 2 * g + 16)};
  const int row = row0 + g;                         // this thread's rows: row, row + 8
  float lse2[2];
#pragma unroll
  for (int r = 0; r < 2; ++r)
    lse2[r] = row + 8 * r < dm.sq ? lse[stat + row + 8 * r] * LOG2E : 0.f;
  const float scale_log2 = dm.scale * LOG2E;

  cp_async_wait<0>();
  __syncthreads();
  uint32_t qa[DP / 16][4];       // Q's fragments stay in registers; dO's are read at each tile
  a_frags<T, DP>(qa, qbuf, 16 * warp, lane);

  float acc[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  const long long qpos = static_cast<long long>(dm.offset) + row;
  const long long first = static_cast<long long>(dm.offset) + row0;   // the warp's first row
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * KEYS, buf = tile & 1;
    if (tile + 1 < n_tiles) {      // the next tile streams in under this one
      load_kv(tile + 1, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (k0 <= first + 15) {        // some row of this warp sees a key of the tile
      const T* kt = kbuf + buf * KEYS * KS;
      float s[8][4], dp[8][4];
      abt<T, DP>(s, qa, kt, lane);
      uint32_t da[DP / 16][4];
      a_frags<T, DP>(da, dobuf, 16 * warp, lane);
      abt<T, DP>(dp, da, vbuf + buf * KEYS * KS, lane);
      const bool full = k0 + KEYS <= dm.sk && k0 + KEYS - 1 <= first;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + 8 * n + 2 * t + (e & 1);
          const bool live = full || (key < dm.sk && qpos + 8 * (e >> 1) >= key);
          const float p = live ? exp2_ftz(fmaf(s[n][e], scale_log2, -lse2[e >> 1])) : 0.f;
          s[n][e] = p * (dp[n][e] - di[e >> 1]);     // dS
        }
      }
      xb<T, DP>(acc, s, kt, lane);
    }
    __syncthreads();               // every warp is done with this buffer
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int orow = row + 8 * r;
    if (orow < dm.sq) {
      T* op = dq + q_off + orow * q_rs;
#pragma unroll
      for (int n = 0; n < DP / 8; ++n)
        if (8 * n < d)
          store2<T>(op, 8 * n + 2 * t, d, acc[n][2 * r] * dm.scale, acc[n][2 * r + 1] * dm.scale);
    }
  }
}

// dK/dV: one block per (64 keys, KV head, batch), the first key tiles
// (which the most rows see) first; warp w owns keys 16w..16w + 15, K and V
// of them in registers as A fragments.  For each query head of the group
// and each 64-row query tile that sees the block's first key, Q, dO and the
// rows' LSE and D_i come by cp.async into one of two buffers (the next tile
// loading under this one): S^T = K Q^T and dP^T = V dO^T, P^T = 2^(S^T
// scale_log2 - LSE log2 e), 0 where masked, dS^T = P^T (dP^T - D_i); dV +=
// P^T dO and dK += dS^T Q with P^T and dS^T rounded to T.  The group is
// summed inside the block: no atomics, so two runs give equal bits.
// Element e of a C fragment n is key g + 8 (e >> 1), query row 8n + 2t +
// (e & 1) of the tile.
template <typename T, int DP>
__global__ void __launch_bounds__(WARPS * 32)
flash_bwd_dkdv_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ dvec,
                          T* __restrict__ dk, T* __restrict__ dv, Dims dm, bool vec) {
  constexpr int KS = DP + 8;
  extern __shared__ __align__(16) unsigned char mma_smem[];
  T* kbuf = reinterpret_cast<T*>(mma_smem);      // KEYS x KS
  T* vbuf = kbuf + KEYS * KS;                     // KEYS x KS
  T* qbuf = vbuf + KEYS * KS;                     // 2 x ROWS x KS
  T* dobuf = qbuf + 2 * ROWS * KS;                // 2 x ROWS x KS
  float* stats = reinterpret_cast<float*>(mma_smem + dq_smem_bytes<DP>());   // 2 x (LSE, D_i)

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int k0 = blockIdx.x * KEYS, hk = blockIdx.y, b = blockIdx.z;
  const int hkv = dm.hq / dm.group, d = dm.d;
  const long long q_rs = static_cast<long long>(dm.hq) * d, k_rs = static_cast<long long>(hkv) * d;
  const long long kv_off = static_cast<long long>(b) * dm.sk * k_rs + hk * d;
  // Query tiles from the one holding the first row that sees key k0
  // (offset + row >= k0): every one of them sees it.
  const long long first_row = max(0LL, static_cast<long long>(k0) - dm.offset);
  const int n_q = (dm.sq + ROWS - 1) / ROWS;
  const int t0 = first_row >= dm.sq ? n_q : static_cast<int>(first_row / ROWS);
  const int per_head = n_q - t0;
  const int n_tiles = dm.group * per_head;
  auto head = [&](int j) { return hk * dm.group + j / per_head; };
  auto rows_of = [&](int j) { return (t0 + j % per_head) * ROWS; };
  auto load_q = [&](int j, int buf) {
    const int h = head(j), r0 = rows_of(j);
    const long long q_off = static_cast<long long>(b) * dm.sq * q_rs + h * d;
    load_rows<T, DP>(qbuf + buf * ROWS * KS, q + q_off, r0, ROWS, dm.sq, q_rs, d, vec);
    load_rows<T, DP>(dobuf + buf * ROWS * KS, dout + q_off, r0, ROWS, dm.sq, q_rs, d, vec);
    const long long stat = (static_cast<long long>(b) * dm.hq + h) * dm.sq;
    const uint32_t st = smem_addr(stats + buf * 2 * ROWS);
    for (int i = threadIdx.x; i < ROWS; i += blockDim.x) {
      const bool in = r0 + i < dm.sq;      // rows past Sq land as zeros
      const long long at = stat + (in ? r0 + i : 0);
      cp_async4(st + 4 * i, lse + at, in);
      cp_async4(st + 4 * (ROWS + i), dvec + at, in);
    }
  };
  load_rows<T, DP>(kbuf, k + kv_off, k0, KEYS, dm.sk, k_rs, d, vec);
  load_rows<T, DP>(vbuf, v + kv_off, k0, KEYS, dm.sk, k_rs, d, vec);
  if (n_tiles > 0) load_q(0, 0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  uint32_t ka[DP / 16][4], va[DP / 16][4];
  a_frags<T, DP>(ka, kbuf, 16 * warp, lane);
  a_frags<T, DP>(va, vbuf, 16 * warp, lane);

  float acc_k[DP / 8][4], acc_v[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[n][e] = acc_v[n][e] = 0.f;
  const int key = k0 + 16 * warp + g;              // this thread's keys: key, key + 8
  const int last_key = k0 + 16 * warp + 15;        // the warp's last key
  const float scale_log2 = dm.scale * LOG2E;
  for (int j = 0; j < n_tiles; ++j) {
    const int buf = j & 1, r0 = rows_of(j);
    if (j + 1 < n_tiles) {
      load_q(j + 1, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const long long first = static_cast<long long>(dm.offset) + r0;   // the tile's first row
    // skip the tile where no row sees a key of this warp, or its keys are past Sk
    if (first + ROWS - 1 >= k0 + 16 * warp && k0 + 16 * warp < dm.sk) {
      const T* qt = qbuf + buf * ROWS * KS;
      const T* dot = dobuf + buf * ROWS * KS;
      const float* lse_t = stats + buf * 2 * ROWS;
      float st[8][4], dpt[8][4];
      abt<T, DP>(st, ka, qt, lane);
      abt<T, DP>(dpt, va, dot, lane);
      const bool full = r0 + ROWS <= dm.sq && last_key < dm.sk && first >= last_key;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int c = 8 * n + 2 * t;                 // rows c, c + 1 of the tile
        const float2 l2 = *reinterpret_cast<const float2*>(lse_t + c);
        const float2 d2 = *reinterpret_cast<const float2*>(lse_t + ROWS + c);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kr = key + 8 * (e >> 1), rr = r0 + c + (e & 1);
          const bool live = full || (kr < dm.sk && rr < dm.sq && first + c + (e & 1) >= kr);
          const float p = live ? exp2_ftz(fmaf(st[n][e], scale_log2,
                                               -LOG2E * ((e & 1) ? l2.y : l2.x)))
                               : 0.f;
          st[n][e] = p;                                            // P^T
          dpt[n][e] = p * (dpt[n][e] - ((e & 1) ? d2.y : d2.x));   // dS^T
        }
      }
      xb<T, DP>(acc_v, st, dot, lane);
      xb<T, DP>(acc_k, dpt, qt, lane);
    }
    __syncthreads();               // every warp is done with this buffer
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kr = key + 8 * r;
    if (kr < dm.sk) {
      const long long at = kv_off + kr * k_rs;
#pragma unroll
      for (int n = 0; n < DP / 8; ++n) {
        if (8 * n < d) {
          store2<T>(dk + at, 8 * n + 2 * t, d, acc_k[n][2 * r] * dm.scale,
                    acc_k[n][2 * r + 1] * dm.scale);
          store2<T>(dv + at, 8 * n + 2 * t, d, acc_v[n][2 * r], acc_v[n][2 * r + 1]);
        }
      }
    }
  }
}

enum Kernel { DQ = 0, DKDV = 1 };

template <typename T, int DP>
cudaError_t launch(int which, const Args& a, Dims dm, bool vec, dim3 grid, size_t smem,
                   cudaStream_t stream) {
  if (smem != (which == DQ ? dq_smem_bytes<DP>() : dkdv_smem_bytes<DP>()))
    return cudaErrorInvalidValue;
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  cudaError_t err;
  if (which == DQ) {
    if ((err = prepare(flash_bwd_dq_mma_kernel<T, DP>, smem)) != cudaSuccess) return err;
    flash_bwd_dq_mma_kernel<T, DP><<<grid, WARPS * 32, smem, stream>>>(
        q, k, v, static_cast<const T*>(a.o), dout, a.lse, a.dvec, static_cast<T*>(a.dq), dm,
        vec);
  } else {
    if ((err = prepare(flash_bwd_dkdv_mma_kernel<T, DP>, smem)) != cudaSuccess) return err;
    flash_bwd_dkdv_mma_kernel<T, DP><<<grid, WARPS * 32, smem, stream>>>(
        q, k, v, dout, a.lse, a.dvec, static_cast<T*>(a.dk), static_cast<T*>(a.dv), dm, vec);
  }
  return cudaGetLastError();
}

}  // namespace mm

// --- fp32: register-tiled FMA, the LSE from flash_tiled_kernel ---------------

namespace tl {

using tiled::LOG2E;

// dQ: one block per (ROWS query rows, query head, batch), heaviest tiles
// first; 16 x 16 threads (f32_tiles.cuh), thread (ty, tx) owning rows q0 +
// RT ty + i (i < RT) of S, dP, dS and dQ, keys k0 + tx + 16 j (j < CT) of the
// scores and dQ columns tx + 16 j (j < J).  D_i = dO_i . O_i of its rows
// from device memory (fp32, written to `dvec` for the dK/dV kernel), the
// rows' LSE in the log2 domain.  Q and dO stay in shared memory; per key
// tile, K and V each in one buffer: V_j came while tile j - 1's products ran,
// K_j loads while dP = dO V_j^T runs, V_{j + 1} while S = Q K_j^T, P = 2^(S
// scale_log2 - LSE log2 e) (0 where masked), dS = P (dP - D_i) and dQ += dS
// K_j run, dS^T passing to the same half warp through shared memory.  A warp
// skips a tile none of its 2 RT rows sees.  Rows past Sq load as zeros with
// LSE and D_i 0, and are not stored.
template <int J>
__global__ void __launch_bounds__(tiled::DqTiles<J>::THREADS, tiled::DqTiles<J>::BLOCKS)
flash_bwd_dq_tiled_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, const float* __restrict__ o,
                          const float* __restrict__ dout, const float* __restrict__ lse,
                          float* __restrict__ dvec, float* __restrict__ dq, Dims dm, bool vec) {
  using L = tiled::DqTiles<J>;
  constexpr int RT = L::RT, CT = L::CT, ROWS = L::ROWS, KEYS = L::KEYS, RS = L::RS,
                XS = L::XS;
  extern __shared__ __align__(16) float tiled_smem[];
  float* qt = tiled_smem + L::Q;
  float* dot = tiled_smem + L::DO;
  float* kt = tiled_smem + L::K;
  float* vt = tiled_smem + L::V;
  float* dst = tiled_smem + L::DS;

  const int tid = threadIdx.x, ty = tid / tiled::TX, tx = tid % tiled::TX, warp = tid / 32;
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * ROWS;   // heaviest query tiles first
  const int hkv = dm.hq / dm.group, d = dm.d;
  const long long q_rs = static_cast<long long>(dm.hq) * d, k_rs = static_cast<long long>(hkv) * d;
  const long long q_off = static_cast<long long>(b) * dm.sq * q_rs + h * d;
  const long long kv_off = static_cast<long long>(b) * dm.sk * k_rs + (h / dm.group) * d;
  const int w = tiled::width(d);
  const int n_tiles = kv_tiles<ROWS, KEYS>(q0, dm.sq, dm.sk, dm.offset);
  tiled::load_tile<J>(qt, q + q_off, q0, ROWS, dm.sq, q_rs, d, vec);
  tiled::load_tile<J>(dot, dout + q_off, q0, ROWS, dm.sq, q_rs, d, vec);
  tiled::load_tile<J>(vt, v + kv_off, 0, KEYS, dm.sk, k_rs, d, vec);
  cp_async_commit();

  // D_i: the row's 16 threads sum columns tx + 16 j; and the LSE.
  const int a0 = RT * ty;
  const long long stat = (static_cast<long long>(b) * dm.hq + h) * dm.sq;
  float di[RT], lse2[RT];
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int row = q0 + a0 + i;
    float part = 0.f;
    if (row < dm.sq) {
      const long long at = q_off + row * q_rs;
#pragma unroll
      for (int j = 0; j < J; ++j)
        if (tx + 16 * j < d) part = fmaf(o[at + tx + 16 * j], dout[at + tx + 16 * j], part);
    }
    di[i] = tiled::sum16(part);
    if (tx == 0 && row < dm.sq) dvec[stat + row] = di[i];
    lse2[i] = row < dm.sq ? lse[stat + row] * LOG2E : 0.f;
  }
  const float scale_log2 = dm.scale * LOG2E;

  float acc[RT][J];
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int j = 0; j < J; ++j) acc[i][j] = 0.f;
  const long long pos0 = static_cast<long long>(dm.offset) + q0 + a0;
  const int wr0 = q0 + 2 * RT * warp;                    // the warp's rows: wr0 .. wr0 + 2 RT - 1
  const long long w_first = static_cast<long long>(dm.offset) + wr0;
  const long long w_last = static_cast<long long>(dm.offset) + min(wr0 + 2 * RT, dm.sq) - 1;
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * KEYS;
    cp_async_wait<0>();
    __syncthreads();               // V_j is in; every warp is done with K_{j - 1} and dS^T
    tiled::load_tile<J>(kt, k + kv_off, k0, KEYS, dm.sk, k_rs, d, vec);
    cp_async_commit();
    const bool active = wr0 < dm.sq && k0 <= w_last;
    float dp[RT][CT];
    if (active) tiled::abt<RT, CT, RS>(dp, dot + a0 * RS, vt + tx * RS, w);
    cp_async_wait<0>();
    __syncthreads();               // K_j is in; every warp is done with V_j
    if (tile + 1 < n_tiles)
      tiled::load_tile<J>(vt, v + kv_off, k0 + KEYS, KEYS, dm.sk, k_rs, d, vec);
    cp_async_commit();
    if (active) {
      float s[RT][CT];
      tiled::abt<RT, CT, RS>(s, qt + a0 * RS, kt + tx * RS, w);
      const bool full = k0 + KEYS <= dm.sk && k0 + KEYS - 1 <= w_first;
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int j = 0; j < CT; ++j) {
          const int key = k0 + tx + 16 * j;
          const bool live = full || (key < dm.sk && pos0 + i >= key);
          const float p = live ? exp2f(fmaf(s[i][j], scale_log2, -lse2[i])) : 0.f;
          s[i][j] = p * (dp[i][j] - di[i]);          // dS
        }
      tiled::store_t<RT, CT, XS>(dst + tx * XS + a0, s);
      __syncwarp();
      tiled::xty<RT, J, KEYS, XS, RS>(acc, dst + a0, kt + tx);
    }
  }

#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int row = q0 + a0 + i;
    if (row < dm.sq) {
      float* op = dq + q_off + row * q_rs;
#pragma unroll
      for (int j = 0; j < J; ++j)
        if (tx + 16 * j < d) op[tx + 16 * j] = acc[i][j] * dm.scale;
    }
  }
}

// dK/dV: one block per (KEYS keys, KV head, batch), the first key tiles
// (which the most rows see) first; 16 x 16 threads, thread (ty, tx) owning
// keys k0 + RT ty + i (i < RT) of S^T, dP^T and the accumulators, query rows
// r0 + tx + 16 j (j < CT) of the scores and dK/dV columns tx + 16 j (j <
// J).  K and V stay in shared memory; for each query head of the group and
// each ROWS-row query tile that sees the block's first key, Q (two buffers,
// the next tile's loading under this one's products, with its rows' LSE and
// D_i) and dO (one buffer: the next tile's loads while dK += dS^T Q runs):
// S^T = K Q^T, P^T = 2^(S^T scale_log2 - LSE log2 e), 0 where masked, dV +=
// P^T dO, then dP^T = V dO^T, dS^T = P^T (dP^T - D_i), dK += dS^T Q, P^T
// and dS^T held in registers and passing to the same half warp through one
// shared buffer in NCH chunks of rows (xty_chunks); computing dP^T after dV
// keeps dP^T, P^T and both accumulators the most a thread holds at once.  Up to
// width 112 a thread holds 8 keys x 4 rows of each score tile (128 keys a
// block), which the one chunked buffer leaves room for.  A warp skips a
// tile in which none of its 2 RT keys is seen, or whose keys lie past Sk.
// The group is summed inside the block: no atomics, so two runs give equal
// bits.
template <int J>
__global__ void __launch_bounds__(tiled::DkdvTiles<J>::THREADS, tiled::DkdvTiles<J>::BLOCKS)
flash_bwd_dkdv_tiled_kernel(const float* __restrict__ q, const float* __restrict__ k,
                            const float* __restrict__ v, const float* __restrict__ dout,
                            const float* __restrict__ lse, const float* __restrict__ dvec,
                            float* __restrict__ dk, float* __restrict__ dv, Dims dm, bool vec) {
  using L = tiled::DkdvTiles<J>;
  constexpr int RT = L::RT, CT = L::CT, ROWS = L::ROWS, KEYS = L::KEYS, RS = L::RS,
                XS = L::XS, NCH = L::NCH;
  extern __shared__ __align__(16) float tiled_smem[];
  float* kt = tiled_smem + L::K;
  float* vt = tiled_smem + L::V;
  float* dot = tiled_smem + L::DO;
  float* pbuf = tiled_smem + L::P;
  auto qbuf = [&](int buf) { return tiled_smem + L::Q + buf * ROWS * RS; };
  auto stats = [&](int buf) { return tiled_smem + L::STATS + buf * 2 * ROWS; };   // LSE, D_i

  const int tid = threadIdx.x, ty = tid / tiled::TX, tx = tid % tiled::TX, warp = tid / 32;
  const int k0 = blockIdx.z * KEYS, hk = blockIdx.x, b = blockIdx.y;
  const int hkv = dm.hq / dm.group, d = dm.d;
  const long long q_rs = static_cast<long long>(dm.hq) * d, k_rs = static_cast<long long>(hkv) * d;
  const long long kv_off = static_cast<long long>(b) * dm.sk * k_rs + hk * d;
  const int w = tiled::width(d);
  // Query tiles from the one holding the first row that sees key k0
  // (offset + row >= k0): every one of them sees it.
  const long long first_row = max(0LL, static_cast<long long>(k0) - dm.offset);
  const int n_q = (dm.sq + ROWS - 1) / ROWS;
  const int t0 = first_row >= dm.sq ? n_q : static_cast<int>(first_row / ROWS);
  const int per_head = n_q - t0;
  const int n_tiles = dm.group * per_head;
  auto head = [&](int j) { return hk * dm.group + j / per_head; };
  auto rows_of = [&](int j) { return (t0 + j % per_head) * ROWS; };
  auto q_off = [&](int j) { return static_cast<long long>(b) * dm.sq * q_rs + head(j) * d; };
  auto load_q = [&](int j, int buf) {
    tiled::load_tile<J>(qbuf(buf), q + q_off(j), rows_of(j), ROWS, dm.sq, q_rs, d, vec);
    const long long stat = (static_cast<long long>(b) * dm.hq + head(j)) * dm.sq;
    tiled::load_stats(stats(buf), lse + stat, rows_of(j), ROWS, dm.sq);
    tiled::load_stats(stats(buf) + ROWS, dvec + stat, rows_of(j), ROWS, dm.sq);
  };
  tiled::load_tile<J>(kt, k + kv_off, k0, KEYS, dm.sk, k_rs, d, vec);
  tiled::load_tile<J>(vt, v + kv_off, k0, KEYS, dm.sk, k_rs, d, vec);
  if (n_tiles > 0) {
    load_q(0, 0);
    tiled::load_tile<J>(dot, dout + q_off(0), rows_of(0), ROWS, dm.sq, q_rs, d, vec);
  }
  cp_async_commit();

  float acc_k[RT][J], acc_v[RT][J];
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int j = 0; j < J; ++j) acc_k[i][j] = acc_v[i][j] = 0.f;
  const int a0 = RT * ty;                                // the thread's first key in the block
  const int wk0 = k0 + 2 * RT * warp, wk_last = wk0 + 2 * RT - 1;   // the warp's keys
  const float scale_log2 = dm.scale * LOG2E;
  for (int j = 0; j < n_tiles; ++j) {
    const int buf = j & 1, r0 = rows_of(j);
    const float* qt = qbuf(buf);
    const float* st_t = stats(buf);
    cp_async_wait<0>();
    __syncthreads();               // Q_j, dO_j and their rows' LSE and D_i are in; every
                                   // warp is done with tile j - 1 (Q buffer buf ^ 1)
    if (j + 1 < n_tiles) load_q(j + 1, buf ^ 1);
    cp_async_commit();
    const long long first = static_cast<long long>(dm.offset) + r0;    // the tile's first row
    const long long last = static_cast<long long>(dm.offset) + min(r0 + ROWS, dm.sq) - 1;
    const bool active = wk0 < dm.sk && last >= wk0;
    float ds[RT][CT];             // dP^T, then dS^T
    if (active) {
      float st[RT][CT];           // S^T, then P^T
      tiled::abt<RT, CT, RS>(st, kt + a0 * RS, qt + tx * RS, w);
      const bool full = r0 + ROWS <= dm.sq && wk_last < dm.sk && first >= wk_last;
#pragma unroll
      for (int c = 0; c < CT; ++c) {
        const int r = tx + 16 * c;                       // the row in the tile
        const float l2 = st_t[r] * LOG2E;
#pragma unroll
        for (int i = 0; i < RT; ++i) {
          const int kr = k0 + a0 + i;
          const bool live = full || (kr < dm.sk && r0 + r < dm.sq && first + r >= kr);
          st[i][c] = live ? exp2f(fmaf(st[i][c], scale_log2, -l2)) : 0.f;
        }
      }
      tiled::xty_chunks<RT, CT, J, NCH, XS, RS>(acc_v, st, pbuf, dot + tx, tx, a0);  // dV
      // dP^T beside P^T and both accumulators: at 8 keys a thread its loop
      // is not unrolled, which keeps the registers under 255
      tiled::abt<RT, CT, RS, RT == 8 ? 1 : 2>(ds, vt + a0 * RS, dot + tx * RS, w);
#pragma unroll
      for (int c = 0; c < CT; ++c) {
        const float di = st_t[ROWS + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < RT; ++i) ds[i][c] = st[i][c] * (ds[i][c] - di);
      }
    }
    __syncthreads();               // every warp is done with dO_j
    if (j + 1 < n_tiles)
      tiled::load_tile<J>(dot, dout + q_off(j + 1), rows_of(j + 1), ROWS, dm.sq, q_rs, d, vec);
    cp_async_commit();
    if (active) tiled::xty_chunks<RT, CT, J, NCH, XS, RS>(acc_k, ds, pbuf, qt + tx, tx, a0);
  }

#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int key = k0 + a0 + i;
    if (key < dm.sk) {
      const long long at = kv_off + key * k_rs;
#pragma unroll
      for (int j = 0; j < J; ++j) {
        if (tx + 16 * j < d) {
          dk[at + tx + 16 * j] = acc_k[i][j] * dm.scale;
          dv[at + tx + 16 * j] = acc_v[i][j];
        }
      }
    }
  }
}

enum Kernel { DQ = 0, DKDV = 1 };

// The grid's z extent and the dynamic shared memory of kernel `which` at J
// slots: query tiles of DqTiles<J>::ROWS for dQ, key blocks of
// DkdvTiles<J>::KEYS for dK/dV.
template <int J>
cudaError_t launch(int which, const Args& a, Dims dm, bool vec, dim3 grid, size_t smem,
                   cudaStream_t stream) {
  using Q = tiled::DqTiles<J>;
  using K = tiled::DkdvTiles<J>;
  const int tiles = which == DQ ? (dm.sq + Q::ROWS - 1) / Q::ROWS : (dm.sk + K::KEYS - 1) / K::KEYS;
  if (smem != (which == DQ ? Q::SMEM : K::SMEM) || grid.z != static_cast<unsigned>(tiles))
    return cudaErrorInvalidValue;
  const float* q = static_cast<const float*>(a.q);
  const float* k = static_cast<const float*>(a.k);
  const float* v = static_cast<const float*>(a.v);
  const float* dout = static_cast<const float*>(a.dout);
  cudaError_t err;
  if (which == DQ) {
    if ((err = prepare(flash_bwd_dq_tiled_kernel<J>, smem)) != cudaSuccess) return err;
    flash_bwd_dq_tiled_kernel<J><<<grid, Q::THREADS, smem, stream>>>(
        q, k, v, static_cast<const float*>(a.o), dout, a.lse, a.dvec, static_cast<float*>(a.dq),
        dm, vec);
  } else {
    if ((err = prepare(flash_bwd_dkdv_tiled_kernel<J>, smem)) != cudaSuccess) return err;
    flash_bwd_dkdv_tiled_kernel<J><<<grid, K::THREADS, smem, stream>>>(
        q, k, v, dout, a.lse, a.dvec, static_cast<float*>(a.dk), static_cast<float*>(a.dv), dm,
        vec);
  }
  return cudaGetLastError();
}

}  // namespace tl

}  // namespace

extern "C" {

// The fma route.  which: 0 = stats, 1 = dK/dV, 2 = dQ; dtype 0 = float32,
// 1 = bfloat16, 2 = float16.
// q, o, dout, dq (b, sq, hq, d) and k, v, dk, dv (b, sk, hkv, d) contiguous;
// lse, dvec float32 (b, hq, sq).  1 <= d <= 256, on the least padded width
// of 16, 32, 64, 128, 256 that holds it; hq a multiple of hkv,
// causal_offset >= 0.  The grid must be the kernel's: (ceil(sq / R), hq, b)
// for stats and dQ, (ceil(sk / R), hkv, b) for dK/dV, R the tiles' rows
// (64, or 32 at width 256); `smem` its dynamic shared memory.
int gqa_flash_bwd(int which, int dtype, const void* q, const void* k, const void* v,
                  const void* o, const void* dout, float* lse, float* dvec, void* dq, void* dk,
                  void* dv, int b, int sq, int sk, int hq, int hkv, int d, int causal_offset,
                  int grid_x, int grid_y, int grid_z, long long smem, void* stream) {
  if (b < 1 || sq < 1 || sk < 1 || hkv < 1 || hq % hkv != 0 || causal_offset < 0 ||
      b > 65535 || hq > 65535 || dtype < 0 || dtype > 2 || which < 0 || which > 2 || d < 1 ||
      d > 256)
    return static_cast<int>(cudaErrorInvalidValue);
  const int rows = padded_dim(d) > 128 ? tile_rows<256>() : tile_rows<128>();
  const int tiles = which == DKDV ? (sk + rows - 1) / rows : (sq + rows - 1) / rows;
  if (grid_x != tiles || grid_y != (which == DKDV ? hkv : hq) || grid_z != b)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, o, dout, lse, dvec, dq, dk, dv};
  const Dims dm{sq, sk, hq, hq / hkv, causal_offset, d, 1.0f / sqrtf(static_cast<float>(d))};
  const dim3 grid(grid_x, grid_y, grid_z);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t sm = static_cast<size_t>(smem);
  return static_cast<int>(dtype == 0   ? dispatch<float>(which, d, a, dm, grid, sm, s)
                          : dtype == 1 ? dispatch<__nv_bfloat16>(which, d, a, dm, grid, sm, s)
                                       : dispatch<__half>(which, d, a, dm, grid, sm, s));
}

// which: 0 = dQ (and D_i), 1 = dK/dV, launched in that order; dtype 1 =
// bfloat16, 2 = float16.  o, dq (b, sq, hq, d) and dk, dv (b, sk, hkv, d)
// contiguous; lse, the forward's (b, hq, sq), and dvec (b, hq, sq) float32:
// the dQ kernel writes D_i there, the dK/dV kernel reads it.  q, k, v and
// dout are what the tensor maps read: the inputs, or at a d off a multiple
// of 8 views of copies with rows ceil(d / 8) * 8 wide (TMA's byte strides
// are multiples of 16); dout's rows are ceil(d / 8) * 8 wide in any case
// (the D_i pass reads it so, beside o).  1 <= d <= 256: given group_kv > 0
// a multiple of 8 in (32, 128] on the head-dim kernels (wg::by_width: the
// products ceil(d / 16) * 16 wide, the L2 order with group_kv KV heads a
// group), else bf16 at d 64, 112 and 128 on instantiations of their own (d
// = 112 on the d = 128 tiles: the head-dim kernels' yardstick there) and
// every other d on the tiles 16, 32, 64, 128, 192 or 256 wide
// (hopper::tile_of(d)) with the head dim taken at run time; hq a multiple
// of hkv, causal_offset >= 0.  `maps` holds, for q, k, v and dout in turn,
// eleven numbers (gqa_flash_wgmma's, with box (w, 1, R, 1): w 16, 32 or 64,
// R 64 up to d 128, else 32).  The grid must be the kernel's: (hq, b, ceil(sq / 128)) for
// dQ, (hkv, b, ceil(sk / 64)) for dK/dV, or in the L2 order (b * hq * ceil(sq
// / 128), 1, 1) and (b * hkv * ceil(sk / 64), 1, 1); `smem` its dynamic
// shared memory.
int gqa_flash_bwd_wgmma(int which, int dtype, const void* q, const void* k, const void* v,
                        const void* o, const void* dout, const float* lse, float* dvec,
                        void* dq, void* dk, void* dv, int b, int sq, int sk, int hq, int hkv,
                        int d, int causal_offset, int group_kv, const unsigned long long* maps,
                        int grid_x, int grid_y, int grid_z, long long smem, void* stream) {
  // the L2 order: the head-dim kernels
  const bool ordered = group_kv > 0;
  const bool widths = d % 8 == 0 && d > 32 && d <= 128;
  const bool wide = d > 128;      // the wide kernels, at every run-time head dim past 128
  if (b < 1 || sq < 1 || sk < 1 || hkv < 1 || hq % hkv != 0 || causal_offset < 0 ||
      b > 65535 || hq > 65535 || (which != wg::DQ && which != wg::DKDV) ||
      (dtype != 1 && dtype != 2) || d < 1 || d > 256)
    return static_cast<int>(cudaErrorInvalidValue);
  if (group_kv < 0 || (ordered && !widths && !wide))
    return static_cast<int>(cudaErrorInvalidValue);
  const int rows = which == wg::DQ ? wg::DQ_ROWS : wg::KV_KEYS;
  const long long tiles = ((which == wg::DQ ? sq : sk) + static_cast<long long>(rows) - 1) / rows;
  const long long heads = which == wg::DQ ? hq : hkv;
  if (ordered ? grid_x != b * heads * tiles || grid_y != 1 || grid_z != 1
              : grid_x != heads || grid_y != b || grid_z != tiles || tiles > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const void* ptrs[4] = {q, k, v, dout};
  CUtensorMap tm[4];
  const int err = hopper::encode_maps(tm, ptrs, 4, maps, d,
                                      d > 128 ? wg::WIDE_BOX_ROWS : wg::BOX_ROWS, dtype == 2);
  if (err != 0) return err;
  const wg::Args a{o, dout, lse, dvec, dq, dk, dv};
  const dim3 grid(grid_x, grid_y, grid_z);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t sm = static_cast<size_t>(smem);
  if (ordered && wide) {
    if (dtype == 2)
      return d % 8 != 0 ? wg::by_wide<-1, __half>(which, tm, a, sq, sk, hq, hkv, d,
                                                 causal_offset, grid, sm, s, group_kv)
                        : wg::by_wide<0, __half>(which, tm, a, sq, sk, hq, hkv, d,
                                                causal_offset, grid, sm, s, group_kv);
    return d % 8 != 0 ? wg::by_wide<-1, __nv_bfloat16>(which, tm, a, sq, sk, hq, hkv, d,
                                                      causal_offset, grid, sm, s, group_kv)
                      : wg::by_wide<0, __nv_bfloat16>(which, tm, a, sq, sk, hq, hkv, d,
                                                     causal_offset, grid, sm, s, group_kv);
  }
  if (ordered)
    return dtype == 2 ? wg::by_width<__half>(which, tm, a, sq, sk, hq, hkv, d, causal_offset,
                                             grid, sm, s, group_kv)
                      : wg::by_width<__nv_bfloat16>(which, tm, a, sq, sk, hq, hkv, d,
                                                    causal_offset, grid, sm, s, group_kv);
  if (dtype == 2)
    return d % 8 != 0 ? wg::by_tile<-1, __half>(which, tm, a, sq, sk, hq, hkv, d,
                                               causal_offset, grid, sm, s)
                      : wg::by_tile<0, __half>(which, tm, a, sq, sk, hq, hkv, d,
                                              causal_offset, grid, sm, s);
  switch (d) {
    case 64:
      return static_cast<int>(wg::launch<64>(which, tm, a, sq, sk, hq, hkv, d, causal_offset,
                                             grid, sm, s));
    case 112:
      return static_cast<int>(wg::launch<128, 112>(which, tm, a, sq, sk, hq, hkv, d,
                                                   causal_offset, grid, sm, s));
    case 128:
      return static_cast<int>(wg::launch<128>(which, tm, a, sq, sk, hq, hkv, d, causal_offset,
                                              grid, sm, s));
  }
  return d % 8 != 0 ? wg::by_tile<-1, __nv_bfloat16>(which, tm, a, sq, sk, hq, hkv, d,
                                                    causal_offset, grid, sm, s)
                    : wg::by_tile<0, __nv_bfloat16>(which, tm, a, sq, sk, hq, hkv, d,
                                                   causal_offset, grid, sm, s);
}

// The "mma" route.  which: 0 = dQ (and D_i), 1 = dK/dV, launched in that
// order; dtype 1 = bfloat16, 2 = float16.  q, o, dout, dq (b, sq, hq, d) and
// k, v, dk, dv (b, sk, hkv, d) contiguous; lse, the forward's (b, hq, sq)
// (either forward's), and dvec (b, hq, sq) float32: the dQ kernel writes
// D_i there, the dK/dV kernel reads it.  1 <= d <= 32, on padded width 16 or
// 32; hq a multiple of hkv, causal_offset >= 0.  The grid must be the
// kernel's: (ceil(sq / 64), hq, b) for dQ, (ceil(sk / 64), hkv, b) for
// dK/dV; `smem` its dynamic shared memory.  Tiles come by 16-byte cp.async
// where d is a multiple of 8 and the starts 16-byte aligned, else element by
// element.
int gqa_flash_bwd_mma(int which, int dtype, const void* q, const void* k, const void* v,
                      const void* o, const void* dout, const float* lse, float* dvec, void* dq,
                      void* dk, void* dv, int b, int sq, int sk, int hq, int hkv, int d,
                      int causal_offset, int grid_x, int grid_y, int grid_z, long long smem,
                      void* stream) {
  if (b < 1 || sq < 1 || sk < 1 || hkv < 1 || hq % hkv != 0 || causal_offset < 0 ||
      b > 65535 || hq > 65535 || (which != mm::DQ && which != mm::DKDV) ||
      (dtype != 1 && dtype != 2) || d < 1 || d > 32)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = which == mm::DQ ? (sq + mm::ROWS - 1) / mm::ROWS
                                    : (sk + mm::KEYS - 1) / mm::KEYS;
  if (grid_x != tiles || grid_y != (which == mm::DQ ? hq : hkv) || grid_z != b)
    return static_cast<int>(cudaErrorInvalidValue);
  bool vec = d % 8 == 0;
  for (const void* ptr : {q, k, v, dout}) vec = vec && reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
  const Args a{q, k, v, o, dout, const_cast<float*>(lse), dvec, dq, dk, dv};
  const Dims dm{sq, sk, hq, hq / hkv, causal_offset, d, 1.0f / sqrtf(static_cast<float>(d))};
  const dim3 grid(grid_x, grid_y, grid_z);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t sm = static_cast<size_t>(smem);
  if (dtype == 2)
    return static_cast<int>(d <= 16 ? mm::launch<__half, 16>(which, a, dm, vec, grid, sm, s)
                                    : mm::launch<__half, 32>(which, a, dm, vec, grid, sm, s));
  return static_cast<int>(d <= 16 ? mm::launch<__nv_bfloat16, 16>(which, a, dm, vec, grid, sm, s)
                                  : mm::launch<__nv_bfloat16, 32>(which, a, dm, vec, grid, sm, s));
}

// The "tiled" route (fp32).  which: 0 = dQ (and D_i), 1 = dK/dV, launched in
// that order; dtype must be 0 (float32).  q, o, dout, dq (b, sq, hq, d) and
// k, v, dk, dv (b, sk, hkv, d) contiguous; lse, the forward's (b, hq, sq)
// (flash_tiled_kernel's), and dvec (b, hq, sq) float32: the dQ kernel
// writes D_i there, the dK/dV kernel reads it.  1 <= d <= 256, on J =
// ceil(d / 16) accumulator slots; hq a multiple of hkv, causal_offset >= 0.
// The grid must be the kernel's: (hq, b, ceil(sq / R)) for dQ, R its query
// rows a block, (hkv, b, ceil(sk / K)) for dK/dV, K its keys a block;
// `smem` its dynamic shared memory.  Tiles come by 16-byte cp.async where d
// is a multiple of 4 and the starts 16-byte aligned, else by 4-byte
// cp.async.
int gqa_flash_bwd_tiled(int which, int dtype, const void* q, const void* k, const void* v,
                        const void* o, const void* dout, const float* lse, float* dvec,
                        void* dq, void* dk, void* dv, int b, int sq, int sk, int hq, int hkv,
                        int d, int causal_offset, int grid_x, int grid_y, int grid_z,
                        long long smem, void* stream) {
  if (b < 1 || sq < 1 || sk < 1 || hkv < 1 || hq % hkv != 0 || causal_offset < 0 ||
      b > 65535 || hq > 65535 || (which != tl::DQ && which != tl::DKDV) || dtype != 0 ||
      d < 1 || d > 256 || grid_x != (which == tl::DQ ? hq : hkv) || grid_y != b ||
      grid_z < 1 || grid_z > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  bool vec = d % 4 == 0;
  for (const void* ptr : {q, k, v, dout}) vec = vec && reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
  const Args a{q, k, v, o, dout, const_cast<float*>(lse), dvec, dq, dk, dv};
  const Dims dm{sq, sk, hq, hq / hkv, causal_offset, d, 1.0f / sqrtf(static_cast<float>(d))};
  const dim3 grid(grid_x, grid_y, grid_z);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t sm = static_cast<size_t>(smem);
  return static_cast<int>(tiled::with_slots(tiled::slots(d), [&](auto j) {
    return tl::launch<decltype(j)::value>(which, a, dm, vec, grid, sm, s);
  }));
}

}  // extern "C"
