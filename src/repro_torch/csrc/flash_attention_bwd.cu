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
// (kernels/flash_attention.py::bwd_route):
//
// "wgmma" (bf16 and fp16 at D a multiple of 8 in (32, 128], where the
// forward's route is the Hopper kernel; every model config that trains in
// bf16), namespace wg.  The forward's flash_wgmma_kernel writes each row's
// LSE, so P = exp(S * scale - LSE) needs no statistics pass.  Two kernels,
// each a TMA producer warpgroup (one thread issuing 4-D tensor-map loads
// with 128-byte swizzle, boxes of 64 rows x 64 bf16) and two wgmma consumer
// warpgroups, launched in this order:
//   flash_bwd_dq_wgmma_kernel: one block per (128 query rows, query head,
//     batch), heaviest tiles first.  It first takes D_i of its rows from
//     device memory (written to fp32 scratch for the next kernel); then per
//     ring stage of 64 keys S = Q K^T and dP = dO V^T (m64n64k16, both
//     operands in shared memory), P and dS = P (dP - D_i) in registers, dS
//     rounded to bf16 as wgmma's register-A operand, dQ += dS K (K read
//     MN-major); dQ * scale stored once in bf16.
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
// D = 112 runs the D = 128 kernels: TMA fills columns 112..127 of every tile
// with zeros and 112 columns are stored; every other D of the route runs the
// 64-wide (D <= 64) or 128-wide kernels the same way with D taken at run time
// (instantiations <64, 0, T> and <128, 0, T>; fp16 through .f16 wgmma).
// Rows past Sq add nothing: their Q and dO land as zeros and their LSE and
// D_i are taken as 0, so dS and P^T dO vanish there; tiles that cross the
// diagonal or the end of K are masked.
//
// "fma" (fp32 at any D; bf16 and fp16 at every D off the wgmma route; and, on
// request, any shape as the yardstick of the wgmma route): the first design's
// three kernels, on the forward's padded widths DP of 16, 32, 64, 128, 256
// (tile columns past D zero), in this order:
//   flash_bwd_stats_kernel: one block per (query tile, query head, batch):
//     each row's log-sum-exp LSE = m + log(l), streamed over the row's live
//     key tiles with an online max, and D_i; both fp32 into (B, Hq, Sq)
//     scratch (the fp32 and mma.sync forwards emit no LSE).
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
// at internvl2-2b's train shape the route took 55.7 ms on an H100 80GB HBM3
// at 700 W, against SDPA's backward's 1.46 ms.  Rows past Sq and keys past Sk load as zeros and
// are masked; nothing past them is stored.
//
// What bounds it on an H100: at internvl2-2b's training shape (B=4,
// Sq=Sk=2304, Hq=16, Hkv=8, D=128, bf16) the function needs five products,
// 5 * 2*B*Hq*D*(S(S+1)/2) = 217.5 GFLOP: 0.220 ms at the tensor cores' 989
// TFLOP/s, far above its bytes (~0.03 ms).  The wgmma route runs seven
// (dQ: S, dP, dQ; dK/dV: S, dP, dV, dK), 304.5 GFLOP, 0.308 ms: the two
// recomputed products are the price of determinism.  One kernel over key
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

constexpr int THREADS = 384;       // the producer warpgroup, then two consumers
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;   // 40*128 + 232*256 = 168*384
constexpr int BOX_ROWS = 64;       // rows of a TMA box; a dQ consumer's rows
constexpr int DQ_ROWS = 128;       // dQ: query rows per block, 64 per consumer
constexpr int DQ_KEYS = 64;        // dQ: keys per tile
constexpr int KV_KEYS = 64;        // dK/dV: keys per block
constexpr int KV_ROWS = 64;        // dK/dV: query rows per tile
constexpr int STAGES = 4;          // depth of either kernel's ring
constexpr float LOG2E = 1.4426950408889634f;

// A tile of R rows by D columns in shared memory: D / 64 column boxes, each R
// rows of 128 swizzled bytes, filled by boxes of BOX_ROWS rows.
template <int D, int R>
struct Tile {
  static constexpr uint32_t BOX_STRIDE = R * ROW_BYTES;   // from one column box to the next
  static constexpr uint32_t BYTES = (D / BOX) * BOX_STRIDE;
};

// Shared memory of the dQ kernel, from a 1024-byte aligned base: Q and dO
// (128 rows), the K ring and the V ring (64 keys a stage), then the
// mbarriers q_full, kv_full[STAGES], empty[STAGES].
template <int D>
struct DqLayout {
  using Rows = Tile<D, DQ_ROWS>;
  using Keys = Tile<D, DQ_KEYS>;
  static constexpr uint32_t Q = 0;
  static constexpr uint32_t DOUT = Q + Rows::BYTES;
  static constexpr uint32_t K = DOUT + Rows::BYTES;
  static constexpr uint32_t V = K + STAGES * Keys::BYTES;
  static constexpr uint32_t BARS = V + STAGES * Keys::BYTES;
  static constexpr size_t SMEM = 1024 + BARS + 8 * (1 + 2 * STAGES);
};

// Shared memory of the dK/dV kernel: K and V (64 keys), the Q ring and the
// dO ring (64 query rows a stage), each stage's 64 LSEs then 64 D_i, two
// buffers of P^T (64 x 64 fp32), then the mbarriers kv_full,
// q_full[STAGES], empty[STAGES].
template <int D>
struct KvLayout {
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
// per 64 rows and column box, all counted against `bar`.  Rows past S and
// columns past the head dim land as zeros.
template <int D, int R>
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap& map, uint32_t bar,
                                          int h, int r0, int b) {
#pragma unroll
  for (int x = 0; x < D / BOX; ++x)
#pragma unroll
    for (int y = 0; y < R / BOX_ROWS; ++y)
      tma_load(dst + x * Tile<D, R>::BOX_STRIDE + y * BOX_ROWS * ROW_BYTES, map, bar, x * BOX,
               h, r0 + y * BOX_ROWS, b);
}

// acc (64 x 64, fp32) = A B^T over D (issued, not committed): A's 64 rows at
// `a` and B's 64 rows at `b`, both K-major in tiles whose column boxes are
// A_STRIDE and B_STRIDE bytes apart; D/16 steps of 16 columns, each 32 bytes
// into a swizzled row (the qk pattern of the forward).
template <int D, uint32_t A_STRIDE, uint32_t B_STRIDE, typename T>
__device__ __forceinline__ void ss_product(float (&acc)[32], uint32_t a, uint32_t b) {
  wgmma_ss_n64_first<T>(acc, sw128_desc(a, 16, GROUP_BYTES), sw128_desc(b, 16, GROUP_BYTES));
#pragma unroll
  for (int kk = 1; kk < D / 16; ++kk)
    wgmma_ss_n64<T>(acc, sw128_desc(a + (kk / 4) * A_STRIDE + (kk % 4) * 32, 16, GROUP_BYTES),
                    sw128_desc(b + (kk / 4) * B_STRIDE + (kk % 4) * 32, 16, GROUP_BYTES));
}

// acc (64 x D, fp32) += A B (issued, not committed): A 64 x 64 in registers
// (four bf16x2 a slice of 16 along the product), B the 64 rows at `b` of a
// tile whose column boxes are B_STRIDE apart, read MN-major through the
// transpose bit (the pv pattern of the forward).
template <int D, uint32_t B_STRIDE, typename T>
__device__ __forceinline__ void rs_product(float (&acc)[D / 2], const uint32_t (&a)[16],
                                           uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t bd = sw128_desc(b + kk * 16 * ROW_BYTES, B_STRIDE, GROUP_BYTES);
    if constexpr (D == 128)
      wgmma_rs_n128<T>(acc, a + 4 * kk, bd);
    else
      wgmma_rs_n64<T>(acc, a + 4 * kk, bd);
  }
}

// 4 bytes global -> shared, asynchronously; when `in` is false nothing is
// read and the 4 bytes are zero-filled.
__device__ __forceinline__ void cp_async4(uint32_t dst, const float* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(in ? 4 : 0)
               : "memory");
}

// Arrive on `bar` once this thread's earlier cp.async copies have landed
// (the barrier's count already holds this arrival).
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}

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
// 64 keys S = Q K^T and dP = dO V^T from shared memory, P = 2^(S scale_log2
// - LSE log2 e) and dS = P (dP - D_i) in registers, dS rounded to bf16,
// dQ += dS K with K read MN-major.  D is the tiles' width, DO <= D the head
// dim (columns 112..127 of every tile are zeros at DO = 112); DO = 0 takes
// it from `dh` at run time (a multiple of 8 in (D - 64, D]).  T is bf16 or
// fp16.
template <int D, int DO = D, typename T = __nv_bfloat16>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                          const __grid_constant__ CUtensorMap kmap,
                          const __grid_constant__ CUtensorMap vmap,
                          const __grid_constant__ CUtensorMap domap, const T* __restrict__ o,
                          const T* __restrict__ dout, const float* __restrict__ lse,
                          float* __restrict__ dvec, T* __restrict__ dq, int sq, int sk, int hq,
                          int group, int offset, int dh, float scale_log2, float scale) {
  using L = DqLayout<D>;
  extern __shared__ unsigned char bwd_smem[];
  const uint32_t base = (smem_addr(bwd_smem) + 1023) & ~1023u;
  const uint32_t bars = base + L::BARS;
  const uint32_t q_full = bars;
  auto kv_full = [bars](int s) { return bars + 8 * (1 + s); };
  auto empty = [bars](int s) { return bars + 8 * (1 + STAGES + s); };

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * DQ_ROWS;   // heaviest query tiles first
  const int n_tiles = kv_tiles<DQ_ROWS, DQ_KEYS>(q0, sq, sk, offset);
  if (threadIdx.x == 0) init_ring(q_full, 1, bars);
  __syncthreads();

  if (threadIdx.x < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == 0) {
      const int hk = h / group;
      mbar_expect(q_full, 2 * L::Rows::BYTES);
      load_tile<D, DQ_ROWS>(base + L::Q, qmap, q_full, h, q0, b);
      load_tile<D, DQ_ROWS>(base + L::DOUT, domap, q_full, h, q0, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % STAGES;
        mbar_wait(empty(s), ((j / STAGES) & 1) ^ 1);     // round 0 finds every stage free
        mbar_expect(kv_full(s), 2 * L::Keys::BYTES);
        load_tile<D, DQ_KEYS>(base + L::K + s * L::Keys::BYTES, kmap, kv_full(s), hk,
                              j * DQ_KEYS, b);
        load_tile<D, DQ_KEYS>(base + L::V + s * L::Keys::BYTES, vmap, kv_full(s), hk,
                              j * DQ_KEYS, b);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    const int c = threadIdx.x / 128 - 1;             // which 64 rows of the block
    const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const int row0 = q0 + 64 * c + 16 * warp;        // this warp's 16 rows
    const int row = row0 + g;                        // this thread's rows: row, row + 8
    const long long stat = (static_cast<long long>(b) * hq + h) * sq;

    // D_i of the warp's 16 rows: lane l holds columns 4l..4l + 3 of a row (8
    // bytes of o and of dO).  The loads take no branch, so all 16 rows' issue
    // before the sums: rows past Sq re-read the last row, lanes past the head
    // dim its last columns, and both add 0.
    const int dcols = DO > 0 ? DO : dh;
    float di[2] = {0.f, 0.f};
    uint2 ov[16], dov[16];
    const int col = min(4 * lane, dcols - 4);
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
      float sum = fmaf(u0.x, w0.x, fmaf(u0.y, w0.y, fmaf(u1.x, w1.x, u1.y * w1.y)));
      if (row0 + r >= sq || 4 * lane >= dcols) sum = 0.f;
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

    float acc[D / 2];     // dQ
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    const uint32_t qa = base + L::Q + c * BOX_ROWS * ROW_BYTES;
    const uint32_t da = base + L::DOUT + c * BOX_ROWS * ROW_BYTES;
    const long long first = static_cast<long long>(offset) + q0 + 64 * c;   // first row's position
    const long long qpos = static_cast<long long>(offset) + row;
    mbar_wait(q_full, 0);
    for (int j = 0; j < n_tiles; ++j) {
      const int st = j % STAGES;
      const int k0 = j * DQ_KEYS;
      mbar_wait(kv_full(st), (j / STAGES) & 1);
      if (k0 > first + 63) {          // no row of this consumer sees a key of the tile
        mbar_arrive(empty(st));
        continue;
      }
      const uint32_t kt = base + L::K + st * L::Keys::BYTES;
      float s[32], dp[32];
      wgmma_fence();
      ss_product<D, L::Rows::BOX_STRIDE, L::Keys::BOX_STRIDE, T>(s, qa, kt);
      ss_product<D, L::Rows::BOX_STRIDE, L::Keys::BOX_STRIDE, T>(
          dp, da, base + L::V + st * L::Keys::BYTES);
      wgmma_commit();
      wgmma_wait<0>();
      pin(s);
      pin(dp);
      // Only tiles that cross the diagonal or the end of K are masked.
      const bool masked = !(k0 + DQ_KEYS <= sk && k0 + DQ_KEYS - 1 <= first);
      uint32_t ds[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) {
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
      rs_product<D, L::Keys::BOX_STRIDE, T>(acc, ds, kt);
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
        T* op = dq + ((static_cast<long long>(b) * sq + orow) * hq + h) * dcols + 2 * t;
#pragma unroll
        for (int n = 0; n < D / 8; ++n)     // columns 8n + 2t, +1 < the head dim
          if (8 * n < dcols)
            *reinterpret_cast<uint32_t*>(op + n * 8) =
                pack2<T>(acc[4 * n + 2 * r] * scale, acc[4 * n + 2 * r + 1] * scale);
      }
    }
  }
}

// dK/dV: one block per (64 keys, KV head, batch), the first key tiles (which
// the most rows see) first.  K and V come once by TMA; the ring brings, for
// each query head of the group and each 64-row query tile that sees the
// block's first key, Q and dO by TMA, and its rows' LSE and D_i, which
// producer warp 1 copies with cp.async (rows past Sq as zeros: their Q and
// dO are zeros too, so P^T dO and dS^T = P^T (dP^T - D_i) vanish there).
// The two consumers split the outputs, so each holds one 64 x D accumulator:
// consumer 0 takes S^T = K Q^T, P^T in registers (masked where the tile
// crosses the diagonal), hands P^T in fp32 to consumer 1 through shared
// memory (two buffers, thread to thread in the accumulator layout, named
// barriers 1 + buf (full) and 3 + buf (empty)), and runs dV += P^T dO;
// consumer 1 takes dP^T = V dO^T, dS^T = P^T (dP^T - D_i), and runs dK +=
// dS^T Q; P^T and dS^T enter as bf16 register-A operands, dO and Q are read
// MN-major.  Each dK/dV element has one writer and its sum one order.  D,
// DO (0: `dh` at run time) and T as in the dQ kernel.
template <int D, int DO = D, typename T = __nv_bfloat16>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                            const __grid_constant__ CUtensorMap kmap,
                            const __grid_constant__ CUtensorMap vmap,
                            const __grid_constant__ CUtensorMap domap,
                            const float* __restrict__ lse, const float* __restrict__ dvec,
                            T* __restrict__ dk, T* __restrict__ dv, int sq, int sk, int hq,
                            int group, int offset, int dh, float scale_log2, float scale) {
  using L = KvLayout<D>;
  extern __shared__ unsigned char bwd_smem[];
  const uint32_t base = (smem_addr(bwd_smem) + 1023) & ~1023u;
  unsigned char* const aligned = bwd_smem + (base - smem_addr(bwd_smem));
  const float* const stats = reinterpret_cast<const float*>(aligned + L::STATS);
  float4* const pex = reinterpret_cast<float4*>(aligned + L::P);
  const uint32_t bars = base + L::BARS;
  const uint32_t kv_full = bars;
  auto q_full = [bars](int s) { return bars + 8 * (1 + s); };
  auto empty = [bars](int s) { return bars + 8 * (1 + STAGES + s); };

  const int hk = blockIdx.x, b = blockIdx.y;
  const int k0 = blockIdx.z * KV_KEYS;
  // Query tiles from the one holding the first row that sees key k0
  // (offset + row >= k0): every one of them sees it.
  const long long first_row = max(0LL, static_cast<long long>(k0) - offset);
  const int n_q = (sq + KV_ROWS - 1) / KV_ROWS;
  const int t0 = first_row >= sq ? n_q : static_cast<int>(first_row / KV_ROWS);
  const int per_head = n_q - t0;
  const int n_tiles = group * per_head;
  if (threadIdx.x == 0) init_ring(kv_full, 1 + 32, bars);   // q_full: TMA and warp 1's lanes
  __syncthreads();

  if (threadIdx.x < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == 0) {
      mbar_expect(kv_full, 2 * L::Keys::BYTES);
      load_tile<D, KV_KEYS>(base + L::K, kmap, kv_full, hk, k0, b);
      load_tile<D, KV_KEYS>(base + L::V, vmap, kv_full, hk, k0, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % STAGES;
        const int h = hk * group + j / per_head, r0 = (t0 + j % per_head) * KV_ROWS;
        mbar_wait(empty(s), ((j / STAGES) & 1) ^ 1);
        mbar_expect(q_full(s), 2 * L::Rows::BYTES);
        load_tile<D, KV_ROWS>(base + L::Q + s * L::Rows::BYTES, qmap, q_full(s), h, r0, b);
        load_tile<D, KV_ROWS>(base + L::DOUT + s * L::Rows::BYTES, domap, q_full(s), h, r0, b);
      }
    } else if (threadIdx.x >= 32 && threadIdx.x < 64) {
      const int lane = threadIdx.x - 32;
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % STAGES;
        const int h = hk * group + j / per_head, r0 = (t0 + j % per_head) * KV_ROWS;
        const long long stat = (static_cast<long long>(b) * hq + h) * sq;
        const uint32_t st = smem_addr(stats + s * L::STAT_FLOATS);
        mbar_wait(empty(s), ((j / STAGES) & 1) ^ 1);
        for (int i = lane; i < KV_ROWS; i += 32) {
          const bool in = r0 + i < sq;    // rows past Sq land as zeros
          const long long at = stat + (in ? r0 + i : 0);
          cp_async4(st + 4 * i, lse + at, in);
          cp_async4(st + 4 * (KV_ROWS + i), dvec + at, in);
        }
        cp_async_arrive(q_full(s));  // q_full counts this lane once its copies land
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    const int c = threadIdx.x / 128 - 1;             // 0: P^T and dV; 1: dS^T and dK
    const int tid = threadIdx.x & 127;
    const int warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int key = k0 + 16 * warp + g;              // this thread's keys: key, key + 8

    float acc[D / 2];                                // dV (consumer 0) or dK (consumer 1)
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
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
      ss_product<D, L::Keys::BOX_STRIDE, L::Rows::BOX_STRIDE, T>(s, a_op, c == 0 ? qt : dot);
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
      }
      pin(acc);
      pin(a);
      wgmma_fence();
      rs_product<D, L::Rows::BOX_STRIDE, T>(acc, a, c == 0 ? dot : qt);
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
        T* op = out + ((static_cast<long long>(b) * sk + kr) * hkv + hk) * dcols + 2 * t;
#pragma unroll
        for (int n = 0; n < D / 8; ++n)     // columns 8n + 2t, +1 < the head dim
          if (8 * n < dcols)
            *reinterpret_cast<uint32_t*>(op + n * 8) =
                pack2<T>(acc[4 * n + 2 * r] * mul, acc[4 * n + 2 * r + 1] * mul);
      }
    }
  }
}

enum Kernel { DQ = 0, DKDV = 1 };

template <int D>
size_t smem_bytes(int which) {
  return which == DQ ? DqLayout<D>::SMEM : KvLayout<D>::SMEM;
}

// setmaxnreg only moves registers between the warpgroups: the launch must
// hold what the consumers ask for, or their setmaxnreg would wait.
template <typename Fn>
cudaError_t prepare(Fn kernel, size_t smem) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  if (attr.numRegs * THREADS < PRODUCER_REGS * 128 + CONSUMER_REGS * 256)
    return cudaErrorLaunchOutOfResources;
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
// multiple of 8 in (D - 64, D]), T bf16 or fp16.
template <int D, int DO = D, typename T = __nv_bfloat16>
cudaError_t launch(int which, const CUtensorMap (&maps)[4], const Args& a, int sq, int sk,
                   int hq, int hkv, int dh, int offset, dim3 grid, size_t smem,
                   cudaStream_t stream) {
  static_assert(DO == 0 || (DO <= D && DO % 16 == 0 && D - DO < BOX),
                "DO: the head dim in D's last box");
  if (DO > 0 ? dh != DO : (dh % 8 != 0 || dh > D || D - dh >= BOX))
    return cudaErrorInvalidValue;
  if (smem != smem_bytes<D>(which)) return cudaErrorInvalidValue;
  const float scale = 1.0f / sqrtf(static_cast<float>(dh));
  const float scale_log2 = scale * LOG2E;
  cudaError_t err;
  if (which == DQ) {
    if ((err = prepare(flash_bwd_dq_wgmma_kernel<D, DO, T>, smem)) != cudaSuccess) return err;
    flash_bwd_dq_wgmma_kernel<D, DO, T><<<grid, THREADS, smem, stream>>>(
        maps[0], maps[1], maps[2], maps[3], static_cast<const T*>(a.o),
        static_cast<const T*>(a.dout), a.lse, a.dvec, static_cast<T*>(a.dq), sq, sk, hq,
        hq / hkv, offset, dh, scale_log2, scale);
  } else {
    if ((err = prepare(flash_bwd_dkdv_wgmma_kernel<D, DO, T>, smem)) != cudaSuccess) return err;
    flash_bwd_dkdv_wgmma_kernel<D, DO, T><<<grid, THREADS, smem, stream>>>(
        maps[0], maps[1], maps[2], maps[3], a.lse, a.dvec, static_cast<T*>(a.dk),
        static_cast<T*>(a.dv), sq, sk, hq, hq / hkv, offset, dh, scale_log2, scale);
  }
  return cudaGetLastError();
}

}  // namespace wg

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
// bfloat16, 2 = float16.  q, o, dout, dq (b, sq, hq, d) and k, v, dk, dv
// (b, sk, hkv, d) contiguous; lse, the forward's (b, hq, sq), and dvec (b,
// hq, sq) float32: the dQ kernel writes D_i there, the dK/dV kernel reads
// it.  d a multiple of 8 in (32, 128]: bf16 at d 64, 112 and 128 on
// instantiations of their own (d = 112 on the d = 128 tiles), every other
// d on the 64-wide (d <= 64) or 128-wide tiles with the head dim taken at
// run time; hq a multiple of hkv, causal_offset >= 0.  `maps` holds, for q,
// k, v and dout in turn, eleven numbers (gqa_flash_wgmma's, with box (64,
// 1, 64, 1)).  The grid must be the kernel's: (hq, b, ceil(sq / 128)) for
// dQ, (hkv, b, ceil(sk / 64)) for dK/dV; `smem` its dynamic shared memory.
int gqa_flash_bwd_wgmma(int which, int dtype, const void* q, const void* k, const void* v,
                        const void* o, const void* dout, const float* lse, float* dvec,
                        void* dq, void* dk, void* dv, int b, int sq, int sk, int hq, int hkv,
                        int d, int causal_offset, const unsigned long long* maps, int grid_x,
                        int grid_y, int grid_z, long long smem, void* stream) {
  if (b < 1 || sq < 1 || sk < 1 || hkv < 1 || hq % hkv != 0 || causal_offset < 0 ||
      b > 65535 || hq > 65535 || (which != wg::DQ && which != wg::DKDV) ||
      (dtype != 1 && dtype != 2) || d % 8 != 0 || d <= 32 || d > 128)
    return static_cast<int>(cudaErrorInvalidValue);
  const int rows = which == wg::DQ ? wg::DQ_ROWS : wg::KV_KEYS;
  const int tiles = ((which == wg::DQ ? sq : sk) + rows - 1) / rows;
  if (grid_x != (which == wg::DQ ? hq : hkv) || grid_y != b || grid_z != tiles || tiles > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const void* ptrs[4] = {q, k, v, dout};
  CUtensorMap tm[4];
  const int err = hopper::encode_maps(tm, ptrs, 4, maps, d, wg::BOX_ROWS, dtype == 2);
  if (err != 0) return err;
  const wg::Args a{o, dout, lse, dvec, dq, dk, dv};
  const dim3 grid(grid_x, grid_y, grid_z);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t sm = static_cast<size_t>(smem);
  if (dtype == 2)
    return static_cast<int>(
        d <= 64 ? wg::launch<64, 0, __half>(which, tm, a, sq, sk, hq, hkv, d, causal_offset,
                                            grid, sm, s)
                : wg::launch<128, 0, __half>(which, tm, a, sq, sk, hq, hkv, d, causal_offset,
                                             grid, sm, s));
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
    default:
      return static_cast<int>(
          d <= 64 ? wg::launch<64, 0>(which, tm, a, sq, sk, hq, hkv, d, causal_offset, grid, sm,
                                      s)
                  : wg::launch<128, 0>(which, tm, a, sq, sk, hq, hkv, d, causal_offset, grid,
                                       sm, s));
  }
}

}  // extern "C"
