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
// Outputs are written in the inputs' dtype (float32 or bfloat16).
//
// Three kernels, launched in this order by the wrapper:
//   flash_bwd_stats_kernel: one block per (query tile, query head, batch):
//     each row's log-sum-exp LSE = m + log(l), streamed over the row's live
//     key tiles with an online max, and D_i; both fp32 into (B, Hq, Sq)
//     scratch.  The forward kernels stay as they are (and do not emit the
//     LSE), so the serving path cannot move.
//   flash_bwd_dkdv_kernel: one block per (key tile, KV head, batch).  K and
//     V of its 64 keys stay in shared memory; it loops over the group's
//     query heads and, for each, the query tiles that can see its keys,
//     recomputing P = exp(S * scale - LSE) and dS, and accumulates dV and
//     dK in registers.  Summing the group inside the block is what keeps
//     GQA free of atomics: every output element has one writer, and each
//     sum runs in a fixed order, so two runs give equal bits.
//   flash_bwd_dq_kernel: one block per (query tile, query head, batch),
//     looping over the key tiles its rows can see: dQ += dS K.  Heaviest
//     (last) query tiles first.
// All three use 16 x 16 threads, thread (ty, tx) owning a 4 x 4 block of
// scores (rows ty + 16i, columns tx + 16j) and 4 rows x D/16 columns of its
// accumulators; tiles are 64 x 64, staged in shared memory as fp32 with odd
// row strides, and every product is fp32 FMA on the CUDA cores (bf16 inputs
// are widened on load).  Rows past Sq and keys past Sk load as zeros and
// are masked; nothing past them is stored.
//
// What bounds it on an H100: at internvl2-2b's training shape (B=4,
// Sq=Sk=2304, Hq=16, Hkv=8, D=128, bf16) the backward needs five products
// plus the stats pass's Q K^T, 6 * 2*B*Hq*D*(S(S+1)/2) = 261 GFLOP: 0.26 ms
// at the tensor cores' 989 TFLOP/s, far above its bytes.  These kernels run
// seven products (the dK/dV and dQ kernels each recompute S and dP) on the
// fp32 pipe (67 TFLOP/s peak), reading each operand from shared memory, so
// they sit far from that bound; mma.sync or wgmma with TMA, and the LSE
// taken from the forward, are later work.
//
// Plain C interface (loaded with ctypes); each entry point returns the
// cudaError_t of its launch, 0 on success.  Nothing here allocates or
// synchronises.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int BQ = 64;             // query rows per tile
constexpr int BK = 64;             // keys per tile
constexpr int THREADS = 256;       // 16 x 16: ty = tid / 16, tx = tid % 16
constexpr int PS = BK + 1;         // row stride of the score tiles
constexpr float NEG = -1e30f;

struct Dims {
  int sq, sk, hq, group, offset;
  float scale;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Tiles of BK keys that the query tile starting at row q0 needs: up to the
// last key its last valid row can see.
__device__ __forceinline__ int kv_tiles(int q0, int sq, int sk, int offset) {
  const long long last_row = min(q0 + BQ, sq) - 1;
  const long long visible = min(static_cast<long long>(sk), offset + last_row + 1);
  return static_cast<int>((visible + BK - 1) / BK);
}

// rows [r0, r0 + 64) of one head of a (B, S, H, D) tensor -> fp32 tile with
// row stride D + 1; rows at or past `rows` are zero.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int r0, int rows,
                                          long long row_stride) {
  for (int e = threadIdx.x; e < 64 * D; e += THREADS) {
    const int r = e / D, c = e % D;
    dst[r * (D + 1) + c] = r0 + r < rows ? to_f(src[(r0 + r) * row_stride + c]) : 0.f;
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

template <typename T, int D>
constexpr size_t stats_smem_bytes() {
  return sizeof(float) * static_cast<size_t>(BQ + BK) * (D + 1);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_stats_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ o, const T* __restrict__ dout,
                       float* __restrict__ lse, float* __restrict__ dvec, Dims dm) {
  constexpr int DS = D + 1;
  extern __shared__ float smem[];
  float* qt = smem;                // BQ x DS
  float* kt = qt + BQ * DS;        // BK x DS
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hkv = dm.hq / dm.group;
  const long long q_rs = static_cast<long long>(dm.hq) * D, k_rs = static_cast<long long>(hkv) * D;
  const T* qb = q + static_cast<long long>(b) * dm.sq * q_rs + h * D;
  const T* kb = k + static_cast<long long>(b) * dm.sk * k_rs + (h / dm.group) * D;

  load_tile<T, D>(qt, qb, q0, dm.sq, q_rs);
  float m[4] = {NEG, NEG, NEG, NEG}, l[4] = {0.f, 0.f, 0.f, 0.f};
  const int n_tiles = kv_tiles(q0, dm.sq, dm.sk, dm.offset);
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * BK;
    __syncthreads();               // the last tile is consumed (and Q is staged)
    load_tile<T, D>(kt, kb, k0, dm.sk, k_rs);
    __syncthreads();
    float s[4][4] = {};
#pragma unroll 8
    for (int c = 0; c < D; ++c) {
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
      const long long qpos = static_cast<long long>(dm.offset) + q0 + ty + 16 * i;
      float mx = NEG;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + tx + 16 * j;
        s[i][j] = qpos >= key && key < dm.sk ? s[i][j] * dm.scale : NEG;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], max16(mx));
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) rs += expf(s[i][j] - m_new);
      l[i] = l[i] * expf(m[i] - m_new) + sum16(rs);
      m[i] = m_new;
    }
  }

  // D_i = sum_d dO_i,d O_i,d: lane tx takes columns tx + 16j.
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    float acc = 0.f;
    if (row < dm.sq) {
      const long long base = (static_cast<long long>(b) * dm.sq + row) * q_rs + h * D;
      for (int c = tx; c < D; c += 16) acc = fmaf(to_f(dout[base + c]), to_f(o[base + c]), acc);
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

template <typename T, int D>
constexpr size_t dkdv_smem_bytes() {
  return sizeof(float) * (static_cast<size_t>(BK + BK + BQ + BQ) * (D + 1) + 2 * BK * PS + 2 * BQ);
}

// Thread (ty, tx): keys ty + 16i; query rows tx + 16j of the transposed
// score tiles; dK/dV columns tx + 16j.
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ dvec,
                      T* __restrict__ dk, T* __restrict__ dv, Dims dm) {
  constexpr int DS = D + 1;
  constexpr int DJ = D / 16;
  extern __shared__ float smem[];
  float* kt = smem;                // BK x DS
  float* vt = kt + BK * DS;        // BK x DS
  float* qt = vt + BK * DS;        // BQ x DS
  float* dot = qt + BQ * DS;       // BQ x DS
  float* pt = dot + BQ * DS;       // BK x PS: P^T
  float* dst = pt + BK * PS;       // BK x PS: dS^T
  float* lse_s = dst + BK * PS;    // BQ
  float* dv_s = lse_s + BQ;        // BQ

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int k0 = blockIdx.x * BK, hk = blockIdx.y, b = blockIdx.z;
  const int hkv = dm.hq / dm.group;
  const long long q_rs = static_cast<long long>(dm.hq) * D, k_rs = static_cast<long long>(hkv) * D;
  const long long kv_off = static_cast<long long>(b) * dm.sk * k_rs + hk * D;
  load_tile<T, D>(kt, k + kv_off, k0, dm.sk, k_rs);
  load_tile<T, D>(vt, v + kv_off, k0, dm.sk, k_rs);

  float acc_k[4][DJ], acc_v[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc_k[i][j] = acc_v[i][j] = 0.f;

  // The first row that sees key k0: offset + row >= k0.
  const long long first_row = max(0LL, static_cast<long long>(k0) - dm.offset);
  const int n_q = (dm.sq + BQ - 1) / BQ;
  const int first_tile = first_row >= dm.sq ? n_q : static_cast<int>(first_row / BQ);
  for (int hg = 0; hg < dm.group; ++hg) {
    const int h = hk * dm.group + hg;
    const long long q_off = static_cast<long long>(b) * dm.sq * q_rs + h * D;
    const float* lse_h = lse + (static_cast<long long>(b) * dm.hq + h) * dm.sq;
    const float* dv_h = dvec + (static_cast<long long>(b) * dm.hq + h) * dm.sq;
    for (int qtile = first_tile; qtile < n_q; ++qtile) {
      const int q0 = qtile * BQ;
      __syncthreads();             // the last tile's P^T, dS^T, Q, dO are consumed
      load_tile<T, D>(qt, q + q_off, q0, dm.sq, q_rs);
      load_tile<T, D>(dot, dout + q_off, q0, dm.sq, q_rs);
      if (tid < BQ) {
        const bool in = q0 + tid < dm.sq;
        lse_s[tid] = in ? lse_h[q0 + tid] : 0.f;
        dv_s[tid] = in ? dv_h[q0 + tid] : 0.f;
      }
      __syncthreads();

      // S^T = K Q^T and dP^T = V dO^T, 64 keys x 64 rows.
      float st[4][4] = {}, dpt[4][4] = {};
#pragma unroll 4
      for (int c = 0; c < D; ++c) {
        float ka[4], va[4], qb[4], db[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          ka[i] = kt[(ty + 16 * i) * DS + c];
          va[i] = vt[(ty + 16 * i) * DS + c];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          qb[j] = qt[(tx + 16 * j) * DS + c];
          db[j] = dot[(tx + 16 * j) * DS + c];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            st[i][j] = fmaf(ka[i], qb[j], st[i][j]);
            dpt[i][j] = fmaf(va[i], db[j], dpt[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = k0 + ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = tx + 16 * j;
          const bool live = q0 + r < dm.sq && key < dm.sk &&
                            static_cast<long long>(dm.offset) + q0 + r >= key;
          const float p = live ? expf(st[i][j] * dm.scale - lse_s[r]) : 0.f;
          pt[(ty + 16 * i) * PS + r] = p;
          dst[(ty + 16 * i) * PS + r] = p * (dpt[i][j] - dv_s[r]);
        }
      }
      __syncthreads();

      // dV += P^T dO, dK += dS^T Q.
#pragma unroll 4
      for (int r = 0; r < BQ; ++r) {
        float pa[4], sa[4], dob[DJ], qv[DJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pa[i] = pt[(ty + 16 * i) * PS + r];
          sa[i] = dst[(ty + 16 * i) * PS + r];
        }
#pragma unroll
        for (int j = 0; j < DJ; ++j) {
          dob[j] = dot[r * DS + tx + 16 * j];
          qv[j] = qt[r * DS + tx + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < DJ; ++j) {
            acc_v[i][j] = fmaf(pa[i], dob[j], acc_v[i][j]);
            acc_k[i][j] = fmaf(sa[i], qv[j], acc_k[i][j]);
          }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty + 16 * i;
    if (key < dm.sk) {
      const long long base = kv_off + key * k_rs;
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        dk[base + tx + 16 * j] = from_f<T>(acc_k[i][j] * dm.scale);
        dv[base + tx + 16 * j] = from_f<T>(acc_v[i][j]);
      }
    }
  }
}

// --- (c) dQ ------------------------------------------------------------------

template <typename T, int D>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) * (static_cast<size_t>(BQ + BQ + BK + BK) * (D + 1) + BQ * PS);
}

// Thread (ty, tx): rows ty + 16i; keys tx + 16j; dQ columns tx + 16j.
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ dvec, T* __restrict__ dq, Dims dm) {
  constexpr int DS = D + 1;
  constexpr int DJ = D / 16;
  extern __shared__ float smem[];
  float* qt = smem;                // BQ x DS
  float* dot = qt + BQ * DS;       // BQ x DS
  float* kt = dot + BQ * DS;       // BK x DS
  float* vt = kt + BK * DS;        // BK x DS
  float* ds = vt + BK * DS;        // BQ x PS

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hkv = dm.hq / dm.group;
  const long long q_rs = static_cast<long long>(dm.hq) * D, k_rs = static_cast<long long>(hkv) * D;
  const long long q_off = static_cast<long long>(b) * dm.sq * q_rs + h * D;
  const long long kv_off = static_cast<long long>(b) * dm.sk * k_rs + (h / dm.group) * D;
  load_tile<T, D>(qt, q + q_off, q0, dm.sq, q_rs);
  load_tile<T, D>(dot, dout + q_off, q0, dm.sq, q_rs);
  float lse_r[4], dv_r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    const long long at = (static_cast<long long>(b) * dm.hq + h) * dm.sq + row;
    lse_r[i] = row < dm.sq ? lse[at] : 0.f;
    dv_r[i] = row < dm.sq ? dvec[at] : 0.f;
  }

  float acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;

  const int n_tiles = kv_tiles(q0, dm.sq, dm.sk, dm.offset);
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * BK;
    __syncthreads();               // the last tile's K and dS are consumed (Q, dO staged)
    load_tile<T, D>(kt, k + kv_off, k0, dm.sk, k_rs);
    load_tile<T, D>(vt, v + kv_off, k0, dm.sk, k_rs);
    __syncthreads();

    float s[4][4] = {}, dp[4][4] = {};
#pragma unroll 4
    for (int c = 0; c < D; ++c) {
      float qa[4], da[4], kb[4], vb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qa[i] = qt[(ty + 16 * i) * DS + c];
        da[i] = dot[(ty + 16 * i) * DS + c];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kb[j] = kt[(tx + 16 * j) * DS + c];
        vb[j] = vt[(tx + 16 * j) * DS + c];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
          dp[i][j] = fmaf(da[i], vb[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
      const long long qpos = static_cast<long long>(dm.offset) + row;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + tx + 16 * j;
        const bool live = row < dm.sq && key < dm.sk && qpos >= key;
        const float p = live ? expf(s[i][j] * dm.scale - lse_r[i]) : 0.f;
        ds[(ty + 16 * i) * PS + tx + 16 * j] = p * (dp[i][j] - dv_r[i]);
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float sa[4], kv[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) sa[i] = ds[(ty + 16 * i) * PS + kk];
#pragma unroll
      for (int j = 0; j < DJ; ++j) kv[j] = kt[kk * DS + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(sa[i], kv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row < dm.sq) {
      const long long base = q_off + row * q_rs;
#pragma unroll
      for (int j = 0; j < DJ; ++j) dq[base + tx + 16 * j] = from_f<T>(acc[i][j] * dm.scale);
    }
  }
}

// --- launches ----------------------------------------------------------------

enum Kernel { STATS = 0, DKDV = 1, DQ = 2 };

template <typename T, int D>
size_t smem_bytes(int which) {
  return which == STATS ? stats_smem_bytes<T, D>()
         : which == DKDV ? dkdv_smem_bytes<T, D>()
                         : dq_smem_bytes<T, D>();
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

template <typename T, int D>
cudaError_t launch(int which, const Args& a, Dims dm, dim3 grid, size_t smem,
                   cudaStream_t stream) {
  if (smem != smem_bytes<T, D>(which)) return cudaErrorInvalidValue;
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  cudaError_t err;
  if (which == STATS) {
    if ((err = prepare(flash_bwd_stats_kernel<T, D>, smem)) != cudaSuccess) return err;
    flash_bwd_stats_kernel<T, D><<<grid, THREADS, smem, stream>>>(
        q, k, static_cast<const T*>(a.o), dout, a.lse, a.dvec, dm);
  } else if (which == DKDV) {
    if ((err = prepare(flash_bwd_dkdv_kernel<T, D>, smem)) != cudaSuccess) return err;
    flash_bwd_dkdv_kernel<T, D><<<grid, THREADS, smem, stream>>>(
        q, k, v, dout, a.lse, a.dvec, static_cast<T*>(a.dk), static_cast<T*>(a.dv), dm);
  } else {
    if ((err = prepare(flash_bwd_dq_kernel<T, D>, smem)) != cudaSuccess) return err;
    flash_bwd_dq_kernel<T, D><<<grid, THREADS, smem, stream>>>(
        q, k, v, dout, a.lse, a.dvec, static_cast<T*>(a.dq), dm);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int which, int d, const Args& a, Dims dm, dim3 grid, size_t smem,
                     cudaStream_t stream) {
  switch (d) {
    case 32: return launch<T, 32>(which, a, dm, grid, smem, stream);
    case 64: return launch<T, 64>(which, a, dm, grid, smem, stream);
    case 112: return launch<T, 112>(which, a, dm, grid, smem, stream);
    case 128: return launch<T, 128>(which, a, dm, grid, smem, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// which: 0 = stats, 1 = dK/dV, 2 = dQ; dtype 0 = float32, 1 = bfloat16.
// q, o, dout, dq (b, sq, hq, d) and k, v, dk, dv (b, sk, hkv, d) contiguous;
// lse, dvec float32 (b, hq, sq).  d in {32, 64, 112, 128}, hq a multiple of
// hkv, causal_offset >= 0.  The grid must be the kernel's: (ceil(sq / 64),
// hq, b) for stats and dQ, (ceil(sk / 64), hkv, b) for dK/dV; `smem` its
// dynamic shared memory.
int gqa_flash_bwd(int which, int dtype, const void* q, const void* k, const void* v,
                  const void* o, const void* dout, float* lse, float* dvec, void* dq, void* dk,
                  void* dv, int b, int sq, int sk, int hq, int hkv, int d, int causal_offset,
                  int grid_x, int grid_y, int grid_z, long long smem, void* stream) {
  if (b < 1 || sq < 1 || sk < 1 || hkv < 1 || hq % hkv != 0 || causal_offset < 0 ||
      b > 65535 || hq > 65535 || (dtype != 0 && dtype != 1) || which < 0 || which > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = which == DKDV ? (sk + BK - 1) / BK : (sq + BQ - 1) / BQ;
  if (grid_x != tiles || grid_y != (which == DKDV ? hkv : hq) || grid_z != b)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, o, dout, lse, dvec, dq, dk, dv};
  const Dims dm{sq, sk, hq, hq / hkv, causal_offset, 1.0f / sqrtf(static_cast<float>(d))};
  const dim3 grid(grid_x, grid_y, grid_z);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t sm = static_cast<size_t>(smem);
  return static_cast<int>(dtype == 0 ? dispatch<float>(which, d, a, dm, grid, sm, s)
                                     : dispatch<__nv_bfloat16>(which, d, a, dm, grid, sm, s));
}

}  // extern "C"
