// Hand-written Hopper kernels for causal GQA attention with an online
// softmax (flash attention, forward only), the attention of the LM prefill.
//
// Replaces the TPU kernel of src/repro/kernels/flash_attention.py:
//   gqa_flash_fwd, gqa_flash_wgmma  <- _flash_kernel  (pallas_call at
//       flash_attention.py:94, called via gqa_flash, from models/common.py
//       attention when attention_backend="pallas")
//
// Semantics, as the TPU kernel and kernels/ref.py::flash_attention_ref:
// q (B, Sq, Hq, D), k/v (B, Sk, Hkv, D), query head h reads KV head
// h / (Hq / Hkv); scores q.k / sqrt(D) in fp32, masked unless
// causal_offset + q_row >= k_row (and k_row < Sk); softmax over the keys;
// out = acc / max(l, 1e-30) in the input dtype.
//
// The TPU kernel transposed q/k/v to (B, H, S, D), padded S to its 128-row
// blocks and carried (m, l, acc) in scratch across a sequential KV grid
// axis.  Here each block owns a tile of query rows of one head and loops
// over the key tiles itself, (m, l, acc) in registers, reading q/k/v in the
// model's (B, S, H, D) layout through their strides.  The loop stops after
// the last tile any row of the block can see: the tiles it skips would
// contribute exactly 0.  Three kernels, routed by dtype and D alone (the
// wrapper, kernels/flash_attention.py, picks one):
//
//   flash_wgmma_kernel (bf16, D in {64, 112, 128}; every model config): the
//     Hopper design.  One block owns 128 query rows of one head and runs
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
//     1.14x the work the function needs.
//   flash_bf16_kernel (bf16, D in {16, 32}: the small trainers of
//     repro_torch.examples.train_carbon_aware, head dim 16 at its tiny preset
//     and 32 at 10m): 4 warps, each owning 16 of 64 query rows, mma.sync
//     m16n8k16; K and V tiles of 64 keys stream into two shared-memory
//     buffers with cp.async, the next tile loading while the block computes
//     on the current one; ldmatrix reads K's fragments and, transposing, V's.
//     Its loops step over D in slices of 16 (Q K^T's k-steps, P V's column
//     pairs), so D = 16 is one slice of each; the tile rows of D + 8 = 24
//     elements (48 bytes) keep each 8 x 8 matrix's rows 16-byte aligned and
//     in distinct banks.  It takes D in {64, 128} as well (and D = 112), for
//     comparison with the Hopper kernel.
//   flash_f32_kernel (fp32): 16x16 threads, each owning a 4x4 block of
//     scores and 4 rows x D/16 columns of the output, fp32 FMA on the CUDA
//     cores (no TF32, so the result stays within 2e-5 of the fp32
//     reference).
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
// series, and only the other consumer's products fill the gap.  Issuing
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

// --- bf16: mma.sync on the tensor cores --------------------------------------

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// 16 bytes global -> shared without passing through registers; when `in`
// is false nothing is read and the 16 bytes are zero-filled.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8x8 bf16 matrices from shared memory, lanes 8i..8i+7 giving the row
// addresses of matrix i; plain: lane 4g + t gets row g, columns 2t, 2t + 1
// of each; .trans: rows 2t, 2t + 1 of column g.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

template <int D>
constexpr size_t bf16_smem_bytes() {         // K and V, two buffers each
  return sizeof(__nv_bfloat16) * 4 * BK * (D + 8);
}

// Fragment layout of m16n8k16 (lane = 4 * g + t): A holds rows g and g + 8,
// columns 2t, 2t + 1 and 2t + 8, 2t + 9; B holds k rows 2t, 2t + 1 and
// 2t + 8, 2t + 9 of column g; C holds rows g (c0, c1) and g + 8 (c2, c3),
// columns 2t, 2t + 1.  K and V tiles are both stored row-major (key, d):
// plain ldmatrix gives K's B fragments for S = Q K^T, .trans gives V's for
// O = P V.  Tile rows are padded to D + 8 elements, so the eight 16-byte
// rows of each 8x8 matrix fall in distinct banks.
template <int D>
__global__ void __launch_bounds__(128)
flash_bf16_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                  int sq, int sk, int hq, int group, int offset, Strides qs, Strides ks,
                  Strides vs, float scale) {
  constexpr int KS = D + 8;        // row stride of every tile, in elements
  constexpr int VEC = 8;           // bf16 per 16-byte copy
  constexpr int DV = D / VEC;
  extern __shared__ __align__(16) unsigned char flash_smem[];
  __nv_bfloat16* kbuf = reinterpret_cast<__nv_bfloat16*>(flash_smem);  // 2 x BK x KS
  __nv_bfloat16* vbuf = kbuf + 2 * BK * KS;                            // 2 x BK x KS

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const __nv_bfloat16* qb = q + b * qs.b + h * qs.h;
  const __nv_bfloat16* kb = k + b * ks.b + (h / group) * ks.h;
  const __nv_bfloat16* vb = v + b * vs.b + (h / group) * vs.h;

  // Q tile -> shared memory (rows past Sq are zero) -> A fragments.
  for (int e = tid; e < BQ * DV; e += blockDim.x) {
    const int r = e / DV, c = (e % DV) * VEC;
    const bool in = q0 + r < sq;
    cp_async16(kbuf + r * KS + c, qb + (in ? q0 + r : 0) * qs.s + c, in);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  uint32_t qa[D / 16][4];
  {
    const __nv_bfloat16* base = kbuf + (warp * 16 + g) * KS + 2 * t;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      qa[kk][0] = ld32(base + kk * 16);
      qa[kk][1] = ld32(base + 8 * KS + kk * 16);
      qa[kk][2] = ld32(base + kk * 16 + 8);
      qa[kk][3] = ld32(base + 8 * KS + kk * 16 + 8);
    }
  }
  __syncthreads();                 // Q is in registers; its buffer is free

  // Rows [64 tile, 64 tile + 64) of K and V into buffer `buf`, zero past Sk.
  auto load_tile = [&](int tile, int buf) {
    const int k0 = tile * BK;
    __nv_bfloat16* kd = kbuf + buf * BK * KS;
    __nv_bfloat16* vd = vbuf + buf * BK * KS;
    for (int e = tid; e < BK * DV; e += blockDim.x) {
      const int r = e / DV, c = (e % DV) * VEC;
      const bool in = k0 + r < sk;
      const long long row = in ? k0 + r : 0;
      cp_async16(kd + r * KS + c, kb + row * ks.s + c, in);
      cp_async16(vd + r * KS + c, vb + row * vs.s + c, in);
    }
    cp_async_commit();
  };

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
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
    const __nv_bfloat16* kt = kbuf + buf * BK * KS;
    const __nv_bfloat16* vt = vbuf + buf * BK * KS;

    // S = Q K^T for this warp's 16 rows x 64 keys.
    float s[BK / 8][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int np = 0; np < BK / 16; ++np) {
        uint32_t kf[4];
        ldmatrix_x4(kf, kt + (np * 16 + k_row) * KS + kk * 16 + k_col);
        mma_bf16(s[2 * np], qa[kk], kf[0], kf[1]);
        mma_bf16(s[2 * np + 1], qa[kk], kf[2], kf[3]);
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
    for (int n = 0; n < D / 8; ++n) {
      acc[n][0] *= corr[0];
      acc[n][1] *= corr[0];
      acc[n][2] *= corr[1];
      acc[n][3] *= corr[1];
    }

    // O += P V: two adjacent C fragments of S are one A fragment of P.
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, vt + (kk * 16 + v_row) * KS + dp * 16 + v_col);
        mma_bf16(acc[2 * dp], pa, vf[0], vf[1]);
        mma_bf16(acc[2 * dp + 1], pa, vf[2], vf[3]);
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
      __nv_bfloat16* op = o + ((static_cast<long long>(b) * sq + orow) * hq + h) * D + 2 * t;
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        *reinterpret_cast<__nv_bfloat162*>(op + n * 8) =
            __floats2bfloat162_rn(acc[n][2 * r] / den, acc[n][2 * r + 1] / den);
    }
  }
}

// --- fp32: FMA on the CUDA cores ---------------------------------------------

constexpr int F32_THREADS = 256;  // 16 x 16: ty = tid / 16, tx = tid % 16

template <int D>
constexpr size_t f32_smem_bytes() {
  return sizeof(float) * (static_cast<size_t>(BQ + 2 * BK) * (D + 1) + BQ * (BK + 1));
}

// Thread (ty, tx) owns score rows ty + 16i and keys tx + 16j (i, j < 4), and
// output rows ty + 16i, columns tx + 16j (j < D/16).  Tiles are stored with
// odd row strides, so the column reads of 16 lanes hit 16 distinct banks.
template <int D>
__global__ void __launch_bounds__(F32_THREADS)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int sq, int sk,
                 int hq, int group, int offset, Strides qs, Strides ks, Strides vs,
                 float scale) {
  constexpr int DS = D + 1;
  constexpr int PS = BK + 1;
  constexpr int DJ = D / 16;
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

  for (int e = tid; e < BQ * D; e += F32_THREADS) {
    const int r = e / D, c = e % D;
    qt[r * DS + c] = q0 + r < sq ? qb[(q0 + r) * qs.s + c] : 0.f;
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
    for (int e = tid; e < BK * D; e += F32_THREADS) {
      const int r = e / D, c = e % D;
      const bool in = k0 + r < sk;
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
      float* op = o + ((static_cast<long long>(b) * sq + orow) * hq + h) * D;
#pragma unroll
      for (int j = 0; j < DJ; ++j) op[tx + 16 * j] = acc[i][j] / den;
    }
  }
}

template <int D>
cudaError_t launch(int dtype, const void* q, const void* k, const void* v, void* o,
                   int b, int sq, int sk, int hq, int hkv, int offset, Strides qs,
                   Strides ks, Strides vs, cudaStream_t stream) {
  const dim3 grid((sq + BQ - 1) / BQ, hq, b);
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  const int group = hq / hkv;
  if (dtype == 1) {
    const size_t smem = bf16_smem_bytes<D>();
    cudaError_t err = cudaFuncSetAttribute(
        flash_bf16_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    flash_bf16_kernel<D><<<grid, 128, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), sq, sk, hq,
        group, offset, qs, ks, vs, scale);
    return cudaGetLastError();
  }
  const size_t smem = f32_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  flash_f32_kernel<D><<<grid, F32_THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), sq, sk, hq, group, offset, qs,
      ks, vs, scale);
  return cudaGetLastError();
}

// --- bf16 on Hopper: wgmma fed by TMA, one producer and two consumers --------

namespace hopper {

constexpr int ROWS = 128;          // query rows per block, 64 per consumer warpgroup
constexpr int KEYS = 128;          // keys per tile
constexpr int THREADS = 384;       // the producer warpgroup, then two consumers
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;   // 40*128 + 232*256 = 168*384
constexpr uint32_t BOX_BYTES = 128 * ROW_BYTES;   // a box of 128 rows (ROWS == KEYS)

// Shared memory, from a 1024-byte aligned base (the 128-byte swizzle repeats
// every 8 rows): Q, the K ring, the V ring, then the mbarriers q_full,
// k_full[STAGES], v_full[STAGES], empty[STAGES].
template <int D>
struct Layout {
  static constexpr int BOXES = D / BOX;                // boxes per tile
  static constexpr int STAGES = D == 128 ? 2 : 3;      // ring depth
  static constexpr uint32_t TILE = BOXES * BOX_BYTES;  // a Q, K or V tile
  static constexpr uint32_t Q = 0;
  static constexpr uint32_t K = Q + TILE;
  static constexpr uint32_t V = K + STAGES * TILE;
  static constexpr uint32_t BARS = V + STAGES * TILE;
  static constexpr size_t SMEM = 1024 + BARS + 8 * (1 + 3 * STAGES);   // 1024: alignment slack
};

// S = Q K^T (issued, not waited for): D/16 steps of 16 along D, each 32
// bytes into a swizzled row of Q's and K's boxes (the hardware applies the
// swizzle); 8-row groups 1024 bytes apart (the SBO).
template <int D>
__device__ __forceinline__ void qk(float (&s)[64], uint32_t q, uint32_t k) {
  wgmma_ss_n128_first(s, sw128_desc(q, 16, GROUP_BYTES), sw128_desc(k, 16, GROUP_BYTES));
#pragma unroll
  for (int kk = 1; kk < D / 16; ++kk) {
    const uint32_t off = (kk / 4) * BOX_BYTES + (kk % 4) * 32;
    wgmma_ss_n128(s, sw128_desc(q + off, 16, GROUP_BYTES), sw128_desc(k + off, 16, GROUP_BYTES));
  }
  wgmma_commit();
}

// O += P V (issued, not waited for): 8 steps of 16 keys, each 16 rows (2048
// bytes) into V's boxes; N = D spans D/64 boxes, BOX_BYTES apart (the LBO).
template <int D>
__device__ __forceinline__ void pv(float (&acc)[D / 2], const uint32_t (&p)[32], uint32_t v) {
#pragma unroll
  for (int kk = 0; kk < KEYS / 16; ++kk) {
    const uint64_t vd = sw128_desc(v + kk * 16 * ROW_BYTES, BOX_BYTES, GROUP_BYTES);
    if constexpr (D == 128)
      wgmma_rs_n128(acc, p + 4 * kk, vd);
    else
      wgmma_rs_n64(acc, p + 4 * kk, vd);
  }
  wgmma_commit();
}

// Mask S (only tiles that cross the diagonal or the end of K), then the
// online softmax in the log2 domain: s becomes 2^(s * scale_log2 - m *
// scale_log2) with m the new row max, l the per-thread partial row sums
// (summed at the end), corr what O must be scaled by.
__device__ __forceinline__ void softmax(float (&s)[64], float (&m)[2], float (&l)[2],
                                        float (&corr)[2], int k0, int sk, long long qpos,
                                        long long first, int t, float scale_log2) {
  if (!(k0 + KEYS <= sk && k0 + KEYS - 1 <= first)) {
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const int key = k0 + 8 * (i >> 2) + 2 * t + (i & 1);
      if (!(key < sk && qpos + 8 * ((i >> 1) & 1) >= key)) s[i] = NEG;
    }
  }
  float mx[2] = {m[0], m[1]}, ms[2];
#pragma unroll
  for (int i = 0; i < 64; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
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
  for (int i = 0; i < 64; ++i) {
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
// columns stored.  With `lse` each row's log-sum-exp of its scaled scores,
// m * scale + ln(l), goes to lse (B, Hq, Sq) in fp32 for the backward;
// nullptr stores nothing, and the output is the same either way.
template <int D, int DO = D>
__global__ void __launch_bounds__(THREADS, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap, __nv_bfloat16* __restrict__ o,
                   float* __restrict__ lse, int sq, int sk, int hq, int group, int offset,
                   float scale_log2) {
  using L = Layout<D>;
  constexpr int S = L::STAGES;
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

  if (threadIdx.x < 128) {
    // Producer: one thread keeps the ring full.  TMA counts the whole box,
    // rows past Sq or Sk included (they land as zeros).
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == 0) {
      const int hk = h / group;
      mbar_expect(q_full, L::TILE);
      for (int x = 0; x < L::BOXES; ++x)
        tma_load(base + L::Q + x * BOX_BYTES, qmap, q_full, x * BOX, h, q0, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % S;
        mbar_wait(empty(s), ((j / S) & 1) ^ 1);    // round 0 finds every stage free
        mbar_expect(k_full(s), L::TILE);
        for (int x = 0; x < L::BOXES; ++x)
          tma_load(base + L::K + s * L::TILE + x * BOX_BYTES, kmap, k_full(s), x * BOX, hk,
                   j * KEYS, b);
        mbar_expect(v_full(s), L::TILE);
        for (int x = 0; x < L::BOXES; ++x)
          tma_load(base + L::V + s * L::TILE + x * BOX_BYTES, vmap, v_full(s), x * BOX, hk,
                   j * KEYS, b);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    const int c = threadIdx.x / 128 - 1;             // which 64 rows of the block
    const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const int row = q0 + 64 * c + 16 * warp + g;     // this thread's rows: row, row + 8
    const long long qpos = static_cast<long long>(offset) + row;
    const long long first = static_cast<long long>(offset) + q0 + 64 * c;
    const uint32_t qa = base + L::Q + c * 64 * ROW_BYTES;

    float s[64];          // S for 128 keys, then P in fp32
    float acc[D / 2];     // O
    uint32_t p[32];       // P in bf16 pairs: the A fragments of the 8 key slices
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};

    // The two consumers take turns to issue their S products (ping-pong, on
    // named barrier 1 + c: consumer c's turn), so that one's softmax runs
    // while the other's products hold the tensor cores.  Each has n_tiles
    // turns; consumer 0 goes first.
    float corr[2];
    mbar_wait(q_full, 0);
    if (c == 1) bar_arrive_consumers(1);
    for (int j = 0; j < n_tiles; ++j) {
      const int st = j % S;
      const uint32_t parity = (j / S) & 1;
      mbar_wait(k_full(st), parity);
      bar_sync_consumers(1 + c);
      wgmma_fence();
      qk<D>(s, qa, base + L::K + st * L::TILE);
      if (c == 0 || j + 1 < n_tiles) bar_arrive_consumers(2 - c);
      wgmma_wait<0>();
      pin(s);
      softmax(s, m, l, corr, j * KEYS, sk, qpos, first, t, scale_log2);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] *= corr[(i >> 1) & 1];
#pragma unroll
      for (int i = 0; i < 32; ++i) p[i] = pack_bf16(s[2 * i], s[2 * i + 1]);
      mbar_wait(v_full(st), parity);
      pin(acc);
      pin(p);
      wgmma_fence();
      pv<D>(acc, p, base + L::V + st * L::TILE);
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
        __nv_bfloat16* op = o + ((static_cast<long long>(b) * sq + orow) * hq + h) * DO + 2 * t;
#pragma unroll
        for (int n = 0; n < DO / 8; ++n)    // columns 8n + 2t, +1 < DO
          *reinterpret_cast<__nv_bfloat162*>(op + n * 8) =
              __floats2bfloat162_rn(acc[4 * n + 2 * r] * inv, acc[4 * n + 2 * r + 1] * inv);
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

// The Hopper kernel on tiles D wide for head dim DO (DO = D, or 112 on D = 128).
template <int D, int DO = D>
cudaError_t launch(const CUtensorMap (&maps)[3], void* o, float* lse, int sq, int sk, int hq,
                   int hkv, int offset, dim3 grid, size_t smem, cudaStream_t stream) {
  static_assert(DO <= D && DO % 16 == 0 && D - DO < BOX, "DO: the head dim in D's last box");
  if (smem != Layout<D>::SMEM) return cudaErrorInvalidValue;
  // setmaxnreg only moves registers between the warpgroups: the launch
  // must hold what the consumers ask for, or their setmaxnreg would wait.
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, flash_wgmma_kernel<D, DO>);
  if (err != cudaSuccess) return err;
  if (attr.numRegs * THREADS < PRODUCER_REGS * 128 + CONSUMER_REGS * 256)
    return cudaErrorLaunchOutOfResources;
  err = cudaFuncSetAttribute(flash_wgmma_kernel<D, DO>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const float scale_log2 = 1.4426950408889634f / sqrtf(static_cast<float>(DO));
  flash_wgmma_kernel<D, DO><<<grid, THREADS, smem, stream>>>(
      maps[0], maps[1], maps[2], static_cast<__nv_bfloat16*>(o), lse, sq, sk, hq, hq / hkv,
      offset, scale_log2);
  return cudaGetLastError();
}

}  // namespace hopper

}  // namespace

extern "C" {

// dtype 0 = float32, 1 = bfloat16.  q (b, sq, hq, d), k/v (b, sk, hkv, d)
// with unit stride along d and the given element strides along b, s, h;
// o (b, sq, hq, d) contiguous.  d in {16, 32, 64, 112, 128}, hq a multiple of
// hkv, causal_offset >= 0.  The grid must be the kernels' (ceil(sq / 64), hq,
// b), as the wrapper plans it.
int gqa_flash_fwd(int dtype, const void* q, const void* k, const void* v, void* o,
                  int b, int sq, int sk, int hq, int hkv, int d, int causal_offset,
                  long long q_sb, long long q_ss, long long q_sh, long long k_sb,
                  long long k_ss, long long k_sh, long long v_sb, long long v_ss,
                  long long v_sh, int grid_x, int grid_y, int grid_z, void* stream) {
  if (b < 1 || sq < 1 || sk < 1 || hkv < 1 || hq % hkv != 0 || causal_offset < 0 ||
      b > 65535 || hq > 65535 || (dtype != 0 && dtype != 1) ||
      grid_x != (sq + BQ - 1) / BQ || grid_y != hq || grid_z != b)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh}, vs{v_sb, v_ss, v_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 16:
      return static_cast<int>(launch<16>(dtype, q, k, v, o, b, sq, sk, hq, hkv,
                                         causal_offset, qs, ks, vs, s));
    case 32:
      return static_cast<int>(launch<32>(dtype, q, k, v, o, b, sq, sk, hq, hkv,
                                         causal_offset, qs, ks, vs, s));
    case 64:
      return static_cast<int>(launch<64>(dtype, q, k, v, o, b, sq, sk, hq, hkv,
                                         causal_offset, qs, ks, vs, s));
    case 112:
      return static_cast<int>(launch<112>(dtype, q, k, v, o, b, sq, sk, hq, hkv,
                                          causal_offset, qs, ks, vs, s));
    case 128:
      return static_cast<int>(launch<128>(dtype, q, k, v, o, b, sq, sk, hq, hkv,
                                          causal_offset, qs, ks, vs, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// bf16 q (b, sq, hq, d), k/v (b, sk, hkv, d), d in {64, 112, 128}, through
// the Hopper kernel (d = 112 on the d = 128 tiles); o (b, sq, hq, d)
// contiguous; lse, when not null, (b, hq, sq) float32: each row's
// log-sum-exp for the backward.  `maps` holds, for q, k and v in turn,
// eleven numbers: the tensor map's dims (d, h, s, b), its byte strides
// along h, s and b, and its box (64, 1, 128, 1).  The grid is (hq, b,
// ceil(sq / 128)); `smem` the kernel's dynamic shared memory.
int gqa_flash_wgmma(const void* q, const void* k, const void* v, void* o, float* lse, int b,
                    int sq, int sk, int hq, int hkv, int d, int causal_offset,
                    const unsigned long long* maps, int grid_x, int grid_y, int grid_z,
                    long long smem, void* stream) {
  using hopper::ROWS;
  if (b < 1 || sq < 1 || sk < 1 || hkv < 1 || hq % hkv != 0 || causal_offset < 0 ||
      grid_x != hq || grid_y != b || grid_z != (sq + ROWS - 1) / ROWS || b > 65535 ||
      grid_z > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const void* ptrs[3] = {q, k, v};
  CUtensorMap tm[3];
  const int err = hopper::encode_maps(tm, ptrs, 3, maps, d, ROWS);
  if (err != 0) return err;
  const dim3 grid(grid_x, grid_y, grid_z);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64:
      return static_cast<int>(hopper::launch<64>(tm, o, lse, sq, sk, hq, hkv, causal_offset,
                                                 grid, static_cast<size_t>(smem), s));
    case 112:
      return static_cast<int>(hopper::launch<128, 112>(tm, o, lse, sq, sk, hq, hkv,
                                                       causal_offset, grid,
                                                       static_cast<size_t>(smem), s));
    case 128:
      return static_cast<int>(hopper::launch<128>(tm, o, lse, sq, sk, hq, hkv, causal_offset,
                                                  grid, static_cast<size_t>(smem), s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
