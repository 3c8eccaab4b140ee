// Building blocks of gqa_flash's "tiled" route: fp32 attention on the CUDA
// cores' FMA pipe with register micro-tiles, shared by the forward's
// flash_tiled_kernel (csrc/flash_attention.cu) and the backward's
// flash_bwd_dq_tiled_kernel and flash_bwd_dkdv_tiled_kernel
// (csrc/flash_attention_bwd.cu): the tiles' geometry at each width, the
// asynchronous fp32 tile loader, and the two products every kernel is made of.
//
// Every kernel runs TY x 16 threads (256: TY = 16), thread (ty, tx) = (tid /
// 16, tid % 16), so that a row's 16 threads are one half warp.  A score tile of
// R x C (query rows x keys; keys x query rows in dK/dV) gives thread (ty, tx)
// the RT contiguous A-rows ty * RT .. ty * RT + RT - 1 and the CT strided
// B-rows tx + 16 j (j < CT): RT x CT scores, at least 8 x 4 where the
// registers allow it.  Its accumulators (O, dQ, dK, dV) are the same RT
// A-rows by the J columns tx + 16 j (j < J), J = ceil(D / 16).
//
// Shared memory: Q, K, V and dO tiles lie row by row as in device memory,
// columns 0 .. 16 J - 1 (zero from D on), rows RS = 16 J + 4 floats apart.
// RS / 4 is odd, so the 8 lanes of a quarter warp reading 16 bytes each from
// 8 consecutive rows hit 8 distinct groups of 4 banks.  The S-like products
// (S = Q K^T, dP = dO V^T, and their transposes) read a thread's A-rows and
// B-rows 4 columns at a time as 128-bit loads: the 16 threads of a half warp
// share the A-row address (a broadcast), and the B-rows of a warp are 64
// distinct 16-byte words, 2 wavefronts; 8 x 4 scores take 3 loads (4 shared
// wavefronts a warp) for 32 FMAs a column.  The O-like products (O += P V,
// dQ += dS K, dV += P^T dO, dK += dS^T Q) read the score tile transposed
// from shared memory (P^T: B index major, the RT A-rows of a thread
// contiguous, again a broadcast 128-bit load) and the J columns of the other
// operand as 32-bit loads, 16 consecutive words a half warp: RT x J FMAs for
// RT / 4 + J loads.
#pragma once

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

#include "hopper.cuh"

namespace {

// 4 bytes global -> shared, asynchronously; when `in` is false nothing is
// read and the 4 bytes are zero-filled.
__device__ __forceinline__ void cp_async4(uint32_t dst, const float* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(in ? 4 : 0)
               : "memory");
}

namespace tiled {

constexpr int TX = 16;                // threads across a tile: a half warp
constexpr int MAX_J = 16;             // accumulator slots: widths up to 256
constexpr size_t SMEM_MAX = 232448;   // what a block may take on an H100
constexpr float NEG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// The width the S-like products run over at head dim d (the least multiple
// of 8 that holds it), and the accumulators' slots of 16 columns: J =
// ceil(d / 16), past 8 rounded up to an even count, so that the widths past
// 128 build 4 instantiations of each kernel instead of 8.
__host__ __device__ constexpr int width(int d) { return (d + 7) / 8 * 8; }
__host__ __device__ constexpr int slots(int d) {
  return (d + 15) / 16 > 8 ? ((d + 15) / 16 + 1) / 2 * 2 : (d + 15) / 16;
}
// Row stride, in floats, of a Q, K, V or dO tile at J slots.
__host__ __device__ constexpr int row_stride(int j) { return 16 * j + 4; }

// The forward: ROWS = 16 RT query rows a block (RT 8 up to width 128, 4
// past it, where the output's 8 J floats a thread would not fit beside S),
// KEYS keys a tile: 128 (8 x 8 scores a thread) where shared memory holds
// them, up to width 112, else 64 (32 past 192); shared memory Q (ROWS rows),
// K and V (KEYS rows each), then one buffer through which P^T passes in NCH
// chunks of 64 keys (row stride ROWS + 4; xty_chunks).
template <int J>
struct FwdTiles {
  static constexpr int TY = 16, THREADS = TY * TX, BLOCKS = 1;   // blocks an SM
  static constexpr int RT = J > 8 ? 4 : 8;
  static constexpr int ROWS = TY * RT;
  static constexpr int RS = row_stride(J);
  static constexpr int PS = ROWS + 4;
  static constexpr size_t bytes(int keys) {
    return sizeof(float) * ((ROWS + 2 * keys) * RS + (keys > 64 ? 64 : keys) * PS);
  }
  static constexpr int KEYS = RT == 8 && bytes(128) <= SMEM_MAX ? 128
                              : bytes(64) <= SMEM_MAX         ? 64
                                                              : 32;
  static constexpr int CT = KEYS / TX, NCH = KEYS > 64 ? 2 : 1;
  static constexpr int Q = 0, K = ROWS * RS, V = K + KEYS * RS, P = V + KEYS * RS;
  static constexpr size_t SMEM = bytes(KEYS);
};

// dQ: ROWS = 16 RT query rows a block, KEYS keys a tile (64 where it fits,
// else 32); shared memory Q and dO (ROWS rows), K and V (KEYS rows), then
// dS^T (KEYS rows of ROWS + 4).
template <int J>
struct DqTiles {
  static constexpr int TY = 16, THREADS = TY * TX, BLOCKS = 1;
  static constexpr int RT = J > 8 ? 4 : 8;
  static constexpr int ROWS = TY * RT;
  static constexpr int RS = row_stride(J);
  static constexpr int XS = ROWS + 4;
  static constexpr size_t bytes(int keys) {
    return sizeof(float) * ((2 * ROWS + 2 * keys) * RS + keys * XS);
  }
  static constexpr int KEYS = bytes(64) <= SMEM_MAX ? 64 : 32;
  static constexpr int CT = KEYS / TX;
  static constexpr int Q = 0, DO = ROWS * RS, K = DO + ROWS * RS, V = K + KEYS * RS,
                       DS = V + KEYS * RS;
  static constexpr size_t SMEM = bytes(KEYS);
};

// dK/dV: KEYS = 16 RT keys a block (the block holds two accumulators of RT
// x J floats a thread: RT 8 up to width 112, 4 at 128, 2 past it), ROWS
// query rows a tile (64 where it fits, else 32); shared memory K and V (KEYS
// rows), two buffers of Q and one of dO (ROWS rows), one buffer through
// which P^T, then dS^T, pass in NCH chunks of ROWS / NCH rows (row stride
// KEYS + 4: a half warp's keys are its own, so a chunk needs only
// __syncwarp), then two buffers of the rows' LSE and D_i.
template <int J>
struct DkdvTiles {
  static constexpr int TY = 16, THREADS = TY * TX, BLOCKS = 1;
  static constexpr int RT = J > 8 ? 2 : J == 8 ? 4 : 8;
  static constexpr int KEYS = TY * RT;
  static constexpr int NCH = RT == 8 ? 2 : 1;
  static constexpr int RS = row_stride(J);
  static constexpr int XS = KEYS + 4;
  static constexpr size_t bytes(int rows) {
    return sizeof(float) * ((2 * KEYS + 3 * rows) * RS + rows / NCH * XS + 4 * rows);
  }
  static constexpr int ROWS = bytes(64) <= SMEM_MAX ? 64 : 32;
  static constexpr int CT = ROWS / TX;
  static constexpr int K = 0, V = KEYS * RS, Q = V + KEYS * RS, DO = Q + 2 * ROWS * RS,
                       P = DO + ROWS * RS, STATS = P + ROWS / NCH * XS;
  static constexpr size_t SMEM = bytes(ROWS);
};

// Rows [r0, r0 + rows) of one head of an fp32 (B, S, H, D) tensor (row
// stride `rs` floats, unit stride along D) into a tile of row stride
// row_stride(J), columns 0 .. 16 J - 1, zero at rows >= valid and columns >=
// d; asynchronous (the caller commits and waits).  `vec`: d and rs multiples
// of 4 and src 16-byte aligned, so 16-byte copies; else 4-byte ones.
template <int J>
__device__ __forceinline__ void load_tile(float* dst, const float* src, int r0, int rows,
                                          int valid, long long rs, int d, bool vec) {
  constexpr int RS = row_stride(J), COLS = 16 * J;
  if (vec) {
    constexpr int C4 = COLS / 4;
    for (int e = threadIdx.x; e < rows * C4; e += blockDim.x) {
      const int r = e / C4, c = (e % C4) * 4;
      const bool in = r0 + r < valid && c < d;
      cp_async16(dst + r * RS + c, src + (in ? (r0 + r) * rs + c : 0), in);
    }
  } else {
    for (int e = threadIdx.x; e < rows * COLS; e += blockDim.x) {
      const int r = e / COLS, c = e % COLS;
      const bool in = r0 + r < valid && c < d;
      cp_async4(smem_addr(dst + r * RS + c), src + (in ? (r0 + r) * rs + c : 0), in);
    }
  }
}

// The statistics (LSE or D_i) of rows [r0, r0 + rows) of one head into
// shared memory, zero at rows >= valid; asynchronous.
__device__ __forceinline__ void load_stats(float* dst, const float* src, int r0, int rows,
                                           int valid) {
  for (int i = threadIdx.x; i < rows; i += blockDim.x) {
    const bool in = r0 + i < valid;
    cp_async4(smem_addr(dst + i), src + (in ? r0 + i : 0), in);
  }
}

// s[i][j] = sum_{c < w} A[i][c] B[16 j][c]: a the thread's first A-row, b its
// first B-row (row stride RS each); w a multiple of 8.  UNROLL steps of 4
// columns unrolled (1 where the registers are short).
template <int RT, int CT, int RS, int UNROLL = 2>
__device__ __forceinline__ void abt(float (&s)[RT][CT], const float* a, const float* b, int w) {
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int j = 0; j < CT; ++j) s[i][j] = 0.f;
#pragma unroll(UNROLL)
  for (int c = 0; c < w; c += 4) {
    float4 bv[CT];
#pragma unroll
    for (int j = 0; j < CT; ++j) bv[j] = *reinterpret_cast<const float4*>(b + 16 * j * RS + c);
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const float4 av = *reinterpret_cast<const float4*>(a + i * RS + c);
#pragma unroll
      for (int j = 0; j < CT; ++j) {
        s[i][j] = fmaf(av.x, bv[j].x, s[i][j]);
        s[i][j] = fmaf(av.y, bv[j].y, s[i][j]);
        s[i][j] = fmaf(av.z, bv[j].z, s[i][j]);
        s[i][j] = fmaf(av.w, bv[j].w, s[i][j]);
      }
    }
  }
}

// The thread's RT contiguous floats of a transposed tile.
template <int RT>
__device__ __forceinline__ void load_row(float (&x)[RT], const float* p) {
  if constexpr (RT % 4 == 0) {
#pragma unroll
    for (int i = 0; i < RT; i += 4) {
      const float4 t = *reinterpret_cast<const float4*>(p + i);
      x[i] = t.x, x[i + 1] = t.y, x[i + 2] = t.z, x[i + 3] = t.w;
    }
  } else {
    static_assert(RT == 2, "2, or a multiple of 4, rows a thread");
    const float2 t = *reinterpret_cast<const float2*>(p);
    x[0] = t.x, x[1] = t.y;
  }
}

// acc[i][j] += sum_{n < N} X^T[n][i] Y[n][16 j]: xt the thread's first A-row
// of the transposed tile (row stride XS), y its first column of the
// row-layout tile (row stride RS).
template <int RT, int J, int N, int XS, int RS>
__device__ __forceinline__ void xty(float (&acc)[RT][J], const float* xt, const float* y) {
#pragma unroll 4
  for (int n = 0; n < N; ++n) {
    float x[RT], yv[J];
    load_row<RT>(x, xt + n * XS);
#pragma unroll
    for (int j = 0; j < J; ++j) yv[j] = y[n * RS + 16 * j];
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < J; ++j) acc[i][j] = fmaf(x[i], yv[j], acc[i][j]);
  }
}

// The thread's RT x CT tile x into the transposed tile (row stride XS) at
// its first A-row xt: x[i][j] to xt[16 j * XS + i].
template <int RT, int CT, int XS>
__device__ __forceinline__ void store_t(float* xt, const float (&x)[RT][CT]) {
#pragma unroll
  for (int j = 0; j < CT; ++j) {
    if constexpr (RT % 4 == 0) {
#pragma unroll
      for (int i = 0; i < RT; i += 4)
        *reinterpret_cast<float4*>(xt + 16 * j * XS + i) =
            make_float4(x[i][j], x[i + 1][j], x[i + 2][j], x[i + 3][j]);
    } else {
      *reinterpret_cast<float2*>(xt + 16 * j * XS) = make_float2(x[0][j], x[1][j]);
    }
  }
}

// acc[i][j] += sum_r X^T[r][i] Y[r][16 j] over the 16 CT rows of a score
// tile the thread holds in registers, x[i][c] its row tx + 16 c: in NCH
// chunks of 16 CT / NCH rows, each stored transposed into `buf` (row stride
// XS; the thread's RT entries at a0) and summed against y's rows of the
// chunk (y the thread's first column, row stride RS).  buf's entries of a
// thread's keys are read only by its half warp, so __syncwarp orders them.
template <int RT, int CT, int J, int NCH, int XS, int RS>
__device__ __forceinline__ void xty_chunks(float (&acc)[RT][J], const float (&x)[RT][CT],
                                           float* buf, const float* y, int tx, int a0) {
  constexpr int CC = CT / NCH, N = 16 * CC;
#pragma unroll
  for (int ch = 0; ch < NCH; ++ch) {
    __syncwarp();                  // the half warp is done with buf's last rows
#pragma unroll
    for (int c = 0; c < CC; ++c) {
      float* row = buf + (tx + 16 * c) * XS + a0;
      if constexpr (RT % 4 == 0) {
#pragma unroll
        for (int i = 0; i < RT; i += 4)
          *reinterpret_cast<float4*>(row + i) =
              make_float4(x[i][ch * CC + c], x[i + 1][ch * CC + c], x[i + 2][ch * CC + c],
                          x[i + 3][ch * CC + c]);
      } else {
        *reinterpret_cast<float2*>(row) = make_float2(x[0][ch * CC + c], x[1][ch * CC + c]);
      }
    }
    __syncwarp();
    xty<RT, J, N, XS, RS>(acc, buf + a0, y + ch * N * RS);
  }
}

// Sum and max over the 16 threads of a half warp (one row's).
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

// fn(std::integral_constant<int, J>) at J = j, one of slots()'s values (1 ..
// 8, then 10, 12, 14, 16): the launch of the instantiation that holds the
// head dim.
template <int J = 1, typename Fn>
cudaError_t with_slots(int j, Fn&& fn) {
  if constexpr (J > MAX_J) {
    return cudaErrorInvalidValue;
  } else {
    if (j == J) return fn(std::integral_constant<int, J>{});
    return with_slots<J < 8 ? J + 1 : J + 2>(j, fn);
  }
}

}  // namespace tiled

}  // namespace
