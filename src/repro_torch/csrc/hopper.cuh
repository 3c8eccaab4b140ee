// Building blocks shared by csrc/flash_attention.cu (the forward's
// flash_wgmma_kernel and flash_mma_kernel) and csrc/flash_attention_bwd.cu
// (the backward's wgmma and mma kernels): the two 16-bit element types (bf16
// and fp16) as pairs, the column-guarded pair store of an output row;
// mma.sync m16n8k16, ldmatrix, 16-byte cp.async and the tile loader of the
// mma.sync kernels; and, for Hopper, mbarriers,
// TMA loads through 4-D tensor maps over (B, S, H, D) 16-bit elements with
// 32-, 64- or 128-byte swizzle (tiles 16, 32, or 64 and more columns wide:
// Swz), wgmma descriptors and products (each for either element type, bf16
// by default: S-like products K-major from shared memory at N 32, 64 and
// 128; O-like products with A in registers and B MN-major at N 16, 32, 64,
// 128, 192 and 256, the tiles' widths), and the encoding of the tensor maps
// on the host.
// Everything has internal linkage: each library that includes it gets its
// own copy.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <typename T>
constexpr bool is_f16 = std::is_same<T, __half>::value;

// Two floats rounded to a pair of T (bf16 or fp16), low half first, as one
// 32-bit register; and back.
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (is_f16<T>) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  } else {
    return pack_bf16(lo, hi);
  }
}

template <typename T>
__device__ __forceinline__ float2 unpack2(uint32_t x) {
  if constexpr (is_f16<T>)
    return __half22float2(*reinterpret_cast<const __half2*>(&x));
  else
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x));
}

// One element: float, bf16 or fp16, widened to float or rounded from it.
__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <>
__device__ __forceinline__ __half from_f<__half>(float x) { return __float2half_rn(x); }

// Columns col and col + 1 of an output row `row` (a T pointer at column 0)
// of a head dim d: one 32-bit store when both are below d and the pair is
// 4-byte aligned (at an odd d every other row starts off 4 bytes), else one
// store each; a column at or past d is not stored.
template <typename T>
__device__ __forceinline__ void store2(T* row, int col, int d, float lo, float hi) {
  if (col + 1 < d && reinterpret_cast<uintptr_t>(row + col) % 4 == 0) {
    *reinterpret_cast<uint32_t*>(row + col) = pack2<T>(lo, hi);
  } else {
    if (col < d) row[col] = from_f<T>(lo);
    if (col + 1 < d) row[col + 1] = from_f<T>(hi);
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// --- mma.sync (the forward's flash_mma_kernel and the backward's "mma" route) ---

// c += a b on one m16n8k16 tile, T bf16 or fp16, fp32 accumulation.
template <typename T>
__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  if constexpr (is_f16<T>)
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  else
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <typename T>
__device__ __forceinline__ uint32_t ld32(const T* p) {
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

// Four 8x8 16-bit matrices from shared memory, lanes 8i..8i+7 giving the row
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

// Rows [r0, r0 + rows) of one head (row stride `rs` elements) into a tile
// of rows x DP with row stride DP + 8, zero past `valid` rows and past
// column d.  `vec`: d and every stride multiples of 8 elements and the base
// 16-byte aligned, so 16-byte cp.async copies (zero-filled past d in whole
// chunks, asynchronous: the caller commits and waits); else 2-byte loads
// through registers, stored at once.
template <typename T, int DP>
__device__ __forceinline__ void load_rows(T* dst, const T* src, int r0, int rows, int valid,
                                          long long rs, int d, bool vec) {
  constexpr int KS = DP + 8;
  if (vec) {
    constexpr int DV = DP / 8;
    for (int e = threadIdx.x; e < rows * DV; e += blockDim.x) {
      const int r = e / DV, c = (e % DV) * 8;
      const bool in = r0 + r < valid && c < d;
      cp_async16(dst + r * KS + c, src + (in ? (r0 + r) * rs + c : 0), in);
    }
  } else {
    for (int e = threadIdx.x; e < rows * DP; e += blockDim.x) {
      const int r = e / DP, c = e % DP;
      dst[r * KS + c] = r0 + r < valid && c < d ? src[(r0 + r) * rs + c] : from_f<T>(0.f);
    }
  }
}

namespace hopper {

constexpr int BOX = 64;            // bf16 per 128-byte swizzled row: a box's inner extent

// The width of the tiles that head dim d runs on: 16 up to 16, 32 up to 32,
// else the least multiple of BOX that holds it (64, 128, 192 or 256); and
// the least head dim a tile of width w takes (the widths below it take the
// rest).
__host__ __device__ constexpr int tile_of(int d) {
  return d <= 16 ? 16 : d <= 32 ? 32 : (d + BOX - 1) / BOX * BOX;
}
__host__ __device__ constexpr int least_dim(int w) {
  return w == 16 ? 1 : w == 32 ? 17 : w == 64 ? 33 : w - BOX + 1;
}

// The swizzled layout of tiles D columns wide: rows of COLS 16-bit elements
// (a box's inner extent: 16, 32, or 64 from width 64 on), ROW bytes each,
// under the swizzle of the same span (32, 64 or 128 bytes), which TMA writes
// and wgmma reads through descriptors of layout type LAYOUT (3, 2 or 1).  A
// tile wider than 64 lies as D / 64 such column boxes one after another.  A
// row holds KSTEPS steps of 16 along D, 32 bytes each; 8 rows (GROUP bytes)
// are one swizzle atom, wgmma's stride byte offset.  Tiles start at
// multiples of 1024 bytes, where every swizzle's pattern starts.
template <int D>
struct Swz {
  static constexpr int COLS = D < BOX ? D : BOX;
  static constexpr uint32_t ROW = 2 * COLS;
  static constexpr uint32_t GROUP = 8 * ROW;
  static constexpr int KSTEPS = ROW / 32;
  static constexpr uint64_t LAYOUT = COLS == 16 ? 3 : COLS == 32 ? 2 : 1;
  static_assert(COLS == 16 || COLS == 32 || COLS == BOX, "a tile width");
  // wgmma's descriptor of a matrix at `addr`: start address, leading and
  // stride byte offsets (in 16-byte units), the layout type.
  __device__ static uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
    return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | static_cast<uint64_t>(lbo >> 4) << 16 |
           static_cast<uint64_t>(sbo >> 4) << 32 | LAYOUT << 62;
  }
};

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// Arrive, and add `bytes` to what must land before the phase completes.
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("{\n.reg .b64 state;\nmbarrier.arrive.shared::cta.b64 state, [%0];\n}\n" ::"r"(
                   bar)
               : "memory");
}

__device__ __forceinline__ bool mbar_test(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait until the phase of `bar` with this parity has completed.  Waiting
// 2^34 cycles (seconds) means a deadlock: trap, so that the launch fails
// instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_test(bar, parity)) return;
  const long long start = clock64();
  while (!mbar_test(bar, parity))
    if (clock64() - start > (1ll << 34)) __trap();
}

// One box of a 4-D tensor map over (B, S, H, D), coordinates innermost
// first, into shared memory; its bytes count against `bar`'s transaction.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap& map, uint32_t bar,
                                         int d0, int h, int row, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(&map)), "r"(bar), "r"(d0), "r"(h), "r"(row), "r"(b)
      : "memory");
}

// The roles of the threads of a block of two consumer warpgroups (the
// forward's and the backward's wgmma kernels).  Up to tile width 128 (WIDE
// false) a producer warpgroup 0 issues the TMA loads and gives registers to
// the consumers, warpgroups 1 and 2, by setmaxnreg: 384 threads, 168
// registers a thread at launch, 40 and 232 after.  ptxas allocates each
// kernel only what the launch gives a thread, whatever setmaxnreg asks for
// later: an SM sub-partition's 16,384 registers over its three warps, 168
// (kernels built for 168, 232 and 240 after setmaxnreg spill alike, and so
// does a block of 288 threads).  A consumer whose output takes 128 floats
// (tiles 256 wide) spills there, so the 256-wide kernels (WIDE) run the two
// consumer warpgroups alone, 256 threads of up to 255 registers, and a
// consumer thread (LOADER) issues the loads at a point of its loop where the
// stage it fills is known to be free.  Tiles 192 wide fit 168 registers and
// keep the producer, which timed faster there than the consumers alone (trial
// builds with Roles<true> at 192); chip_smoke.py times the bf16 D 192
// forward and backward on this layout, the yardstick for a re-check.  The
// narrow tiles (16 and 32 wide, NARROW) take the layout without a producer
// too, two blocks an SM (BLOCKS): at these widths a tile holds little work
// for its barriers and waits (the exponentials set the floor, not the
// products), and a consumer's O, S and P fit the 128 registers that two
// blocks of 256 threads leave a thread, so four consumer warpgroups share an
// SM where the producer layout runs two.
template <bool W, int B = 1>
struct Roles {
  static constexpr bool WIDE = W;
  static constexpr int BLOCKS = B;
  static constexpr int THREADS = WIDE ? 256 : 384;
  static constexpr int CONSUMER = WIDE ? 0 : 128;      // consumer 0's first thread
  static constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;   // 40*128 + 232*256 = 168*384
  __device__ static bool producer() { return !WIDE && threadIdx.x < 128; }
  __device__ static int consumer() { return (threadIdx.x - CONSUMER) / 128; }
  // Hand the producer's registers to the consumers (narrow kernels only).
  __device__ static void producer_regs() {
    if constexpr (!WIDE) asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
  }
  __device__ static void consumer_regs() {
    if constexpr (!WIDE) asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  }
  // setmaxnreg only moves registers between the warpgroups: the launch must
  // hold what the consumers ask for, or their setmaxnreg would wait.
  static bool launchable(int regs) {
    return WIDE || regs * THREADS >= PRODUCER_REGS * 128 + CONSUMER_REGS * 256;
  }
};

// The widest tiles of the narrow layout, and the roles of the tiles D wide.
constexpr int NARROW = 32;
template <int D>
using RolesOf = Roles<(D > 192 || D <= NARROW), (D <= NARROW ? 2 : 1)>;

// Named barrier `id` over the 256 threads of the two consumer warpgroups (0
// is __syncthreads): wait for all 256, or arrive without waiting.
__device__ __forceinline__ void bar_sync_consumers(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void bar_arrive_consumers(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {    // at most N groups still running
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Registers an in-flight wgmma reads or writes: the empty asm keeps the
// compiler from moving their other uses, or reusing them, across the
// instructions that issue and retire it.
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void pin(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// d (64 x 128, fp32) = a (64 x 16) * b (16 x 128): the first step of a
// product, which reads nothing of d (so d is dead before it).
#define WGMMA_SS_N128_FIRST_ASM(TY) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {" \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63" \
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n" \
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]), \
        "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]), \
        "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]), "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]), \
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31]), \
        "=f"(d[32]), "=f"(d[33]), "=f"(d[34]), "=f"(d[35]), "=f"(d[36]), "=f"(d[37]), "=f"(d[38]), "=f"(d[39]), \
        "=f"(d[40]), "=f"(d[41]), "=f"(d[42]), "=f"(d[43]), "=f"(d[44]), "=f"(d[45]), "=f"(d[46]), "=f"(d[47]), \
        "=f"(d[48]), "=f"(d[49]), "=f"(d[50]), "=f"(d[51]), "=f"(d[52]), "=f"(d[53]), "=f"(d[54]), "=f"(d[55]), \
        "=f"(d[56]), "=f"(d[57]), "=f"(d[58]), "=f"(d[59]), "=f"(d[60]), "=f"(d[61]), "=f"(d[62]), "=f"(d[63]) \
      : "l"(a), "l"(b), "r"(0))
template <typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_ss_n128_first(float (&d)[64], uint64_t a, uint64_t b) {
  if constexpr (is_f16<T>)
    WGMMA_SS_N128_FIRST_ASM("f16");
  else
    WGMMA_SS_N128_FIRST_ASM("bf16");
}

// d (64 x 128, fp32) += a (64 x 16) * b (16 x 128), a and b in shared memory,
// both K-major.
#define WGMMA_SS_N128_ASM(TY) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {" \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63" \
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]) \
      : "l"(a), "l"(b), "r"(1))
template <typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a, uint64_t b) {
  if constexpr (is_f16<T>)
    WGMMA_SS_N128_ASM("f16");
  else
    WGMMA_SS_N128_ASM("bf16");
}

// d (64 x 128, fp32) += a (64 x 16, four bf16x2 registers) * b (16 x 128, shared
// memory, MN-major: the transpose bit is set).
#define WGMMA_RS_N128_ASM(TY) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {" \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63" \
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1))
template <typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t* a, uint64_t b) {
  if constexpr (is_f16<T>)
    WGMMA_RS_N128_ASM("f16");
  else
    WGMMA_RS_N128_ASM("bf16");
}

// d (64 x 16, fp32) += a (64 x 16, four bf16x2 registers) * b (16 x 16, shared
// memory, MN-major: the transpose bit is set).
#define WGMMA_RS_N16_ASM(TY) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n16k16.f32." TY "." TY " {" \
      "%0, %1, %2, %3, %4, %5, %6, %7" \
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1))
template <typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8], const uint32_t* a, uint64_t b) {
  if constexpr (is_f16<T>)
    WGMMA_RS_N16_ASM("f16");
  else
    WGMMA_RS_N16_ASM("bf16");
}

// d (64 x 32, fp32) += a (64 x 16, four bf16x2 registers) * b (16 x 32, shared
// memory, MN-major: the transpose bit is set).
#define WGMMA_RS_N32_ASM(TY) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY " {" \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15" \
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1))
template <typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t* a, uint64_t b) {
  if constexpr (is_f16<T>)
    WGMMA_RS_N32_ASM("f16");
  else
    WGMMA_RS_N32_ASM("bf16");
}

// d (64 x 64, fp32) += a (64 x 16, four bf16x2 registers) * b (16 x 64, shared
// memory, MN-major: the transpose bit is set).
#define WGMMA_RS_N64_ASM(TY) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {" \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31" \
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1))
template <typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t* a, uint64_t b) {
  if constexpr (is_f16<T>)
    WGMMA_RS_N64_ASM("f16");
  else
    WGMMA_RS_N64_ASM("bf16");
}

// d (64 x 64, fp32) = a (64 x 16) * b (16 x 64), a and b in shared memory,
// both K-major: the first step of a product, which reads nothing of d.
#define WGMMA_SS_N64_FIRST_ASM(TY) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {" \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31" \
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n" \
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]), \
        "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]), \
        "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]), "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]), \
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31]) \
      : "l"(a), "l"(b), "r"(0))
template <typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_ss_n64_first(float (&d)[32], uint64_t a, uint64_t b) {
  if constexpr (is_f16<T>)
    WGMMA_SS_N64_FIRST_ASM("f16");
  else
    WGMMA_SS_N64_FIRST_ASM("bf16");
}

// d (64 x 64, fp32) += a (64 x 16) * b (16 x 64), a and b in shared memory,
// both K-major.
#define WGMMA_SS_N64_ASM(TY) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {" \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31" \
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]) \
      : "l"(a), "l"(b), "r"(1))
template <typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a, uint64_t b) {
  if constexpr (is_f16<T>)
    WGMMA_SS_N64_ASM("f16");
  else
    WGMMA_SS_N64_ASM("bf16");
}

// d (64 x 32, fp32) = a (64 x 16) * b (16 x 32), a and b in shared memory,
// both K-major: the first step of a product, which reads nothing of d.
#define WGMMA_SS_N32_FIRST_ASM(TY) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY " {" \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15" \
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n" \
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]), \
        "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]) \
      : "l"(a), "l"(b), "r"(0))
template <typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_ss_n32_first(float (&d)[16], uint64_t a, uint64_t b) {
  if constexpr (is_f16<T>)
    WGMMA_SS_N32_FIRST_ASM("f16");
  else
    WGMMA_SS_N32_FIRST_ASM("bf16");
}

// d (64 x 32, fp32) += a (64 x 16) * b (16 x 32), a and b in shared memory,
// both K-major.
#define WGMMA_SS_N32_ASM(TY) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY " {" \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15" \
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]) \
      : "l"(a), "l"(b), "r"(1))
template <typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t a, uint64_t b) {
  if constexpr (is_f16<T>)
    WGMMA_SS_N32_ASM("f16");
  else
    WGMMA_SS_N32_ASM("bf16");
}

// d (64 x 192, fp32) += a (64 x 16, four bf16x2 registers) * b (16 x 192, shared
// memory, MN-major: the transpose bit is set).
#define WGMMA_RS_N192_ASM(TY) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n192k16.f32." TY "." TY " {" \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, " \
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, " \
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95" \
      "}, {%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), \
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), \
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), \
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), \
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1))
template <typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_rs_n192(float (&d)[96], const uint32_t* a, uint64_t b) {
  if constexpr (is_f16<T>)
    WGMMA_RS_N192_ASM("f16");
  else
    WGMMA_RS_N192_ASM("bf16");
}

// d (64 x 256, fp32) += a (64 x 16, four bf16x2 registers) * b (16 x 256, shared
// memory, MN-major: the transpose bit is set).
#define WGMMA_RS_N256_ASM(TY) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n256k16.f32." TY "." TY " {" \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, " \
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, " \
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, " \
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, " \
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127" \
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), \
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), \
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), \
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), \
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), \
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), \
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), \
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), \
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127]) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1))
template <typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128], const uint32_t* a, uint64_t b) {
  if constexpr (is_f16<T>)
    WGMMA_RS_N256_ASM("f16");
  else
    WGMMA_RS_N256_ASM("bf16");
}

// The product of each width: d (64 x N, fp32) += a (64 x 16, registers) *
// b (16 x N, MN-major) at N 16, 32, 64, 128, 192 or 256; and d (64 x N) = a b
// (FIRST) or += a b, both K-major in shared memory, at N 32, 64 or 128.
template <int N, typename T>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t* a, uint64_t b) {
  static_assert(N == 16 || N == 32 || N == 64 || N == 128 || N == 192 || N == 256,
                "a tile width");
  if constexpr (N == 256)
    wgmma_rs_n256<T>(d, a, b);
  else if constexpr (N == 192)
    wgmma_rs_n192<T>(d, a, b);
  else if constexpr (N == 128)
    wgmma_rs_n128<T>(d, a, b);
  else if constexpr (N == 64)
    wgmma_rs_n64<T>(d, a, b);
  else if constexpr (N == 32)
    wgmma_rs_n32<T>(d, a, b);
  else
    wgmma_rs_n16<T>(d, a, b);
}
template <int N, bool FIRST, typename T>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a, uint64_t b) {
  static_assert(N == 32 || N == 64 || N == 128, "a score tile's keys");
  if constexpr (N == 128) {
    if constexpr (FIRST) wgmma_ss_n128_first<T>(d, a, b); else wgmma_ss_n128<T>(d, a, b);
  } else if constexpr (N == 64) {
    if constexpr (FIRST) wgmma_ss_n64_first<T>(d, a, b); else wgmma_ss_n64<T>(d, a, b);
  } else {
    if constexpr (FIRST) wgmma_ss_n32_first<T>(d, a, b); else wgmma_ss_n32<T>(d, a, b);
  }
}

// 2^x in one MUFU instruction, results below 2^-126 flushed to 0 (exp2f
// adds a range check and two scalings for them; beside the row max's 1 they
// add nothing).
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the libcuda that the runtime has loaded, so
// that the library needs no link to it.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// Tensor maps over n (B, S, H, D) tensors of 16-bit elements (bf16, or fp16
// with `f16`), from the wrapper's numbers: eleven for each
// (kernels/flash_attention.py::tensor_map), its dims (d, h, s, b), byte
// strides along h, s and b, and box (w, 1, box_rows, 1), w the inner extent
// of the tiles of head dim d (Swz<tile_of(d)>::COLS: 16, 32 or 64).  The
// swizzle spans a box's row, 2 w bytes (32, 64 or 128: the wrapper's
// tma_swizzle); boxes reaching past S or D land as zeros.  Returns 0, a
// cudaError_t, or the CUresult of a failed encoding negated.
int encode_maps(CUtensorMap* tm, const void* const* ptrs, int n,
                const unsigned long long* maps, int d, unsigned box_rows, bool f16 = false) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint32_t cols = tile_of(d) < BOX ? tile_of(d) : BOX;
  for (int i = 0; i < n; ++i) {
    const unsigned long long* m = maps + 11 * i;
    const cuuint64_t dims[4] = {m[0], m[1], m[2], m[3]};
    const cuuint64_t strides[3] = {m[4], m[5], m[6]};
    const cuuint32_t box[4] = {static_cast<cuuint32_t>(m[7]), static_cast<cuuint32_t>(m[8]),
                               static_cast<cuuint32_t>(m[9]), static_cast<cuuint32_t>(m[10])};
    const cuuint32_t unit[4] = {1, 1, 1, 1};
    if (dims[0] != static_cast<cuuint64_t>(d) || box[0] != cols || box[1] != 1 ||
        box[2] != box_rows || box[3] != 1)
      return static_cast<int>(cudaErrorInvalidValue);
    const CUtensorMapSwizzle swizzle = cols == 16   ? CU_TENSOR_MAP_SWIZZLE_32B
                                       : cols == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                    : CU_TENSOR_MAP_SWIZZLE_128B;
    const CUresult r = encode(&tm[i], f16 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                          : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                              const_cast<void*>(ptrs[i]), dims, strides, box, unit,
                              CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                              CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (r != CUDA_SUCCESS) return -static_cast<int>(r);
  }
  return 0;
}

}  // namespace hopper

}  // namespace
