"""Split the device time of two of the PyTorch port's kernels into phases on
one NVIDIA GPU (built for an H100), with throwaway variants that this script
builds (none of them is kept in the library):

    python3 scripts/kernel_splits.py

1. ``score_matrix`` at the oracle's two shapes (the first learning window's
   pair grid, 6944 x 168, and evaluation week 0's span, 6800 x 552): a
   memset of the output (``Tensor.zero_``), the flat kernel (PR 14,
   ``route="flat"``), a tile design (a block computes whole rows into shared
   memory, then one thread stores the tile with one bulk copy), the same
   storing zeros, the shipped rows kernel (direct ``float4`` stores, 8 rows
   and 128 threads a block) and its indexing storing zeros;
2. ``knn_topk_batch`` at Q=168 N=1344 D=13 k=5 on its plan: an empty kernel
   launched the same way, then ``csrc/knn.cu``'s cluster kernel cut after
   each phase: the staging (queries, one bulk copy, the mbarrier) and the two
   cluster barriers; with the distances and the lanes' lists; with each
   warp's selection (no merge); the whole kernel.

3. ``geo_resolve`` on the busiest recorded geo-flex step of ``geo-full``
   (B=3, n_pad 1792, R=2), each route of ``csrc/geo_walk.cu`` cut by a STOP
   parameter: an empty kernel on the same grid; ``"chunked"`` (the first
   kernel) with phase 1 alone (state copied, migration rule settled, chunk
   masks), with phase 2's chunk loop loading each lane's row but taking no
   turns, whole; ``"compact"`` with its staging alone (phase 1, the block
   scan and the compacted index list), with staging and the write-out but
   no walk, whole;
4. ``capacity_fill`` at B=64 on the mpc-scale tile's busiest recorded step
   of ``sweep-full`` (n_pad 1792), each route of ``csrc/fill.cu`` cut the
   same way: an empty kernel, the staging pass alone, the whole kernel.
5. ``tiled``, only when named: fp32's tiled kernels at chip_smoke.py's fp32
   D-100 shapes (forward B=4 S=2048 Hq=16 Hkv=8, backward the same at S
   2304), each cut after its phases: the forward with its loads alone (Q, the
   K and V tiles by cp.async, the barriers), + S = Q K^T (summed into the
   output, to keep it), + the online softmax, whole; and two trial designs
   of it, whole: 64 query rows and 64 keys a tile (128 threads, two blocks
   an SM) and the accurate exp2f for the exponentials (the kernel takes
   ex2.approx.ftz), alone and together; dQ with its staging, D_i and loads
   alone, + S, dP, P and dS, whole; dK/dV with its loads alone, + S^T and
   P^T, + dV += P^T dO, + dP^T and dS^T, whole (a cut-off product's inputs
   summed into the accumulators, to keep them); beside the shipped wrappers and the first design's kernels
   (``kernel="fp32_simple"``, ``route="fma"``).
6. ``mma``, only when named: the mma backward pair (``route="mma"``, the
   yardstick of the narrow wgmma pair) at bf16 D 32 (B 4, S 2048, Hq 16,
   Hkv 8), each kernel cut after its phases: dQ with its staging, D_i and
   loads alone, + S, dP, P and dS (summed into dQ), whole; dK/dV with its
   loads alone, + S^T, dP^T, P^T and dS^T (summed into the accumulators),
   whole; beside the whole route and the narrow wgmma pair.
7. ``narrow``, only when named: the narrow wgmma kernels (tiles 32 wide) at
   the same shape, each cut after its phases: the forward with its loads,
   barriers and turns alone, + S = Q K^T, + the online softmax, whole; dQ
   with D_i and the loads alone, + S, dP, P and dS, whole; dK/dV with its
   loads and P^T, dS^T and their exchange on zero scores, + S^T and dP^T,
   whole; and the layout they replaced, whole: a producer warpgroup and two
   consumers, one block an SM (``hopper.cuh::Roles<false>``), beside the
   wrappers, ``mma.sync`` and the mma pair.
8. ``flash``, only when named and given ``--against ROOT``: ``gqa_flash``'s
   forward and backward on this checkout's wrappers and kernels against
   those of the checkout at ROOT (say the parent commit, unpacked there by
   ``git archive``; its sources built into its own ``build/``), at every
   timed shape of ``chip_smoke.py`` (``DIMS_FWD_TIMED``, ``DIMS_BWD_TIMED``,
   ``DIMS_D192_TIMED``) on which both take the same route: the outputs
   compared, then each timed by CUDA events in turns (ROOT's, this one's,
   this one's, ROOT's), the call as a user makes it (``launch``; the
   backward ``launch_bwd`` on the forward's LSE).

The variants that compute the output are first held equal to the shipped
kernel; then every variant is timed in turns by profiler device time
(``chip_smoke.device_ms``, 200 calls a turn, 4 turns each).  The card and its
power limit come first.  Builds go to ``build/`` (nvcc, ``sm_90a``).  Name
splits to run only those (``score``, ``knn``, ``geo``, ``fill``, ``tiled``,
``mma``, ``narrow``, ``flash``):

    python3 scripts/kernel_splits.py geo fill
    python3 scripts/kernel_splits.py tiled
    python3 scripts/kernel_splits.py mma narrow
    python3 scripts/kernel_splits.py flash --against build/parent
"""
import argparse
import ctypes
import importlib
import os
import subprocess
import sys
from pathlib import Path

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402  (exits without a CUDA device)
from repro_torch.kernels import fill, geo_walk, knn, score  # noqa: E402
from repro_torch.kernels._build import CSRC, NVCC_FLAGS, _nvcc  # noqa: E402

SCORE_VARIANTS = r"""
#include <cuda_runtime.h>
#include <cstdint>

__device__ __forceinline__ float score(float marg, float c, int t, int t0, int t1) {
  const float den = c < 1e-9f ? 1e-9f : c;
  return (t >= t0 && t < t1) ? __fdiv_rn(marg, den) : 0.0f;
}

// The tile design: bj rows a block computed into shared memory, one bulk
// store of the tile (the ragged last block by plain stores).
template <bool COMPUTE>
__global__ void tile_kernel(const float* marg, const float* ci, const int* ts, const int* te,
                            int J, int T, int bj, float* out) {
  extern __shared__ __align__(128) float tile[];
  float* m_s = tile + bj * T;
  int* ts_s = reinterpret_cast<int*>(m_s + bj);
  int* te_s = ts_s + bj;
  const int j0 = blockIdx.x * bj;
  const int rows = min(bj, J - j0);
  for (int r = threadIdx.x; r < rows; r += blockDim.x) {
    m_s[r] = marg[j0 + r];
    ts_s[r] = ts[j0 + r];
    te_s[r] = te[j0 + r];
  }
  __syncthreads();
  float* dst = out + static_cast<size_t>(j0) * T;
  for (int t = threadIdx.x; t < T; t += blockDim.x) {
    const float c = ci[t];
    for (int r = 0; r < rows; ++r) {
      const float v = COMPUTE ? score(m_s[r], c, t, ts_s[r], te_s[r]) : 0.f;
      if (rows == bj) tile[r * T + t] = v;
      else dst[static_cast<size_t>(r) * T + t] = v;
    }
  }
  if (rows < bj) return;
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  if (threadIdx.x == 0) {
    asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst),
                 "r"(static_cast<uint32_t>(__cvta_generic_to_shared(tile))),
                 "r"(static_cast<uint32_t>(4 * bj * T)) : "memory");
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
}

// The rows kernel's indexing and float4 stores, storing zeros.
__global__ void rows_zero_kernel(int J, int T, int bj, float* out) {
  const int T4 = T >> 2;
  const int j0 = blockIdx.x * bj;
  const int total = min(bj, J - j0) * T4;
  int e = threadIdx.x, r = e / T4, c = e - r * T4;
  const int dr = blockDim.x / T4, dc = blockDim.x - dr * T4;
  for (; e < total; e += blockDim.x) {
    *reinterpret_cast<float4*>(out + static_cast<size_t>(j0 + r) * T + 4 * c) =
        make_float4(0.f, 0.f, 0.f, 0.f);
    c += dc;
    r += dr;
    if (c >= T4) {
      c -= T4;
      ++r;
    }
  }
}

extern "C" int score_variant(int which, const float* marg, const float* ci, const int* ts,
                             const int* te, int J, int T, int bj, int threads, float* out,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = (J + bj - 1) / bj;
  const int smem = bj * (4 * T + 12);
  if (which == 2) {
    rows_zero_kernel<<<blocks, threads, 0, s>>>(J, T, bj, out);
  } else if (which == 1) {
    tile_kernel<false><<<blocks, threads, smem, s>>>(marg, ci, ts, te, J, T, bj, out);
  } else {
    tile_kernel<true><<<blocks, threads, smem, s>>>(marg, ci, ts, te, J, T, bj, out);
  }
  return static_cast<int>(cudaGetLastError());
}
"""

# The cluster kernel of csrc/knn.cu with a STOP parameter: 1 staging and
# barriers only, 2 with the distances, 3 with each warp's selection, 4 whole.
# Each cut writes what it has (lane heads, the warp's candidates) so that
# nothing before it is optimised away.
KNN_CUTS = [
    ("template <int K, int D>\n__global__ void __launch_bounds__(BATCH_GROUP_MAX * 32)\n"
     "knn_cluster_kernel(",
     "template <int K, int D, int STOP>\n__global__ void __launch_bounds__(BATCH_GROUP_MAX * 32)\n"
     "split_kernel("),
    ("    for (int r = lane; r < cnt; r += 32) {\n      const float* xv",
     "    if (STOP == 1) continue;\n    for (int r = lane; r < cnt; r += 32) {\n      const float* xv"),
    ("  float best_d;\n  int best_i;\n  warp_topk(ld, li, lane, best_d, best_i);",
     "  float best_d = ld[0];\n  int best_i = li[0];\n"
     "  if (STOP >= 3) warp_topk(ld, li, lane, best_d, best_i);"),
    ("  if (rank == 0) {\n    list_init(ld, li);",
     "  if (rank == 0 && STOP < 4) {\n    const int qi = q0 + warp;\n"
     "    if (lane < K && qi < nq) {\n"
     "      out_dist[static_cast<size_t>(qi) * K + lane] = best_d;\n"
     "      out_idx[static_cast<size_t>(qi) * K + lane] = best_i;\n    }\n"
     "  } else if (rank == 0) {\n    list_init(ld, li);"),
]

KNN_ENTRY = r"""
extern "C" int knn_variant(int stop, const float* cases, const float* queries, int n, int d,
                           int nq, int rows, int chunks, int blocks, int threads, int slices,
                           int smem, float* out_dist, long long* out_idx, void* stream) {
  const void* kernel = stop == 1 ? (const void*)split_kernel<5, 13, 1>
                     : stop == 2 ? (const void*)split_kernel<5, 13, 2>
                     : stop == 3 ? (const void*)split_kernel<5, 13, 3>
                                 : (const void*)split_kernel<5, 13, 4>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         BATCH_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* args[] = {&cases, &queries, &n, &d, &nq, &rows, &chunks, &out_dist, &out_idx};
  return static_cast<int>(launch_cluster(kernel, args, blocks, threads, slices, smem,
                                         static_cast<cudaStream_t>(stream)));
}
"""


def knn_variants_source() -> str:
    """csrc/knn.cu with its cluster kernel copied under the cuts above (each
    must apply exactly once) and an entry that launches a cut."""
    src = open(os.path.join(ROOT, "src", "repro_torch", "csrc", "knn.cu")).read()
    start = src.index("template <int K, int D>\n__global__ void __launch_bounds__(BATCH_GROUP_MAX")
    end = src.index("// Launched as the cluster kernel is, doing nothing")
    kernel = src[start:end]
    for old, new in KNN_CUTS:
        if kernel.count(old) != 1:
            raise RuntimeError(f"the cluster kernel no longer reads {old!r}: update the cuts")
        kernel = kernel.replace(old, new)
    close = src.index("}  // namespace")
    return src[:close] + kernel + src[close:] + KNN_ENTRY


def build(name: str, source: str) -> ctypes.CDLL:
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    cu = os.path.join(ROOT, "build", f"{name}.cu")
    so = os.path.join(ROOT, "build", f"lib{name}.so")
    with open(cu, "w") as f:
        f.write(source)
    proc = subprocess.run([_nvcc(Path(cu)), *NVCC_FLAGS, "-I", CSRC, "-o", so, cu],
                          capture_output=True, text=True)
    if proc.returncode != 0:      # the sources' headers come from csrc/
        raise RuntimeError(f"nvcc failed to build {cu}:\n{proc.stdout}{proc.stderr}")
    return ctypes.CDLL(so)


def tile_rows(j: int, t: int) -> int:
    """The tile design's rows a block: the largest multiple of 4 whose tile
    fits 48 KB and that leaves at least 2 x 132 blocks (at least 4)."""
    bj = 49152 // (4 * t + 12) // 4 * 4
    while bj > 4 and -(-j // bj) < 264:
        bj -= 4
    return bj


def report(title, turns, extra=lambda key, ms: ""):
    log(title)
    for key, v in turns.items():
        ms = float(np.mean(v))
        log(f"  {key:34s} {ms:.6f} ms (turns {[round(x, 6) for x in v]}){extra(key, ms)}")


def log(*args):
    print(*args, flush=True)


def score_split():
    lib = build("score_splits", SCORE_VARIANTS)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.score_variant.argtypes = [i, p, p, p, p, i, i, i, i, p, p]
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    windows = cs.oracle_windows()
    for name, jobs, ci, h in (windows[0], windows[-1]):
        a = cs.score_args(jobs, ci, h, dev)
        j, t = a[0].shape[0], a[1].shape[0]
        out = torch.empty((j, t), device=dev)
        bj = tile_rows(j, t)
        threads = min(-(-t // 32) * 32, 1024)
        want = score.score_matrix(*a)
        rows_bj = score.plan(j, t)["bj"]

        def variant(which, rows, th):
            return lambda: lib.score_variant(which, *(x.data_ptr() for x in a), j, t, rows,
                                             th, out.data_ptr(), stream)

        variant(0, bj, threads)()
        torch.cuda.synchronize()
        if not torch.equal(out, want):
            raise AssertionError(f"{name}: the tile design differs from the shipped kernel")
        runs = {"memset of the output": out.zero_,
                "flat kernel (PR 14)": lambda: score.score_matrix(*a, route="flat"),
                f"tile of {bj} rows, one bulk store": variant(0, bj, threads),
                "the same storing zeros": variant(1, bj, threads),
                f"rows kernel ({rows_bj} rows, float4 stores)": lambda: score.score_matrix(*a),
                "its indexing storing zeros": variant(2, rows_bj, score.ROW_THREADS)}
        bound, _ = cs.bound_ms(12 * j + 4 * t + 4 * j * t, j * t)
        report(f"score_matrix {name}: J={j} T={t}, bound {bound:.9f} ms (bytes)",
               cs.in_turns(runs), lambda key, ms: f", {bound / ms:.4f} of the bound")


def knn_split():
    lib = build("knn_splits", knn_variants_source())
    knn.build()
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.knn_variant.argtypes = [i, p, p] + [i] * 9 + [p, p, p]
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    gen = np.random.default_rng(0)
    n, d, nq, k = 1344, 13, 168, 5
    cases = torch.from_numpy(gen.normal(size=(n, d)).astype(np.float32)).to(dev)
    qs = torch.from_numpy(gen.normal(size=(nq, d)).astype(np.float32)).to(dev)
    dist = torch.empty((nq, k), device=dev)
    idx = torch.empty((nq, k), dtype=torch.int64, device=dev)
    pl = knn.batch_plan(n, d, nq, k)

    def cut(stop):
        return lambda: lib.knn_variant(
            stop, cases.data_ptr(), qs.data_ptr(), n, d, nq, pl["rows"], pl["chunks"],
            pl["blocks"], pl["threads"], pl["slices"], pl["smem"], dist.data_ptr(),
            idx.data_ptr(), stream)

    cut(4)()
    want = knn.knn_topk_batch(cases, qs, k)
    torch.cuda.synchronize()
    if not (torch.equal(dist, want[0]) and torch.equal(idx, want[1])):
        raise AssertionError("the whole cut differs from the shipped cluster kernel")
    runs = {"empty kernel, same launch": lambda: knn._lib.knn_batch_floor(
                pl["blocks"], pl["threads"], pl["slices"], pl["smem"], stream),
            "staging and the cluster barriers": cut(1), "+ distances and lane lists": cut(2),
            "+ each warp's selection": cut(3), "+ block 0's merge (whole kernel)": cut(4),
            "knn_topk_batch (the wrapper)": lambda: knn.knn_topk_batch(cases, qs, k)}
    report(f"knn_topk_batch Q={nq} N={n} D={d} k={k} on {pl}", cs.in_turns(runs))


# Each route's kernel of csrc/geo_walk.cu and csrc/fill.cu copied under a
# STOP parameter: (first line of the kernel, the text that follows it, the
# cuts, each applied exactly once, the variant's name and its stops).
GEO_SPLITS = {
    "compact": dict(
        start="__global__ void __launch_bounds__(COMPACT_THREADS) geo_walk_compact_kernel(",
        end="// The floor of a call",
        name="geo_compact_split", stops=("staging alone (the pass, the scan, the list)",
                                         "+ the write-out, no walk", "whole kernel"),
        cuts=[
            ("__global__ void __launch_bounds__(COMPACT_THREADS) geo_walk_compact_kernel(",
             "template <int STOP>\n"
             "__global__ void __launch_bounds__(COMPACT_THREADS) geo_compact_split("),
            ("  __syncthreads();\n\n  if (warp == 0) {\n    // Walk:",
             "  __syncthreads();\n  if (STOP == 1) return;\n\n"
             "  if (warp == 0 && STOP == 3) {\n    // Walk:"),
        ]),
    "chunked": dict(
        start="__global__ void __launch_bounds__(THREADS) geo_walk_kernel(const GeoArgs a) {",
        end="// A geo-flex row's preference",
        name="geo_chunked_split", stops=("phase 1 alone", "+ the chunk loop, no turns",
                                         "whole kernel"),
        cuts=[
            ("__global__ void __launch_bounds__(THREADS) geo_walk_kernel(const GeoArgs a) {",
             "template <int STOP>\n"
             "__global__ void __launch_bounds__(THREADS) geo_chunked_split(const GeoArgs a) {"),
            ("  __syncthreads();\n  if (warp != 0) return;\n",
             "  __syncthreads();\n  if (warp != 0 || STOP == 1) return;\n"),
            ("    for (unsigned int turn = live; turn; turn &= turn - 1) {",
             "    if (STOP == 2) {   // keep the lane's loads, take no turn\n"
             "      if (mine && k + polr + engr + (long long)pref + strt + placed + forced +\n"
             "          search == -987654321LL) a.take[row] = 2;\n"
             "      continue;\n    }\n"
             "    for (unsigned int turn = live; turn; turn &= turn - 1) {"),
        ]),
}

FILL_SPLITS = {
    "compact": dict(
        start="__global__ void __launch_bounds__(COMPACT_THREADS)\ncapacity_fill_compact_kernel(",
        end="// The floor of a call",
        name="fill_compact_split", stops=("staging alone (the pass, the scan, the list)",
                                          "whole kernel"),
        cuts=[
            ("__global__ void __launch_bounds__(COMPACT_THREADS)\ncapacity_fill_compact_kernel(",
             "template <int STOP>\n__global__ void __launch_bounds__(COMPACT_THREADS)\n"
             "fill_compact_split("),
            ("  __syncthreads();\n  if (warp != 0) return;\n",
             "  __syncthreads();\n  if (warp != 0 || STOP == 1) return;\n"),
        ]),
    "chunked": dict(
        start="__global__ void __launch_bounds__(THREADS)\ncapacity_fill_kernel(",
        end="// Warp 0: exclusive offsets",
        name="fill_chunked_split", stops=("staging pass alone", "whole kernel"),
        cuts=[
            ("__global__ void __launch_bounds__(THREADS)\ncapacity_fill_kernel(",
             "template <int STOP>\n__global__ void __launch_bounds__(THREADS)\n"
             "fill_chunked_split("),
            ("  __syncthreads();\n  if (warp != 0) return;\n",
             "  __syncthreads();\n"
             "  if (STOP == 1) {   // keep the masks and the floor\n"
             "    if (threadIdx.x == 0 && masks[0] + masks[chunks] == 0x7fffffffu &&\n"
             "        warp_floor[0] == -3) out[0] = 2;\n"
             "    return;\n  }\n"
             "  if (warp != 0) return;\n"),
        ]),
}

GEO_ENTRY = r"""
extern "C" int geo_split(int route, int stop, const GeoArgs* a, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const unsigned int blocks = (unsigned int)a->cells;
  if (route == 0) {
    const size_t smem = (size_t)smem_bytes(COMPACT, a->n);
    cudaError_t err = opt_in(geo_compact_split<1>, smem);
    if (err == cudaSuccess) err = opt_in(geo_compact_split<2>, smem);
    if (err == cudaSuccess) err = opt_in(geo_compact_split<3>, smem);
    if (err != cudaSuccess) return (int)err;
    if (stop == 1) geo_compact_split<1><<<blocks, COMPACT_THREADS, smem, s>>>(*a);
    else if (stop == 2) geo_compact_split<2><<<blocks, COMPACT_THREADS, smem, s>>>(*a);
    else geo_compact_split<3><<<blocks, COMPACT_THREADS, smem, s>>>(*a);
  } else {
    const size_t smem = (size_t)smem_bytes(CHUNKED, a->n);
    if (stop == 1) geo_chunked_split<1><<<blocks, THREADS, smem, s>>>(*a);
    else if (stop == 2) geo_chunked_split<2><<<blocks, THREADS, smem, s>>>(*a);
    else geo_chunked_split<3><<<blocks, THREADS, smem, s>>>(*a);
  }
  return (int)cudaGetLastError();
}
"""

FILL_ENTRY = r"""
extern "C" int fill_split(int route, int stop, const unsigned char* cand,
                          const unsigned char* forced, const long long* kreq,
                          const long long* m_cap, long long rows, int n,
                          unsigned char* take, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const unsigned int blocks = (unsigned int)rows;
  if (route == 0) {
    const size_t smem = (size_t)smem_bytes(COMPACT, n);
    cudaError_t err = opt_in(fill_compact_split<1>, smem);
    if (err == cudaSuccess) err = opt_in(fill_compact_split<2>, smem);
    if (err != cudaSuccess) return (int)err;
    if (stop == 1) fill_compact_split<1><<<blocks, COMPACT_THREADS, smem, s>>>(
        cand, forced, kreq, m_cap, n, take);
    else fill_compact_split<2><<<blocks, COMPACT_THREADS, smem, s>>>(
        cand, forced, kreq, m_cap, n, take);
  } else {
    const size_t smem = (size_t)smem_bytes(CHUNKED, n);
    if (stop == 1) fill_chunked_split<1><<<blocks, THREADS, smem, s>>>(
        cand, forced, kreq, m_cap, n, take);
    else fill_chunked_split<2><<<blocks, THREADS, smem, s>>>(
        cand, forced, kreq, m_cap, n, take);
  }
  return (int)cudaGetLastError();
}
"""


def split_source(cu: str, splits: dict, entry: str, close: str = "}  // namespace") -> str:
    """``csrc/<cu>`` with each route's kernel copied under its cuts (each
    must apply exactly once) into the namespace that ``close`` (its last
    occurrence) ends, the anonymous one by default, and ``entry``."""
    src = open(os.path.join(ROOT, "src", "repro_torch", "csrc", cu)).read()
    copies = ""
    for route, sp in splits.items():
        start = src.index(sp["start"])
        kernel = src[start:src.index(sp["end"], start)]
        for old, new in sp["cuts"]:
            if kernel.count(old) != 1:
                raise RuntimeError(f"{cu}'s {route} kernel no longer reads {old!r}: "
                                   "update the cuts")
            kernel = kernel.replace(old, new)
        copies += kernel
    at = src.rindex(close)
    return src[:at] + copies + src[at:] + entry


def split_runs(splits, variant, floor, wrapper, equal):
    """The runs to time in turns: the floor, then per route each stop (the
    last, the whole kernel, first held equal to the wrapper's output on
    that route) and the wrapper."""
    runs = {"empty kernel, same grid": floor}
    for ri, (route, sp) in enumerate(splits.items()):
        equal(route, variant(ri, len(sp["stops"])))
        for stop, what in enumerate(sp["stops"], 1):
            runs[f"{route}: {what}"] = variant(ri, stop)
        runs[f"{route}: the wrapper"] = wrapper(route)
    return runs


def geo_split():
    record = []
    cs.geo_full("cuda", "scan", record)
    walked = [int((a[0] & ~geo_walk.geo_resolve("geo-flex", *a, route="chunked")[6])
                  .sum(1).max())
              for a in record]
    step = max(range(len(record)), key=walked.__getitem__)
    args = record[step]
    b, n = args[0].shape
    regions = args[3]["caps"].shape[1]
    lib = build("geo_splits", split_source("geo_walk.cu", GEO_SPLITS, GEO_ENTRY))
    lib.geo_split.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(geo_walk._Args),
                              ctypes.c_void_p]
    stream = torch.cuda.current_stream().cuda_stream
    smem = geo_walk.plan(b, n, regions)["smem_bytes"]
    outs = [o.clone() for o in geo_walk.geo_resolve("geo-flex", *args, route="chunked")]
    c_args = geo_walk.pack_args("geo-flex", args[0], args[1],
                                {**args[2], **args[3], **args[4]}, outs)

    def variant(route, stop):
        return lambda: lib.geo_split(route, stop, ctypes.byref(c_args), stream)

    def equal(route, run):
        want = [o.clone() for o in geo_walk.geo_resolve("geo-flex", *args, route=route)]
        run()
        torch.cuda.synchronize()
        if not all(torch.equal(a, w) for a, w in zip(outs, want)):
            raise AssertionError(f"geo {route}: the whole cut differs from the route")

    runs = split_runs(
        GEO_SPLITS, variant,
        lambda: geo_walk._lib.geo_walk_floor(0, b, smem, stream),
        lambda route: lambda: geo_walk.geo_resolve("geo-flex", *args, route=route), equal)
    report(f"geo_resolve geo-flex B={b} n_pad={n} R={regions}, the busiest recorded step "
           f"of geo-full ({walked[step]} candidates walked in its busiest cell)",
           cs.in_turns(runs))


def fill_split():
    record = []
    cs.sweep_full("cuda", "scan", "device", record)
    cands = [int(r[0].sum()) for r in record]
    step = max(range(len(record)), key=cands.__getitem__)
    b_tile, n = record[step][0].shape
    args = [x[[i % b_tile for i in range(64)]].contiguous() for x in record[step]]
    lib = build("fill_splits", split_source("fill.cu", FILL_SPLITS, FILL_ENTRY))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.fill_split.argtypes = [i, i, p, p, p, p, ctypes.c_longlong, i, p, p]
    stream = torch.cuda.current_stream().cuda_stream
    take = torch.empty((64, n), dtype=torch.bool, device=args[0].device)
    smem = fill.plan(64, n)["smem_bytes"]

    def variant(route, stop):
        return lambda: lib.fill_split(route, stop, *(x.data_ptr() for x in args), 64, n,
                                      take.data_ptr(), stream)

    def equal(route, run):
        run()
        torch.cuda.synchronize()
        if not torch.equal(take, fill.capacity_fill(*args, route=route)):
            raise AssertionError(f"fill {route}: the whole cut differs from the route")

    runs = split_runs(FILL_SPLITS, variant,
                      lambda: fill._lib.capacity_fill_floor(0, 64, smem, stream),
                      lambda route: lambda: fill.capacity_fill(*args, route=route), equal)
    report(f"capacity_fill B=64 n_pad={n}, the mpc-scale tile's busiest recorded step "
           f"({b_tile} cells repeated; {int(args[0].sum())} candidates)", cs.in_turns(runs))


# fp32's tiled kernels at J = 7 accumulator slots (D 97..112), each copied
# under a STOP parameter; the forward also under its tiling L and APPROX
# (ex2.approx.ftz, the shipped kernel's, or else the accurate exp2f).
TILED_FWD_SPLITS = {
    "forward": dict(
        start="template <int J>\n__global__ void __launch_bounds__(tiled::FwdTiles<J>::THREADS, "
              "tiled::FwdTiles<J>::BLOCKS)\nflash_tiled_kernel(",
        end="template <int J>\ncudaError_t launch_tiled(",
        stops=("loads alone (Q, K and V tiles, barriers)", "+ S = Q K^T (summed into O)",
               "+ the online softmax", "whole kernel"),
        cuts=[
            ("template <int J>\n__global__ void __launch_bounds__(tiled::FwdTiles<J>::THREADS, "
             "tiled::FwdTiles<J>::BLOCKS)\nflash_tiled_kernel(",
             "template <int J, int STOP, class L, bool APPROX>\n"
             "__global__ void __launch_bounds__(L::THREADS, L::BLOCKS)\ntiled_fwd_cut("),
            ("  using L = tiled::FwdTiles<J>;\n", ""),
            ("    if (active) {\n      tiled::abt<RT, CT, RS>(s, qt + a0 * RS, kt + tx * RS, w);",
             "    if (STOP >= 2 && active) {\n"
             "      tiled::abt<RT, CT, RS>(s, qt + a0 * RS, kt + tx * RS, w);"),
            ("      for (int i = 0; i < RT; ++i) {\n        float mx = m[i];",
             "      for (int i = 0; i < (STOP >= 3 ? RT : 0); ++i) {\n        float mx = m[i];"),
            ("const float corr = hopper::exp2_ftz(m[i] - mx);",
             "const float corr = APPROX ? hopper::exp2_ftz(m[i] - mx) : exp2f(m[i] - mx);"),
            ("s[i][j] = hopper::exp2_ftz(s[i][j] - mx);",
             "s[i][j] = APPROX ? hopper::exp2_ftz(s[i][j] - mx) : exp2f(s[i][j] - mx);"),
            # a product cut off keeps its inputs alive by summing them into the output
            ("    if (active) tiled::xty_chunks<RT, CT, J, NCH, PS, RS>(acc, s, pt, vt + tx, tx, "
             "a0);",
             "    if (STOP >= 4 && active)\n"
             "      tiled::xty_chunks<RT, CT, J, NCH, PS, RS>(acc, s, pt, vt + tx, tx, a0);\n"
             "    else if (STOP >= 2 && active)\n"
             "      for (int i = 0; i < RT * CT; ++i) acc[0][0] += s[i / CT][i % CT];"),
        ]),
}
TILED_FWD_ENTRY = r"""
// The forward's tiles with 64 query rows and 64 keys a tile: 128 threads, two
// blocks an SM.
template <int J>
struct Rows64 {
  static constexpr int TY = 8, THREADS = TY * tiled::TX, BLOCKS = 2;
  static constexpr int RT = 8, ROWS = TY * RT, RS = tiled::row_stride(J), PS = ROWS + 4;
  static constexpr int KEYS = 64, CT = KEYS / tiled::TX, NCH = 1;
  static constexpr int Q = 0, K = ROWS * RS, V = K + KEYS * RS, P = V + KEYS * RS;
  static constexpr size_t SMEM = sizeof(float) * (P + KEYS * PS);
};

template <int STOP, class L, bool APPROX>
static int fwd_cut(const float* q, const float* k, const float* v, float* o, int b, int sq,
                   int sk, int hq, int hkv, int d, cudaStream_t s) {
  constexpr int J = 7;
  cudaError_t err = cudaFuncSetAttribute(tiled_fwd_cut<J, STOP, L, APPROX>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)L::SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(hq, b, (sq + L::ROWS - 1) / L::ROWS);
  const Strides qs{(long long)sq * hq * d, (long long)hq * d, d};
  const Strides ks{(long long)sk * hkv * d, (long long)hkv * d, d};
  tiled_fwd_cut<J, STOP, L, APPROX><<<grid, L::THREADS, L::SMEM, s>>>(
      q, k, v, o, nullptr, sq, sk, hq, hq / hkv, 0, d, true, qs, ks, ks,
      tiled::LOG2E / sqrtf((float)d));
  return (int)cudaGetLastError();
}

// variant 0: the shipped kernel, cut at stop 1..4; 1: Rows64; 2: exp2f in
// place of ex2.approx.ftz; 3: both (the last three whole).  Contiguous fp32
// inputs, 97 <= d <= 112.
extern "C" int tiled_fwd_split(int variant, int stop, const float* q, const float* k,
                               const float* v, float* o, int b, int sq, int sk, int hq, int hkv,
                               int d, void* stream) {
  using F = tiled::FwdTiles<7>;
  const cudaStream_t s = (cudaStream_t)stream;
  if (variant == 0 && stop == 1) return fwd_cut<1, F, true>(q, k, v, o, b, sq, sk, hq, hkv, d, s);
  if (variant == 0 && stop == 2) return fwd_cut<2, F, true>(q, k, v, o, b, sq, sk, hq, hkv, d, s);
  if (variant == 0 && stop == 3) return fwd_cut<3, F, true>(q, k, v, o, b, sq, sk, hq, hkv, d, s);
  if (variant == 0) return fwd_cut<4, F, true>(q, k, v, o, b, sq, sk, hq, hkv, d, s);
  if (variant == 1) return fwd_cut<4, Rows64<7>, true>(q, k, v, o, b, sq, sk, hq, hkv, d, s);
  if (variant == 2) return fwd_cut<4, F, false>(q, k, v, o, b, sq, sk, hq, hkv, d, s);
  return fwd_cut<4, Rows64<7>, false>(q, k, v, o, b, sq, sk, hq, hkv, d, s);
}
"""
TILED_BWD_SPLITS = {
    "dQ": dict(
        start="template <int J>\n__global__ void __launch_bounds__(tiled::DqTiles<J>::THREADS, "
              "tiled::DqTiles<J>::BLOCKS)\nflash_bwd_dq_tiled_kernel(",
        end="// dK/dV: one block per (KEYS keys",
        stops=("staging, D_i and the loads alone", "+ S, dP, P and dS (dS^T stored)",
               "whole kernel"),
        cuts=[
            ("template <int J>\n__global__ void __launch_bounds__(tiled::DqTiles<J>::THREADS, "
             "tiled::DqTiles<J>::BLOCKS)\nflash_bwd_dq_tiled_kernel(",
             "using tiled::LOG2E;\ntemplate <int J, int STOP>\n__global__ void "
             "__launch_bounds__(tiled::DqTiles<J>::THREADS, tiled::DqTiles<J>::BLOCKS)\n"
             "tiled_dq_cut("),
            ("    if (active) tiled::abt<RT, CT, RS>(dp, dot + a0 * RS, vt + tx * RS, w);",
             "    if (STOP >= 2 && active) tiled::abt<RT, CT, RS>(dp, dot + a0 * RS, vt + tx * RS, "
             "w);"),
            ("    if (active) {\n      float s[RT][CT];",
             "    if (STOP >= 2 && active) {\n      float s[RT][CT];"),
            ("      tiled::xty<RT, J, KEYS, XS, RS>(acc, dst + a0, kt + tx);",
             "      if (STOP >= 3) tiled::xty<RT, J, KEYS, XS, RS>(acc, dst + a0, kt + tx);"),
        ]),
    "dK/dV": dict(
        start="template <int J>\n__global__ void __launch_bounds__(tiled::DkdvTiles<J>::THREADS, "
              "tiled::DkdvTiles<J>::BLOCKS)\nflash_bwd_dkdv_tiled_kernel(",
        end="enum Kernel { DQ = 0, DKDV = 1 };",
        stops=("the loads alone", "+ S^T and P^T (summed into the accumulators)",
               "+ dV += P^T dO", "+ dP^T and dS^T (summed into the accumulators)",
               "whole kernel"),
        cuts=[
            ("template <int J>\n__global__ void __launch_bounds__(tiled::DkdvTiles<J>::THREADS, "
             "tiled::DkdvTiles<J>::BLOCKS)\nflash_bwd_dkdv_tiled_kernel(",
             "template <int J, int STOP>\n__global__ void "
             "__launch_bounds__(tiled::DkdvTiles<J>::THREADS, tiled::DkdvTiles<J>::BLOCKS)\n"
             "tiled_dkdv_cut("),
            ("    if (active) {\n      float st[RT][CT];           // S^T, then P^T",
             "    if (STOP >= 2 && active) {\n      float st[RT][CT];"),
            # a product cut off keeps its inputs alive by summing them into the accumulators
            ("      tiled::xty_chunks<RT, CT, J, NCH, XS, RS>(acc_v, st, pbuf, dot + tx, tx, a0);  // dV",
             "      if (STOP >= 3)\n"
             "        tiled::xty_chunks<RT, CT, J, NCH, XS, RS>(acc_v, st, pbuf, dot + tx, tx, a0);\n"
             "      else\n"
             "        for (int i = 0; i < RT * CT; ++i) acc_v[0][0] += st[i / CT][i % CT];\n"
             "      if (STOP >= 4) {"),
            ("        for (int i = 0; i < RT; ++i) ds[i][c] = st[i][c] * (ds[i][c] - di);\n      }\n"
             "    }",
             "        for (int i = 0; i < RT; ++i) ds[i][c] = st[i][c] * (ds[i][c] - di);\n      }\n"
             "      }\n    }"),
            ("    if (active) tiled::xty_chunks<RT, CT, J, NCH, XS, RS>(acc_k, ds, pbuf, qt + tx, "
             "tx, a0);",
             "    if (STOP >= 5 && active)\n"
             "      tiled::xty_chunks<RT, CT, J, NCH, XS, RS>(acc_k, ds, pbuf, qt + tx, tx, a0);\n"
             "    else if (STOP == 4 && active)\n"
             "      for (int i = 0; i < RT * CT; ++i) acc_k[0][0] += ds[i / CT][i % CT];"),
        ]),
}
TILED_BWD_ENTRY = r"""
template <int STOP>
static int dq_cut(const Args& a, Dims dm, int b, cudaStream_t s) {
  using L = tiled::DqTiles<7>;
  cudaError_t err = cudaFuncSetAttribute(tiled_dq_cut<7, STOP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)L::SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(dm.hq, b, (dm.sq + L::ROWS - 1) / L::ROWS);
  tiled_dq_cut<7, STOP><<<grid, L::THREADS, L::SMEM, s>>>(
      (const float*)a.q, (const float*)a.k, (const float*)a.v, (const float*)a.o,
      (const float*)a.dout, a.lse, a.dvec, (float*)a.dq, dm, true);
  return (int)cudaGetLastError();
}

template <int STOP>
static int dkdv_cut(const Args& a, Dims dm, int b, cudaStream_t s) {
  using L = tiled::DkdvTiles<7>;
  cudaError_t err = cudaFuncSetAttribute(tiled_dkdv_cut<7, STOP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)L::SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(dm.hq / dm.group, b, (dm.sk + L::KEYS - 1) / L::KEYS);
  tiled_dkdv_cut<7, STOP><<<grid, L::THREADS, L::SMEM, s>>>(
      (const float*)a.q, (const float*)a.k, (const float*)a.v, (const float*)a.dout, a.lse,
      a.dvec, (float*)a.dk, (float*)a.dv, dm, true);
  return (int)cudaGetLastError();
}

// kernel 0: dQ (stop 1..3), 1: dK/dV (stop 1..5).  Contiguous fp32 inputs,
// 97 <= d <= 112, the LSE the forward's, D_i as the dQ kernel writes it.
extern "C" int tiled_bwd_split(int kernel, int stop, const void* q, const void* k,
                               const void* v, const void* o, const void* dout, float* lse,
                               float* dvec, void* dq, void* dk, void* dv, int b, int sq, int sk,
                               int hq, int hkv, int d, void* stream) {
  const Args a{q, k, v, o, dout, lse, dvec, dq, dk, dv};
  const Dims dm{sq, sk, hq, hq / hkv, 0, d, 1.0f / sqrtf((float)d)};
  const cudaStream_t s = (cudaStream_t)stream;
  if (kernel == 0)
    return stop == 1 ? dq_cut<1>(a, dm, b, s) : stop == 2 ? dq_cut<2>(a, dm, b, s)
                                                          : dq_cut<3>(a, dm, b, s);
  return stop == 1   ? dkdv_cut<1>(a, dm, b, s)
         : stop == 2 ? dkdv_cut<2>(a, dm, b, s)
         : stop == 3 ? dkdv_cut<3>(a, dm, b, s)
         : stop == 4 ? dkdv_cut<4>(a, dm, b, s)
                     : dkdv_cut<5>(a, dm, b, s);
}
"""


def tiled_split():
    from concurrent.futures import ThreadPoolExecutor

    fa = cs.fa
    fa.build()
    fa.build_bwd()
    with ThreadPoolExecutor(2) as ex:
        fwd_lib, bwd_lib = ex.map(lambda a: build(*a), [
            ("tiled_fwd_splits", split_source("flash_attention.cu", TILED_FWD_SPLITS,
                                              TILED_FWD_ENTRY)),
            ("tiled_bwd_splits", split_source("flash_attention_bwd.cu", TILED_BWD_SPLITS,
                                              TILED_BWD_ENTRY))])
    p, i = ctypes.c_void_p, ctypes.c_int
    fwd_lib.tiled_fwd_split.argtypes = [i, i] + [p] * 4 + [i] * 6 + [p]
    bwd_lib.tiled_bwd_split.argtypes = [i, i] + [p] * 10 + [i] * 6 + [p]
    stream = torch.cuda.current_stream().cuda_stream
    gen = np.random.default_rng(0)

    def checked(err, what):
        if err != 0:
            raise RuntimeError(f"{what}: cudaError_t {err}")

    # the forward
    tag, b, sq, sk, hq, hkv, d, dtype = [s for s in cs.DIMS_FWD_TIMED if s[0] == "fp32-d100"][0]
    q, k, v = cs.card_normal(gen, (b, sq, hq, d), (b, sk, hkv, d), (b, sk, hkv, d), dtype=dtype)
    o = torch.empty_like(q)

    def fwd(variant, stop):
        return lambda: checked(fwd_lib.tiled_fwd_split(
            variant, stop, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, sq, sk,
            hq, hkv, d, stream), f"forward variant {variant} stop {stop}")

    want = fa.launch(q, k, v, 0)
    for variant in range(4):
        fwd(variant, 4)()
        torch.cuda.synchronize()
        log(f"forward variant {variant} whole: equal to the wrapper's output "
            f"{torch.equal(o, want)}, max abs difference {(o - want).abs().max().item()}")
    stops = TILED_FWD_SPLITS["forward"]["stops"]
    runs = {f"forward: {what}": fwd(0, stop) for stop, what in enumerate(stops, 1)}
    runs.update({"forward: 64 rows and 64 keys a tile, two blocks an SM": fwd(1, 4),
                 "forward: exp2f": fwd(2, 4), "forward: both": fwd(3, 4),
                 "forward: the wrapper": lambda: fa.launch(q, k, v, 0),
                 "forward: flash_f32_kernel": lambda: fa.launch(q, k, v, 0, "fp32_simple")})
    nbytes, flops = cs.flash_work(b, sq, sk, hq, hkv, d, 0, 4)
    bound, _ = cs.bound_ms(nbytes, flops, cs.FP32_FLOP_PER_S)
    report(f"gqa_flash {tag} (B={b} S={sq} Hq={hq} Hkv={hkv} D={d} fp32), the tiled forward "
           f"cut after each phase; the bound {bound:.6f} ms", cs.in_turns(runs),
           lambda key, ms: f", {bound / ms:.4f} of the bound")
    del q, k, v, o, want

    # the backward, on the forward's LSE; D_i in place from one dQ run
    tag, b, sq, sk, hq, hkv, d, dtype = [s for s in cs.DIMS_BWD_TIMED if s[0] == "fp32-d100"][0]
    q, k, v, do = cs.card_normal(gen, (b, sq, hq, d), (b, sk, hkv, d), (b, sk, hkv, d),
                                 (b, sq, hq, d), dtype=dtype)
    o, lse = fa.launch(q, k, v, 0, with_lse=True)
    bufs = fa.bwd_buffers(q, k, lse)
    ptrs = [t.data_ptr() for t in (q, k, v, o, do, *bufs)]

    def bwd(kernel, stop):
        return lambda: checked(bwd_lib.tiled_bwd_split(kernel, stop, *ptrs, b, sq, sk, hq, hkv,
                                                       d, stream),
                               f"backward kernel {kernel} stop {stop}")

    want = fa.launch_bwd(q, k, v, o, do, 0, lse=lse)
    bwd(0, 3)()
    bwd(1, len(TILED_BWD_SPLITS["dK/dV"]["stops"]))()
    torch.cuda.synchronize()
    log("backward cuts, whole: equal to the wrapper's gradients "
        f"{all(torch.equal(a, w) for a, w in zip(bufs[2:], want))}")
    runs = {}
    for kernel, (name, sp) in enumerate(TILED_BWD_SPLITS.items()):
        for stop, what in enumerate(sp["stops"], 1):
            runs[f"{name}: {what}"] = bwd(kernel, stop)
    runs.update({"the tiled route (the wrapper)": lambda: fa.launch_bwd(q, k, v, o, do, 0,
                                                                        lse=lse),
                 "the fma route": lambda: fa.launch_bwd(q, k, v, o, do, 0, route="fma")})
    work = cs.bwd_work(b, sq, sk, hq, hkv, d, 0, 4)
    bound, _ = cs.bound_ms(*work["gqa_flash_bwd"], cs.FP32_FLOP_PER_S)
    report(f"gqa_flash_bwd {tag} (B={b} S={sq} Hq={hq} Hkv={hkv} D={d} fp32), the tiled "
           f"kernels cut after each phase; the function's bound {bound:.6f} ms (dQ's three "
           f"products {cs.bound_ms(*work['bwd_tiled_dq'], cs.FP32_FLOP_PER_S)[0]:.6f}, dK/dV's "
           f"four {cs.bound_ms(*work['bwd_tiled_dkdv'], cs.FP32_FLOP_PER_S)[0]:.6f})",
           cs.in_turns(runs))


MMA_BWD_SPLITS = {
    "dQ": dict(
        start="template <typename T, int DP>\n__global__ void __launch_bounds__(WARPS * 32)\n"
              "flash_bwd_dq_mma_kernel(",
        end="// dK/dV: one block per (64 keys, KV head, batch), the first key tiles",
        stops=("staging, D_i and the loads alone", "+ S, dP, P and dS (summed into dQ)",
               "whole kernel"),
        cuts=[
            ("template <typename T, int DP>\n__global__ void __launch_bounds__(WARPS * 32)\n"
             "flash_bwd_dq_mma_kernel(",
             "template <typename T, int DP, int STOP>\n"
             "__global__ void __launch_bounds__(WARPS * 32)\nmma_dq_cut("),
            ("    if (k0 <= first + 15) {        // some row of this warp sees a key of the tile",
             "    if (STOP >= 2 && k0 <= first + 15) {"),
            # a product cut off keeps its inputs alive by summing them into the output
            ("      xb<T, DP>(acc, s, kt, lane);",
             "      if (STOP >= 3) xb<T, DP>(acc, s, kt, lane);\n"
             "      else for (int i = 0; i < 32; ++i) acc[0][0] += s[i / 4][i % 4];"),
        ]),
    "dK/dV": dict(
        start="template <typename T, int DP>\n__global__ void __launch_bounds__(WARPS * 32)\n"
              "flash_bwd_dkdv_mma_kernel(",
        end="enum Kernel { DQ = 0, DKDV = 1 };",
        stops=("K, V and the Q/dO/LSE/D_i loads alone",
               "+ S^T, dP^T, P^T and dS^T (summed into dK, dV)", "whole kernel"),
        cuts=[
            ("template <typename T, int DP>\n__global__ void __launch_bounds__(WARPS * 32)\n"
             "flash_bwd_dkdv_mma_kernel(",
             "template <typename T, int DP, int STOP>\n"
             "__global__ void __launch_bounds__(WARPS * 32)\nmma_dkdv_cut("),
            ("    if (first + ROWS - 1 >= k0 + 16 * warp && k0 + 16 * warp < dm.sk) {",
             "    if (STOP >= 2 && first + ROWS - 1 >= k0 + 16 * warp && k0 + 16 * warp < dm.sk) {"),
            ("      xb<T, DP>(acc_v, st, dot, lane);\n      xb<T, DP>(acc_k, dpt, qt, lane);",
             "      if (STOP >= 3) {\n        xb<T, DP>(acc_v, st, dot, lane);\n"
             "        xb<T, DP>(acc_k, dpt, qt, lane);\n      } else {\n"
             "        for (int i = 0; i < 32; ++i) {\n"
             "          acc_v[0][0] += st[i / 4][i % 4];\n"
             "          acc_k[0][0] += dpt[i / 4][i % 4];\n        }\n      }"),
        ]),
}
MMA_BWD_ENTRY = r"""
template <int STOP>
static int mma_cut(int kernel, const Args& a, Dims dm, int b, cudaStream_t s) {
  using T = __nv_bfloat16;
  constexpr int DP = 32;
  const size_t smem = kernel == 0 ? mm::dq_smem_bytes<DP>() : mm::dkdv_smem_bytes<DP>();
  cudaError_t err;
  if (kernel == 0) {
    err = cudaFuncSetAttribute(mm::mma_dq_cut<T, DP, STOP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((dm.sq + mm::ROWS - 1) / mm::ROWS, dm.hq, b);
    mm::mma_dq_cut<T, DP, STOP><<<grid, mm::WARPS * 32, smem, s>>>(
        (const T*)a.q, (const T*)a.k, (const T*)a.v, (const T*)a.o, (const T*)a.dout, a.lse,
        a.dvec, (T*)a.dq, dm, true);
  } else {
    err = cudaFuncSetAttribute(mm::mma_dkdv_cut<T, DP, STOP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((dm.sk + mm::KEYS - 1) / mm::KEYS, dm.hq / dm.group, b);
    mm::mma_dkdv_cut<T, DP, STOP><<<grid, mm::WARPS * 32, smem, s>>>(
        (const T*)a.q, (const T*)a.k, (const T*)a.v, (const T*)a.dout, a.lse, a.dvec,
        (T*)a.dk, (T*)a.dv, dm, true);
  }
  return (int)cudaGetLastError();
}

// kernel 0: dQ, 1: dK/dV, each cut at stop 1..3.  Contiguous bf16 inputs,
// 17 <= d <= 32 a multiple of 8, the LSE the forward's, D_i as the dQ
// kernel writes it.
extern "C" int mma_bwd_split(int kernel, int stop, const void* q, const void* k,
                             const void* v, const void* o, const void* dout, float* lse,
                             float* dvec, void* dq, void* dk, void* dv, int b, int sq, int sk,
                             int hq, int hkv, int d, void* stream) {
  const Args a{q, k, v, o, dout, lse, dvec, dq, dk, dv};
  const Dims dm{sq, sk, hq, hq / hkv, 0, d, 1.0f / sqrtf((float)d)};
  const cudaStream_t s = (cudaStream_t)stream;
  return stop == 1 ? mma_cut<1>(kernel, a, dm, b, s)
         : stop == 2 ? mma_cut<2>(kernel, a, dm, b, s) : mma_cut<3>(kernel, a, dm, b, s);
}
"""
_NARROW_HEAD = ("template <int D, int DO = D, typename T = __nv_bfloat16>\n__global__ void "
                "__launch_bounds__(RolesOf<D>::THREADS, RolesOf<D>::BLOCKS)\n")
_NARROW_CUT_HEAD = ("template <int D, int DO, typename T, int STOP, class R>\n__global__ void "
                    "__launch_bounds__(R::THREADS, R::BLOCKS)\n")
NARROW_FWD_SPLITS = {
    "forward": dict(
        start=_NARROW_HEAD + "flash_wgmma_kernel(",
        end="// The Hopper kernel on tiles D wide for head dim DO",
        stops=("loads alone (Q, the K/V ring, the barriers and turns)",
               "+ S = Q K^T (summed into O)", "+ the online softmax", "whole kernel"),
        cuts=[
            (_NARROW_HEAD + "flash_wgmma_kernel(", _NARROW_CUT_HEAD + "narrow_fwd_cut("),
            ("  using R = RolesOf<D>;\n", ""),
            ("      qk<D, T>(s, qa, base + L::K + st * L::KV_TILE);",
             "      if constexpr (STOP >= 2) qk<D, T>(s, qa, base + L::K + st * L::KV_TILE);\n"
             "      else for (int i = 0; i < KEYS / 2; ++i) s[i] = 0.f;"),
            ("      softmax<KEYS>(s, m, l, corr, j * KEYS, sk, qpos, first, t, scale_log2);",
             "      if constexpr (STOP >= 3)\n"
             "        softmax<KEYS>(s, m, l, corr, j * KEYS, sk, qpos, first, t, scale_log2);\n"
             "      else corr[0] = corr[1] = 1.f;"),
            # a product cut off keeps its inputs alive by summing them into the output
            ("      pv<D, T>(acc, p, base + L::V + st * L::KV_TILE);",
             "      if constexpr (STOP >= 4) pv<D, T>(acc, p, base + L::V + st * L::KV_TILE);\n"
             "      else for (int i = 0; i < KEYS / 4; ++i) acc[i % (D / 2)] += __uint_as_float(p[i]);"),
        ]),
}
NARROW_FWD_ENTRY = r"""
template <int STOP, class R>
static int narrow_fwd(const void* q, const void* k, const void* v, void* o,
                      const unsigned long long* maps, int b, int sq, int sk, int hq, int hkv,
                      int d, cudaStream_t s) {
  using T = __nv_bfloat16;
  constexpr int D = 32;
  const void* ptrs[3] = {q, k, v};
  CUtensorMap tm[3];
  const int e = hopper::encode_maps(tm, ptrs, 3, maps, d, hopper::keys_of(d));
  if (e != 0) return e;
  const size_t smem = hopper::Layout<D>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(hopper::narrow_fwd_cut<D, 0, T, STOP, R>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(hq, b, (sq + hopper::ROWS - 1) / hopper::ROWS);
  hopper::narrow_fwd_cut<D, 0, T, STOP, R><<<grid, R::THREADS, smem, s>>>(
      tm[0], tm[1], tm[2], (T*)o, nullptr, sq, sk, hq, hq / hkv, 0, d,
      1.4426950408889634f / sqrtf((float)d));
  return (int)cudaGetLastError();
}

// variant 0: the shipped layout (no producer, two blocks an SM) cut at stop
// 1..4; 1: the producer warpgroup and two consumers, one block an SM
// (Roles<false>), whole.  bf16, 17 <= d <= 32 a multiple of 8, the maps
// the wrapper plans.
extern "C" int narrow_fwd_split(int variant, int stop, const void* q, const void* k,
                                const void* v, void* o, const unsigned long long* maps, int b,
                                int sq, int sk, int hq, int hkv, int d, void* stream) {
  using N = hopper::RolesOf<32>;
  using P = hopper::Roles<false, 1>;
  const cudaStream_t s = (cudaStream_t)stream;
  if (variant == 1) return narrow_fwd<4, P>(q, k, v, o, maps, b, sq, sk, hq, hkv, d, s);
  return stop == 1   ? narrow_fwd<1, N>(q, k, v, o, maps, b, sq, sk, hq, hkv, d, s)
         : stop == 2 ? narrow_fwd<2, N>(q, k, v, o, maps, b, sq, sk, hq, hkv, d, s)
         : stop == 3 ? narrow_fwd<3, N>(q, k, v, o, maps, b, sq, sk, hq, hkv, d, s)
                     : narrow_fwd<4, N>(q, k, v, o, maps, b, sq, sk, hq, hkv, d, s);
}
"""
NARROW_BWD_SPLITS = {
    "dQ": dict(
        start=_NARROW_HEAD + "flash_bwd_dq_wgmma_kernel(",
        end="// dK/dV: one block per (64 keys, KV head, batch), the first key tiles (which",
        stops=("staging, D_i and the loads alone", "+ S, dP, P and dS (summed into dQ)",
               "whole kernel"),
        cuts=[
            (_NARROW_HEAD + "flash_bwd_dq_wgmma_kernel(", _NARROW_CUT_HEAD + "narrow_dq_cut("),
            ("  using R = RolesOf<D>;\n", ""),
            ("      if (k0 > first + 63) {          // no row of this consumer sees a key of the tile",
             "      if (STOP < 2 || k0 > first + 63) {"),
            ("      rs_product<D, L::Keys::BOX_STRIDE, T, KEYS>(acc, ds, kt);",
             "      if constexpr (STOP >= 3) rs_product<D, L::Keys::BOX_STRIDE, T, KEYS>(acc, ds, kt);\n"
             "      else for (int i = 0; i < KEYS / 4; ++i) acc[i % (D / 2)] += __uint_as_float(ds[i]);"),
        ]),
    "dK/dV": dict(
        start=_NARROW_HEAD + "flash_bwd_dkdv_wgmma_kernel(",
        end="enum Kernel { DQ = 0, DKDV = 1 };",
        stops=("the loads, and P^T, dS^T and their exchange on zero scores",
               "+ S^T and dP^T (summed into dK, dV)", "whole kernel"),
        cuts=[
            (_NARROW_HEAD + "flash_bwd_dkdv_wgmma_kernel(", _NARROW_CUT_HEAD + "narrow_dkdv_cut("),
            ("  using R = RolesOf<D>;\n", ""),
            ("      ss_product<D, L::Keys::BOX_STRIDE, L::Rows::BOX_STRIDE, T>(s, a_op, c == 0 ? qt : dot);",
             "      if constexpr (STOP >= 2)\n"
             "        ss_product<D, L::Keys::BOX_STRIDE, L::Rows::BOX_STRIDE, T>(s, a_op, c == 0 ? qt : dot);\n"
             "      else for (int i = 0; i < 32; ++i) s[i] = 0.f;"),
            ("      rs_product<D, L::Rows::BOX_STRIDE, T>(acc, a, c == 0 ? dot : qt);",
             "      if constexpr (STOP >= 3) rs_product<D, L::Rows::BOX_STRIDE, T>(acc, a, c == 0 ? dot : qt);\n"
             "      else for (int i = 0; i < 16; ++i) acc[i % (D / 2)] += __uint_as_float(a[i]);"),
        ]),
}
NARROW_BWD_ENTRY = r"""
template <int STOP, class R>
static int narrow_bwd(int kernel, const void* const* ptrs, const void* o, const float* lse,
                      float* dvec, void* dq, void* dk, void* dv, const unsigned long long* maps,
                      int b, int sq, int sk, int hq, int hkv, int d, cudaStream_t s) {
  using T = __nv_bfloat16;
  constexpr int D = 32;
  CUtensorMap tm[4];
  const int e = hopper::encode_maps(tm, ptrs, 4, maps, d, wg::BOX_ROWS);
  if (e != 0) return e;
  const float scale = 1.0f / sqrtf((float)d), scale_log2 = scale * wg::LOG2E;
  cudaError_t err;
  if (kernel == 0) {
    const size_t smem = wg::DqLayout<D>::SMEM;
    err = cudaFuncSetAttribute(wg::narrow_dq_cut<D, 0, T, STOP, R>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid(hq, b, (sq + wg::DQ_ROWS - 1) / wg::DQ_ROWS);
    wg::narrow_dq_cut<D, 0, T, STOP, R><<<grid, R::THREADS, smem, s>>>(
        tm[0], tm[1], tm[2], tm[3], (const T*)o, (const T*)ptrs[3], lse, dvec, (T*)dq, sq, sk,
        hq, hq / hkv, 0, d, scale_log2, scale);
  } else {
    const size_t smem = wg::KvLayout<D>::SMEM;
    err = cudaFuncSetAttribute(wg::narrow_dkdv_cut<D, 0, T, STOP, R>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid(hkv, b, (sk + wg::KV_KEYS - 1) / wg::KV_KEYS);
    wg::narrow_dkdv_cut<D, 0, T, STOP, R><<<grid, R::THREADS, smem, s>>>(
        tm[0], tm[1], tm[2], tm[3], lse, dvec, (T*)dk, (T*)dv, sq, sk, hq, hq / hkv, 0, d,
        scale_log2, scale);
  }
  return (int)cudaGetLastError();
}

// kernel 0: dQ, 1: dK/dV; variant 0: the shipped layout (no producer, two
// blocks an SM) cut at stop 1..3; 1: the producer warpgroup and two
// consumers, one block an SM (Roles<false>), whole.  bf16, 17 <= d <= 32 a
// multiple of 8, the maps the wrapper plans, the LSE the forward's, D_i as
// the dQ kernel writes it.
extern "C" int narrow_bwd_split(int kernel, int variant, int stop, const void* q,
                                const void* k, const void* v, const void* o, const void* dout,
                                float* lse, float* dvec, void* dq, void* dk, void* dv,
                                const unsigned long long* maps, int b, int sq, int sk, int hq,
                                int hkv, int d, void* stream) {
  using N = hopper::RolesOf<32>;
  using P = hopper::Roles<false, 1>;
  const void* ptrs[4] = {q, k, v, dout};
  const cudaStream_t s = (cudaStream_t)stream;
  if (variant == 1)
    return narrow_bwd<3, P>(kernel, ptrs, o, lse, dvec, dq, dk, dv, maps, b, sq, sk, hq, hkv, d, s);
  return stop == 1   ? narrow_bwd<1, N>(kernel, ptrs, o, lse, dvec, dq, dk, dv, maps, b, sq, sk,
                                        hq, hkv, d, s)
         : stop == 2 ? narrow_bwd<2, N>(kernel, ptrs, o, lse, dvec, dq, dk, dv, maps, b, sq, sk,
                                        hq, hkv, d, s)
                     : narrow_bwd<3, N>(kernel, ptrs, o, lse, dvec, dq, dk, dv, maps, b, sq, sk,
                                        hq, hkv, d, s);
}
"""
# bf16 D 32 at chip_smoke.py's timed shape (B 4, S 2048, Hq 16, Hkv 8): the
# narrow tiles' widest, train_carbon_aware's 10m preset
NARROW_SHAPE = ("bf16-d32", 4, 2048, 2048, 16, 8, 32, torch.bfloat16)


def narrow_inputs(gen):
    """bf16 D 32 q, k, v, dO at NARROW_SHAPE, the forward's output and LSE."""
    fa = cs.fa
    _, b, sq, sk, hq, hkv, d, dtype = NARROW_SHAPE
    q, k, v, do = cs.card_normal(gen, (b, sq, hq, d), (b, sk, hkv, d), (b, sk, hkv, d),
                                 (b, sq, hq, d), dtype=dtype)
    o, lse = fa.launch(q, k, v, 0, with_lse=True)
    return q, k, v, do, o, lse


def bwd_cut_runs(splits, call, bufs, want):
    """Each backward kernel's cut at every stop (the whole cuts first held
    equal to the wrapper's gradients ``want``), by name."""
    for kernel, sp in enumerate(splits.values()):
        call(kernel, len(sp["stops"]))()
    torch.cuda.synchronize()
    log("backward cuts, whole: equal to the wrapper's gradients "
        f"{all(torch.equal(a, w) for a, w in zip(bufs[2:], want))}")
    return {f"{name}: {what}": call(kernel, stop)
            for kernel, (name, sp) in enumerate(splits.items())
            for stop, what in enumerate(sp["stops"], 1)}


def mma_split():
    """The mma pair (the yardstick of the narrow wgmma backward) at bf16 D
    32, each kernel cut after its phases, beside the whole route and the
    narrow wgmma pair, by profiler device time in turns."""
    fa = cs.fa
    fa.build()
    fa.build_bwd()
    lib = build("mma_bwd_splits", split_source("flash_attention_bwd.cu", MMA_BWD_SPLITS,
                                               MMA_BWD_ENTRY, close="}  // namespace mm"))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.mma_bwd_split.argtypes = [i, i] + [p] * 10 + [i] * 6 + [p]
    stream = torch.cuda.current_stream().cuda_stream
    q, k, v, do, o, lse = narrow_inputs(np.random.default_rng(0))
    tag, b, sq, sk, hq, hkv, d, _ = NARROW_SHAPE
    bufs = fa.bwd_buffers(q, k, lse)
    ptrs = [t.data_ptr() for t in (q, k, v, o, do, *bufs)]

    def cut(kernel, stop):
        def run():
            err = lib.mma_bwd_split(kernel, stop, *ptrs, b, sq, sk, hq, hkv, d, stream)
            if err != 0:
                raise RuntimeError(f"mma kernel {kernel} stop {stop}: cudaError_t {err}")
        return run

    want = fa.launch_bwd(q, k, v, o, do, 0, lse=lse, route="mma")
    runs = bwd_cut_runs(MMA_BWD_SPLITS, cut, bufs, want)
    runs.update({"the mma route (the wrapper)":
                 lambda: fa.launch_bwd(q, k, v, o, do, 0, lse=lse, route="mma"),
                 "the narrow wgmma route": lambda: fa.launch_bwd(q, k, v, o, do, 0, lse=lse)})
    work = cs.bwd_work(b, sq, sk, hq, hkv, d, 0, 2)
    bound, _ = cs.bound_ms(*work["gqa_flash_bwd"], cs.BF16_FLOP_PER_S)
    scores = b * hq * sum(min(sk, r + 1) for r in range(sq))
    report(f"gqa_flash_bwd {tag} (B={b} S={sq} Hq={hq} Hkv={hkv} D={d} bf16), the mma "
           f"kernels cut after each phase; the function's bound {bound:.6f} ms, the "
           f"exponentials' floor {2 * scores / cs.EXP2_PER_S * 1e3:.6f} ms (one a score in "
           f"each kernel)", cs.in_turns(runs))


def narrow_split():
    """The narrow wgmma kernels at bf16 D 32, each cut after its phases, and
    the layout they replaced (a producer warpgroup, one block an SM), beside
    the wrappers and the yardsticks, by profiler device time in turns."""
    from concurrent.futures import ThreadPoolExecutor

    fa = cs.fa
    fa.build()
    fa.build_bwd()
    with ThreadPoolExecutor(2) as ex:
        fwd_lib, bwd_lib = ex.map(lambda a: build(*a), [
            ("narrow_fwd_splits", split_source("flash_attention.cu", NARROW_FWD_SPLITS,
                                               NARROW_FWD_ENTRY, close="}  // namespace hopper")),
            ("narrow_bwd_splits", split_source("flash_attention_bwd.cu", NARROW_BWD_SPLITS,
                                               NARROW_BWD_ENTRY, close="}  // namespace wg"))])
    p, i = ctypes.c_void_p, ctypes.c_int
    fwd_lib.narrow_fwd_split.argtypes = [i, i] + [p] * 5 + [i] * 6 + [p]
    bwd_lib.narrow_bwd_split.argtypes = [i, i, i] + [p] * 11 + [i] * 6 + [p]
    stream = torch.cuda.current_stream().cuda_stream
    q, k, v, do, o, lse = narrow_inputs(np.random.default_rng(0))
    tag, b, sq, sk, hq, hkv, d, _ = NARROW_SHAPE
    scores = b * hq * sum(min(sk, r + 1) for r in range(sq))
    floor = scores / cs.EXP2_PER_S * 1e3

    def maps_of(values):
        return (ctypes.c_ulonglong * len(values))(*values)

    fmaps = maps_of(fa.plan(q, k, v).maps)
    out = torch.empty_like(q)

    def fwd(variant, stop):
        def run():
            err = fwd_lib.narrow_fwd_split(variant, stop, q.data_ptr(), k.data_ptr(),
                                           v.data_ptr(), out.data_ptr(), fmaps, b, sq, sk, hq,
                                           hkv, d, stream)
            if err != 0:
                raise RuntimeError(f"forward variant {variant} stop {stop}: error {err}")
        return run

    for variant in range(2):
        fwd(variant, 4)()
        torch.cuda.synchronize()
        log(f"forward variant {variant} whole: equal to the wrapper's output "
            f"{torch.equal(out, o)}, max abs difference {(out - o).abs().max().item()}")
    stops = NARROW_FWD_SPLITS["forward"]["stops"]
    runs = {f"forward: {what}": fwd(0, stop) for stop, what in enumerate(stops, 1)}
    runs.update({"forward: a producer warpgroup, one block an SM": fwd(1, 4),
                 "forward: the wrapper": lambda: fa.launch(q, k, v, 0, with_lse=True),
                 "forward: mma.sync": lambda: fa.launch(q, k, v, 0, "mma_sync", with_lse=True)})
    nbytes, flops = cs.flash_work(b, sq, sk, hq, hkv, d, 0, 2)
    bound, _ = cs.bound_ms(nbytes, flops, cs.BF16_FLOP_PER_S)
    report(f"gqa_flash {tag} (B={b} S={sq} Hq={hq} Hkv={hkv} D={d} bf16), the narrow forward "
           f"cut after each phase; the bound {bound:.6f} ms, the exponentials' floor "
           f"{floor:.6f} ms", cs.in_turns(runs))

    bmaps = maps_of(fa.plan_bwd(q, k, v, o, do).maps)
    bufs = fa.bwd_buffers(q, k, lse)
    ptrs = [t.data_ptr() for t in (q, k, v, o, do, *bufs)]

    def bwd(kernel, stop, variant=0):
        def run():
            err = bwd_lib.narrow_bwd_split(kernel, variant, stop, *ptrs, bmaps, b, sq, sk, hq,
                                           hkv, d, stream)
            if err != 0:
                raise RuntimeError(f"backward kernel {kernel} variant {variant} stop {stop}: "
                                   f"error {err}")
        return run

    want = fa.launch_bwd(q, k, v, o, do, 0, lse=lse)
    runs = bwd_cut_runs(NARROW_BWD_SPLITS, bwd, bufs, want)
    for kernel in range(2):
        bwd(kernel, 3, variant=1)()
    torch.cuda.synchronize()
    log("backward, a producer warpgroup, one block an SM: equal to the wrapper's gradients "
        f"{all(torch.equal(a, w) for a, w in zip(bufs[2:], want))}")
    runs.update({"dQ: a producer warpgroup, one block an SM": bwd(0, 3, 1),
                 "dK/dV: a producer warpgroup, one block an SM": bwd(1, 3, 1),
                 "the narrow wgmma route (the wrapper)":
                     lambda: fa.launch_bwd(q, k, v, o, do, 0, lse=lse),
                 "the mma route": lambda: fa.launch_bwd(q, k, v, o, do, 0, lse=lse,
                                                        route="mma")})
    work = cs.bwd_work(b, sq, sk, hq, hkv, d, 0, 2)
    bound, _ = cs.bound_ms(*work["gqa_flash_bwd"], cs.BF16_FLOP_PER_S)
    report(f"gqa_flash_bwd {tag} (B={b} S={sq} Hq={hq} Hkv={hkv} D={d} bf16), the narrow "
           f"kernels cut after each phase; the function's bound {bound:.6f} ms, the "
           f"exponentials' floor {2 * floor:.6f} ms", cs.in_turns(runs))


def checkout_flash(root: str):
    """``repro_torch.kernels.flash_attention`` of the checkout at ``root``,
    imported beside this checkout's: the package's modules leave
    ``sys.modules`` for the import and come back after it, so each module
    keeps its own ``_build``, which builds its own checkout's sources into
    that checkout's ``build/``."""
    def package():
        return [n for n in sys.modules if n == "repro_torch" or n.startswith("repro_torch.")]

    saved = {n: sys.modules.pop(n) for n in package()}
    sys.path.insert(0, os.path.join(os.path.abspath(root), "src"))
    try:
        return importlib.import_module("repro_torch.kernels.flash_attention")
    finally:
        sys.path.pop(0)
        for n in package():
            del sys.modules[n]
        sys.modules.update(saved)


def flash_split(against: str):
    theirs = checkout_flash(against)
    mods = {"against": theirs, "this": cs.fa}
    for m in mods.values():
        m.build()
        m.build_bwd()
    gen = np.random.default_rng(0)
    shapes = [(s, False) for s in [*cs.DIMS_FWD_TIMED, cs.DIMS_D192_TIMED[0]]] \
        + [(s, True) for s in [*cs.DIMS_BWD_TIMED, cs.DIMS_D192_TIMED[1]]]
    for (tag, b, sq, sk, hq, hkv, d, dtype), backward in shapes:
        what = f"gqa_flash{'_bwd' if backward else ''} {tag} (B={b} S={sq} Hq={hq} Hkv={hkv})"
        routes = {key: (m.bwd_route if backward else m.route)(dtype, d)
                  for key, m in mods.items()}
        if routes["against"] != routes["this"]:
            log(f"{what}: routes differ {routes}, not compared")
            continue
        q, k, v = cs.flash_inputs(gen, b, sq, sk, hq, hkv, d, dtype)
        do = torch.from_numpy(gen.normal(size=q.shape).astype(np.float32)).to("cuda", dtype)
        half = dtype in (torch.bfloat16, torch.float16)

        def call(m):
            if not backward:
                return lambda: m.launch(q, k, v, 0)
            o, lse = m.launch(q, k, v, 0, with_lse=True) if routes["this"] != "fma" \
                else (m.launch(q, k, v, 0), None)
            return lambda: m.launch_bwd(q, k, v, o, do, 0, lse=lse)

        fns = {key: call(m) for key, m in mods.items()}
        outs = {key: fn() for key, fn in fns.items()}
        outs = {key: out if backward else (out,) for key, out in outs.items()}
        diff = max((a.float() - t.float()).abs().max().item()
                   for a, t in zip(outs["against"], outs["this"]))
        del outs
        iters = 3 if routes["this"] == "fma" else 10 if backward or not half else 20
        turns, _ = cs.in_turns_ms({key: (fn, iters, 2) for key, fn in fns.items()})
        report(f"{what} on {routes['this']}: ms a call, CUDA events, {iters} calls a turn; "
               f"outputs differ by up to {diff}", turns)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("splits", nargs="*",
                    help="score, knn, geo, fill (the default), tiled, mma, narrow, flash")
    ap.add_argument("--against", help="the root of the checkout the flash split compares")
    args = ap.parse_args()
    splits = dict(score=score_split, knn=knn_split, geo=geo_split, fill=fill_split,
                  tiled=tiled_split, mma=mma_split, narrow=narrow_split,
                  flash=lambda: flash_split(args.against))
    if set(args.splits) - set(splits):
        ap.error(f"unknown splits {sorted(set(args.splits) - set(splits))}")
    if "flash" in args.splits and not args.against:
        ap.error("the flash split needs --against ROOT")
    log(f"card: {cs.card_line()}")
    for name in args.splits or ["score", "knn", "geo", "fill"]:
        splits[name]()


if __name__ == "__main__":
    main()
