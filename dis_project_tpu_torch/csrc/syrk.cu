// Lower-triangle SYRK C = tril(Li^T Li) for a lower-triangular f32 Li, on
// Hopper (sm_90a), with split 3xTF32 products on the tensor cores (wgmma).
//
// Replaces, from the JAX package:
//   K3  dis_project_tpu/ops/pallas_cholesky.py::_syrk_kernel  (syrk_ltl_tril)
//
// It forms tril(Sigma^{-1}) = tril(L^{-T} L^{-1}) in the backward pass of the
// exact MLL (ops/mll.py). Li is n x n, row-major, zero above its diagonal.
//
// Work: C[a][b] = sum_{k >= max(a, b)} Li[k][a] Li[k][b], so only the lower
// output tiles (i >= j) are computed and the reduction over k starts at tile
// row i: about n^3 / 3 FLOPs, a sixth of the dense product. As on the TPU,
// the tile triples (i >= j, k >= i) are exactly the ones the triangular
// structure needs; here the (i, j) pairs are the grid and the k loop runs
// inside each block.
//
// What bounds it on the H100: arithmetic. FP32 outside the tensor cores
// (67 TFLOP/s) stops at ~5 ms for n = 1e4; only the tensor cores go below.
// Single-pass TF32 keeps 10 mantissa bits and is not allowed (factorisation
// products stay f32-faithful). So every operand is split, as the TPU
// kernel splits into bf16 (pallas_cholesky.py::_syrk_kernel):
// hi = tf32(x), lo = tf32(x - hi), both rounded to nearest (away) by
// cvt.rna.tf32.f32 written in PTX, so the compiler cannot fold the round
// trip; the products lo*hi + hi*lo + hi*hi accumulate in FP32, small terms
// first. Three passes of 3.3e11 FLOPs at 495 TFLOP/s: a 2.0 ms bound.
//
// Design. A CTA of two warpgroups computes a 128 x 128 output tile, each
// warpgroup 64 rows with wgmma.m64n128k8 (TF32). wgmma takes tf32 operands
// only K-major, and both operands here are row slices of Li (contiguous
// along M/N, not along k), so:
// - 32-deep k slices of both operands stream into a 3-stage ring of raw
//   float32 tiles by cp.async (16-byte copies when n % 4 == 0, 4-byte
//   otherwise; zero-filled past the edge), loads overlapping the products;
// - B (columns b) is split once per slice and written K-major into two
//   planes (hi, lo) in wgmma's no-swizzle core-matrix layout: 8 rows x 16
//   bytes per core matrix, K-adjacent ones 128 bytes apart (LBO), 8-row
//   groups 256 bytes apart (SBO). Each thread reads 4 consecutive k of one
//   column and stores each plane's 16 bytes at once;
// - A (rows a) goes to wgmma from registers: each thread reads its fragment
//   elements from the raw tile and splits them there.
// Per slice, each warpgroup issues the 8 small products (lo*hi, hi*lo) and
// then the 4 large ones (hi*hi) into a fresh accumulator, and adds it into
// the running sum with FP32 adds after the group completes: the tensor
// cores' truncating accumulation then touches a large value 4 times a
// slice, and never the whole k range.
//
// Order: the grid enumerates lower tiles row by row (np.tril_indices
// order). Tile row i runs k from 128 i to n, so the first blocks carry the
// longest loops, and the block scheduler hands out blocks in index order:
// longest first, without a persistent loop.
//
// The kernel writes only the lower tiles, and inside diagonal tiles only
// their lower half; the caller supplies C zero-filled. It launches on the
// given stream, allocates nothing and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>
#include <math.h>

#include "kernel_attrs.cuh"

namespace {

constexpr int BM = 128;                   // output tile edge
constexpr int BK = 32;                    // k slice depth
constexpr int K8 = BK / 8;                // wgmma k steps a slice
constexpr int STAGES = 3;                 // raw cp.async ring depth
constexpr int LDS = BM + 8;               // raw row stride, floats
constexpr int THREADS = 256;              // two warpgroups
constexpr int RAW_FLOATS = 2 * BK * LDS;  // A and B raw slices
constexpr int PLANE_FLOATS = BK * BM;     // one split plane of a B slice
constexpr int SMEM_BYTES = (2 * PLANE_FLOATS + STAGES * RAW_FLOATS) * (int)sizeof(float);

__device__ __forceinline__ void tril_tile(long long b, int* i_out, int* j_out) {
  int i = (int)((sqrt(8.0 * (double)b + 1.0) - 1.0) * 0.5);
  while ((long long)i * (i + 1) / 2 > b) --i;
  while ((long long)(i + 1) * (i + 2) / 2 <= b) ++i;
  *i_out = i;
  *j_out = (int)(b - (long long)i * (i + 1) / 2);
}

// Asynchronous copy global -> shared of 16 or 4 bytes; src_bytes 0 fills
// the destination with zeros and reads nothing.
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Round to TF32 (10 mantissa bits), to nearest, ties away from zero.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// wgmma shared-memory descriptor, no swizzle: start, LBO, SBO in 16 bytes.
__device__ __forceinline__ uint64_t smem_desc(const float* p, uint32_t lbo, uint32_t sbo) {
  const uint64_t addr = (uint64_t)__cvta_generic_to_shared(p);
  return ((addr >> 4) & 0x3FFF) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous wgmma's issue and completion.
__device__ __forceinline__ void fence_regs(float (&d)[64]) {
#pragma unroll
  for (int e = 0; e < 64; ++e) asm volatile("" : "+f"(d[e])::"memory");
}

// d (+)= A * B for a 64 x 128 x 8 TF32 product: A from registers (lane
// 4 g + t of warp w holds A[16w + g][t], A[16w + g + 8][t], A[16w + g][t + 4],
// A[16w + g + 8][t + 4]), B from shared memory through its descriptor; d
// zeroed first when accumulate is 0. d[4 j + e] is D[16w + g + 8 (e / 2)]
// [8 j + 2 t + e % 2].
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], const uint32_t (&a)[4], uint64_t desc,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
}

// Stage k slice [k0, k0 + BK) of the A columns [a0, a0 + BM) and B columns
// [b0, b0 + BM) of Li into one ring slot: As[k][m], Bs[k][n].
template <bool VEC>
__device__ __forceinline__ void load_slice(float* As, float* Bs, const float* __restrict__ Li,
                                           int n, int k0, int a0, int b0, int tid) {
  if (VEC) {
#pragma unroll
    for (int c = tid; c < BK * BM / 4; c += THREADS) {
      const int kk = c / (BM / 4);
      const int col = (c % (BM / 4)) * 4;
      const int k = k0 + kk;
      const size_t base = (size_t)k * n;
      const bool ka = k < n;
      cp_async16(As + kk * LDS + col, ka && a0 + col < n ? Li + base + a0 + col : Li,
                 ka && a0 + col < n);
      cp_async16(Bs + kk * LDS + col, ka && b0 + col < n ? Li + base + b0 + col : Li,
                 ka && b0 + col < n);
    }
  } else {
#pragma unroll 4
    for (int c = tid; c < BK * BM; c += THREADS) {
      const int kk = c / BM;
      const int col = c % BM;
      const int k = k0 + kk;
      const size_t base = (size_t)k * n;
      const bool ka = k < n;
      cp_async4(As + kk * LDS + col, ka && a0 + col < n ? Li + base + a0 + col : Li,
                ka && a0 + col < n);
      cp_async4(Bs + kk * LDS + col, ka && b0 + col < n ? Li + base + b0 + col : Li,
                ka && b0 + col < n);
    }
  }
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS, 1)
syrk_ltl_tril_kernel(const float* __restrict__ Li, int n, float* __restrict__ C) {
  extern __shared__ __align__(128) float smem[];
  // The hi and lo planes of B, then the raw ring. A plane holds K8 blocks
  // of [16 column groups][2 k halves][8 columns][4 k] floats.
  float* hi_plane = smem;
  float* lo_plane = smem + PLANE_FLOATS;
  float* raw = smem + 2 * PLANE_FLOATS;
  int i, j;
  tril_tile(blockIdx.x, &i, &j);
  const int a0 = i * BM;
  const int b0 = j * BM;
  const int tid = threadIdx.x;
  const int wg = tid / 128;           // warpgroup: rows 64 wg .. 64 wg + 63
  const int warp = (tid % 128) / 32;  // warp in the warpgroup
  const int lane = tid % 32;
  const int g = lane >> 2;
  const int t = lane & 3;

  float acc[64], part[64];
#pragma unroll
  for (int e = 0; e < 64; ++e) acc[e] = part[e] = 0.f;

  // Li[k][a] = 0 for k < a, and every a of this tile is >= a0 >= b0.
  const int nslices = (n - a0 + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nslices) {
      float* As = raw + s * RAW_FLOATS;
      load_slice<VEC>(As, As + BK * LDS, Li, n, a0 + s * BK, a0, b0, tid);
    }
    cp_async_commit();
  }

  for (int s = 0; s < nslices; ++s) {
    cp_async_wait<STAGES - 2>();
    // Slice s has landed; slice s - 1's ring slot and the planes are free
    // (each warpgroup waited for its products of slice s - 1).
    __syncthreads();
    const int next = s + STAGES - 1;
    if (next < nslices) {
      float* As = raw + (next % STAGES) * RAW_FLOATS;
      load_slice<VEC>(As, As + BK * LDS, Li, n, a0 + next * BK, a0, b0, tid);
    }
    cp_async_commit();

    const float* As = raw + (s % STAGES) * RAW_FLOATS;
    const float* Bs = As + BK * LDS;
    // B: split and store K-major (4 consecutive k of one column a thread).
#pragma unroll
    for (int q = tid; q < BK / 4 * BM; q += THREADS) {
      const int col = q % BM;
      const int kq = q / BM;  // k = 4 kq .. 4 kq + 3
      uint32_t h[4], l[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) split(Bs[(4 * kq + e) * LDS + col], h[e], l[e]);
      const int off = (kq / 2) * (BM * 8) + (col / 8) * 64 + (kq % 2) * 32 + (col % 8) * 4;
      *reinterpret_cast<uint4*>(hi_plane + off) = make_uint4(h[0], h[1], h[2], h[3]);
      *reinterpret_cast<uint4*>(lo_plane + off) = make_uint4(l[0], l[1], l[2], l[3]);
    }
    // A: this thread's fragments of the K8 steps, split in registers.
    uint32_t ahi[K8][4], alo[K8][4];
    const float* Aw = As + wg * 64 + warp * 16 + g;
#pragma unroll
    for (int k8 = 0; k8 < K8; ++k8) {
      const float* Ak = Aw + (8 * k8 + t) * LDS;
      split(Ak[0], ahi[k8][0], alo[k8][0]);
      split(Ak[8], ahi[k8][1], alo[k8][1]);
      split(Ak[4 * LDS], ahi[k8][2], alo[k8][2]);
      split(Ak[4 * LDS + 8], ahi[k8][3], alo[k8][3]);
    }
    // The generic-proxy stores above must be visible to wgmma's reads.
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();

    fence_regs(part);
    wgmma_fence();
#pragma unroll
    for (int k8 = 0; k8 < K8; ++k8)
      wgmma_tf32(part, alo[k8], smem_desc(hi_plane + k8 * BM * 8, 128, 256), k8 > 0);
#pragma unroll
    for (int k8 = 0; k8 < K8; ++k8)
      wgmma_tf32(part, ahi[k8], smem_desc(lo_plane + k8 * BM * 8, 128, 256), 1);
#pragma unroll
    for (int k8 = 0; k8 < K8; ++k8)
      wgmma_tf32(part, ahi[k8], smem_desc(hi_plane + k8 * BM * 8, 128, 256), 1);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(part);
#pragma unroll
    for (int e = 0; e < 64; ++e) acc[e] += part[e];
  }
  cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = a0 + wg * 64 + warp * 16 + g + 8 * h;
    if (row >= n) continue;
#pragma unroll
    for (int jn = 0; jn < BM / 8; ++jn) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = b0 + 8 * jn + 2 * t + e;
        if (col < n && col <= row) C[(size_t)row * n + col] = acc[4 * jn + 2 * h + e];
      }
    }
  }
}

template <bool VEC>
int launch(const float* Li, int n, float* C, cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      syrk_ltl_tril_kernel<VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const long long nt = (n + BM - 1) / BM;
  const unsigned blocks = (unsigned)(nt * (nt + 1) / 2);
  syrk_ltl_tril_kernel<VEC><<<blocks, THREADS, SMEM_BYTES, stream>>>(Li, n, C);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int syrk_ltl_tril_f32(const float* Li, int n, float* C, cudaStream_t stream) {
  if (n <= 0) return (int)cudaGetLastError();
  // 16-byte copies need every row start 16-byte aligned.
  if (n % 4 == 0 && reinterpret_cast<uintptr_t>(Li) % 16 == 0)
    return launch<true>(Li, n, C, stream);
  return launch<false>(Li, n, C, stream);
}

// Kernel `which` (0: K3 with 16-byte copies, 1: with 4-byte copies) for
// chip_smoke.py: its name into *name, its registers, local and static
// shared bytes into attrs[0..2]; -1 past the last kernel.
extern "C" int kernel_attrs(int which, const char** name, int* attrs) {
  switch (which) {
    case 0: *name = "syrk_ltl_tril_kernel<16-byte copies>";
      return func_attrs(syrk_ltl_tril_kernel<true>, attrs);
    case 1: *name = "syrk_ltl_tril_kernel<4-byte copies>";
      return func_attrs(syrk_ltl_tril_kernel<false>, attrs);
    default: return -1;
  }
}
