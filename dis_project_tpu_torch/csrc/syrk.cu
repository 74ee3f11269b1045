// Lower-triangle SYRK C = tril(Li^T Li) for a lower-triangular f32 Li, on
// Hopper (sm_90a).
//
// Replaces, from the JAX package:
//   K3  dis_project_tpu/ops/pallas_cholesky.py::_syrk_kernel  (syrk_ltl_tril)
//
// It forms tril(Sigma^{-1}) = tril(L^{-T} L^{-1}) in the backward pass of the
// exact MLL (ops/mll.py). Li is n x n, row-major, zero above its diagonal.
//
// Work: C[a][b] = sum_{k >= max(a, b)} Li[k][a] Li[k][b], so only the lower
// output tiles (i >= j) are computed and the reduction over k starts at tile
// row i -- about n^3 / 3 FLOPs, a sixth of the dense product. As on the TPU,
// the tile triples (i >= j, k >= i) are exactly the ones the triangular
// structure needs; here the (i, j) pairs are the grid and the k loop runs
// inside each block (blocks run in parallel, in no order, so no accumulator
// carries between them).
//
// What bounds it on the H100: arithmetic. n = 1e4 needs ~3.3e11 FLOPs, ~5 ms
// at the 67 TFLOP/s FP32 (non-tensor-core) peak, against ~0.6 GB of traffic
// (0.2 ms). Products are plain FP32 FMAs: the split-bf16 3-pass trick of the
// TPU kernel is not carried over, and single-pass TF32 is not allowed (it
// NaN'd the factorisation of real Grams in its bf16 form on the TPU). The
// design is a classic register-tiled SGEMM: a 64 x 64 output tile per block,
// 16-deep k slices of both operands staged in shared memory with coalesced
// loads (both operands are row slices of Li, since the product contracts
// over rows), and a 4 x 4 register block of accumulators per thread fed by
// 128-bit shared loads. wgmma/TMA with 3xTF32 products is later work.
//
// The kernel writes only the lower tiles (zeros above the diagonal inside
// diagonal tiles); the caller supplies C zero-filled. It launches on the
// given stream, allocates nothing and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>

#include "kernel_attrs.cuh"

namespace {

constexpr int BM = 64;   // output tile edge
constexpr int BK = 16;   // k slice depth
constexpr int TM = 4;    // per-thread register block edge
constexpr int THREADS = (BM / TM) * (BM / TM);  // 256

__device__ __forceinline__ void tril_tile(long long b, int* i_out, int* j_out) {
  int i = (int)((sqrt(8.0 * (double)b + 1.0) - 1.0) * 0.5);
  while ((long long)i * (i + 1) / 2 > b) --i;
  while ((long long)(i + 1) * (i + 2) / 2 <= b) ++i;
  *i_out = i;
  *j_out = (int)(b - (long long)i * (i + 1) / 2);
}

__global__ void __launch_bounds__(THREADS)
syrk_ltl_tril_kernel(const float* __restrict__ Li, int n, float* __restrict__ C) {
  __shared__ __align__(16) float As[BK][BM];  // As[k][a] = Li[k0 + k][a0 + a]
  __shared__ __align__(16) float Bs[BK][BM];  // Bs[k][b] = Li[k0 + k][b0 + b]
  int i, j;
  tril_tile(blockIdx.x, &i, &j);
  const int a0 = i * BM;
  const int b0 = j * BM;
  const int tid = threadIdx.x;
  const int tx = tid % (BM / TM);  // column block
  const int ty = tid / (BM / TM);  // row block

  float acc[TM][TM];
#pragma unroll
  for (int r = 0; r < TM; ++r)
#pragma unroll
    for (int c = 0; c < TM; ++c) acc[r][c] = 0.f;

  // Li[k][a] = 0 for k < a, and every a of this tile is >= a0 >= b0.
  for (int k0 = a0; k0 < n; k0 += BK) {
#pragma unroll
    for (int e = tid; e < BK * BM; e += THREADS) {
      const int kk = e / BM;
      const int c = e % BM;
      const int k = k0 + kk;
      const size_t base = (size_t)k * n;
      As[kk][c] = (k < n && a0 + c < n) ? Li[base + a0 + c] : 0.f;
      Bs[kk][c] = (k < n && b0 + c < n) ? Li[base + b0 + c] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&As[kk][ty * TM]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[kk][tx * TM]);
      const float av[TM] = {a.x, a.y, a.z, a.w};
      const float bv[TM] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int r = 0; r < TM; ++r)
#pragma unroll
        for (int c = 0; c < TM; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < TM; ++r) {
    const int row = a0 + ty * TM + r;
    if (row >= n) continue;
#pragma unroll
    for (int c = 0; c < TM; ++c) {
      const int col = b0 + tx * TM + c;
      if (col >= n) continue;
      C[(size_t)row * n + col] = (col > row) ? 0.f : acc[r][c];
    }
  }
}

}  // namespace

extern "C" int syrk_ltl_tril_f32(const float* Li, int n, float* C, cudaStream_t stream) {
  if (n > 0) {
    const long long nt = (n + BM - 1) / BM;
    const unsigned blocks = (unsigned)(nt * (nt + 1) / 2);
    syrk_ltl_tril_kernel<<<blocks, THREADS, 0, stream>>>(Li, n, C);
  }
  return (int)cudaGetLastError();
}

// Kernel `which` (0: K3) for chip_smoke.py: its name into *name, its
// registers, local and static shared bytes into attrs[0..2]; -1 past the
// last kernel.
extern "C" int kernel_attrs(int which, const char** name, int* attrs) {
  if (which != 0) return -1;
  *name = "syrk_ltl_tril_kernel";
  return func_attrs(syrk_ltl_tril_kernel, attrs);
}
