// Device routines for the factorisation of one SPD block by one thread
// block (CTA), shared by the block Cholesky kernels (chol_block.cu) and
// meant for the fused whole-matrix factorisations, which factor and invert
// their diagonal tiles with the same code.
//
// Everything here is run by ALL threads of a CTA of chol_block::THREADS
// threads, and every routine ends with a barrier, so its results (in shared
// or global memory) are visible to the whole CTA when it returns. Global
// buffers that a routine writes and a later one reads are plain (non-const,
// non-restrict) pointers, so loads never take the read-only path.
//
// Arithmetic is plain FP32 (FMA) throughout: no TF32, no bf16. A single-pass
// low-precision product NaN'd the factorisation of a real SIMM Gram on the
// TPU (dis_project_tpu/ops/pallas_cholesky.py, MATMUL_PRECISION).
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace chol_block {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

__device__ __forceinline__ float quiet_nan() { return __int_as_float(0x7fc00000); }

// In-place lower Cholesky of the m x w panel P (m >= w, leading dimension
// ld) in shared memory: rows [0, w) hold the diagonal block, rows [w, m) the
// rows below it, which come out as the panel of L below the diagonal block.
// The unblocked right-looking Cholesky in LAPACK's order: column j is
// scaled by its pivot's square root (one rounding, as potf2), then the
// trailing part of the panel takes the rank-1 update l_i l_k (one FMA);
// two barriers per column. A non-positive pivot writes NaN, so a non-PD
// block gives a NaN factor. Only entries on and below the diagonal are read
// or written.
__device__ void panel_chol_shared(float* P, int ld, int m, int w) {
  const int tx = threadIdx.x & 31;
  const int ty = threadIdx.x >> 5;
  for (int j = 0; j < w; ++j) {
    const float d = P[j * ld + j] > 0.f ? sqrtf(P[j * ld + j]) : quiet_nan();
    for (int i = j + 1 + threadIdx.x; i < m; i += THREADS) P[i * ld + j] /= d;
    __syncthreads();
    if (threadIdx.x == 0) P[j * ld + j] = d;  // every thread has read the pivot
    for (int i = j + 1 + ty; i < m; i += WARPS) {
      const float lij = P[i * ld + j];
      const int kmax = min(i, w - 1);
      for (int k = j + 1 + tx; k <= kmax; k += 32) {
        P[i * ld + k] = fmaf(-lij, P[k * ld + j], P[i * ld + k]);
      }
    }
    __syncthreads();
  }
}

// In-place lower Cholesky of the n x n block D in shared memory, blocked
// right-looking over PW-wide panels: each panel by panel_chol_shared, then
// the trailing lower triangle takes the panel's rank-PW update, each entry's
// PW products summed in a register and subtracted once. Against n rank-1
// updates in place (panel_chol_shared on the whole block) this rounds each
// entry n/PW times instead of n.
constexpr int PW = 32;

__device__ void block_chol_shared(float* D, int ld, int n) {
  for (int off = 0; off < n; off += PW) {
    const int w = min(PW, n - off);
    panel_chol_shared(D + off * ld + off, ld, n - off, w);
    const int t0 = off + w;
    for (int i = t0 + (threadIdx.x >> 5); i < n; i += WARPS) {
      for (int k = t0 + (threadIdx.x & 31); k <= i; k += 32) {
        float acc = 0.f;
        for (int t = off; t < t0; ++t) acc = fmaf(D[i * ld + t], D[k * ld + t], acc);
        D[i * ld + k] -= acc;
      }
    }
    __syncthreads();
  }
}

// X = L^{-1} for the n x n lower-triangular L in shared memory (leading
// dimensions ldl, ldx), by forward substitution against the identity, row
// by row: row k is divided by L[k][k] (now final), then every row i > k
// subtracts L[i][k] X[k][:] (one FMA). Zeros above the diagonal. This is
// the stable route; the TPU kernel's nilpotent doubling diverges on real
// Gram factors beyond the 128 scale.
__device__ void invert_lower_shared(const float* L, int ldl, float* X, int ldx, int n) {
  const int tx = threadIdx.x & 31;
  const int ty = threadIdx.x >> 5;
  for (int i = ty; i < n; i += WARPS)
    for (int c = tx; c < n; c += 32) X[i * ldx + c] = (i == c) ? 1.f : 0.f;
  __syncthreads();
  for (int k = 0; k < n; ++k) {
    const float lkk = L[k * ldl + k];
    for (int c = threadIdx.x; c <= k; c += THREADS) X[k * ldx + c] /= lkk;
    __syncthreads();
    for (int i = k + 1 + ty; i < n; i += WARPS) {
      const float lik = L[i * ldl + k];
      for (int c = tx; c <= k; c += 32) X[i * ldx + c] = fmaf(-lik, X[k * ldx + c], X[i * ldx + c]);
    }
    __syncthreads();
  }
}

// CTA-wide product in global memory:
//   Cout[i][j] = Cin[i][j] + alpha * sum_k A[i][k] op(B)[k][j],  i < M, j < N,
// with A[i][k] at A[i * lda + k], op(B)[k][j] at B[j * ldb + k] when
// B_TRANS and at B[k * ldb + j] otherwise, and Cin == nullptr meaning 0.
// Cin may equal Cout (each entry is read and written by one thread); A and B
// must not overlap the Cout region. LOWER_ONLY skips 64 x 64 output tiles
// strictly above the diagonal (diagonal tiles are written whole). A
// register-tiled SGEMM: 64 x 64 output tiles, 16-deep k slices of both
// operands staged in shared memory (smem: GEMM_SMEM_FLOATS floats), a 4 x 4
// accumulator block per thread.
constexpr int GBM = 64;
constexpr int GBK = 16;
constexpr int GLD = GBM + 4;  // padded: fewer bank conflicts, rows stay 16-byte aligned
constexpr int GEMM_SMEM_FLOATS = 2 * GBK * GLD;

template <bool B_TRANS, bool LOWER_ONLY>
__device__ void cta_gemm(int M, int N, int K, float alpha, const float* A, int lda,
                         const float* B, int ldb, const float* Cin, int ldci, float* Cout,
                         int ldco, float* smem) {
  float* As = smem;             // As[k][i]
  float* Bs = smem + GBK * GLD;  // Bs[k][j]
  const int tid = threadIdx.x;
  const int tcol = tid % (GBM / 4);
  const int trow = tid / (GBM / 4);
  const int tm = (M + GBM - 1) / GBM;
  const int tn = (N + GBM - 1) / GBM;
  for (int t = 0; t < tm * tn; ++t) {
    const int ti = t / tn;
    const int tj = t % tn;
    if (LOWER_ONLY && tj > ti) continue;
    const int i0 = ti * GBM;
    const int j0 = tj * GBM;
    float acc[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
    for (int k0 = 0; k0 < K; k0 += GBK) {
      for (int e = tid; e < GBK * GBM; e += THREADS) {
        // A: 16 consecutive k of one row per 16 threads.
        const int ar = e / GBK, ak = e % GBK;
        const int gi = i0 + ar, gk = k0 + ak;
        As[ak * GLD + ar] = (gi < M && gk < K) ? A[(size_t)gi * lda + gk] : 0.f;
        if (B_TRANS) {
          const int gj = j0 + ar;
          Bs[ak * GLD + ar] = (gj < N && gk < K) ? B[(size_t)gj * ldb + gk] : 0.f;
        } else {
          // B: 64 consecutive j of one k row per 64 threads.
          const int bk = e / GBM, bj = e % GBM;
          const int gj = j0 + bj, gk2 = k0 + bk;
          Bs[bk * GLD + bj] = (gj < N && gk2 < K) ? B[(size_t)gk2 * ldb + gj] : 0.f;
        }
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < GBK; ++kk) {
        const float4 a = *reinterpret_cast<const float4*>(&As[kk * GLD + trow * 4]);
        const float4 b = *reinterpret_cast<const float4*>(&Bs[kk * GLD + tcol * 4]);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int gi = i0 + trow * 4 + r;
      if (gi >= M) continue;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int gj = j0 + tcol * 4 + c;
        if (gj >= N) continue;
        const float base = Cin ? Cin[(size_t)gi * ldci + gj] : 0.f;
        Cout[(size_t)gi * ldco + gj] = fmaf(alpha, acc[r][c], base);
      }
    }
  }
  __syncthreads();
}

// Zero every entry strictly above the diagonal of the n x n row-major M.
__device__ void zero_upper(float* M, int n) {
  const int tx = threadIdx.x & 31;
  const int ty = threadIdx.x >> 5;
  for (int i = ty; i < n; i += WARPS)
    for (int j = i + 1 + tx; j < n; j += 32) M[(size_t)i * n + j] = 0.f;
}

// L and L^{-1} of one B x B SPD block (B a multiple of SUB), the work of K4.
// A: the block (lower triangle read, row stride lda). L, Li: B x B
// row-major outputs, zeros above the diagonal. W: B x B workspace for the
// trailing matrix (unused when B == SUB). smem: CHOL_INV_SMEM_FLOATS floats.
//
// Left-looking over SUB-wide panels, as the TPU kernel: the SUB x SUB
// diagonal block is factored (block_chol_shared) and inverted in shared
// memory, the panel below
// it is the product with that inverse (the TRSM as a product), the trailing
// matrix takes the panel's rank-SUB update, and the inverse is assembled
// block-wise: Li[p, :off] = -dinv (L[p, :off] Li[:off, :off]), the inner
// product staged in W's finished columns.
constexpr int SUB = 128;
constexpr int SLD = SUB + 1;
constexpr int CHOL_INV_SMEM_FLOATS = 2 * SUB * SLD + GEMM_SMEM_FLOATS;

__device__ void chol_inv_block(const float* A, int lda, int B, float* L, float* Li, float* W,
                               float* smem) {
  float* D = smem;                // factor of the diagonal block
  float* X = smem + SUB * SLD;    // its inverse
  float* G = smem + 2 * SUB * SLD;
  zero_upper(L, B);
  zero_upper(Li, B);
  for (int off = 0; off < B; off += SUB) {
    const float* src = off == 0 ? A : W;
    const int lds = off == 0 ? lda : B;
    for (int i = threadIdx.x >> 5; i < SUB; i += WARPS)
      for (int j = threadIdx.x & 31; j <= i; j += 32)
        D[i * SLD + j] = src[(size_t)(off + i) * lds + off + j];
    __syncthreads();
    block_chol_shared(D, SLD, SUB);
    invert_lower_shared(D, SLD, X, SLD, SUB);
    for (int i = threadIdx.x >> 5; i < SUB; i += WARPS)
      for (int j = threadIdx.x & 31; j <= i; j += 32) {
        L[(size_t)(off + i) * B + off + j] = D[i * SLD + j];
        Li[(size_t)(off + i) * B + off + j] = X[i * SLD + j];
      }
    __syncthreads();
    const int rest = B - off - SUB;
    float* Lp = L + (size_t)(off + SUB) * B + off;  // panel below the diagonal block
    if (rest > 0) {
      cta_gemm<true, false>(rest, SUB, SUB, 1.f, src + (size_t)(off + SUB) * lds + off, lds,
                            Li + (size_t)off * B + off, B, nullptr, 0, Lp, B, G);
      cta_gemm<true, true>(rest, rest, SUB, -1.f, Lp, B, Lp, B,
                           src + (size_t)(off + SUB) * lds + off + SUB, lds,
                           W + (size_t)(off + SUB) * B + off + SUB, B, G);
    }
    if (off > 0) {
      float* T = W + (size_t)off * B;  // W[off:off+SUB, :off] is free now
      cta_gemm<false, false>(SUB, off, off, 1.f, L + (size_t)off * B, B, Li, B, nullptr, 0, T, B,
                             G);
      cta_gemm<false, false>(SUB, off, SUB, -1.f, Li + (size_t)off * B + off, B, T, B, nullptr,
                             0, Li + (size_t)off * B, B, G);
    }
  }
}

}  // namespace chol_block
