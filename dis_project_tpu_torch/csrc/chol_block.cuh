// Device routines for the factorisation of one SPD block, shared by the
// block Cholesky kernels (chol_block.cu) and the fused whole-matrix
// factorisations (chol_fused.cu), which factor and invert their diagonal
// tiles with the same code.
//
// The warp routines (warp_chol32, warp_inv32) are run by one whole warp and
// touch only their 32 x 32 piece; trsm_row32 by one thread. Everything else
// is run by ALL threads of a CTA of chol_block::THREADS threads, and ends
// with a barrier, so its results (in shared or global memory) are visible
// to the whole CTA when it returns. Global buffers that a routine writes and a later one
// reads are plain (non-const, non-restrict) pointers, so loads never take
// the read-only path.
//
// Two routines give L and L^{-1} of a diagonal block, B a multiple of 128
// up to 512, left-looking over 128-wide steps:
//   chol_inv_block (K4's, and K7's diagonal tiles): each 128 step by
//     block_chol_shared + invert_lower_shared, ~512 CTA barriers and a
//     handful of FMAs per thread between two of them; 0.27 ms at B = 128 on
//     an H100 80GB HBM3 at 700 W (PERF.md), latency-bound.
//   chol_inv_block_fast (K6's diagonal tiles): each 128 step by
//     chol_inv_128_fast, 14 CTA barriers: the 32 x 32 pieces factored and
//     inverted by one warp in registers (shuffles, no barrier), the inverse
//     beside the panel's substitution and update by the other 7 warps. Still latency-bound (the pieces are
//     a chain of 4 x 32 dependent pivots); PERF.md has its time.
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

// ---------------------------------------------------------------------------
// One warp, 32 x 32, in registers (no CTA barrier). Lane i holds row i.
// ---------------------------------------------------------------------------

constexpr unsigned FULL_MASK = 0xffffffffu;

// In-place lower Cholesky of the 32 x 32 block at P (leading dimension
// ld), by one whole warp, lane i holding row i in registers: the order and
// arithmetic of panel_chol_shared (column k scaled by its pivot's square
// root, then the rank-1 update l_i l_j, one FMA), the column broadcast by
// shuffles. Only entries on and below the diagonal are read or written; a
// non-positive pivot gives NaN. Every lane runs every update, also on the
// registers above its diagonal, which come out as junk and are never
// stored: a lane-dependent condition on each update compiles into a
// divergent branch per update (BSSY/BSYNC pairs in the SASS), which
// serialises the warp.
__device__ void warp_chol32(float* P, int ld) {
  const int lane = threadIdx.x & 31;
  float a[32];
#pragma unroll
  for (int j = 0; j < 32; ++j) a[j] = j <= lane ? P[lane * ld + j] : 0.f;
#pragma unroll
  for (int k = 0; k < 32; ++k) {
    const float piv = __shfl_sync(FULL_MASK, a[k], k);
    const float d = piv > 0.f ? sqrtf(piv) : quiet_nan();
    const float q = a[k] / d;
    a[k] = lane == k ? d : q;
    float lj[32];
#pragma unroll
    for (int j = k + 1; j < 32; ++j) lj[j] = __shfl_sync(FULL_MASK, a[k], j);
#pragma unroll
    for (int j = k + 1; j < 32; ++j) a[j] = fmaf(-a[k], lj[j], a[j]);
  }
#pragma unroll
  for (int j = 0; j < 32; ++j)
    if (j <= lane) P[lane * ld + j] = a[j];
}

// The inverse X = L^{-1} of the lower-triangular 32 x 32 factor at P
// (leading dimension ld), from the factor in registers, by substitution in
// the order of invert_lower_shared: row k of X is scaled by 1 / L[k][k],
// then every row i > k subtracts L[i][k] X[k][:] (one FMA; the rows i <= k
// take a zero multiplier, which leaves them exact). X's strictly lower part
// goes TRANSPOSED into P's strictly upper part (X[i][c] at P[c * ld + i]),
// its diagonal to xd[0..31]. Called by one whole warp; reads only P's lower
// triangle, writes only its strict upper one.
__device__ void warp_inv32(float* P, int ld, float* xd) {
  const int lane = threadIdx.x & 31;
  float a[32], x[32];
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    a[j] = j <= lane ? P[lane * ld + j] : 0.f;
    x[j] = j == lane ? 1.f : 0.f;
  }
#pragma unroll
  for (int k = 0; k < 32; ++k) {
    const float rk = 1.f / __shfl_sync(FULL_MASK, a[k], k);
    float xk[32];
#pragma unroll
    for (int c = 0; c <= k; ++c) {
      x[c] = lane == k ? x[c] * rk : x[c];
      xk[c] = __shfl_sync(FULL_MASK, x[c], k);
    }
    const float m = lane > k ? a[k] : 0.f;
#pragma unroll
    for (int c = 0; c <= k; ++c) x[c] = fmaf(-m, xk[c], x[c]);
  }
#pragma unroll
  for (int c = 0; c < 32; ++c) {
    if (c < lane) P[c * ld + lane] = x[c];
    if (c == lane) xd[lane] = x[c];
  }
}

// x L^T = row for the 32 entries of one row (in place), by substitution
// against the 32 x 32 lower factor at D (leading dimension ldd). The row,
// and each row of D, are loaded before the FMA chain that uses them.
__device__ __forceinline__ void trsm_row32(float* row, const float* D, int ldd) {
  float x[32];
#pragma unroll
  for (int j = 0; j < 32; ++j) x[j] = row[j];
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    float dj[32];
#pragma unroll
    for (int t = 0; t <= j; ++t) dj[t] = D[j * ldd + t];
    float s = x[j];
#pragma unroll
    for (int t = 0; t < j; ++t) s = fmaf(-x[t], dj[t], s);
    x[j] = s / dj[j];
  }
#pragma unroll
  for (int j = 0; j < 32; ++j) row[j] = x[j];
}

// A barrier of warps 1..WARPS-1 only (named barrier 1), while warp 0 works
// on its own.
__device__ __forceinline__ void sync_rest() {
  asm volatile("bar.sync 1, %0;" ::"n"(THREADS - 32) : "memory");
}

// ---------------------------------------------------------------------------
// L and L^{-1} of one B x B SPD block (B a multiple of SUB).
// ---------------------------------------------------------------------------

constexpr int SUB = 128;
constexpr int SLD = SUB + 1;
constexpr int CHOL_INV_SMEM_FLOATS = 2 * SUB * SLD + GEMM_SMEM_FLOATS;

// The 128 step of chol_inv_block_fast, in shared memory. F (SUB x SLD)
// holds the block's lower triangle; on return it holds L on and below the
// diagonal and L^{-1} TRANSPOSED strictly above it (X[i][j], j < i, at
// F[j * SLD + i]), and xd the diagonal of L^{-1}. Right-looking over
// 32-wide panels: the 32 x 32 diagonal piece factored by warp 0 in
// registers (warp_chol32); then, at once, warp 0 inverts it (warp_inv32)
// while warps 1..7 solve the panel below it by substitution and apply the
// rank-32 trailing update (register-summed, 4 x 4 per thread); then the
// inverse assembled block-wise,
//   X[p, :p] = -X[p, p] (L[p, :p] X[:p, :p]),   p = 1..3 (32-blocks),
// the inner product staged in T (32 x FAST_TLD). 14 CTA barriers and 3
// barriers of warps 1..7 in all, against ~512 in block_chol_shared +
// invert_lower_shared.
constexpr int FAST_TLD = 3 * 32 + 1;
static_assert(WARPS * 4 == 32, "the inverse assembly gives each warp 4 rows of a 32-row block");
constexpr int FAST_T_FLOATS = 32 * FAST_TLD;

__device__ void chol_inv_128_fast(float* F, float* xd, float* T) {
  const int tid = threadIdx.x;
  for (int off = 0; off < SUB; off += 32) {
    if (tid < 32) warp_chol32(F + off * SLD + off, SLD);
    __syncthreads();
    if (tid < 32) {  // warp 0: the piece's inverse, off the critical path
      warp_inv32(F + off * SLD + off, SLD, xd + off);
    } else if (off + 32 < SUB) {
      // Warps 1..7: the panel below the piece by substitution (one row per
      // thread), then the trailing update of the lower triangle of rows and
      // columns [off+32, SUB), 4 x 4 per thread, register-summed.
      const int t0 = off + 32, m = SUB - t0, rt = tid - 32;
      if (rt < m) trsm_row32(F + (t0 + rt) * SLD + off, F + off * SLD + off, SLD);
      sync_rest();
      const int mt = m / 4, ntiles = mt * (mt + 1) / 2;
      for (int s = rt; s < ntiles; s += THREADS - 32) {
        int ti = (int)((sqrtf(8.f * s + 1.f) - 1.f) * 0.5f);
        while (ti * (ti + 1) / 2 > s) --ti;
        while ((ti + 1) * (ti + 2) / 2 <= s) ++ti;
        const int tk = s - ti * (ti + 1) / 2;
        const int i0 = t0 + 4 * ti, k0 = t0 + 4 * tk;
        float acc[4][4] = {};
#pragma unroll 8
        for (int t = off; t < t0; ++t) {
          float av[4], bv[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) av[r] = F[(i0 + r) * SLD + t], bv[r] = F[(k0 + r) * SLD + t];
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
        }
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            if (k0 + c <= i0 + r) F[(i0 + r) * SLD + k0 + c] -= acc[r][c];
      }
    }
    __syncthreads();
  }
  // The block-wise inverse, register-tiled: warp w takes rows 4w..4w+3 of
  // the block row, lane l the columns l, l + 32, l + 64 (up to off). Loop
  // bounds are the same for every lane, and the structural zeros are
  // selected in (a per-lane trip count diverges); each entry is one FMA
  // chain in ascending order, its first terms exact zeros.
  const int r0 = (tid >> 5) * 4, c0 = tid & 31;
  for (int off = 32; off < SUB; off += 32) {
    // T[r][c] = sum_{c <= t < off} L[off + r][t] X[t][c]
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      if (32 * j >= off) break;
      const int c = c0 + 32 * j;
      const float xcc = xd[c];
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      for (int t = 32 * j; t < off; ++t) {
        const float xv = F[c * SLD + t];  // X[t][c] for t > c
        const float x = t > c ? xv : (t == c ? xcc : 0.f);
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[q] = fmaf(F[(off + r0 + q) * SLD + t], x, acc[q]);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) T[(r0 + q) * FAST_TLD + c] = acc[q];
    }
    __syncthreads();
    // X[off + r][c] = -sum_{u <= r} X[off + r][off + u] T[u][c]
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      if (32 * j >= off) break;
      const int c = c0 + 32 * j;
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      for (int u = 0; u < r0 + 4; ++u) {
        const float tv = T[u * FAST_TLD + c];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int r = r0 + q;
          const float xv = F[(off + u) * SLD + off + r];  // X[off + r][off + u] for u < r
          const float x = u < r ? xv : (u == r ? xd[off + r] : 0.f);
          acc[q] = fmaf(x, tv, acc[q]);
        }
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) F[c * SLD + off + r0 + q] = -acc[q];
    }
    __syncthreads();
  }
}

// Shared memory of chol_inv_block_fast: F, xd, and T (which the 128 steps
// and the cta_gemm staging share).
constexpr int CHOL_INV_FAST_SMEM_FLOATS =
    SUB * SLD + SUB + (FAST_T_FLOATS > GEMM_SMEM_FLOATS ? FAST_T_FLOATS : GEMM_SMEM_FLOATS);

// L and L^{-1} of one B x B SPD block (B a multiple of SUB). A: the block
// (lower triangle read, row stride lda). L, Li: B x B row-major outputs,
// zeros above the diagonal. W: B x B workspace for the trailing matrix
// (unused when B == SUB). smem: CHOL_INV_SMEM_FLOATS floats (FAST:
// CHOL_INV_FAST_SMEM_FLOATS).
//
// Left-looking over SUB-wide panels, as the TPU kernel: the SUB x SUB
// diagonal block is factored and inverted in shared memory, the panel below
// it is the product with that inverse (the TRSM as a product), the trailing
// matrix takes the panel's rank-SUB update, and the inverse is assembled
// block-wise: Li[p, :off] = -dinv (L[p, :off] Li[:off, :off]), the inner
// product staged in W's finished columns. The 128 step: block_chol_shared
// and invert_lower_shared (chol_inv_block, K4's routine, ~512 barriers), or
// chol_inv_128_fast (chol_inv_block_fast, K6's routine, 14 barriers).
template <bool FAST>
__device__ void chol_inv_block_impl(const float* A, int lda, int B, float* L, float* Li, float* W,
                                    float* smem) {
  float* D = smem;                // factor of the diagonal block
  float* X = smem + SUB * SLD;    // its inverse (FAST: its diagonal, then T)
  float* G = FAST ? X + SUB : smem + 2 * SUB * SLD;
  zero_upper(L, B);
  zero_upper(Li, B);
  for (int off = 0; off < B; off += SUB) {
    const float* src = off == 0 ? A : W;
    const int lds = off == 0 ? lda : B;
    if (FAST) {
      // All 64 loads of a thread before their stores: src and D are plain
      // pointers, so the compiler otherwise keeps each load behind the
      // previous store, one L2 round trip each.
      const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
      float v[SUB / WARPS][4];
#pragma unroll
      for (int s = 0; s < SUB / WARPS; ++s)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int i = w + WARPS * s, j = lane + 32 * c;
          v[s][c] = j <= i ? src[(size_t)(off + i) * lds + off + j] : 0.f;
        }
#pragma unroll
      for (int s = 0; s < SUB / WARPS; ++s)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int i = w + WARPS * s, j = lane + 32 * c;
          if (j <= i) D[i * SLD + j] = v[s][c];
        }
    } else {
      for (int i = threadIdx.x >> 5; i < SUB; i += WARPS)
        for (int j = threadIdx.x & 31; j <= i; j += 32)
          D[i * SLD + j] = src[(size_t)(off + i) * lds + off + j];
    }
    __syncthreads();
    if (FAST) {
      chol_inv_128_fast(D, X, G);
    } else {
      block_chol_shared(D, SLD, SUB);
      invert_lower_shared(D, SLD, X, SLD, SUB);
    }
    for (int i = threadIdx.x >> 5; i < SUB; i += WARPS)
      for (int j = threadIdx.x & 31; j <= i; j += 32) {
        L[(size_t)(off + i) * B + off + j] = D[i * SLD + j];
        Li[(size_t)(off + i) * B + off + j] =
            FAST ? (j == i ? X[i] : D[j * SLD + i]) : X[i * SLD + j];
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

// K4's routine (K4, and K7's diagonal tiles).
__device__ void chol_inv_block(const float* A, int lda, int B, float* L, float* Li, float* W,
                               float* smem) {
  chol_inv_block_impl<false>(A, lda, B, L, Li, W, smem);
}

// K6's routine: the same outputs, 32-blocked 128 steps.
__device__ void chol_inv_block_fast(const float* A, int lda, int B, float* L, float* Li,
                                    float* W, float* smem) {
  chol_inv_block_impl<true>(A, lda, B, L, Li, W, smem);
}

}  // namespace chol_block
