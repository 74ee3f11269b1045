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
// chol_inv_block_fast gives L and L^{-1} of a diagonal block, B a multiple
// of 128 up to 512, left-looking over 128-wide steps, each step
// chol_inv_128_fast: one warp factors each 32 x 32 piece in registers
// (shuffles, no barrier), another inverts it, and six warps solve and
// update the panel below it and carry the inverse along; named barriers
// hand the pieces over. It is K4's body (chol_block.cu) and the diagonal
// routine of K6 and K7 (chol_fused.cu). Latency-bound: a chain of 4 x 32
// dependent pivots, each panel's solve and update between them; PERF.md
// has its time and its phases (the optional stamps).
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

// The card's %globaltimer, in ns (what the kernels' stamps record). The
// "memory" clobber keeps the compiler from moving the read across memory
// accesses; a stamp after a barrier needs more (bar_count).
__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t)::"memory");
  return t;
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

// ---------------------------------------------------------------------------
// One warp, 32 x 32, in registers (no CTA barrier). Lane i holds row i.
// ---------------------------------------------------------------------------

constexpr unsigned FULL_MASK = 0xffffffffu;

// 1/sqrt(x) and 1/x from the hardware estimates (MUFU.RSQ, MUFU.RCP) and
// one Newton step each, within about an ulp, branch-free. On the chains of
// the one-warp routines they replace IEEE square roots and divisions, each
// a refinement with a slow-path branch and a convergence barrier
// (BSSY/BSYNC) in the SASS. rsqrt_pivot gives NaN for x <= 0.
__device__ __forceinline__ float rsqrt_pivot(float x) {
  const float r = rsqrtf(x);
  const float r1 = fmaf(0.5f * r, fmaf(-x * r, r, 1.f), r);
  return x > 0.f ? r1 : quiet_nan();
}
__device__ __forceinline__ float rcp_newton(float d) {
  const float r = __fdividef(1.f, d);
  return fmaf(r, fmaf(-d, r, 1.f), r);
}

// In-place lower Cholesky of the 32 x 32 block at P (leading dimension
// ld), by one whole warp, lane i holding row i in registers: LAPACK's
// unblocked order (column k scaled by the reciprocal of its pivot's square
// root, rsqrt_pivot, then the rank-1 update l_i l_j, one FMA), the column
// broadcast by shuffles. Only entries on and below the diagonal are read or written; a
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
  float piv = __shfl_sync(FULL_MASK, a[0], 0);
#pragma unroll
  for (int k = 0; k < 32; ++k) {
    const float r = rsqrt_pivot(piv);
    const float q = a[k] * r;
    a[k] = lane == k ? piv * r : q;
    float lj[32];
#pragma unroll
    for (int j = k + 1; j < 32; ++j) lj[j] = __shfl_sync(FULL_MASK, a[k], j);
    if (k + 1 < 32) {
      // The next pivot, on every lane, with lane k+1's own update of it
      // (the same FMA on the same operands): one shuffle fewer on the
      // chain of pivots than shuffling the updated value.
      const float next = __shfl_sync(FULL_MASK, a[k + 1], k + 1);
      piv = fmaf(-lj[k + 1], lj[k + 1], next);
    }
#pragma unroll
    for (int j = k + 1; j < 32; ++j) a[j] = fmaf(-a[k], lj[j], a[j]);
  }
#pragma unroll
  for (int j = 0; j < 32; ++j)
    if (j <= lane) P[lane * ld + j] = a[j];
}

// x L^T = x in place, for the 32 values of one row held in registers, by
// substitution against the 32 x 32 lower factor at D (leading dimension
// ldd). Each row of D and the reciprocal of its diagonal entry
// (rcp_newton) are loaded or formed before the FMA chain that uses them
// (D is the same for every lane: broadcast loads); each dot product runs as
// two interleaved chains, which halves the chain on the critical path.
__device__ __forceinline__ void solve_row32(float x[32], const float* D, int ldd) {
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    float dj[32];
#pragma unroll
    for (int t = 0; t < j; ++t) dj[t] = D[j * ldd + t];
    const float rdj = rcp_newton(D[j * ldd + j]);
    float s0 = x[j], s1 = 0.f;
#pragma unroll
    for (int t = 0; t < j; ++t) {
      if (t % 2 == 0) s0 = fmaf(-x[t], dj[t], s0);
      else s1 = fmaf(-x[t], dj[t], s1);
    }
    x[j] = (s0 + s1) * rdj;
  }
}

// x L^T = row for the 32 entries of one row (in place), one thread.
__device__ __forceinline__ void trsm_row32(float* row, const float* D, int ldd) {
  float x[32];
#pragma unroll
  for (int j = 0; j < 32; ++j) x[j] = row[j];
  solve_row32(x, D, ldd);
#pragma unroll
  for (int j = 0; j < 32; ++j) row[j] = x[j];
}

// The inverse X = L^{-1} of the lower-triangular 32 x 32 factor at P
// (leading dimension ld), by one whole warp: lane c solves
// e_c L^{-T}, which is column c of X, by the substitution of trsm_row32
// (its entries above the diagonal come out as exact zeros). X's strictly
// lower part goes TRANSPOSED into P's strictly upper part (X[i][c] at
// P[c * ld + i]: lane c writes row c), its diagonal to xd[0..31]. Reads
// only P's lower triangle, writes only its strict upper one.
__device__ void warp_inv32(float* P, int ld, float* xd) {
  const int lane = threadIdx.x & 31;
  float x[32];
#pragma unroll
  for (int j = 0; j < 32; ++j) x[j] = j == lane ? 1.f : 0.f;
  solve_row32(x, P, ld);
  float d = 0.f;
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    if (j > lane) P[lane * ld + j] = x[j];
    d = j == lane ? x[j] : d;
  }
  xd[lane] = d;
}

// Named barriers (id 0 is __syncthreads): bar_sync waits until `count`
// threads (whole warps) have arrived, bar_arrive counts this warp without
// waiting; prior shared-memory writes of the arriving threads are visible
// to the waiting ones when the barrier completes.
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(count) : "memory");
}

// ---------------------------------------------------------------------------
// L and L^{-1} of one B x B SPD block (B a multiple of SUB).
// ---------------------------------------------------------------------------

constexpr int SUB = 128;
constexpr int SLD = SUB + 1;

// Phase stamps of chol_inv_block_fast (stamps != nullptr; thread 0 writes
// %globaltimer after the barrier that ends each phase of the first 128
// step): entry, block loaded, each of the four 32-wide steps, the
// block-wise inverse assembled, L and L^{-1} stored.
constexpr int K4_STAMPS = 8;

// The 128 step of chol_inv_block_fast, in shared memory. F (SUB x SLD)
// holds the block's lower triangle (its strict upper part may hold
// anything); on return it holds L on and below the diagonal and X = L^{-1}
// TRANSPOSED strictly above it (X[i][j], j < i, at F[j * SLD + i]), and xd
// the diagonal of X. Right-looking over 32-wide panels p = 0..3, the warps
// split three ways:
//   warp 0 factors each 32 x 32 diagonal piece in registers (warp_chol32),
//     the chain of the step: piece p+1 as soon as panel p's update is done;
//   warp 7 inverts each piece (warp_inv32) once it is factored, off the
//     chain;
//   warps 1..6 (the solvers) solve the panel below piece p by substitution
//     (one row per thread), apply its rank-32 update to the trailing lower
//     triangle (register-summed, 4 x 4 per thread), and then, while warp 0
//     factors the next piece, carry the inverse one block row further: X
//     is formed by the same right-looking forward substitution,
//       X[p, :p]  = X[p, p] P[p, :p]                       (inv_finish)
//       P[i, :p+1] -= L[i, p] X[p, :p+1],  i > p            (inv_update)
//     with P (the partial rows, X's place in F) summed per 32-block in
//     registers and subtracted once, as the factor's updates are.
// Named barriers hand each piece over. After one CTA barrier only
// X[3, :3] = X[3, 3] P[3, :3] is left, for all 8 warps. stamps (or
// nullptr): slots 2..6 of K4_STAMPS, each step's end as warp 0 sees it
// (step 3: every warp done) and the last block row of X.
static_assert(WARPS == 8, "the 128 step splits 8 warps 1 + 6 + 1");
constexpr int SOLVERS = WARPS - 2;  // warps 1..6
constexpr int INV_WARP = WARPS - 1;
constexpr int BAR_SOLVERS = 1;      // warps 1..6 among themselves
constexpr int BAR_PIECE = 2;        // warp 0 arrives, 1..6 wait: piece factored
constexpr int BAR_UPDATED = 3;      // warps 0..6: trailing update done (a count)
constexpr int BAR_TO_INV = 4;       // + p (4..7): warp 0 arrives, warp 7 waits: piece p factored
constexpr int BAR_INVERTED = 8;     // + p (8..10): warp 7 arrives, 1..6 wait: piece p inverted
constexpr int CHAIN_COUNT = 32 * (SOLVERS + 1);

// A barrier's wait is deferred (BAR.SYNC.DEFER_BLOCKING in the SASS): a
// timer read right after bar.sync measured the time the warp ARRIVED, not
// the time the barrier completed (checked against clock64 on an H100). The
// stamps therefore follow barriers that return a count (bar.red.popc): the
// read depends on the count, which exists only once every thread has
// arrived.
__device__ __forceinline__ int bar_count(int id, int count) {
  int n;
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.u32 p, %3, 0;\n\t"
      "bar.red.popc.u32 %0, %1, %2, p;\n\t}"
      : "=r"(n)
      : "r"(id), "r"(count), "r"(1)
      : "memory");
  return n;
}

// Thread 0 stamps `slot` (stamps may be nullptr); `arrived` is a barrier
// count, which orders the read after the barrier.
__device__ __forceinline__ void stamp(long long* stamps, int slot, int arrived = 1) {
  if (stamps != nullptr && threadIdx.x == 0 && arrived > 0) stamps[slot] = global_ns();
}

// __syncthreads, then stamp `slot` once every thread has arrived.
__device__ __forceinline__ void sync_stamp(long long* stamps, int slot) {
  stamp(stamps, slot, __syncthreads_count(1));
}

// X[t][c] (t, c < SUB) as chol_inv_128_fast keeps it: transposed above the
// diagonal, xdc = xd[c] on it, zero below it (where F holds L). xdc is
// loaded by the caller ahead of its loop: a load behind the condition
// compiles into a branch (and a convergence barrier) per entry.
__device__ __forceinline__ float x_at(const float* F, float xdc, int t, int c) {
  const float v = F[c * SLD + t];
  return t > c ? v : (t == c ? xdc : 0.f);
}

// The inverse's two updates work on 32 x 16 tiles, one per warp at a time:
// lane l holds a 4 x 4 block, rows 4 (l % 8).., columns 4 (l / 8)..; each
// step of the sum loads 4 values of each operand (lanes that share them
// read one broadcast address; the others hit distinct banks) for 16 FMAs.

// P[i][c] -= sum_{t in block q} L[i][t] X[t][c] for the rows i of the blocks
// below q and the columns c < 32 (q + 1); the columns of block q start from
// zero. Warp w of `nwarps` (warp-uniform) takes every nwarps-th tile.
__device__ void inv_update(float* F, const float* xd, int q, int w, int nwarps) {
  const int lane = threadIdx.x & 31, off = 32 * q, t0 = off + 32;
  const int tiles_c = t0 / 16, tiles = (SUB - t0) / 32 * tiles_c;
  for (int tile = w; tile < tiles; tile += nwarps) {
    const int i0 = t0 + 32 * (tile / tiles_c) + 4 * (lane % 8);
    const int c0 = 16 * (tile % tiles_c) + 4 * (lane / 8);
    float xdc[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) xdc[j] = xd[c0 + j];
    float acc[4][4] = {};
#pragma unroll 8
    for (int t = off; t < t0; ++t) {
      float lv[4], xv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) lv[i] = F[(i0 + i) * SLD + t];
#pragma unroll
      for (int j = 0; j < 4; ++j) xv[j] = x_at(F, xdc[j], t, c0 + j);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(lv[i], xv[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float* x = F + (c0 + j) * SLD + i0 + i;
        *x = (c0 + j < off ? *x : 0.f) - acc[i][j];
      }
  }
}

// X[q, :q] = X[q, q] P[q, :q] in place (q >= 1), each entry one FMA chain
// over k in ascending order (the terms above X[q, q]'s diagonal exact
// zeros). Warp w of `nwarps` takes every nwarps-th tile of 16 columns.
__device__ void inv_finish(float* F, const float* xd, int q, int w, int nwarps) {
  const int lane = threadIdx.x & 31, off = 32 * q, r0 = 4 * (lane % 8);
  float xdr[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) xdr[i] = xd[off + r0 + i];
  for (int tile = w; tile < off / 16; tile += nwarps) {
    const int c0 = 16 * tile + 4 * (lane / 8);
    float out[4][4] = {};
#pragma unroll 8
    for (int k = 0; k < 32; ++k) {
      float xr[4], pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) xr[i] = x_at(F, xdr[i], off + r0 + i, off + k);
#pragma unroll
      for (int j = 0; j < 4; ++j) pv[j] = F[(c0 + j) * SLD + off + k];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) out[i][j] = fmaf(xr[i], pv[j], out[i][j]);
    }
    __syncwarp();  // the warp has read its 16 columns of P
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) F[(c0 + j) * SLD + off + r0 + i] = out[i][j];
  }
}

__device__ void chol_inv_128_fast(float* F, float* xd, long long* stamps) {
  const int tid = threadIdx.x, warp = tid >> 5;
  if (warp == 0) {
    for (int p = 0; p < 4; ++p) {
      if (p > 0) stamp(stamps, 1 + p, bar_count(BAR_UPDATED, CHAIN_COUNT));
      warp_chol32(F + 32 * p * SLD + 32 * p, SLD);
      bar_arrive(BAR_TO_INV + p, 64);
      if (p < 3) bar_arrive(BAR_PIECE, CHAIN_COUNT);
    }
  } else if (warp == INV_WARP) {
    for (int p = 0; p < 4; ++p) {
      bar_sync(BAR_TO_INV + p, 64);
      warp_inv32(F + 32 * p * SLD + 32 * p, SLD, xd + 32 * p);
      if (p < 3) bar_arrive(BAR_INVERTED + p, CHAIN_COUNT);
    }
  } else {
    const int rt = tid - 32, sw = warp - 1;
    // The inverse's block row q, once piece q is inverted and panel q solved.
    auto inverse_step = [&](int q) {
      bar_sync(BAR_INVERTED + q, CHAIN_COUNT);
      if (q > 0) {
        inv_finish(F, xd, q, sw, SOLVERS);
        bar_sync(BAR_SOLVERS, 32 * SOLVERS);
      }
      inv_update(F, xd, q, sw, SOLVERS);
    };
    for (int p = 0; p < 3; ++p) {
      const int off = 32 * p, t0 = off + 32, m = SUB - t0;
      bar_sync(BAR_PIECE, CHAIN_COUNT);
      if (rt < m) trsm_row32(F + (t0 + rt) * SLD + off, F + off * SLD + off, SLD);
      bar_sync(BAR_SOLVERS, 32 * SOLVERS);
      const int mt = m / 4, ntiles = mt * (mt + 1) / 2;
      for (int s = rt; s < ntiles; s += 32 * SOLVERS) {
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
      bar_count(BAR_UPDATED, CHAIN_COUNT);  // warp 0 is there already
      inverse_step(p);                      // while warp 0 factors the next piece
    }
  }
  sync_stamp(stamps, 5);
  inv_finish(F, xd, 3, warp, WARPS);
  sync_stamp(stamps, 6);
}

// Shared memory of chol_inv_block_fast: F, xd, and the cta_gemm staging.
constexpr int CHOL_INV_SMEM_FLOATS = SUB * SLD + SUB + GEMM_SMEM_FLOATS;

// L and L^{-1} of one B x B SPD block (B a multiple of SUB). A: the block
// (lower triangle used; the whole square is read, row stride lda). L, Li:
// B x B row-major outputs, zeros above the diagonal. W: B x B workspace for
// the trailing matrix (unused when B == SUB). smem: CHOL_INV_SMEM_FLOATS
// floats. stamps: K4_STAMPS slots, or nullptr.
//
// Left-looking over SUB-wide panels, as the TPU kernel: the SUB x SUB
// diagonal block is factored and inverted in shared memory
// (chol_inv_128_fast), the panel below it is the product with that inverse
// (the TRSM as a product), the trailing matrix takes the panel's rank-SUB
// update, and the inverse is assembled block-wise:
// Li[p, :off] = -dinv (L[p, :off] Li[:off, :off]), the inner product staged
// in W's finished columns. Each 128 step writes its rows of L and Li from
// its diagonal block to the right edge, zeros included, so nothing is
// zero-filled beforehand.
__device__ void chol_inv_block_fast(const float* A, int lda, int B, float* L, float* Li, float* W,
                                    float* smem, long long* stamps) {
  stamp(stamps, 0);
  float* D = smem;               // factor of the diagonal block
  float* xd = smem + SUB * SLD;  // the diagonal of its inverse
  float* G = xd + SUB;           // cta_gemm's staging
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int off = 0; off < B; off += SUB) {
    long long* st = off == 0 ? stamps : nullptr;
    const float* src = off == 0 ? A : W;
    const int lds = off == 0 ? lda : B;
    {
      // All 64 loads of a thread before their stores, unconditional (the
      // square is in bounds; its upper part is never read): src and D are
      // plain pointers, so the compiler otherwise keeps each load behind
      // the previous store, one L2 round trip each.
      float v[SUB / WARPS][4];
#pragma unroll
      for (int s = 0; s < SUB / WARPS; ++s)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          v[s][c] = src[(size_t)(off + w + WARPS * s) * lds + off + lane + 32 * c];
#pragma unroll
      for (int s = 0; s < SUB / WARPS; ++s)
#pragma unroll
        for (int c = 0; c < 4; ++c) D[(w + WARPS * s) * SLD + lane + 32 * c] = v[s][c];
    }
    sync_stamp(st, 1);
    chol_inv_128_fast(D, xd, st);
    // Rows off..off+SUB of L and Li, columns off..B: the diagonal block,
    // then zeros.
    // Loads ahead of the selects (a load behind a condition compiles into a
    // branch per entry).
    for (int i = w; i < SUB; i += WARPS) {
      float* Lrow = L + (size_t)(off + i) * B + off;
      float* Lirow = Li + (size_t)(off + i) * B + off;
      const float xdi = xd[i];
#pragma unroll
      for (int c = 0; c < SUB / 32; ++c) {
        const int j = lane + 32 * c;
        const float lv = D[i * SLD + j], xv = D[j * SLD + i];
        Lrow[j] = j <= i ? lv : 0.f;
        Lirow[j] = j < i ? xv : (j == i ? xdi : 0.f);
      }
      for (int j = SUB + lane; j < B - off; j += 32) Lrow[j] = Lirow[j] = 0.f;
    }
    sync_stamp(st, 7);
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
