// Whole-matrix lower Cholesky factor in one launch, on Hopper (sm_90a).
//
// Replaces, from the JAX package (dis_project_tpu/ops/pallas_cholesky_fused.py):
//   K6  _fused_kernel   (fused_cholesky):  2-D (column k, row tile i) grid in
//       order, the tiles above the diagonal written as zero tiles
//       -> fused_chol_kernel
//   K7  _fused_kernel2  (fused_cholesky2): 1-D grid of the nb(nb+1)/2 active
//       tiles in the order of two scalar-prefetched index lists, each
//       off-diagonal tile also zeroing its mirror tile
//       -> fused_chol2_kernel
//
// Both compute the left-looking tile factorisation of an n x n SPD matrix A
// (n = nb * B, B a multiple of 128 up to 512), tile (k, i) being rows i,
// columns k of L, for i >= k:
//   C = A[i, k] - sum_{j < k} L[i, j] L[k, j]^T
//   i == k: L[k, k] and Linv_kk from the diagonal routine
//           (chol_block.cuh::chol_inv_block_fast, K4's body); Linv_kk goes
//           to a per-column global buffer
//   i >  k: L[i, k] = C Linv_kk^T   (the TRSM as a product, as on the TPU)
//
// Order across CTAs. The TPU grid runs in order, so a step may read any tile
// written by an earlier step. CTAs on the card run in parallel and start in
// no set order, so each CTA takes an atomic ticket on entry and factors the
// tile that ticket names: K6 numbers all nb^2 tiles in the TPU grid's order
// (k major, then i); K7 reads (k, i) from an index table, tiles[ticket],
// the card's form of the TPU kernel's scalar-prefetched kidx/iidx (a block
// loads its own indices). The wrapper passes a look-ahead order
// (ops/cuda_cholesky_fused.py, tile_order), which hands out each
// diagonal tile and the tiles next to it ahead of far tiles of earlier
// columns; on the TPU the order is what makes the sequential grid correct,
// here it is only a schedule. In any order the wrapper builds, every tile
// that (k, i) reads -- (j, i) and (j, k) for j < k, and (k, k) for i > k --
// has a smaller ticket, and so is held by a CTA that is already resident:
// no CTA waits on one that may never run, so the launch cannot deadlock
// whatever the number of CTAs per SM. Each finished tile sets a
// ready flag (an int per tile, zeroed by the wrapper before the launch):
// every thread writes its part and fences, the CTA syncs, one thread stores
// the flag with release semantics. A reader's thread 0 spins on the flag with
// an acquire load and __nanosleep backoff, then the CTA syncs; tiles written
// by other CTAs are loaded with ld.global.cg (__ldcg), which skips the SM's
// non-coherent L1. Finished column blocks are consumed one at a time (wait
// on (j, i) and (j, k) just before step j), so only the last step of a
// tile's correction sits on the diagonal chain. A wait is bounded by a
// clock64() budget of a few seconds: past it the CTA sets the error word
// (sync[1]), stops waiting, writes NaN to its tile and still sets its flag,
// so a broken dependency shows as an error and a NaN factor, never a hang.
// A non-PD matrix gives NaN pivots (both diagonal routines write NaN for a
// non-positive pivot), which spread to every later tile; every tile still
// sets its flag.
//
// Products are plain FP32 FMAs (no TF32, no bf16): the TPU kernels staged
// their correction operands in bf16, which gives a NaN factor on a real SIMM
// Gram (pallas_cholesky_fused.py:6-14). No bf16 or transposed copies of L:
// L[k, j] is read in rows as the transposed operand. Each 128 x 128 output
// subtile is a register-tiled SGEMM (8 x 8 per thread, 16-deep k slices of
// both operands double-buffered in shared memory, the next slice's loads in
// flight during the current slice's FMAs). Each correction step j sums its
// B products in a fresh register accumulator and subtracts the sum from C
// once (C lives in the tile's place in L between steps), as the plain
// version's C -= L[i, j] L[k, j]^T does: one long FMA chain from A into C
// rounds C B times as often, and failed the reconstruction limit at n = 1e4
// on the real dense10k Sigma where the plain version passed with room to
// spare (PERF.md). The TRSM skips the structural zeros of Linv_kk^T (output
// column block c needs C's column blocks <= c) and runs c downwards, so it
// works in place on C.
//
// What bounds it on the H100: the diagonal chain. The factorisation is
// n^3/3 FP32 operations (5 ms at 67 TFLOP/s for n = 1e4), spread over 132
// SMs, but column k+1 cannot start its diagonal factorisation before column
// k's diagonal tile and the tile below it are done: nb dependent diagonal
// factorisations by one CTA each, plus one correction step and one TRSM per
// column. The chain is measured, not inferred: each diagonal tile k stamps
// %globaltimer (the wrapper's (5, nb) buffer) when it takes its ticket, when
// its own corrections j < k-1 are done, when it starts its diagonal routine
// and when it sets its flag, and the sub-diagonal tile (k-1, k) stamps when
// it sets its flag; so each link splits into the TRSM below the previous
// diagonal tile, the diagonal tile's last correction (and any lateness of
// its earlier ones), and the routine (PERF.md). Both kernels run
// chol_inv_block_fast (chol_block.cuh), whose 32 x 32 pieces one warp
// factors and another inverts in registers; its registers (the full 255 a
// thread) hold the kernels to one CTA per SM: capped at 128 so that two
// fit, it spilled and measured slower (PERF.md). A small B shortens each link and lengthens the chain;
// the design keeps everything off the chain that can be (the other tiles
// of a column run their corrections while they wait).
//
// The C entry points launch on the given stream, allocate nothing (the
// wrapper passes L, the per-column diagonal scratch, the zeroed sync words
// and the stamps), and return cudaGetLastError() (or the attribute call's
// error).

#include "chol_block.cuh"
#include "kernel_attrs.cuh"

namespace {

using namespace chol_block;

constexpr int TS = 128;      // output subtile
constexpr int KS = 16;       // k slice
constexpr int TLD = TS + 4;  // padded shared row: float4 reads stay aligned
constexpr int MMA_SMEM_FLOATS = 2 * 2 * KS * TLD;
constexpr int max_floats(int a, int b) { return a > b ? a : b; }
// Shared memory of both kernels: the diagonal routine's or tile_mma's
// staging, whichever is larger (they are used one after the other).
constexpr int SMEM_FLOATS = max_floats(CHOL_INV_SMEM_FLOATS, MMA_SMEM_FLOATS);
constexpr int MAX_B = 512;
// ~5 s at the H100's SM clock: far above any legitimate wait (a whole
// factorisation at n = 1e4 takes tens of milliseconds).
constexpr long long WAIT_CYCLES = 10000000000LL;

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// Thread (ty, tx) of a 16 x 16 grid holds rows ty*4 + {0..3} and
// 64 + ty*4 + {0..3}, columns likewise, of a 128 x 128 subtile.
__device__ __forceinline__ int frag_row(int r) {
  return (r < 4 ? 0 : 64) + (threadIdx.x / 16) * 4 + (r & 3);
}
__device__ __forceinline__ int frag_col(int h) { return h * 64 + (threadIdx.x % 16) * 4; }

// dst = src - acc on the thread's fragment (src and dst may be the same).
// The loads of each half of the fragment go before its stores: since src
// may alias dst, the compiler otherwise keeps every load behind the
// previous store, one L2 round trip per float4.
__device__ void subtract_frag(float acc[8][8], const float* src, float* dst, size_t ld) {
  constexpr int GROUP = 8;  // float4 loads in flight
#pragma unroll
  for (int g = 0; g < 16; g += GROUP) {
    float4 v[GROUP];
#pragma unroll
    for (int q = 0; q < GROUP; ++q) {
      const int r = (g + q) / 2, h = (g + q) % 2;
      v[q] = __ldcg(reinterpret_cast<const float4*>(src + frag_row(r) * ld + frag_col(h)));
    }
#pragma unroll
    for (int q = 0; q < GROUP; ++q) {
      const int r = (g + q) / 2, h = (g + q) % 2;
      *reinterpret_cast<float4*>(dst + frag_row(r) * ld + frag_col(h)) =
          make_float4(v[q].x - acc[r][4 * h], v[q].y - acc[r][4 * h + 1],
                      v[q].z - acc[r][4 * h + 2], v[q].w - acc[r][4 * h + 3]);
    }
  }
}

__device__ void store_frag(float acc[8][8], float* C, size_t ld) {
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float4*>(C + frag_row(r) * ld + frag_col(h)) =
          make_float4(acc[r][4 * h], acc[r][4 * h + 1], acc[r][4 * h + 2], acc[r][4 * h + 3]);
}

// acc = A B^T over K (a multiple of KS) for a 128 x 128 subtile: A and B are
// 128 rows each, row-major with leading dimensions lda and ldb, read with
// __ldcg (they may have been written by other CTAs during this launch). Each
// entry is one FMA chain over k in order. Ends with a barrier, after which
// every thread has finished reading A and B.
__device__ void tile_mma(float acc[8][8], const float* A, size_t lda, const float* B, size_t ldb,
                         int K, float* smem) {
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;
  constexpr int FETCH = TS * KS / 4 / THREADS;  // float4 of each operand per thread
  float4 ra[FETCH], rb[FETCH];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int p = 0; p < FETCH; ++p) {
      const int e = threadIdx.x + p * THREADS;
      const int row = e / (KS / 4), q = e % (KS / 4);
      ra[p] = __ldcg(reinterpret_cast<const float4*>(A + row * lda + k0 + 4 * q));
      rb[p] = __ldcg(reinterpret_cast<const float4*>(B + row * ldb + k0 + 4 * q));
    }
  };
  auto stash = [&](int buf) {
    float* as = smem + buf * 2 * KS * TLD;
    float* bs = as + KS * TLD;
#pragma unroll
    for (int p = 0; p < FETCH; ++p) {
      const int e = threadIdx.x + p * THREADS;
      const int row = e / (KS / 4), q = e % (KS / 4);
      as[(4 * q) * TLD + row] = ra[p].x, as[(4 * q + 1) * TLD + row] = ra[p].y;
      as[(4 * q + 2) * TLD + row] = ra[p].z, as[(4 * q + 3) * TLD + row] = ra[p].w;
      bs[(4 * q) * TLD + row] = rb[p].x, bs[(4 * q + 1) * TLD + row] = rb[p].y;
      bs[(4 * q + 2) * TLD + row] = rb[p].z, bs[(4 * q + 3) * TLD + row] = rb[p].w;
    }
  };
  const int ty4 = (threadIdx.x / 16) * 4, tx4 = (threadIdx.x % 16) * 4;
  fetch(0);
  stash(0);
  __syncthreads();
  int buf = 0;
  for (int k0 = 0; k0 < K; k0 += KS, buf ^= 1) {
    const bool more = k0 + KS < K;
    if (more) fetch(k0 + KS);
    const float* as = smem + buf * 2 * KS * TLD;
    const float* bs = as + KS * TLD;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&as[kk * TLD + ty4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&as[kk * TLD + 64 + ty4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&bs[kk * TLD + tx4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&bs[kk * TLD + 64 + tx4]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c)
          acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
    }
    if (more) stash(buf ^ 1);
    __syncthreads();
  }
}

// Rows of the chain stamps, (CHAIN_ROWS, nb) int64, %globaltimer in ns:
// diagonal tile k took its ticket, finished its corrections j < k-1, began
// its diagonal routine, set its ready flag; and the sub-diagonal tile
// (k-1, k) set its ready flag (0 for k = 0).
enum ChainRow { TICKET = 0, EARLY_DONE, ROUTINE, FLAG, SUBDIAG_FLAG, CHAIN_ROWS };

struct Matrix {
  const float* A;     // n x n input
  float* L;           // n x n output
  float* diag;        // (nb, 3, B, B): Linv_kk, the diagonal routine's L and its workspace
  int* sync;          // [ticket counter, error word, nb * nb ready flags]
  long long* stamps;  // (CHAIN_ROWS, nb), see ChainRow
  const int* tiles;   // K7: (nb(nb+1)/2, 2) int32, (k, i) of each ticket
  int n, B, nb;
};

__device__ __forceinline__ void chain_stamp(const Matrix& m, ChainRow row, int k) {
  m.stamps[(size_t)row * m.nb + k] = global_ns();
}

__device__ __forceinline__ int* ready(const Matrix& m, int k, int i) {
  return m.sync + 2 + (size_t)k * m.nb + i;
}

// Thread 0 waits for the flag (unless this CTA has already given up), then
// the CTA syncs.
__device__ void wait_ready(const Matrix& m, int k, int i, int* gave_up) {
  if (threadIdx.x == 0 && !*gave_up) {
    const int* f = ready(m, k, i);
    const long long t0 = clock64();
    unsigned ns = 64;
    while (ld_acquire(f) == 0) {
      if (clock64() - t0 > WAIT_CYCLES) {
        *gave_up = 1;
        atomicExch(m.sync + 1, 1);
        break;
      }
      __nanosleep(ns);
      ns = min(2 * ns, 1024u);
    }
  }
  __syncthreads();
}

__device__ void fill_tile(float* T, size_t ld, int B, float v) {
  for (int e = threadIdx.x; e < B * B / 4; e += THREADS) {
    const int row = e / (B / 4), q = e % (B / 4);
    *reinterpret_cast<float4*>(T + row * ld + 4 * q) = make_float4(v, v, v, v);
  }
}

// Tile (k, i), i >= k: correction, then the diagonal factorisation
// (chol_inv_block_fast) or the TRSM, then the ready flag, with the chain
// stamps of a diagonal tile and of a sub-diagonal one.
__device__ void factor_tile(const Matrix& m, int k, int i, float* smem, int* gave_up) {
  const size_t n = m.n;
  const int B = m.B, nsub = B / TS;
  const bool on_diag = i == k;
  const size_t tile = (size_t)i * B * n + (size_t)k * B;
  if (on_diag && threadIdx.x == 0) chain_stamp(m, TICKET, k);
  const float* At = m.A + tile;
  float* Lt = m.L + tile;
  float* Linv = m.diag + (size_t)k * 3 * B * B;

  float acc[8][8];
  for (int j = 0; j < k; ++j) {
    if (on_diag && j == k - 1 && threadIdx.x == 0) chain_stamp(m, EARLY_DONE, k);
    wait_ready(m, j, i, gave_up);
    wait_ready(m, j, k, gave_up);
    const float* Lij = m.L + (size_t)i * B * n + (size_t)j * B;
    const float* Lkj = m.L + (size_t)k * B * n + (size_t)j * B;
    for (int s = 0; s < nsub * nsub; ++s) {
      const int r = s / nsub, c = s % nsub;
      if (on_diag && c > r) continue;  // the diagonal routine reads the lower part only
      const size_t sub = (size_t)r * TS * n + (size_t)c * TS;
      tile_mma(acc, Lij + (size_t)r * TS * n, n, Lkj + (size_t)c * TS * n, n, B, smem);
      subtract_frag(acc, (j == 0 ? At : Lt) + sub, Lt + sub, n);
    }
  }
  __threadfence();
  // A count-returning barrier, so that the routine's stamp follows every
  // thread's last correction (see chol_block.cuh, bar_count).
  const int arrived = __syncthreads_count(1);
  const float* C = k == 0 ? At : Lt;  // the corrected tile

  if (on_diag) {
    if (threadIdx.x == 0 && arrived > 0) {
      if (k == 0) chain_stamp(m, EARLY_DONE, k);
      chain_stamp(m, ROUTINE, k);
    }
    float* Lbuf = Linv + (size_t)B * B;
    chol_inv_block_fast(C, (int)n, B, Lbuf, Linv, Lbuf + (size_t)B * B, smem, nullptr);
    // Zeros above the diagonal too; 16 loads in flight before their stores
    // (see subtract_frag).
    constexpr int GROUP = 16;
    for (int e0 = threadIdx.x; e0 < B * B / 4; e0 += GROUP * THREADS) {
      float4 v[GROUP];
#pragma unroll
      for (int q = 0; q < GROUP; ++q) v[q] = reinterpret_cast<const float4*>(Lbuf)[e0 + q * THREADS];
#pragma unroll
      for (int q = 0; q < GROUP; ++q) {
        const int e = e0 + q * THREADS, row = e / (B / 4), c = e % (B / 4);
        *reinterpret_cast<float4*>(Lt + row * n + 4 * c) = v[q];
      }
    }
  } else {
    wait_ready(m, k, k, gave_up);
    for (int c = nsub - 1; c >= 0; --c)
      for (int r = 0; r < nsub; ++r) {
        tile_mma(acc, C + (size_t)r * TS * n, n, Linv + (size_t)c * TS * B, B, (c + 1) * TS,
                 smem);
        store_frag(acc, Lt + (size_t)r * TS * n + (size_t)c * TS, n);
      }
  }
  __syncthreads();
  if (*gave_up) {
    fill_tile(Lt, n, B, quiet_nan());
    if (on_diag) fill_tile(Linv, B, B, quiet_nan());
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    st_release(ready(m, k, i), 1);
    if (on_diag) chain_stamp(m, FLAG, k);
    if (i == k + 1) chain_stamp(m, SUBDIAG_FLAG, i);
  }
}

__device__ int take_ticket(const Matrix& m, int* shared_ticket, int* gave_up) {
  if (threadIdx.x == 0) {
    *shared_ticket = atomicAdd(m.sync, 1);
    *gave_up = 0;
  }
  __syncthreads();
  return *shared_ticket;
}

__global__ void __launch_bounds__(THREADS) fused_chol_kernel(Matrix m) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int ticket, gave_up;
  const int t = take_ticket(m, &ticket, &gave_up);
  const int k = t / m.nb, i = t % m.nb;
  if (i < k) {  // above the diagonal: a zero tile, which nothing waits on
    fill_tile(m.L + (size_t)i * m.B * m.n + (size_t)k * m.B, m.n, m.B, 0.f);
    return;
  }
  factor_tile(m, k, i, smem, &gave_up);
}

__global__ void __launch_bounds__(THREADS) fused_chol2_kernel(Matrix m) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int ticket, gave_up;
  const int t = take_ticket(m, &ticket, &gave_up);
  const int k = __ldg(m.tiles + 2 * t), i = __ldg(m.tiles + 2 * t + 1);
  if (i > k) fill_tile(m.L + (size_t)k * m.B * m.n + (size_t)i * m.B, m.n, m.B, 0.f);
  factor_tile(m, k, i, smem, &gave_up);
}

using Kernel = void (*)(Matrix);

// Sets the kernel's dynamic shared memory; returns its size in *bytes.
int prepare(Kernel kernel, size_t* bytes) {
  *bytes = SMEM_FLOATS * sizeof(float);
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)*bytes);
}

int launch(Kernel kernel, int tiles, const Matrix& m, cudaStream_t stream) {
  size_t bytes;
  if (int err = prepare(kernel, &bytes)) return err;
  kernel<<<tiles, THREADS, bytes, stream>>>(m);
  return (int)cudaGetLastError();
}

bool valid(int n, int B) { return B > 0 && B % SUB == 0 && B <= MAX_B && n > 0 && n % B == 0; }

}  // namespace

extern "C" int fused_chol_f32(const float* A, int n, int B, float* L, float* diag, int* sync,
                              long long* stamps, cudaStream_t stream) {
  if (!valid(n, B)) return (int)cudaErrorInvalidValue;
  const int nb = n / B;
  return launch(fused_chol_kernel, nb * nb,
                Matrix{A, L, diag, sync, stamps, nullptr, n, B, nb}, stream);
}

// tiles: the (nb(nb+1)/2, 2) int32 order table, a legal order of the active
// tiles (every tile a tile reads has a smaller ticket).
extern "C" int fused_chol2_f32(const float* A, int n, int B, float* L, float* diag, int* sync,
                               long long* stamps, const int* tiles, cudaStream_t stream) {
  if (!valid(n, B) || tiles == nullptr) return (int)cudaErrorInvalidValue;
  const int nb = n / B;
  return launch(fused_chol2_kernel, nb * (nb + 1) / 2,
                Matrix{A, L, diag, sync, stamps, tiles, n, B, nb}, stream);
}

// CTAs per SM of K6 (which == 6) or K7 (which == 7) at their shared memory,
// from cudaOccupancyMaxActiveBlocksPerMultiprocessor, into *blocks.
extern "C" int fused_chol_occupancy(int which, int* blocks) {
  if (which != 6 && which != 7) return (int)cudaErrorInvalidValue;
  const Kernel kernel = which == 6 ? fused_chol_kernel : fused_chol2_kernel;
  size_t bytes;
  if (int err = prepare(kernel, &bytes)) return err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, THREADS, bytes);
}

// Kernel `which` (0: K6, 1: K7) for chip_smoke.py: its name into *name, its
// registers, local and static shared bytes into attrs[0..2]; -1 past the
// last kernel.
extern "C" int kernel_attrs(int which, const char** name, int* attrs) {
  switch (which) {
    case 0: *name = "fused_chol_kernel"; return func_attrs(fused_chol_kernel, attrs);
    case 1: *name = "fused_chol2_kernel"; return func_attrs(fused_chol2_kernel, attrs);
    default: return -1;
  }
}
