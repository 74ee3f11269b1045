// Factorisation of one SPD block, on Hopper (sm_90a).
//
// Replaces, from the JAX package (dis_project_tpu/ops/pallas_cholesky.py):
//   K4  _chol_inv_kernel  (chol_inv_unblocked): L and L^{-1} of one B x B
//       block, B a multiple of 128 up to 512 -> chol_inv_kernel (one CTA)
//   K5  _chol_kernel      (chol_unblocked): L of one B x B block, B <= 512
//       -> chol_cluster_kernel (a thread-block cluster)
//
// On the port's main path K4 is the diagonal step of blocked_cholesky_t
// (B = 128, one launch per 128 columns of the f32 MLL factor); both kernels
// are the diag= options of blocked_cholesky (B = 512).
//
// K4: one CTA, left-looking over 128-wide panels (chol_block.cuh,
// chol_inv_block_fast): each 128 x 128 diagonal block factored and inverted
// in shared memory by chol_inv_128_fast (32 x 32 pieces by one warp in
// registers, 14 CTA barriers a step; the TPU's nilpotent doubling diverges
// on real Gram factors), the TRSM as a product with that inverse, the
// trailing matrix in a global workspace, the block-wise inverse assembly.
// The same routine is the diagonal step of K6 and K7. What bounds it:
// latency, 4 x 32 dependent pivots per 128 block; the optional stamps
// (K4_STAMPS slots of %globaltimer) say where the time of a 128 block goes
// (PERF.md).
//
// K5 replaces a single-CTA kernel (3.03 ms at B = 512, PERF.md): a 512^2
// f32 block is 1 MiB, beyond one CTA's 227 KB of shared memory, so that
// kernel kept its trailing matrix in a global workspace, read and written
// through L2 by each of 16 rank-32 updates, behind a chain of 512 column
// steps. Here the block lives in the shared memory of a thread-block
// cluster of C CTAs (one per 32-row block, at most 8, chosen by the
// wrapper; 8 CTAs at B = 512, each holding 64 rows, 129 KB, and a copy of
// the current panel, <= 66 KB). Rows go out in 32-row blocks, cyclically over
// the cluster's CTAs, so the shrinking trailing matrix stays balanced; the
// size is identity-padded to a multiple of 32 (chol(blkdiag(A, I)) =
// blkdiag(L, I)), so every panel is 32 wide. Right-looking over 32-wide
// panels; step p:
//   1. the CTA that owns the 32 x 32 diagonal block factors it with one
//      warp, in registers (warp_chol32: shuffles, no CTA barrier);
//   2. cluster barrier; every CTA copies that block from the owner's shared
//      memory (distributed shared memory, map_shared_rank) and solves its
//      own rows of the panel below it, one row per thread, by substitution;
//   3. cluster barrier; every CTA copies the finished panel rows below the
//      diagonal block from its peers, transposed, into its own shared
//      memory, and applies the rank-32 update to its own trailing rows,
//      4 rows x 8 columns per thread, each entry's 32 products summed in a
//      register and subtracted once (the rule that keeps K4/K5 accurate).
// At the end each CTA writes its rows of L (zeros above the diagonal) and
// waits at a last cluster barrier, so that no CTA exits while a peer may
// still read its shared memory. What bounds it: latency, 2 cluster barriers
// and one warp's 32-step factorisation per panel (16 panels at B = 512),
// not the B^3/3 operations. The cluster size rule (one CTA per 32-row
// block, at most 8) is the fastest of the sizes that fit, measured at
// B = 96, 128, 256 and 512 (PERF.md): more CTAs shorten each update and
// pull, and cost one more peer per cluster barrier.
//
// Plain FP32 FMAs throughout (no TF32, no bf16). A non-positive pivot gives
// NaN and never a trap; no control flow depends on the data, so every CTA
// reaches every cluster barrier and a non-PD block cannot hang.
//
// The C entry points launch on the given stream, allocate nothing, and
// return cudaGetLastError() (or the first failing attribute, occupancy or
// launch call's error).

#include <cooperative_groups.h>

#include "chol_block.cuh"
#include "kernel_attrs.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace chol_block;

constexpr int KW = 32;          // K5 panel width and row-block height
constexpr int DLD = KW + 1;     // leading dimension of the diagonal-block copy
constexpr int MAX_B = 512;
constexpr int MAX_CLUSTER = 8;  // the portable cluster size
constexpr int PULL = 4;         // remote float4 loads in flight per thread
static_assert(THREADS == KW * KW / 4, "the diagonal-block pull takes one float4 a thread");

// K5's shared memory for a block of B rows over C CTAs: the CTA's rows
// (ceil(nrb / C) row blocks of 32, each row Bp + 4 floats), the panel copy
// (32 x (Bp + 4)) and the diagonal block (32 x 33).
__host__ __device__ constexpr int padded(int B) { return (B + KW - 1) / KW * KW; }
__host__ __device__ constexpr int row_ld(int B) { return padded(B) + 4; }
__host__ __device__ constexpr int local_blocks(int B, int C) {
  return (padded(B) / KW + C - 1) / C;
}
size_t k5_smem_bytes(int B, int C) {
  return ((size_t)local_blocks(B, C) * KW * row_ld(B) + (size_t)KW * row_ld(B) + KW * DLD) *
         sizeof(float);
}

// One CTA a launch: the register limit is the CTA's whole budget (without
// the minimum of 1 the compiler capped the routine at 128 and spilled).
__global__ void __launch_bounds__(THREADS, 1)
chol_inv_kernel(const float* A, int lda, int B, float* L, float* Li, float* W,
                long long* stamps) {
  extern __shared__ __align__(16) float smem[];
  chol_inv_block_fast(A, lda, B, L, Li, W, smem, stamps);
}

__global__ void __launch_bounds__(THREADS)
chol_cluster_kernel(const float* A, int lda, int B, float* L) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int Bp = padded(B), nrb = Bp / KW, ld = row_ld(B);
  float* R = smem;                                              // local rows
  float* PT = R + (size_t)local_blocks(B, C) * KW * ld;         // PT[t][k] = L[k][off + t]
  float* D = PT + (size_t)KW * ld;                              // diagonal block
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // Local row block lb holds global row block lb * C + rank.
  const int nmine = rank < nrb ? (nrb - rank + C - 1) / C : 0;
  auto global_row = [&](int r) { return ((r / KW) * C + rank) * KW + r % KW; };

  // The lower triangle of the identity-padded block.
  for (int e = tid; e < nmine * KW * Bp; e += THREADS) {
    const int r = e / Bp, c = e % Bp, g = global_row(r);
    float v = 0.f;
    if (c <= g) v = g < B ? A[(size_t)g * lda + c] : (c == g ? 1.f : 0.f);
    R[(size_t)r * ld + c] = v;
  }

  for (int p = 0; p < nrb; ++p) {
    const int off = p * KW, owner = p % C, t0 = off + KW;
    __syncthreads();  // this CTA's update of the last panel is done
    if (rank == owner && warp == 0) warp_chol32(R + (size_t)(p / C) * KW * ld + off, ld);
    cluster.sync();
    {  // one float4 of the diagonal block per thread (THREADS == KW * KW / 4)
      const int j = tid / (KW / 4), q = tid % (KW / 4);
      const float4 v = *reinterpret_cast<const float4*>(
          cluster.map_shared_rank(R, owner) + (size_t)((p / C) * KW + j) * ld + off + 4 * q);
      D[j * DLD + 4 * q] = v.x, D[j * DLD + 4 * q + 1] = v.y;
      D[j * DLD + 4 * q + 2] = v.z, D[j * DLD + 4 * q + 3] = v.w;
    }
    __syncthreads();
    // This CTA's rows below the diagonal block: local blocks lb0.. .
    const int lb0 = p >= rank ? (p - rank) / C + 1 : 0;
    const int below = (nmine - lb0) * KW;
    for (int r = tid; r < below; r += THREADS)
      trsm_row32(R + (size_t)(lb0 * KW + r) * ld + off, D, DLD);
    cluster.sync();
    const int nk = Bp - t0;
    if (nk == 0) break;
    // PULL loads in flight per thread before their stores (a remote load
    // takes hundreds of cycles; one at a time they would serialise).
    for (int e0 = tid; e0 < nk * (KW / 4); e0 += PULL * THREADS) {
      float4 v[PULL];
#pragma unroll
      for (int u = 0; u < PULL; ++u) {
        const int e = e0 + u * THREADS;
        if (e >= nk * (KW / 4)) break;
        const int k = t0 + e / (KW / 4), q = e % (KW / 4), blk = k / KW;
        v[u] = *reinterpret_cast<const float4*>(cluster.map_shared_rank(R, blk % C) +
                                                (size_t)((blk / C) * KW + k % KW) * ld + off +
                                                4 * q);
      }
#pragma unroll
      for (int u = 0; u < PULL; ++u) {
        const int e = e0 + u * THREADS;
        if (e >= nk * (KW / 4)) break;
        const int k = t0 + e / (KW / 4), q = e % (KW / 4);
        PT[(4 * q) * ld + k] = v[u].x, PT[(4 * q + 1) * ld + k] = v[u].y;
        PT[(4 * q + 2) * ld + k] = v[u].z, PT[(4 * q + 3) * ld + k] = v[u].w;
      }
    }
    __syncthreads();
    // Rank-32 update of this CTA's trailing rows: per warp, units of 4 rows
    // x 256 columns (lane: columns cb + 4 lane + {0..3} and 128 more).
    const int nchunks = (nk + 255) / 256, units = (below / 4) * nchunks;
    for (int u = warp; u < units; u += WARPS) {
      const int r0 = lb0 * KW + (u / nchunks) * 4, cb = t0 + (u % nchunks) * 256;
      const int g0 = global_row(r0);
      if (cb > g0 + 3) continue;  // the whole unit is above the diagonal
      const int c0 = cb + 4 * lane, c1 = c0 + 128;
      const bool in0 = c0 < Bp, in1 = c1 < Bp;
      float acc[4][8] = {};
#pragma unroll 4
      for (int t = 0; t < KW; ++t) {
        float av[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) av[r] = R[(size_t)(r0 + r) * ld + off + t];
        const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
        const float4 b0 = in0 ? *reinterpret_cast<const float4*>(PT + t * ld + c0) : z;
        const float4 b1 = in1 ? *reinterpret_cast<const float4*>(PT + t * ld + c1) : z;
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
      }
      // Entries above the diagonal are written too: nothing reads them.
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (!(h ? in1 : in0)) continue;
          float4* dst = reinterpret_cast<float4*>(R + (size_t)(r0 + r) * ld + (h ? c1 : c0));
          const float4 v = *dst;
          *dst = make_float4(v.x - acc[r][4 * h], v.y - acc[r][4 * h + 1],
                             v.z - acc[r][4 * h + 2], v.w - acc[r][4 * h + 3]);
        }
    }
  }

  __syncthreads();
  for (int e = tid; e < nmine * KW * B; e += THREADS) {
    const int r = e / B, c = e % B, g = global_row(r);
    if (g < B) L[(size_t)g * B + c] = c <= g ? R[(size_t)r * ld + c] : 0.f;
  }
  cluster.sync();  // no CTA exits while a peer may still read its shared memory
}

template <typename Kernel>
int set_smem(Kernel kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

}  // namespace

// K4. stamps: K4_STAMPS int64 slots for the phase stamps, or nullptr.
extern "C" int chol_inv_block_f32(const float* A, int lda, int B, float* L, float* Li, float* W,
                                  long long* stamps, cudaStream_t stream) {
  if (B <= 0 || B % SUB || B > MAX_B || lda < B || (B > SUB && W == nullptr))
    return (int)cudaErrorInvalidValue;
  const size_t bytes = CHOL_INV_SMEM_FLOATS * sizeof(float);
  // The attribute is a host call of tens of microseconds: set once.
  static bool smem_set = false;
  if (!smem_set) {
    if (int err = set_smem(chol_inv_kernel, bytes)) return err;
    smem_set = true;
  }
  chol_inv_kernel<<<1, THREADS, bytes, stream>>>(A, lda, B, L, Li, W, stamps);
  return (int)cudaGetLastError();
}

// K5 on a cluster of `cluster` CTAs. Fails (without launching) when the
// cluster's shared memory does not fit or no such cluster can be resident.
extern "C" int chol_block_f32(const float* A, int lda, int B, float* L, int cluster,
                              cudaStream_t stream) {
  if (B <= 0 || B > MAX_B || lda < B || cluster < 1 || cluster > MAX_CLUSTER)
    return (int)cudaErrorInvalidValue;
  const size_t bytes = k5_smem_bytes(B, cluster);
  // The attribute and the occupancy check are host calls that cost tens of
  // microseconds, so they are made once (one device per process): the
  // attribute is a maximum, raised to the largest size launched so far
  // (lowering it would refuse a larger launch checked earlier), and the
  // occupancy check is made once per (cluster, row blocks).
  static size_t smem_attr = 0;
  static bool checked[MAX_CLUSTER + 1][MAX_B / KW + 1];
  if (bytes > smem_attr) {
    if (int err = set_smem(chol_cluster_kernel, bytes)) return err;
    smem_attr = bytes;
  }
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(cluster);
  config.blockDim = dim3(THREADS);
  config.dynamicSmemBytes = bytes;
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  if (!checked[cluster][padded(B) / KW]) {
    int clusters = 0;
    if (int err = (int)cudaOccupancyMaxActiveClusters(&clusters, chol_cluster_kernel, &config))
      return err;
    if (clusters < 1) return (int)cudaErrorInvalidConfiguration;
    checked[cluster][padded(B) / KW] = true;
  }
  if (int err = (int)cudaLaunchKernelEx(&config, chol_cluster_kernel, A, lda, B, L)) return err;
  return (int)cudaGetLastError();
}

// Kernel `which` (0: K4, 1: K5) for chip_smoke.py: its name into *name, its
// registers, local and static shared bytes into attrs[0..2]; -1 past the
// last kernel.
extern "C" int kernel_attrs(int which, const char** name, int* attrs) {
  switch (which) {
    case 0: *name = "chol_inv_kernel"; return func_attrs(chol_inv_kernel, attrs);
    case 1: *name = "chol_cluster_kernel"; return func_attrs(chol_cluster_kernel, attrs);
    default: return -1;
  }
}
