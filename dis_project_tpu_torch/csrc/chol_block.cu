// Factorisation of one SPD block by one thread block, on Hopper (sm_90a).
//
// Replaces, from the JAX package (dis_project_tpu/ops/pallas_cholesky.py):
//   K4  _chol_inv_kernel  (chol_inv_unblocked): L and L^{-1} of one B x B
//       block, B a multiple of 128 up to 512 -> chol_inv_kernel
//   K5  _chol_kernel      (chol_unblocked): L of one B x B block, B <= 512
//       -> chol_kernel
//
// On the port's main path K4 is the diagonal step of blocked_cholesky_t
// (B = 128, one launch per 128 columns of the f32 MLL factor); both kernels
// are the diag= options of blocked_cholesky (B = 512).
//
// What bounds them on the H100: latency. One CTA factors one block, and the
// factorisation is a chain of B dependent column steps, each a barrier: a
// B = 128 block is ~1.4 MFLOP (K4), a few microseconds of one SM's FP32
// rate, while the chain costs a barrier and a shared-memory round trip per
// column. The TPU kernels hold the block in VMEM (16 MiB); here a 512^2 f32
// block is 1 MiB, beyond the 227 KB of shared memory, so only the working
// panel lives in shared memory and the trailing matrix in a global
// workspace, which stays in L2 (50 MB). The design keeps the serial part in
// shared memory and does the rest as CTA-wide register-tiled products:
//   K4: left-looking over 128-wide panels (chol_block.cuh, chol_inv_block):
//       the 128 x 128 diagonal block factored (32-wide panels, register-summed
//       trailing updates) and inverted by substitution in shared memory (the
//       TPU's nilpotent doubling inverse diverges on real Gram factors), the
//       TRSM as a product with that inverse, the trailing update, the
//       block-wise inverse assembly.
//   K5: right-looking over 32-wide column panels: each whole m x 32 panel
//       (m <= 512 rows, 66 KB) is factored in shared memory by rank-1
//       updates, as the TPU kernel factors its whole block, then the
//       trailing matrix takes the panel's rank-32 update.
// Plain FP32 FMAs throughout (no TF32, no bf16). A non-positive pivot gives
// NaN, never a trap. Both kernels are latency-bound at these sizes; making
// them fast (more CTAs per block, wgmma products) is later work.
//
// The C entry points launch one CTA on the given stream, allocate nothing,
// and return cudaGetLastError() (or the attribute call's error).

#include "chol_block.cuh"

namespace {

using namespace chol_block;

constexpr int KW = 32;  // K5 panel width
constexpr int KLD = KW + 1;
constexpr int MAX_B = 512;
constexpr int CHOL_SMEM_FLOATS = MAX_B * KLD + GEMM_SMEM_FLOATS;

__global__ void __launch_bounds__(THREADS)
chol_inv_kernel(const float* A, int lda, int B, float* L, float* Li, float* W) {
  extern __shared__ __align__(16) float smem[];
  chol_inv_block(A, lda, B, L, Li, W, smem);
}

__global__ void __launch_bounds__(THREADS)
chol_kernel(const float* A, int lda, int B, float* L, float* W) {
  extern __shared__ __align__(16) float smem[];
  float* P = smem;                  // the m x KW panel
  float* G = smem + MAX_B * KLD;    // product tiles
  zero_upper(L, B);
  for (int off = 0; off < B; off += KW) {
    const int w = min(KW, B - off);
    const int m = B - off;
    const float* src = off == 0 ? A : W;
    const int lds = off == 0 ? lda : B;
    for (int i = threadIdx.x >> 5; i < m; i += WARPS)
      for (int j = threadIdx.x & 31; j < w && j <= i; j += 32)
        P[i * KLD + j] = src[(size_t)(off + i) * lds + off + j];
    __syncthreads();
    panel_chol_shared(P, KLD, m, w);
    for (int i = threadIdx.x >> 5; i < m; i += WARPS)
      for (int j = threadIdx.x & 31; j < w && j <= i; j += 32)
        L[(size_t)(off + i) * B + off + j] = P[i * KLD + j];
    __syncthreads();
    if (m > w) {
      float* Lp = L + (size_t)(off + w) * B + off;
      cta_gemm<true, true>(m - w, m - w, w, -1.f, Lp, B, Lp, B,
                           src + (size_t)(off + w) * lds + off + w, lds,
                           W + (size_t)(off + w) * B + off + w, B, G);
    }
  }
}

template <typename Kernel>
int set_smem(Kernel kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

}  // namespace

extern "C" int chol_inv_block_f32(const float* A, int lda, int B, float* L, float* Li, float* W,
                                  cudaStream_t stream) {
  if (B <= 0 || B % SUB || B > MAX_B || lda < B || (B > SUB && W == nullptr))
    return (int)cudaErrorInvalidValue;
  const size_t bytes = CHOL_INV_SMEM_FLOATS * sizeof(float);
  if (int err = set_smem(chol_inv_kernel, bytes)) return err;
  chol_inv_kernel<<<1, THREADS, bytes, stream>>>(A, lda, B, L, Li, W);
  return (int)cudaGetLastError();
}

extern "C" int chol_block_f32(const float* A, int lda, int B, float* L, float* W,
                              cudaStream_t stream) {
  if (B <= 0 || B > MAX_B || lda < B || W == nullptr) return (int)cudaErrorInvalidValue;
  const size_t bytes = CHOL_SMEM_FLOATS * sizeof(float);
  if (int err = set_smem(chol_kernel, bytes)) return err;
  chol_kernel<<<1, THREADS, bytes, stream>>>(A, lda, B, L, W);
  return (int)cudaGetLastError();
}
