// SIMM latent-force-model covariance kernels for Hopper (sm_90a).
//
// Replaces, from the JAX package:
//   K1  dis_project_tpu/ops/pallas_gram.py::_gram_kernel      (cross_covariance)
//   K2  dis_project_tpu/ops/pallas_gram.py::_gram_sym_kernel  (gram_sym)
//   K2's gradient, dis_project_tpu/ops/pallas_gram.py::_gram_sym_bwd (an XLA
//       fusion of the closed form's VJP there; gram_sym_bwd_kernel here)
//
// All evaluate the closed-form SIMM covariance (ops/lfm_kernels.py: k_xx,
// k_xf, k_ff with the reference's 2l quirk, and the flag-weighted 'mixed'
// combination) from packed per-row metadata [t, decay, sens, flag], laid out
// as a (4, n) array. The closed forms are written once, templated on their
// scalar type: the forward kernels evaluate them in T, the backward kernel
// in Dual<T>, a forward-mode dual number carrying three tangents. Templated
// on float and double: the f64 build lets the canonical goldens be checked
// on the card through the kernels.
//
// What bounds them on the H100: the inputs are O(n + m) metadata, the output
// is n*m values written once (400 MB at n = m = 1e4 in f32, 0.12 ms at
// 3.35 TB/s). The arithmetic is ~8 erf and ~6 exp per 'xx' entry, done by
// CUDA's erff/expf (a few tens of FP32 instructions each), which is the same
// order as the write time, so either can bound a tile. The design keeps
// every input in registers or L1 (no shared-memory staging of metadata) and
// makes every store coalesced: a warp writes 32 consecutive columns of one
// row. K2 halves the arithmetic by computing only lower-triangle tiles; it
// writes the mirror through a shared-memory transpose so those stores stay
// coalesced too. A diagonal tile computes its lower half and mirrors it, so
// the Gram is exactly symmetric.
//
// The backward kernel walks the same lower tiles. K2 writes tril(K) +
// tril(K, -1)^T, so the gradient of <g, K2(theta)> is
//   sum_{a > b} (g_ab + g_ba) dK_ab/dtheta + sum_a g_aa dK_aa/dtheta,
// and g is not symmetric (the MLL backward hands over a lower-triangle
// form). Each CTA reads its tile of g row by row and the mirror tile
// g[j-block, i-block] the same way, transposed through shared memory (the
// forward's mirrored store, in reverse). It reads 4 n^2 bytes in f32
// (0.12 ms at n = 1e4) and does ~4x the forward's arithmetic (the dual
// tangents and one exp per erf for its derivative): operations bound it.
// Each entry's partials are evaluated in the working type; their products
// with the cotangent and every sum after are float64. Per-CTA bins of 2G+1
// accumulators (decay, sens, lengthscale) sit in shared memory: a warp
// shares one row, so row-gene partials take a warp shuffle sum;
// column-gene partials take one when the warp's 32 columns share a gene
// (the gene-major case), shared-memory atomics when not. The bins go to a
// (2G+1) float64 buffer by atomicAdd(double). The sums run over ~5e7 lower
// entries at n = 1e4, and the MLL's cotangent makes them cancel: in-tile
// float32 sums measured 3-30x the float32 plain VJP's error per group on
// the dense10k cotangent on an H100, float64 sums below it.
// Decay and sensitivity partials go only to expression rows of the kind
// (every row for 'xx', flag != 0 for 'mixed', none for 'ff'), each to its
// gene clamped to [0, G-1] as the forward's gather clamps it: a force row
// (gene -1) credits nothing to gene 0.
//
// Padding: none. Ragged edges are masked (the TPU kernel padded to tile
// multiples and sliced).
//
// Every entry point launches on the given stream, allocates nothing and
// returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>

#include "kernel_attrs.cuh"

namespace {

constexpr int TILE = 32;          // output tile edge
constexpr int ROWS_PER_PASS = 8;  // blockDim = (TILE, ROWS_PER_PASS)

enum Kind { XX = 0, FF = 1, XF = 2, FX = 3, MIXED = 4 };

__device__ __forceinline__ float erf_(float x) { return erff(x); }
__device__ __forceinline__ double erf_(double x) { return erf(x); }
__device__ __forceinline__ float exp_(float x) { return expf(x); }
__device__ __forceinline__ double exp_(double x) { return exp(x); }

// Forward-mode dual number with three tangents, for the backward kernel:
// slot 0 the row gene's decay, slot 1 the column gene's decay, slot 2 the
// lengthscale. The closed forms below are templated on their scalar type S
// (T, or Dual<T>); times are plain T. The value part of a Dual evaluation
// runs the same operations in the same order as the T evaluation.
template <typename T>
struct Dual {
  T v, d[3];
};

template <typename T>
__device__ __forceinline__ Dual<T> seed(T v, int slot) {
  Dual<T> r{v, {T(0), T(0), T(0)}};
  r.d[slot] = T(1);
  return r;
}

template <typename S> struct Base { using type = S; };
template <typename T> struct Base<Dual<T>> { using type = T; };

template <typename T>
__device__ __forceinline__ Dual<T> operator+(Dual<T> a, Dual<T> b) {
  return {a.v + b.v, {a.d[0] + b.d[0], a.d[1] + b.d[1], a.d[2] + b.d[2]}};
}
template <typename T>
__device__ __forceinline__ Dual<T> operator-(Dual<T> a, Dual<T> b) {
  return {a.v - b.v, {a.d[0] - b.d[0], a.d[1] - b.d[1], a.d[2] - b.d[2]}};
}
template <typename T>
__device__ __forceinline__ Dual<T> operator-(Dual<T> a) {
  return {-a.v, {-a.d[0], -a.d[1], -a.d[2]}};
}
template <typename T>
__device__ __forceinline__ Dual<T> operator*(Dual<T> a, Dual<T> b) {
  return {a.v * b.v, {a.d[0] * b.v + a.v * b.d[0], a.d[1] * b.v + a.v * b.d[1],
                      a.d[2] * b.v + a.v * b.d[2]}};
}
template <typename T>
__device__ __forceinline__ Dual<T> operator/(Dual<T> a, Dual<T> b) {
  const T q = a.v / b.v;
  const T r = T(1) / b.v;
  return {q, {(a.d[0] - q * b.d[0]) * r, (a.d[1] - q * b.d[1]) * r,
              (a.d[2] - q * b.d[2]) * r}};
}
template <typename T>
__device__ __forceinline__ Dual<T> operator+(Dual<T> a, T b) {
  return {a.v + b, {a.d[0], a.d[1], a.d[2]}};
}
template <typename T>
__device__ __forceinline__ Dual<T> operator+(T a, Dual<T> b) { return b + a; }
template <typename T>
__device__ __forceinline__ Dual<T> operator-(Dual<T> a, T b) {
  return {a.v - b, {a.d[0], a.d[1], a.d[2]}};
}
template <typename T>
__device__ __forceinline__ Dual<T> operator-(T a, Dual<T> b) {
  return {a - b.v, {-b.d[0], -b.d[1], -b.d[2]}};
}
template <typename T>
__device__ __forceinline__ Dual<T> operator*(Dual<T> a, T b) {
  return {a.v * b, {a.d[0] * b, a.d[1] * b, a.d[2] * b}};
}
template <typename T>
__device__ __forceinline__ Dual<T> operator*(T a, Dual<T> b) {
  return {a * b.v, {a * b.d[0], a * b.d[1], a * b.d[2]}};
}
template <typename T>
__device__ __forceinline__ Dual<T> operator/(T a, Dual<T> b) {
  const T q = a / b.v;
  const T r = -q / b.v;
  return {q, {r * b.d[0], r * b.d[1], r * b.d[2]}};
}
template <typename T>
__device__ __forceinline__ Dual<T> exp_(Dual<T> a) {
  const T e = exp_(a.v);
  return {e, {e * a.d[0], e * a.d[1], e * a.d[2]}};
}
// erf'(x) = 2/sqrt(pi) exp(-x^2).
template <typename T>
__device__ __forceinline__ Dual<T> erf_(Dual<T> a) {
  const T de = T(1.1283791670955126) * exp_(-(a.v * a.v));
  return {erf_(a.v), {de * a.d[0], de * a.d[1], de * a.d[2]}};
}

template <typename T>
struct Row {
  T t, d, s, f;
};

// Metadata of row r of a (4, n) [t; d; s; f] array.
template <typename T>
__device__ __forceinline__ Row<T> load_row(const T* __restrict__ meta, int n, int r) {
  return Row<T>{meta[r], meta[n + r], meta[2 * n + r], meta[3 * n + r]};
}

// ops/lfm_kernels.py::h_term, same operation order. S is T or Dual<T>;
// the times t1, t2 carry no tangent.
template <typename S, typename T = typename Base<S>::type>
__device__ __forceinline__ S h_term(S da, S db, T t1, T t2, S l) {
  const S gb = db * l * T(0.5);
  const T td = t2 - t1;
  const S mult = exp_(gb * gb) / (da + db);
  const S first = exp_(-db * td) * (erf_(td / l - gb) + erf_(t1 / l + gb));
  const S second = exp_(-(db * t2 + da * t1)) * (erf_(t2 / l - gb) + erf_(gb));
  return mult * (first - second);
}

// k_xx without its sensitivities: k_xx = S_j S_k * k_xx_u.
template <typename S, typename T = typename Base<S>::type>
__device__ __forceinline__ S k_xx_u(T t, T tp, S dj, S dk, S l) {
  return l * T(0.5 * 1.7724538509055159) * (h_term(dk, dj, tp, t, l) + h_term(dj, dk, t, tp, l));
}

// k_xf without its sensitivity: k_xf = S_j * k_xf_u.
template <typename S, typename T = typename Base<S>::type>
__device__ __forceinline__ S k_xf_u(T tx, T tf, S dj, S l) {
  const S gj = dj * l * T(0.5);
  const T td = tx - tf;
  return T(0.5 * 1.7724538509055159) * l * exp_(gj * gj) * exp_(-dj * td) *
         (erf_(td / l - gj) + erf_(tf / l + gj));
}

template <typename S, typename T = typename Base<S>::type>
__device__ __forceinline__ S k_ff(T t, T tp, S l) {
  const T diff = t - tp;
  return exp_(-(diff * diff) / (T(2) * l));
}

// The four branch values of one covariance entry between row a (decay da)
// and column b (decay db), before sensitivities and flag weights; only the
// branches `kind` uses are evaluated (the others are 0).
template <typename S>
struct Terms {
  S xx, ff, xf, fx;
};

template <int KIND, typename S, typename T = typename Base<S>::type>
__device__ __forceinline__ Terms<S> terms(T ta, T tb, S da, S db, S l) {
  Terms<S> r{};
  if (KIND == XX || KIND == MIXED) r.xx = k_xx_u(ta, tb, da, db, l);
  if (KIND == FF || KIND == MIXED) r.ff = k_ff(ta, tb, l);
  if (KIND == XF || KIND == MIXED) r.xf = k_xf_u(ta, tb, da, l);
  if (KIND == FX || KIND == MIXED) r.fx = k_xf_u(tb, ta, db, l);
  return r;
}

// One covariance entry between row a and column b (pallas_gram._tile_values).
template <int KIND, typename T>
__device__ __forceinline__ T cov_k(const Row<T>& a, const Row<T>& b, T l) {
  const Terms<T> k = terms<KIND>(a.t, b.t, a.d, b.d, l);
  switch (KIND) {
    case XX: return a.s * b.s * k.xx;
    case FF: return k.ff;
    case XF: return a.s * k.xf;
    case FX: return b.s * k.fx;
    default: {
      const T w_xx = a.f * b.f;
      const T w_ff = (T(1) - a.f) * (T(1) - b.f);
      const T w_xf = a.f * (T(1) - b.f);
      const T w_fx = (T(1) - a.f) * b.f;
      return w_xx * (a.s * b.s * k.xx) + w_ff * k.ff + w_xf * (a.s * k.xf) +
             w_fx * (b.s * k.fx);
    }
  }
}

template <typename T>
__device__ __forceinline__ T cov(int kind, const Row<T>& a, const Row<T>& b, T l) {
  switch (kind) {
    case XX: return cov_k<XX>(a, b, l);
    case FF: return cov_k<FF>(a, b, l);
    case XF: return cov_k<XF>(a, b, l);
    case FX: return cov_k<FX>(a, b, l);
    default: return cov_k<MIXED>(a, b, l);
  }
}

// K1: one block per (TILE x TILE) output tile of the (n, m) matrix.
template <typename T>
__global__ void __launch_bounds__(TILE * ROWS_PER_PASS)
gram_rect_kernel(const T* __restrict__ m1, int n, const T* __restrict__ m2, int m,
                 const T* __restrict__ ell, T* __restrict__ out, int kind) {
  const int col = blockIdx.x * TILE + threadIdx.x;
  if (col >= m) return;
  const T l = *ell;
  const Row<T> b = load_row(m2, m, col);
  const int row0 = blockIdx.y * TILE;
  for (int r = threadIdx.y; r < TILE; r += ROWS_PER_PASS) {
    const int row = row0 + r;
    if (row >= n) break;
    out[(size_t)row * m + col] = cov(kind, load_row(m1, n, row), b, l);
  }
}

// Decode the lower-triangle tile (i, j), j <= i, of linear block index b,
// in row-major order over the lower triangle (np.tril_indices order).
__device__ __forceinline__ void tril_tile(long long b, int* i_out, int* j_out) {
  int i = (int)((sqrt(8.0 * (double)b + 1.0) - 1.0) * 0.5);
  while ((long long)i * (i + 1) / 2 > b) --i;
  while ((long long)(i + 1) * (i + 2) / 2 <= b) ++i;
  *i_out = i;
  *j_out = (int)(b - (long long)i * (i + 1) / 2);
}

// K2: one block per lower-triangle tile (i, j); writes tile (i, j) and, off
// the diagonal, its transpose to (j, i) through shared memory.
template <typename T>
__global__ void __launch_bounds__(TILE * ROWS_PER_PASS)
gram_sym_kernel(const T* __restrict__ meta, int n, const T* __restrict__ ell,
                T* __restrict__ out, int kind) {
  __shared__ T tile[TILE][TILE + 1];
  int i, j;
  tril_tile(blockIdx.x, &i, &j);
  const T l = *ell;
  const int tx = threadIdx.x;
  const int col = j * TILE + tx;
  const bool col_ok = col < n;
  Row<T> b{};
  if (col_ok) b = load_row(meta, n, col);
  for (int r = threadIdx.y; r < TILE; r += ROWS_PER_PASS) {
    const int row = i * TILE + r;
    T v = T(0);
    // A diagonal tile computes its lower half only; the store mirrors it.
    if (row < n && col_ok && (i != j || r >= tx)) v = cov(kind, load_row(meta, n, row), b, l);
    tile[r][tx] = v;
  }
  __syncthreads();
  for (int r = threadIdx.y; r < TILE; r += ROWS_PER_PASS) {
    const int row = i * TILE + r;
    if (row < n && col_ok)
      out[(size_t)row * n + col] = (i == j && r < tx) ? tile[tx][r] : tile[r][tx];
  }
  if (i == j) return;
  const int tcol = i * TILE + tx;
  if (tcol >= n) return;
  for (int r = threadIdx.y; r < TILE; r += ROWS_PER_PASS) {
    const int trow = j * TILE + r;
    if (trow < n) out[(size_t)trow * n + tcol] = tile[tx][r];
  }
}

template <typename T>
int launch_rect(const T* m1, int n, const T* m2, int m, const T* ell, T* out, int kind,
                cudaStream_t stream) {
  if (n > 0 && m > 0) {
    const dim3 grid((m + TILE - 1) / TILE, (n + TILE - 1) / TILE);
    gram_rect_kernel<T><<<grid, dim3(TILE, ROWS_PER_PASS), 0, stream>>>(m1, n, m2, m, ell, out,
                                                                        kind);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch_sym(const T* meta, int n, const T* ell, T* out, int kind, cudaStream_t stream) {
  if (n > 0) {
    const long long nt = (n + TILE - 1) / TILE;
    const unsigned blocks = (unsigned)(nt * (nt + 1) / 2);
    gram_sym_kernel<T><<<blocks, dim3(TILE, ROWS_PER_PASS), 0, stream>>>(meta, n, ell, out, kind);
  }
  return (int)cudaGetLastError();
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int KIND, typename T>
__device__ __forceinline__ bool expression_row(T flag) {
  return KIND == XX || (KIND == MIXED && flag != T(0));
}

// Partials of one entry K_ab with respect to the row gene's decay and
// sensitivity, the column gene's decay and sensitivity, and l.
template <typename T>
struct Partials {
  T da, sa, db, sb, l;
};

template <int KIND, typename T>
__device__ __forceinline__ Partials<T> partials(const Row<T>& a, const Row<T>& b, T l) {
  // Sensitivities need no tangent: k_xx and k_xf are S x (unscaled), and
  // their S-partials are taken from the unscaled value.
  const Terms<Dual<T>> k = terms<KIND>(a.t, b.t, seed(a.d, 0), seed(b.d, 1), seed(l, 2));
  Partials<T> p{};
  if (KIND == XX) {
    const T ss = a.s * b.s;
    p = {ss * k.xx.d[0], b.s * k.xx.v, ss * k.xx.d[1], a.s * k.xx.v, ss * k.xx.d[2]};
  } else if (KIND == FF) {
    p.l = k.ff.d[2];
  } else {
    const T w_xx = a.f * b.f;
    const T w_ff = (T(1) - a.f) * (T(1) - b.f);
    const T w_xf = a.f * (T(1) - b.f);
    const T w_fx = (T(1) - a.f) * b.f;
    const T ss = a.s * b.s;
    p.da = w_xx * (ss * k.xx.d[0]) + w_xf * (a.s * k.xf.d[0]);
    p.db = w_xx * (ss * k.xx.d[1]) + w_fx * (b.s * k.fx.d[1]);
    p.sa = w_xx * (b.s * k.xx.v) + w_xf * k.xf.v;
    p.sb = w_xx * (a.s * k.xx.v) + w_fx * k.fx.v;
    p.l = w_xx * (ss * k.xx.d[2]) + w_ff * k.ff.d[2] + w_xf * (a.s * k.xf.d[2]) +
          w_fx * (b.s * k.fx.d[2]);
  }
  return p;
}

// K2's backward: one block per lower-triangle tile (i, j), as the forward.
// grad (2G+1, float64, zeroed by the caller) receives [d decay (G),
// d sens (G), d l]. Dynamic shared memory: 2G+1 float64 bins.
template <typename T, int KIND>
__global__ void __launch_bounds__(TILE * ROWS_PER_PASS)
gram_sym_bwd_kernel(const T* __restrict__ meta, const int* __restrict__ gene, int n, int G,
                    const T* __restrict__ ell, const T* __restrict__ g,
                    double* __restrict__ grad) {
  extern __shared__ __align__(8) unsigned char bins_raw[];
  double* bins = reinterpret_cast<double*>(bins_raw);
  __shared__ T gt[TILE][TILE + 1];  // gt[r][c] = g[j*TILE + r][i*TILE + c]
  int i, j;
  tril_tile(blockIdx.x, &i, &j);
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * TILE + tx;
  constexpr int THREADS = TILE * ROWS_PER_PASS;
  for (int e = tid; e < 2 * G + 1; e += THREADS) bins[e] = 0.0;
  const int mcol = i * TILE + tx;
  for (int r = ty; r < TILE; r += ROWS_PER_PASS) {
    const int mrow = j * TILE + r;
    gt[r][tx] = (mrow < n && mcol < n) ? g[(size_t)mrow * n + mcol] : T(0);
  }
  __syncthreads();

  const T l = *ell;
  const int col = j * TILE + tx;
  const bool col_ok = col < n;
  Row<T> b{};
  int gene_b = 0;
  if (col_ok) {
    b = load_row(meta, n, col);
    gene_b = min(max(gene[col], 0), G - 1);
  }
  const bool col_expr = col_ok && expression_row<KIND>(b.f);
  double c_d = 0.0, c_s = 0.0, c_l = 0.0;
  for (int r = ty; r < TILE; r += ROWS_PER_PASS) {
    const int row = i * TILE + r;
    if (row >= n) break;  // uniform across the warp: one row per warp
    const Row<T> a = load_row(meta, n, row);
    double r_d = 0.0, r_s = 0.0;
    if (col_ok && (i != j || r >= tx)) {
      double w = (double)g[(size_t)row * n + col];
      if (i != j || r != tx) w += (double)gt[tx][r];  // g[col][row]
      const Partials<T> p = partials<KIND>(a, b, l);
      r_d = w * (double)p.da;
      r_s = w * (double)p.sa;
      if (col_expr) {
        c_d += w * (double)p.db;
        c_s += w * (double)p.sb;
      }
      c_l += w * (double)p.l;
    }
    if (KIND != FF && expression_row<KIND>(a.f)) {
      r_d = warp_sum(r_d);
      r_s = warp_sum(r_s);
      if (tx == 0) {
        const int ga = min(max(gene[row], 0), G - 1);
        atomicAdd(&bins[ga], r_d);
        atomicAdd(&bins[G + ga], r_s);
      }
    }
  }
  if (KIND != FF) {
    const int g0 = __shfl_sync(0xffffffffu, gene_b, 0);
    if (__all_sync(0xffffffffu, !col_expr || gene_b == g0)) {
      c_d = warp_sum(c_d);
      c_s = warp_sum(c_s);
      if (tx == 0 && (c_d != 0.0 || c_s != 0.0)) {
        atomicAdd(&bins[g0], c_d);
        atomicAdd(&bins[G + g0], c_s);
      }
    } else if (col_expr) {
      atomicAdd(&bins[gene_b], c_d);
      atomicAdd(&bins[G + gene_b], c_s);
    }
  }
  c_l = warp_sum(c_l);
  if (tx == 0) atomicAdd(&bins[2 * G], c_l);
  __syncthreads();
  for (int e = tid; e < 2 * G + 1; e += THREADS)
    if (bins[e] != 0.0) atomicAdd(&grad[e], bins[e]);
}

template <typename T, int KIND>
int launch_sym_bwd_k(const T* meta, const int* gene, int n, int G, const T* ell, const T* g,
                     double* grad, cudaStream_t stream) {
  const size_t smem = (size_t)(2 * G + 1) * sizeof(double);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        gram_sym_bwd_kernel<T, KIND>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long nt = (n + TILE - 1) / TILE;
  const unsigned blocks = (unsigned)(nt * (nt + 1) / 2);
  gram_sym_bwd_kernel<T, KIND><<<blocks, dim3(TILE, ROWS_PER_PASS), smem, stream>>>(
      meta, gene, n, G, ell, g, grad);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_sym_bwd(const T* meta, const int* gene, int n, int G, const T* ell, const T* g,
                   double* grad, int kind, cudaStream_t stream) {
  if (n <= 0) return (int)cudaGetLastError();
  switch (kind) {
    case XX: return launch_sym_bwd_k<T, XX>(meta, gene, n, G, ell, g, grad, stream);
    case FF: return launch_sym_bwd_k<T, FF>(meta, gene, n, G, ell, g, grad, stream);
    case MIXED: return launch_sym_bwd_k<T, MIXED>(meta, gene, n, G, ell, g, grad, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

int simm_gram_rect_f32(const float* m1, int n, const float* m2, int m, const float* ell,
                       float* out, int kind, cudaStream_t stream) {
  return launch_rect<float>(m1, n, m2, m, ell, out, kind, stream);
}

int simm_gram_rect_f64(const double* m1, int n, const double* m2, int m, const double* ell,
                       double* out, int kind, cudaStream_t stream) {
  return launch_rect<double>(m1, n, m2, m, ell, out, kind, stream);
}

int simm_gram_sym_f32(const float* meta, int n, const float* ell, float* out, int kind,
                      cudaStream_t stream) {
  return launch_sym<float>(meta, n, ell, out, kind, stream);
}

int simm_gram_sym_f64(const double* meta, int n, const double* ell, double* out, int kind,
                      cudaStream_t stream) {
  return launch_sym<double>(meta, n, ell, out, kind, stream);
}

int simm_gram_sym_bwd_f32(const float* meta, const int* gene, int n, int G, const float* ell,
                          const float* g, double* grad, int kind, cudaStream_t stream) {
  return launch_sym_bwd<float>(meta, gene, n, G, ell, g, grad, kind, stream);
}


int simm_gram_sym_bwd_f64(const double* meta, const int* gene, int n, int G, const double* ell,
                          const double* g, double* grad, int kind, cudaStream_t stream) {
  return launch_sym_bwd<double>(meta, gene, n, G, ell, g, grad, kind, stream);
}

// Kernel `which` (0..3: K1 f32, K1 f64, K2 f32, K2 f64; 4..9: K2's
// backward, f32 then f64, kinds xx, ff, mixed) for chip_smoke.py: its name
// into *name, its registers, local and static shared bytes into
// attrs[0..2]; -1 past the last kernel.
int kernel_attrs(int which, const char** name, int* attrs) {
  switch (which) {
    case 0: *name = "gram_rect_kernel<float>"; return func_attrs(gram_rect_kernel<float>, attrs);
    case 1: *name = "gram_rect_kernel<double>"; return func_attrs(gram_rect_kernel<double>, attrs);
    case 2: *name = "gram_sym_kernel<float>"; return func_attrs(gram_sym_kernel<float>, attrs);
    case 3: *name = "gram_sym_kernel<double>"; return func_attrs(gram_sym_kernel<double>, attrs);
    case 4: *name = "gram_sym_bwd_kernel<float, xx>";
      return func_attrs(gram_sym_bwd_kernel<float, XX>, attrs);
    case 5: *name = "gram_sym_bwd_kernel<float, ff>";
      return func_attrs(gram_sym_bwd_kernel<float, FF>, attrs);
    case 6: *name = "gram_sym_bwd_kernel<float, mixed>";
      return func_attrs(gram_sym_bwd_kernel<float, MIXED>, attrs);
    case 7: *name = "gram_sym_bwd_kernel<double, xx>";
      return func_attrs(gram_sym_bwd_kernel<double, XX>, attrs);
    case 8: *name = "gram_sym_bwd_kernel<double, ff>";
      return func_attrs(gram_sym_bwd_kernel<double, FF>, attrs);
    case 9: *name = "gram_sym_bwd_kernel<double, mixed>";
      return func_attrs(gram_sym_bwd_kernel<double, MIXED>, attrs);
    default: return -1;
  }
}

}  // extern "C"
