// SIMM latent-force-model covariance kernels for Hopper (sm_90a).
//
// Replaces, from the JAX package:
//   K1  dis_project_tpu/ops/pallas_gram.py::_gram_kernel      (cross_covariance)
//   K2  dis_project_tpu/ops/pallas_gram.py::_gram_sym_kernel  (gram_sym)
//
// Both evaluate the closed-form SIMM covariance (ops/lfm_kernels.py: k_xx,
// k_xf, k_ff with the reference's 2l quirk, and the flag-weighted 'mixed'
// combination) from packed per-row metadata [t, decay, sens, flag], laid out
// as a (4, n) array. One device function computes an entry; two launchers
// tile the output. Templated on float and double: the f64 build lets the
// canonical goldens be checked on the card through the kernels.
//
// What bounds them on the H100: the inputs are O(n + m) metadata, the output
// is n*m values written once (400 MB at n = m = 1e4 in f32, 0.12 ms at
// 3.35 TB/s). The arithmetic is ~6 erf and ~4 exp per 'xx' entry, done by
// CUDA's erff/expf (a few tens of FP32 instructions each), which is the same
// order as the write time, so either can bound a tile. The design keeps
// every input in registers or L1 (no shared-memory staging of metadata) and
// makes every store coalesced: a warp writes 32 consecutive columns of one
// row. K2 halves the arithmetic by computing only lower-triangle tiles; it
// writes the mirror through a shared-memory transpose so those stores stay
// coalesced too. A diagonal tile computes its lower half and mirrors it, so
// the Gram is exactly symmetric.
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

template <typename T>
struct Row {
  T t, d, s, f;
};

// Metadata of row r of a (4, n) [t; d; s; f] array.
template <typename T>
__device__ __forceinline__ Row<T> load_row(const T* __restrict__ meta, int n, int r) {
  return Row<T>{meta[r], meta[n + r], meta[2 * n + r], meta[3 * n + r]};
}

// ops/lfm_kernels.py::h_term, same operation order.
template <typename T>
__device__ __forceinline__ T h_term(T da, T db, T t1, T t2, T l) {
  const T gb = db * l * T(0.5);
  const T td = t2 - t1;
  const T mult = exp_(gb * gb) / (da + db);
  const T first = exp_(-db * td) * (erf_(td / l - gb) + erf_(t1 / l + gb));
  const T second = exp_(-(db * t2 + da * t1)) * (erf_(t2 / l - gb) + erf_(gb));
  return mult * (first - second);
}

template <typename T>
__device__ __forceinline__ T k_xx(T t, T tp, T dj, T dk, T sj, T sk, T l) {
  const T mult = sj * sk * l * T(0.5 * 1.7724538509055159);
  return mult * (h_term(dk, dj, tp, t, l) + h_term(dj, dk, t, tp, l));
}

template <typename T>
__device__ __forceinline__ T k_xf(T tx, T tf, T dj, T sj, T l) {
  const T gj = dj * l * T(0.5);
  const T td = tx - tf;
  const T first = T(0.5 * 1.7724538509055159) * l * sj;
  return first * exp_(gj * gj) * exp_(-dj * td) * (erf_(td / l - gj) + erf_(tf / l + gj));
}

template <typename T>
__device__ __forceinline__ T k_ff(T t, T tp, T l) {
  const T diff = t - tp;
  return exp_(-(diff * diff) / (T(2) * l));
}

// One covariance entry between row a and column b (pallas_gram._tile_values).
template <typename T>
__device__ __forceinline__ T cov(int kind, const Row<T>& a, const Row<T>& b, T l) {
  switch (kind) {
    case XX: return k_xx(a.t, b.t, a.d, b.d, a.s, b.s, l);
    case FF: return k_ff(a.t, b.t, l);
    case XF: return k_xf(a.t, b.t, a.d, a.s, l);
    case FX: return k_xf(b.t, a.t, b.d, b.s, l);
    default: {
      const T kxx = k_xx(a.t, b.t, a.d, b.d, a.s, b.s, l);
      const T kff = k_ff(a.t, b.t, l);
      const T kxf = k_xf(a.t, b.t, a.d, a.s, l);
      const T kfx = k_xf(b.t, a.t, b.d, b.s, l);
      const T w_xx = a.f * b.f;
      const T w_ff = (T(1) - a.f) * (T(1) - b.f);
      const T w_xf = a.f * (T(1) - b.f);
      const T w_fx = (T(1) - a.f) * b.f;
      return w_xx * kxx + w_ff * kff + w_xf * kxf + w_fx * kfx;
    }
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

// Kernel `which` (0..3: K1 f32, K1 f64, K2 f32, K2 f64) for
// chip_smoke.py: its name into *name, its registers, local and static
// shared bytes into attrs[0..2]; -1 past the last kernel.
int kernel_attrs(int which, const char** name, int* attrs) {
  switch (which) {
    case 0: *name = "gram_rect_kernel<float>"; return func_attrs(gram_rect_kernel<float>, attrs);
    case 1: *name = "gram_rect_kernel<double>"; return func_attrs(gram_rect_kernel<double>, attrs);
    case 2: *name = "gram_sym_kernel<float>"; return func_attrs(gram_sym_kernel<float>, attrs);
    case 3: *name = "gram_sym_kernel<double>"; return func_attrs(gram_sym_kernel<double>, attrs);
    default: return -1;
  }
}

}  // extern "C"
