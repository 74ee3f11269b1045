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
// as a (4, n) array, in float or double (the f64 build lets the canonical
// goldens be checked on the card through the kernels).
//
// K1 (gram_rect_kernel) evaluates the whole closed form per entry, one CTA
// per 32 x 32 tile.
//
// K2 (gram_sym_kernel) and its backward (gram_sym_bwd_kernel) evaluate once
// per row what depends on one row only. For row a (time t, decay D, sens S,
// gamma = D l / 2) a CTA stages in shared memory t, t/l, D, S, flag, gamma,
// E = exp(gamma^2), e = exp(-D t) and r = e (erf(t/l - gamma) + erf(gamma)),
// and for the backward r's derivatives in D and l (fill_table). An 'xx'
// entry (a, b), delta = t_a - t_b, x = delta / l, is then
//   A1 = exp(-D_a delta) (erf(x - gamma_a) + erf(t_b/l + gamma_a))
//   A2 = exp( D_b delta) (erf(-x - gamma_b) + erf(t_a/l + gamma_b))
//   k_xx = S_a S_b c l (E_a (A1 - r_a e_b) + E_b (A2 - r_b e_a)) / (D_a + D_b),
// c = sqrt(pi)/2: 4 erf, 2 exp and one reciprocal, where the closed form
// spends 8 erf, 6 exp and 2 divisions. k_xf and k_fx are c l E A1 and
// c l E A2. exp(-D_a delta) stays one exponential (split into a row and a
// column factor it overflows float once D t > 88). Every erf argument is
// the plain version's bit for bit (delta / l rounded as the IEEE division
// rounds it, by an FMA correction that needs no slow-path branch): erf's
// rounding is amplified by exp(D |delta|) <= e^12 on rows over [0, 12],
// and the kernels must round where the plain version does. Two of the four
// erf depend on one time and one gamma (erf(t_b/l + gamma_a), erf(t_a/l +
// gamma_b)): where a tile's rows and its columns each carry at most GCAP
// distinct gammas (a gene-major layout holds one or two genes in 64 rows),
// the CTA tabulates them per (gamma, time) pair (cross_tables), leaving 2
// erf, 2 exp and the reciprocal per entry; other tiles evaluate all four.
//
// K2 forward: one CTA of 256 threads per 64 x 64 lower tile (i, j), decoded
// from the block index in single precision with integer fix-ups. Each
// thread computes a 4 x 4 block in registers; a warp holds 4 x 8 such
// blocks, so it writes the tile row by row as 16-byte stores of 8 lanes
// (128 contiguous bytes a row) and, off the diagonal, the mirror tile
// (j, i) from the same registers as 16-byte stores of 4 lanes (64 bytes a
// row, whole 32-byte sectors): no shared-memory transpose. A diagonal tile
// computes the blocks on and below its diagonal and mirrors them, so the
// Gram is exactly symmetric. Ragged edges are masked (scalar stores), and
// a row length that is not a multiple of 16 bytes takes scalar stores.
// What bounds it on the H100: 4 n^2 bytes written (400 MB at n = 1e4 in
// f32, 0.12 ms at 3.35 TB/s); its instructions (erf is a polynomial of
// ~30, both of its branches evaluated) take longer than that.
//
// K2's backward is reverse mode written by hand from that hoisted form. K2
// writes tril(K) + tril(K, -1)^T, so the gradient of <g, K2(theta)> is
//   sum_{a > b} (g_ab + g_ba) dK_ab/dtheta + sum_a g_aa dK_aa/dtheta,
// and g is not symmetric (the MLL backward hands over a lower-triangle
// form). Each thread reads its 4 x 4 block of g and the mirror block
// g[b][a] as 16-byte loads (the forward's two store patterns) and, per
// entry, sweeps the hoisted form backwards from the seed dK/dU = S_a S_b
// (partials): the adjoints of A1, A2, E, r, e and the four erf arguments
// (erf'(u) = 2/sqrt(pi) exp(-u^2), one exp each, tabulated with the erf
// they belong to), chained through the staged per-row derivatives. Each
// entry's partials are evaluated in the working type; their products with
// the cotangent and every sum after are float64 (the MLL cotangent cancels:
// float32 sums measured 3-30x the plain VJP's error on the dense10k
// cotangent). Row and column sums go through warp shuffles and shared
// memory to per-CTA float64 bins of 2G+1 (decay, sens, lengthscale), one
// shared atomic per gene present in a warp's 32 rows. The grid is
// persistent (as many CTAs as fit on the card, walking the lower tiles with
// a stride), so each CTA zeroes and flushes its bins once: ~(2G+1) x 132 x
// K2BWD_MIN_CTAS global float64 atomics in all. Decay and sensitivity
// partials go only to expression rows of the kind (every row for 'xx',
// flag != 0 for 'mixed', none for 'ff'), each to its gene clamped to
// [0, G-1] as the forward's gather clamps it: a force row (gene -1) credits
// nothing to gene 0. What bounds it: the same 4 n^2 bytes read; its
// instructions again take longer, and among them the float32-to-float64
// conversions and the exp run at a quarter of the FP32 rate.
//
// Padding: none. Every entry point launches on the given stream, allocates
// nothing and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>

#include <algorithm>

#include "kernel_attrs.cuh"

namespace {

constexpr int TILE = 32;          // K1: output tile edge
constexpr int ROWS_PER_PASS = 8;  // K1: blockDim = (TILE, ROWS_PER_PASS)

constexpr int STILE = 64;         // K2 and its backward: lower tile edge
constexpr int STHREADS = 256;     // 8 warps, each 4 x 8 blocks of 4 x 4
// CTAs an SM must hold (float instances; double takes 1): K2 at 3 (80
// registers), its backward at 2 (128 registers; at 3 it spills), the
// fastest of those tried on an H100 (PERF.md).
constexpr int K2_MIN_CTAS = 3;
constexpr int K2BWD_MIN_CTAS = 2;
constexpr double SQRT_PI = 1.7724538509055159;
constexpr double TWO_OVER_SQRT_PI = 1.1283791670955126;

enum Kind { XX = 0, FF = 1, XF = 2, FX = 3, MIXED = 4 };

__device__ __forceinline__ float erf_(float x) { return erff(x); }
__device__ __forceinline__ double erf_(double x) { return erf(x); }
__device__ __forceinline__ float exp_(float x) { return expf(x); }
__device__ __forceinline__ double exp_(double x) { return exp(x); }

// ---------------------------------------------------------------------------
// K1: the whole closed form per entry.
// ---------------------------------------------------------------------------

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

// k_xx without its sensitivities: k_xx = S_j S_k * k_xx_u.
template <typename T>
__device__ __forceinline__ T k_xx_u(T t, T tp, T dj, T dk, T l) {
  return l * T(0.5 * SQRT_PI) * (h_term(dk, dj, tp, t, l) + h_term(dj, dk, t, tp, l));
}

// k_xf without its sensitivity: k_xf = S_j * k_xf_u.
template <typename T>
__device__ __forceinline__ T k_xf_u(T tx, T tf, T dj, T l) {
  const T gj = dj * l * T(0.5);
  const T td = tx - tf;
  return T(0.5 * SQRT_PI) * l * exp_(gj * gj) * exp_(-dj * td) *
         (erf_(td / l - gj) + erf_(tf / l + gj));
}

template <typename T>
__device__ __forceinline__ T k_ff(T t, T tp, T l) {
  const T diff = t - tp;
  return exp_(-(diff * diff) / (T(2) * l));
}

// One covariance entry between row a and column b (pallas_gram._tile_values).
template <int KIND, typename T>
__device__ __forceinline__ T cov_k(const Row<T>& a, const Row<T>& b, T l) {
  T xx = T(0), ff = T(0), xf = T(0), fx = T(0);
  if (KIND == XX || KIND == MIXED) xx = a.s * b.s * k_xx_u(a.t, b.t, a.d, b.d, l);
  if (KIND == FF || KIND == MIXED) ff = k_ff(a.t, b.t, l);
  if (KIND == XF || KIND == MIXED) xf = a.s * k_xf_u(a.t, b.t, a.d, l);
  if (KIND == FX || KIND == MIXED) fx = b.s * k_xf_u(b.t, a.t, b.d, l);
  switch (KIND) {
    case XX: return xx;
    case FF: return ff;
    case XF: return xf;
    case FX: return fx;
    default: {
      const T w_xx = a.f * b.f;
      const T w_ff = (T(1) - a.f) * (T(1) - b.f);
      const T w_xf = a.f * (T(1) - b.f);
      const T w_fx = (T(1) - a.f) * b.f;
      return w_xx * xx + w_ff * ff + w_xf * xf + w_fx * fx;
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

// ---------------------------------------------------------------------------
// K2 and its backward: one-index terms per row, per-entry terms per entry.
// ---------------------------------------------------------------------------

// The per-row quantities, staged in shared memory as tab[quantity][slot]:
// slots [0, STILE) are the tile's rows (block i), [STILE, 2 STILE) its
// columns (block j).
enum Quantity { QT, QTL, QD, QS, QF, QGAM, QE, QEX, QR, QRD, QRL, NQ };
constexpr int NQ_FWD = QRD;  // the forward needs no derivatives

template <typename T>
struct RowQ {
  T t, tl, D, S, f, gam, E, e, r, rD, rl;
  int g;  // index of gam among the distinct gammas of its side (cross_tables)
};

template <typename T, int NQT>
__device__ __forceinline__ RowQ<T> row_q(const T (*tab)[2 * STILE], const int* gslot,
                                         int slot) {
  RowQ<T> q;
  q.g = gslot[slot];
  q.t = tab[QT][slot];
  q.tl = tab[QTL][slot];
  q.D = tab[QD][slot];
  q.S = tab[QS][slot];
  q.f = tab[QF][slot];
  q.gam = tab[QGAM][slot];
  q.E = tab[QE][slot];
  q.e = tab[QEX][slot];
  q.r = tab[QR][slot];
  if (NQT > QRD) {
    q.rD = tab[QRD][slot];
    q.rl = tab[QRL][slot];
  } else {
    q.rD = q.rl = T(0);
  }
  return q;
}

template <int KIND>
__device__ __forceinline__ bool expression_row(float flag) {
  return KIND == XX || (KIND == MIXED && flag != 0.f);
}

// Threads 0..2 STILE-1 fill one slot each: rows of block i, then columns of
// block j; a slot past n gets finite placeholder values (its entries are
// masked). With `key`, also the gene bin the slot credits (-1: none).
template <typename T, int NQT, int KIND>
__device__ __forceinline__ void fill_table(T (*tab)[2 * STILE], int* key,
                                           const T* __restrict__ meta,
                                           const int* __restrict__ gene, int n, int G,
                                           int i, int j, T l) {
  const int slot = threadIdx.x;
  if (slot >= 2 * STILE) return;
  const int idx = slot < STILE ? i * STILE + slot : j * STILE + slot - STILE;
  T t = T(0), D = T(1), S = T(0), f = T(0);
  if (idx < n) {
    t = meta[idx];
    D = meta[n + idx];
    S = meta[2 * n + idx];
    f = meta[3 * n + idx];
  }
  const T gam = D * l * T(0.5);
  const T tl = t / l;
  const T E = exp_(gam * gam);
  const T e = exp_(-D * t);
  const T u = tl - gam;
  const T r = e * (erf_(u) + erf_(gam));
  tab[QT][slot] = t;
  tab[QTL][slot] = tl;
  tab[QD][slot] = D;
  tab[QS][slot] = S;
  tab[QF][slot] = f;
  tab[QGAM][slot] = gam;
  tab[QE][slot] = E;
  tab[QEX][slot] = e;
  tab[QR][slot] = r;
  if (NQT > QRD) {
    const T phi_u = T(TWO_OVER_SQRT_PI) * exp_(-(u * u));
    const T phi_g = T(TWO_OVER_SQRT_PI) / E;
    tab[QRD][slot] = -t * r + e * (l * T(0.5)) * (phi_g - phi_u);
    tab[QRL][slot] = e * (phi_u * (-tl / l - D * T(0.5)) + phi_g * (D * T(0.5)));
  }
  if (key != nullptr) {
    const bool credits = idx < n && expression_row<KIND>((float)f);
    key[slot] = credits ? min(max(gene[idx], 0), G - 1) : -1;
  }
}

// a / b rounded as the IEEE division rounds it, given ib = 1 / b so
// rounded: a product and one FMA correction (Markstein), with no branch to
// the division's slow path (operands here are far from overflow and
// subnormals). The erf arguments must be the plain version's bit for bit.
__device__ __forceinline__ float div_rn(float a, float b, float ib) {
  const float q = a * ib;
  return fmaf(fmaf(-q, b, a), ib, q);
}
__device__ __forceinline__ double div_rn(double a, double b, double) { return a / b; }

// 1 / s to ~1 ulp without a branch: the hardware reciprocal and one Newton
// step (s = D_a + D_b > 0; not on the erf arguments).
__device__ __forceinline__ float rcp_(float s) {
  const float r = __fdividef(1.f, s);
  return fmaf(r, fmaf(-s, r, 1.f), r);
}
__device__ __forceinline__ double rcp_(double s) { return 1.0 / s; }

// The lengthscale's per-launch constants: l, 1/l, c l, 2l, 1/(2l).
template <typename T>
struct Scale {
  T l, il, cl, two_l, i2l;
};

template <typename T>
__device__ __forceinline__ Scale<T> scale(T l) {
  return {l, T(1) / l, T(0.5 * SQRT_PI) * l, T(2) * l, T(1) / (T(2) * l)};
}

// The two erf terms of an entry that depend on one time and one gamma,
// erf(u2), u2 = t_b/l + gamma_a, and erf(u4), u4 = t_a/l + gamma_b, and
// for the backward their derivatives 2/sqrt(pi) exp(-u^2). A tile whose
// rows and columns carry at most GCAP distinct gammas each reads them from
// tables of (gamma, time) pairs (cross_tables): the same values bit for
// bit, computed once per pair instead of once per entry.
constexpr int GCAP = 8;

template <typename T>
struct Cross {
  T f2, f4, p2, p4;
};

// Shared memory of cross_tables: [side][gamma][slot], side 0 the rows'
// gammas against the columns' times (u2), side 1 the columns' gammas
// against the rows' times (u4).
template <typename T>
struct CrossTables {
  T (*erf)[GCAP][STILE];
  T (*phi)[GCAP][STILE];
};

template <bool TABLE, bool BWD, typename T>
__device__ __forceinline__ Cross<T> cross_terms(const RowQ<T>& a, const RowQ<T>& b, int ra,
                                                int cb, const CrossTables<T>& ct) {
  Cross<T> c{};
  if (TABLE) {
    c.f2 = ct.erf[0][a.g][cb];
    c.f4 = ct.erf[1][b.g][ra];
    if (BWD) {
      c.p2 = ct.phi[0][a.g][cb];
      c.p4 = ct.phi[1][b.g][ra];
    }
  } else {
    const T u2 = b.tl + a.gam, u4 = a.tl + b.gam;
    c.f2 = erf_(u2);
    c.f4 = erf_(u4);
    if (BWD) {
      c.p2 = T(TWO_OVER_SQRT_PI) * exp_(-(u2 * u2));
      c.p4 = T(TWO_OVER_SQRT_PI) * exp_(-(u4 * u4));
    }
  }
  return c;
}

// Lists the distinct gammas of each side (warp 0 the rows, warp 1 the
// columns) and, when neither side has more than GCAP, fills the tables.
// Every thread calls it; returns whether the tables hold (CTA-uniform).
template <typename T, bool BWD>
__device__ __forceinline__ bool cross_tables(const T (*tab)[2 * STILE], int* gslot,
                                             T (*dgam)[GCAP], int* ndist,
                                             const CrossTables<T>& ct) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp < 2) {
    const int base = warp * STILE;
    const T g0 = tab[QGAM][base + lane], g1 = tab[QGAM][base + 32 + lane];
    int i0 = -1, i1 = -1, nd = 0;
    for (;;) {
      const unsigned m0 = __ballot_sync(0xffffffffu, i0 < 0);
      const unsigned m1 = __ballot_sync(0xffffffffu, i1 < 0);
      if (!(m0 | m1)) break;
      if (nd == GCAP) {
        nd = GCAP + 1;
        break;
      }
      const T v0 = __shfl_sync(0xffffffffu, g0, m0 ? __ffs((int)m0) - 1 : 0);
      const T v1 = __shfl_sync(0xffffffffu, g1, m1 ? __ffs((int)m1) - 1 : 0);
      const T v = m0 ? v0 : v1;
      if (i0 < 0 && g0 == v) i0 = nd;
      if (i1 < 0 && g1 == v) i1 = nd;
      if (lane == 0) dgam[warp][nd] = v;
      ++nd;
    }
    gslot[base + lane] = i0;
    gslot[base + 32 + lane] = i1;
    if (lane == 0) ndist[warp] = nd;
  }
  __syncthreads();
  const bool table = ndist[0] <= GCAP && ndist[1] <= GCAP;
  if (table) {
    for (int e = threadIdx.x; e < 2 * GCAP * STILE; e += STHREADS) {
      const int side = e / (GCAP * STILE), g = (e / STILE) % GCAP, slot = e % STILE;
      if (g >= ndist[side]) continue;
      const T u = tab[QTL][(1 - side) * STILE + slot] + dgam[side][g];
      ct.erf[side][g][slot] = erf_(u);
      if (BWD) ct.phi[side][g][slot] = T(TWO_OVER_SQRT_PI) * exp_(-(u * u));
    }
    __syncthreads();
  }
  return table;
}

// The per-entry terms of row a and column b (ops/cuda_gram.py::
// gram_sym_hoisted writes the same arithmetic in PyTorch).
template <typename T>
struct Mid {
  T delta, x, u1, u3, X1, X2, A1, A2, Pa, Pb, q, U, Q1, Q2, kff;
};

template <int KIND, typename T>
__device__ __forceinline__ Mid<T> mid(const RowQ<T>& a, const RowQ<T>& b, const Scale<T>& k,
                                      const Cross<T>& c) {
  Mid<T> m{};
  m.delta = a.t - b.t;
  if (KIND != XX) m.kff = exp_(div_rn(-(m.delta * m.delta), k.two_l, k.i2l));
  if (KIND == FF) return m;
  m.x = div_rn(m.delta, k.l, k.il);
  m.u1 = m.x - a.gam;
  m.u3 = -m.x - b.gam;
  m.X1 = exp_(-a.D * m.delta);
  m.X2 = exp_(b.D * m.delta);
  m.A1 = m.X1 * (erf_(m.u1) + c.f2);
  m.A2 = m.X2 * (erf_(m.u3) + c.f4);
  m.Pa = m.A1 - a.r * b.e;
  m.Pb = m.A2 - b.r * a.e;
  m.q = rcp_(a.D + b.D);
  m.U = k.cl * m.q * (a.E * m.Pa + b.E * m.Pb);
  if (KIND == MIXED) {
    m.Q1 = k.cl * a.E * m.A1;
    m.Q2 = k.cl * b.E * m.A2;
  }
  return m;
}

template <typename T>
struct Weights {
  T xx, ff, xf, fx;
};

template <typename T>
__device__ __forceinline__ Weights<T> weights(T fa, T fb) {
  return {fa * fb, (T(1) - fa) * (T(1) - fb), fa * (T(1) - fb), (T(1) - fa) * fb};
}

template <int KIND, typename T>
__device__ __forceinline__ T sym_value(const RowQ<T>& a, const RowQ<T>& b, const Scale<T>& k,
                                       const Cross<T>& c) {
  const Mid<T> m = mid<KIND>(a, b, k, c);
  if (KIND == XX) return a.S * b.S * m.U;
  if (KIND == FF) return m.kff;
  const Weights<T> w = weights(a.f, b.f);
  return w.xx * (a.S * b.S * m.U) + w.ff * m.kff + w.xf * (a.S * m.Q1) + w.fx * (b.S * m.Q2);
}

// 16-byte vector access to four consecutive values (two for double).
__device__ __forceinline__ void st4(float* p, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void st4(double* p, double a, double b, double c, double d) {
  reinterpret_cast<double2*>(p)[0] = make_double2(a, b);
  reinterpret_cast<double2*>(p)[1] = make_double2(c, d);
}
__device__ __forceinline__ void ld4(const float* p, float* v) {
  const float4 x = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
}
__device__ __forceinline__ void ld4(const double* p, double* v) {
  const double2 x = __ldg(reinterpret_cast<const double2*>(p));
  const double2 y = __ldg(reinterpret_cast<const double2*>(p) + 1);
  v[0] = x.x, v[1] = x.y, v[2] = y.x, v[3] = y.y;
}

// Whether a 4 x 4 block at (r0, c0) lies inside the n x n matrix and its
// rows can take 16-byte accesses (a row length of whole 16-byte units).
template <typename T>
__device__ __forceinline__ bool vector_block(int n, int r0, int c0) {
  return n % (16 / (int)sizeof(T)) == 0 && r0 + 3 < n && c0 + 3 < n;
}

// Store the 4 x 4 block v (or its transpose) at (r0, c0), masked at n.
template <typename T, bool TRANSPOSE>
__device__ __forceinline__ void store_block(T* __restrict__ out, int n, int r0, int c0,
                                            const T (&v)[4][4]) {
  const bool vec = vector_block<T>(n, r0, c0);
#pragma unroll
  for (int rr = 0; rr < 4; ++rr) {
    T x[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) x[k] = TRANSPOSE ? v[k][rr] : v[rr][k];
    T* p = out + (size_t)(r0 + rr) * n + c0;
    if (vec) {
      st4(p, x[0], x[1], x[2], x[3]);
    } else if (r0 + rr < n) {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (c0 + k < n) p[k] = x[k];
    }
  }
}

// Load the 4 x 4 block of g at (r0, c0), zero outside n.
template <typename T>
__device__ __forceinline__ void load_block(const T* __restrict__ g, int n, int r0, int c0,
                                           T (&v)[4][4]) {
  const bool vec = vector_block<T>(n, r0, c0);
#pragma unroll
  for (int rr = 0; rr < 4; ++rr) {
    const T* p = g + (size_t)(r0 + rr) * n + c0;
    if (vec) {
      ld4(p, v[rr]);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) v[rr][k] = (r0 + rr < n && c0 + k < n) ? __ldg(p + k) : T(0);
    }
  }
}

// Decode the lower-triangle tile (i, j), j <= i, of linear index b in
// row-major order over the lower triangle (np.tril_indices order): a
// single-precision guess, corrected in integers.
__device__ __forceinline__ void tril_tile(int b, int* i_out, int* j_out) {
  int i = (int)((sqrtf(8.f * (float)b + 1.f) - 1.f) * 0.5f);
  while ((long long)i * (i + 1) / 2 > b) --i;
  while ((long long)(i + 1) * (i + 2) / 2 <= b) ++i;
  *i_out = i;
  *j_out = (int)(b - (long long)i * (i + 1) / 2);
}

// The 4 x 4 block a thread owns in a tile: block row rg and block column cg
// in [0, 16). A warp holds block rows 4 (w / 2) .. +3 and block columns
// 8 (w % 2) .. +7: lanes 8 apart share a column, lanes 0..7 of an octet a row.
struct Owner {
  int lane, warp, rg, cg;
};

__device__ __forceinline__ Owner owner() {
  Owner o;
  o.lane = threadIdx.x & 31;
  o.warp = threadIdx.x >> 5;
  o.rg = (o.warp >> 1) * 4 + (o.lane >> 3);
  o.cg = (o.warp & 1) * 8 + (o.lane & 7);
  return o;
}

// The 4 x 4 block of values of one thread (rows 4 rg.., columns 4 cg..).
template <int KIND, bool TABLE, typename T>
__device__ __forceinline__ void sym_block(const T (*tab)[2 * STILE], const int* gslot,
                                          const CrossTables<T>& ct, const Owner& o,
                                          const Scale<T>& k, T (&v)[4][4]) {
  RowQ<T> b[4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) b[kk] = row_q<T, NQ_FWD>(tab, gslot, STILE + 4 * o.cg + kk);
#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    const RowQ<T> a = row_q<T, NQ_FWD>(tab, gslot, 4 * o.rg + ii);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const Cross<T> c = cross_terms<TABLE, false>(a, b[kk], 4 * o.rg + ii, 4 * o.cg + kk, ct);
      v[ii][kk] = sym_value<KIND>(a, b[kk], k, c);
    }
  }
}

// K2: one CTA per lower tile (i, j); writes tile (i, j) and, off the
// diagonal, its transpose (j, i), both from registers.
template <typename T, int KIND>
__global__ void __launch_bounds__(STHREADS, sizeof(T) == 4 ? K2_MIN_CTAS : 1)
gram_sym_kernel(const T* __restrict__ meta, int n, const T* __restrict__ ell,
                T* __restrict__ out) {
  __shared__ __align__(16) T tab[NQ_FWD][2 * STILE];
  __shared__ T cerf[2][GCAP][STILE];
  __shared__ T dgam[2][GCAP];
  __shared__ int gslot[2 * STILE];
  __shared__ int ndist[2];
  int i, j;
  tril_tile(blockIdx.x, &i, &j);
  const T l = *ell;
  fill_table<T, NQ_FWD, KIND>(tab, nullptr, meta, nullptr, n, 1, i, j, l);
  __syncthreads();
  const CrossTables<T> ct{cerf, nullptr};
  const bool table = KIND != FF && cross_tables<T, false>(tab, gslot, dgam, ndist, ct);
  const Owner o = owner();
  // In a diagonal tile a block above the diagonal is the mirror of one below.
  if (i == j && o.rg < o.cg) return;
  const Scale<T> k = scale(l);
  T v[4][4];
  if (table)
    sym_block<KIND, true>(tab, gslot, ct, o, k, v);
  else
    sym_block<KIND, false>(tab, gslot, ct, o, k, v);
  const int r0 = i * STILE + 4 * o.rg, c0 = j * STILE + 4 * o.cg;
  if (r0 == c0) {  // a block on the diagonal: its lower half, mirrored
#pragma unroll
    for (int ii = 0; ii < 4; ++ii)
#pragma unroll
      for (int kk = ii + 1; kk < 4; ++kk) v[ii][kk] = v[kk][ii];
    store_block<T, false>(out, n, r0, c0, v);
    return;
  }
  store_block<T, false>(out, n, r0, c0, v);
  store_block<T, true>(out, n, c0, r0, v);
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

__host__ __device__ inline long long lower_tiles(int n) {
  const long long nt = (n + STILE - 1) / STILE;
  return nt * (nt + 1) / 2;
}

template <typename T, int KIND>
void launch_sym_k(const T* meta, int n, const T* ell, T* out, cudaStream_t stream) {
  gram_sym_kernel<T, KIND><<<(unsigned)lower_tiles(n), STHREADS, 0, stream>>>(meta, n, ell, out);
}

template <typename T>
int launch_sym(const T* meta, int n, const T* ell, T* out, int kind, cudaStream_t stream) {
  if (n <= 0) return (int)cudaGetLastError();
  switch (kind) {
    case XX: launch_sym_k<T, XX>(meta, n, ell, out, stream); break;
    case FF: launch_sym_k<T, FF>(meta, n, ell, out, stream); break;
    case MIXED: launch_sym_k<T, MIXED>(meta, n, ell, out, stream); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Partials of one entry K_ab with respect to the row gene's decay and
// sensitivity, the column gene's decay and sensitivity, and l.
template <typename T>
struct Partials {
  T da, sa, db, sb, l;
};

// One reverse sweep over the hoisted form of entry (a, b), seeded with the
// adjoints of U (k_xx = S_a S_b U), Q1 = k_xf / S_a, Q2 = k_fx / S_b and
// k_ff that the kind's weights give.
template <int KIND, typename T>
__device__ __forceinline__ Partials<T> partials(const RowQ<T>& a, const RowQ<T>& b,
                                                const Scale<T>& k, const Cross<T>& c) {
  const Mid<T> m = mid<KIND>(a, b, k, c);
  Partials<T> p{};
  T Ub = T(0), Q1b = T(0), Q2b = T(0), Fb = T(0);
  Weights<T> w{};
  if (KIND == XX) {
    Ub = a.S * b.S;
  } else if (KIND == FF) {
    Fb = T(1);
  } else {
    w = weights(a.f, b.f);
    Ub = w.xx * a.S * b.S;
    Q1b = w.xf * a.S;
    Q2b = w.fx * b.S;
    Fb = w.ff;
  }
  // d k_ff / dl = k_ff (delta^2 / 2l) / l, divided per entry: a factor
  // 1 / l^2 common to every entry would round once for the whole sum.
  if (KIND != XX)
    p.l = Fb * m.kff * div_rn(div_rn(m.delta * m.delta, k.two_l, k.i2l), k.l, k.il);
  if (KIND == FF) return p;
  const T Vb = Ub * k.cl * m.q;
  const T UUq = -Ub * m.U * m.q;
  p.l += (Ub * m.U + Q1b * m.Q1 + Q2b * m.Q2) * k.il;
  const T Ab1 = a.E * (Vb + Q1b * k.cl);
  const T Ab2 = b.E * (Vb + Q2b * k.cl);
  const T Eba = Vb * m.Pa + Q1b * k.cl * m.A1;
  const T Ebb = Vb * m.Pb + Q2b * k.cl * m.A2;
  const T Pba = Vb * a.E, Pbb = Vb * b.E;
  const T rba = -Pba * b.e, eb_b = -Pba * a.r;
  const T rbb = -Pbb * a.e, eb_a = -Pbb * b.r;
  const T Fb12 = Ab1 * m.X1, Fb34 = Ab2 * m.X2;
  const T M = T(TWO_OVER_SQRT_PI);
  const T ub1 = Fb12 * (M * exp_(-(m.u1 * m.u1)));
  const T ub2 = Fb12 * c.p2;
  const T ub3 = Fb34 * (M * exp_(-(m.u3 * m.u3)));
  const T ub4 = Fb34 * c.p4;
  const T s12 = ub2 - ub1, s34 = ub4 - ub3;
  p.da = UUq - m.delta * Ab1 * m.A1 + (k.l * T(0.5)) * s12 + Eba * (a.E * a.gam * k.l) +
         rba * a.rD + eb_a * (-a.t * a.e);
  p.db = UUq + m.delta * Ab2 * m.A2 + (k.l * T(0.5)) * s34 + Ebb * (b.E * b.gam * k.l) +
         rbb * b.rD + eb_b * (-b.t * b.e);
  p.l += -(m.x * (ub1 - ub3) + b.tl * ub2 + a.tl * ub4) * k.il + (a.D * T(0.5)) * s12 +
         (b.D * T(0.5)) * s34 + Eba * (a.E * a.gam * a.D) + Ebb * (b.E * b.gam * b.D) +
         rba * a.rl + rbb * b.rl;
  if (KIND == XX) {
    p.sa = b.S * m.U;
    p.sb = a.S * m.U;
  } else {
    p.sa = w.xx * b.S * m.U + w.xf * m.Q1;
    p.sb = w.xx * a.S * m.U + w.fx * m.Q2;
  }
  return p;
}

// Adds each lane's (vd, vs) to bins[key] and bins[G + key] (key -1: none),
// one shared atomic per distinct key of the warp.
__device__ __forceinline__ void credit(double* bins, int G, int key, double vd, double vs) {
  unsigned todo = __ballot_sync(0xffffffffu, key >= 0);
  while (todo) {
    const int k0 = __shfl_sync(0xffffffffu, key, __ffs((int)todo) - 1);
    const bool mine = key == k0;
    const double sd = warp_sum(mine ? vd : 0.0), ss = warp_sum(mine ? vs : 0.0);
    if ((threadIdx.x & 31) == 0) {
      atomicAdd(&bins[k0], sd);
      atomicAdd(&bins[G + k0], ss);
    }
    todo &= ~__ballot_sync(0xffffffffu, mine);
  }
}

__device__ __forceinline__ double sum_lanes(double v, int first, int last) {
  for (int o = first; o <= last; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// One tile of K2's backward for one thread: its 4 x 4 block's partials
// against the cotangent, summed per row into rowP and per column into
// cd, cs (float64).
template <int KIND, bool TABLE, typename T>
__device__ __forceinline__ void bwd_block(const T (*tab)[2 * STILE], const int* gslot,
                                          const CrossTables<T>& ct, const Owner& o,
                                          const Scale<T>& k, const T* __restrict__ g, int n,
                                          int i, int j, double (*rowP)[2][STILE],
                                          double (&cd)[4], double (&cs)[4], double& acc_l) {
  const bool active = !(i == j && o.rg < o.cg);
  const int r0 = i * STILE + 4 * o.rg, c0 = j * STILE + 4 * o.cg;
  T gm[4][4];  // gm[kk][ii] = g[c0 + kk][r0 + ii], the mirror entries
  if (active) load_block(g, n, c0, r0, gm);
  RowQ<T> b[4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) b[kk] = row_q<T, NQ>(tab, gslot, STILE + 4 * o.cg + kk);
#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    const int ra = r0 + ii;
    double rd = 0.0, rs = 0.0;
    if (active && ra < n) {
      T gd[4];
      const T* grow = g + (size_t)ra * n + c0;
      if (vector_block<T>(n, r0, c0)) {
        ld4(grow, gd);
      } else {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) gd[kk] = c0 + kk < n ? __ldg(grow + kk) : T(0);
      }
      const RowQ<T> a = row_q<T, NQ>(tab, gslot, 4 * o.rg + ii);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int cb = c0 + kk;
        if (cb >= n || cb > ra) continue;  // outside, or above the diagonal
        const double w = (double)gd[kk] + (cb != ra ? (double)gm[kk][ii] : 0.0);
        const Cross<T> c = cross_terms<TABLE, true>(a, b[kk], 4 * o.rg + ii, 4 * o.cg + kk, ct);
        const Partials<T> p = partials<KIND>(a, b[kk], k, c);
        rd += w * (double)p.da;
        rs += w * (double)p.sa;
        cd[kk] += w * (double)p.db;
        cs[kk] += w * (double)p.sb;
        acc_l += w * (double)p.l;
      }
    }
    if (KIND != FF) {
      rd = sum_lanes(rd, 1, 4);  // the 8 lanes of an octet share the row
      rs = sum_lanes(rs, 1, 4);
      if ((o.lane & 7) == 0) {
        rowP[o.warp & 1][0][4 * o.rg + ii] = rd;
        rowP[o.warp & 1][1][4 * o.rg + ii] = rs;
      }
    }
  }
}

// K2's backward: a persistent grid walking the lower tiles with a stride.
// grad (2G+1, float64, zeroed by the caller) receives [d decay (G),
// d sens (G), d l]. Dynamic shared memory: 2G+1 float64 bins.
template <typename T, int KIND>
__global__ void __launch_bounds__(STHREADS, sizeof(T) == 4 ? K2BWD_MIN_CTAS : 1)
gram_sym_bwd_kernel(const T* __restrict__ meta, const int* __restrict__ gene, int n, int G,
                    const T* __restrict__ ell, const T* __restrict__ g,
                    double* __restrict__ grad) {
  extern __shared__ __align__(8) unsigned char bins_raw[];
  double* bins = reinterpret_cast<double*>(bins_raw);
  __shared__ __align__(16) T tab[NQ][2 * STILE];
  __shared__ T cerf[2][GCAP][STILE], cphi[2][GCAP][STILE];
  __shared__ T dgam[2][GCAP];
  __shared__ int gslot[2 * STILE];
  __shared__ int ndist[2];
  __shared__ int key[2 * STILE];
  __shared__ double rowP[2][2][STILE];  // [column half][decay, sens][row]
  __shared__ double colP[4][2][STILE];  // [row quarter][decay, sens][column]
  for (int e = threadIdx.x; e < 2 * G + 1; e += STHREADS) bins[e] = 0.0;
  const T l = *ell;
  const Scale<T> k = scale(l);
  const CrossTables<T> ct{cerf, cphi};
  const Owner o = owner();
  const int tiles = (int)lower_tiles(n);
  double acc_l = 0.0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    int i, j;
    tril_tile(tile, &i, &j);
    __syncthreads();  // the previous tile's tables and partials are read
    fill_table<T, NQ, KIND>(tab, key, meta, gene, n, G, i, j, l);
    __syncthreads();
    const bool table = KIND != FF && cross_tables<T, true>(tab, gslot, dgam, ndist, ct);
    double cd[4] = {0.0, 0.0, 0.0, 0.0}, cs[4] = {0.0, 0.0, 0.0, 0.0};
    if (table)
      bwd_block<KIND, true>(tab, gslot, ct, o, k, g, n, i, j, rowP, cd, cs, acc_l);
    else
      bwd_block<KIND, false>(tab, gslot, ct, o, k, g, n, i, j, rowP, cd, cs, acc_l);
    if constexpr (KIND != FF) {  // gene credits
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        cd[kk] = sum_lanes(cd[kk], 8, 16);  // lanes 8 apart share the column
        cs[kk] = sum_lanes(cs[kk], 8, 16);
        if (o.lane < 8) {
          colP[o.warp >> 1][0][4 * o.cg + kk] = cd[kk];
          colP[o.warp >> 1][1][4 * o.cg + kk] = cs[kk];
        }
      }
      __syncthreads();
      if (o.warp < 4) {  // warps 0, 1: rows 0..63; warps 2, 3: columns 0..63
        const int s = (o.warp & 1) * 32 + o.lane;
        double vd, vs;
        int bin;
        if (o.warp < 2) {
          vd = rowP[0][0][s] + rowP[1][0][s];
          vs = rowP[0][1][s] + rowP[1][1][s];
          bin = key[s];
        } else {
          vd = (colP[0][0][s] + colP[1][0][s]) + (colP[2][0][s] + colP[3][0][s]);
          vs = (colP[0][1][s] + colP[1][1][s]) + (colP[2][1][s] + colP[3][1][s]);
          bin = key[STILE + s];
        }
        credit(bins, G, bin, vd, vs);
      }
    }
  }
  acc_l = warp_sum(acc_l);
  if (o.lane == 0) atomicAdd(&bins[2 * G], acc_l);
  __syncthreads();
  for (int e = threadIdx.x; e < 2 * G + 1; e += STHREADS)
    if (bins[e] != 0.0) atomicAdd(&grad[e], bins[e]);
}

template <typename T, int KIND>
int launch_sym_bwd_k(const T* meta, const int* gene, int n, int G, const T* ell, const T* g,
                     double* grad, cudaStream_t stream) {
  const auto kernel = gram_sym_bwd_kernel<T, KIND>;
  const size_t smem = (size_t)(2 * G + 1) * sizeof(double);
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, STHREADS, smem);
  if (err != cudaSuccess) return (int)err;
  const long long grid = std::min<long long>(lower_tiles(n), (long long)sms * std::max(per_sm, 1));
  kernel<<<(unsigned)grid, STHREADS, smem, stream>>>(meta, gene, n, G, ell, g, grad);
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

// Kernel `which` for chip_smoke.py: 0, 1 K1 (f32, f64); 2..7 K2 (f32 then
// f64, kinds xx, ff, mixed); 8..13 K2's backward (the same order). Its name
// into *name, its registers, local and static shared bytes into
// attrs[0..2]; -1 past the last kernel.
int kernel_attrs(int which, const char** name, int* attrs) {
  switch (which) {
    case 0: *name = "gram_rect_kernel<float>"; return func_attrs(gram_rect_kernel<float>, attrs);
    case 1: *name = "gram_rect_kernel<double>"; return func_attrs(gram_rect_kernel<double>, attrs);
    case 2: *name = "gram_sym_kernel<float, xx>";
      return func_attrs(gram_sym_kernel<float, XX>, attrs);
    case 3: *name = "gram_sym_kernel<float, ff>";
      return func_attrs(gram_sym_kernel<float, FF>, attrs);
    case 4: *name = "gram_sym_kernel<float, mixed>";
      return func_attrs(gram_sym_kernel<float, MIXED>, attrs);
    case 5: *name = "gram_sym_kernel<double, xx>";
      return func_attrs(gram_sym_kernel<double, XX>, attrs);
    case 6: *name = "gram_sym_kernel<double, ff>";
      return func_attrs(gram_sym_kernel<double, FF>, attrs);
    case 7: *name = "gram_sym_kernel<double, mixed>";
      return func_attrs(gram_sym_kernel<double, MIXED>, attrs);
    case 8: *name = "gram_sym_bwd_kernel<float, xx>";
      return func_attrs(gram_sym_bwd_kernel<float, XX>, attrs);
    case 9: *name = "gram_sym_bwd_kernel<float, ff>";
      return func_attrs(gram_sym_bwd_kernel<float, FF>, attrs);
    case 10: *name = "gram_sym_bwd_kernel<float, mixed>";
      return func_attrs(gram_sym_bwd_kernel<float, MIXED>, attrs);
    case 11: *name = "gram_sym_bwd_kernel<double, xx>";
      return func_attrs(gram_sym_bwd_kernel<double, XX>, attrs);
    case 12: *name = "gram_sym_bwd_kernel<double, ff>";
      return func_attrs(gram_sym_bwd_kernel<double, FF>, attrs);
    case 13: *name = "gram_sym_bwd_kernel<double, mixed>";
      return func_attrs(gram_sym_bwd_kernel<double, MIXED>, attrs);
    default: return -1;
  }
}

}  // extern "C"
