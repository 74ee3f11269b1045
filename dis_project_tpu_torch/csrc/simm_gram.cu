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
// combination) in float or double (the f64 build lets the canonical
// goldens be checked on the card through the kernels), in one tile program:
// one CTA of 256 threads per 64 x 64 tile, rows from one row set and
// columns from another (K1) or the same (K2), each thread a 4 x 4 block in
// registers.
//
// What depends on one row only is evaluated once per row. For row a (time
// t, decay D, sens S, gamma = D l / 2) a CTA stages in shared memory t,
// t/l, D, S, flag, gamma, E = exp(gamma^2), e = exp(-D t) and r = e (erf(t/l
// - gamma) + erf(gamma)), for K1's 'xf' and 'fx' C = c l S E, and for the
// backward r's derivatives in D and l (fill_table). K2 and its backward
// read the rows packed as [t; decay; sens; flag], a (4, n) array; K1 reads
// the (n, 3) [t, gene, flag] rows of each set and gathers decay and sens
// itself, each gene clamped to [0, G-1] as ops/gram.py's gathers clamp it.
// An 'xx' entry (a, b), delta = t_a - t_b, x = delta / l, is then
//   A1 = exp(-D_a delta) (erf(x - gamma_a) + erf(t_b/l + gamma_a))
//   A2 = exp( D_b delta) (erf(-x - gamma_b) + erf(t_a/l + gamma_b))
//   k_xx = S_a S_b c l (E_a (A1 - r_a e_b) + E_b (A2 - r_b e_a)) / (D_a + D_b),
// c = sqrt(pi)/2: 4 erf, 2 exp and one reciprocal, where the closed form
// spends 8 erf, 6 exp and 2 divisions. k_xf = C_a A1 and k_fx = C_b A2: one
// exp and two erf. exp(-D_a delta) stays one exponential (split into a row
// and a column factor it overflows float once D t > 88). Every erf argument
// is the plain version's bit for bit (delta / l rounded as the IEEE division
// rounds it, by an FMA correction that needs no slow-path branch): erf's
// rounding is amplified by exp(D |delta|) <= e^12 on rows over [0, 12], and
// the kernels must round where the plain version does. One erf of A1 and
// one of A2 depend on one time and one gamma (erf(t_b/l + gamma_a),
// erf(t_a/l + gamma_b)): where the tile side whose gammas they take carries
// at most GCAP distinct gammas (a gene-major layout holds one or two genes
// in 64 rows), the CTA tabulates them per (gamma, time) pair
// (cross_tables), leaving per entry 2 erf, 2 exp and the reciprocal of
// 'xx', one erf and one exp of 'xf' and 'fx'; other tiles evaluate them all.
//
// K1 (gram_rect_kernel): one CTA per 64 x 64 output tile (i, j) of the
// (n, m) matrix, every tile a full one (no diagonal, nothing mirrored). The
// kind is a template parameter (5 kinds x 2 types, no switch per entry):
// 'xx' and 'mixed' take K2's per-entry terms (mid, sym_value), 'xf' only
// A1, 'fx' only A2, 'ff' k_ff, and cross_tables builds only the table side
// the kind reads. A warp holds 4 x 8 blocks, so it writes the tile row by
// row as 16-byte stores of 8 lanes (128 contiguous bytes a row) where the
// row length m is a whole number of 16-byte units; scalar stores otherwise
// and at the edges, masked at n rows and m columns. What bounds it on the
// H100: the 4 n m bytes written (200 MB at 1e4 x 5000 in f32, 0.06 ms at
// 3.35 TB/s); its instructions take longer, as K2's do.
//
// K2 forward: one CTA per 64 x 64 lower tile (i, j), decoded from the block
// index in single precision with integer fix-ups. Each thread's 4 x 4 block
// is stored as K1 stores it and, off the diagonal, the mirror tile (j, i)
// from the same registers as 16-byte stores of 4 lanes (64 bytes a row,
// whole 32-byte sectors): no shared-memory transpose. A diagonal tile
// computes the blocks on and below its diagonal and mirrors them, so the
// Gram is exactly symmetric. What bounds it on the H100: 4 n^2 bytes
// written (400 MB at n = 1e4 in f32, 0.12 ms at 3.35 TB/s); its
// instructions (erf is a polynomial of ~30, both of its branches
// evaluated) take longer than that.
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

constexpr int STILE = 64;         // tile edge
constexpr int STHREADS = 256;     // 8 warps, each 4 x 8 blocks of 4 x 4
// CTAs an SM must hold (float instances; double takes 1): K1 and K2 at 3
// (80 registers), K2's backward at 2 (128 registers; at 3 it spills), the
// fastest of those tried for K2 and its backward on an H100 (PERF.md).
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
// The tile program: one-index terms per row, per-entry terms per entry.
// ---------------------------------------------------------------------------

// The per-row quantities, staged in shared memory as tab[quantity][slot]:
// slots [0, STILE) are the tile's rows (block i), [STILE, 2 STILE) its
// columns (block j).
enum Quantity { QT, QTL, QD, QS, QF, QGAM, QE, QEX, QR, QC, QRD, QRL, NQ };
constexpr int NQ_SYM = QC;    // K2's forward: no C, no derivatives
constexpr int NQ_RECT = QRD;  // K1: C for 'xf' and 'fx', no derivatives

template <typename T>
struct RowQ {
  T t, tl, D, S, f, gam, E, e, r, C, rD, rl;
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
  q.C = T(0);
  if constexpr (NQT == NQ_RECT) q.C = tab[QC][slot];
  if constexpr (NQT > QRD) {
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

// Row sources of fill_table: rows packed as a (4, n) [t; decay; sens; flag]
// array (K2 and its backward), or (n, 3) [t, gene, flag] rows whose decay
// and sens are gathered here, the gene truncated to an integer and clamped
// to [0, G-1] (K1; ops/gram.py's split_rows and _gather).
template <typename T>
struct PackedRows {
  const T* __restrict__ meta;
  int n;
  __device__ __forceinline__ void load(int idx, T& t, T& D, T& S, T& f) const {
    t = meta[idx];
    D = meta[n + idx];
    S = meta[2 * n + idx];
    f = meta[3 * n + idx];
  }
};

template <typename T>
struct GatherRows {
  const T* __restrict__ x;
  int n;
  const T* __restrict__ decay;
  const T* __restrict__ sens;
  int G;
  __device__ __forceinline__ void load(int idx, T& t, T& D, T& S, T& f) const {
    const int g = min(max((int)x[3 * idx + 1], 0), G - 1);
    t = x[3 * idx];
    D = decay[g];
    S = sens[g];
    f = x[3 * idx + 2];
  }
};

// Threads 0..2 STILE-1 fill one slot each: rows of block i from `rows`,
// then columns of block j from `cols`; a slot past its set's end gets
// finite placeholder values (its entries are masked). With `key`, also the
// gene bin the slot credits (-1: none; K2's backward, rows == cols).
template <typename T, int NQT, int KIND, typename Src>
__device__ __forceinline__ void fill_table(T (*tab)[2 * STILE], int* key, const Src& rows,
                                           const Src& cols, const int* __restrict__ gene,
                                           int G, int i, int j, T l) {
  const int slot = threadIdx.x;
  if (slot >= 2 * STILE) return;
  const bool col = slot >= STILE;
  const int idx = col ? j * STILE + slot - STILE : i * STILE + slot;
  const bool in = idx < (col ? cols.n : rows.n);
  T t = T(0), D = T(1), S = T(0), f = T(0);
  if (in) (col ? cols : rows).load(idx, t, D, S, f);
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
  if constexpr (NQT == NQ_RECT) tab[QC][slot] = T(0.5 * SQRT_PI) * l * S * E;
  if constexpr (NQT > QRD) {
    const T phi_u = T(TWO_OVER_SQRT_PI) * exp_(-(u * u));
    const T phi_g = T(TWO_OVER_SQRT_PI) / E;
    tab[QRD][slot] = -t * r + e * (l * T(0.5)) * (phi_g - phi_u);
    tab[QRL][slot] = e * (phi_u * (-tl / l - D * T(0.5)) + phi_g * (D * T(0.5)));
  }
  if (key != nullptr) {
    const bool credits = in && expression_row<KIND>((float)f);
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

__device__ __forceinline__ float fma_(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double fma_(double a, double b, double c) { return fma(a, b, c); }

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
// erf(u2), u2 = t_b/l + gamma_a (side 0: A1's), and erf(u4), u4 = t_a/l +
// gamma_b (side 1: A2's), and for the backward their derivatives
// 2/sqrt(pi) exp(-u^2). A kind reads the sides in SIDES (bit 0 side 0, bit
// 1 side 1). A tile whose sides read carry at most GCAP distinct gammas
// each reads them from tables of (gamma, time) pairs (cross_tables): the
// same values bit for bit, computed once per pair instead of once per
// entry.
constexpr int GCAP = 8;

template <int KIND>
__host__ __device__ constexpr int cross_sides() {
  return KIND == FF ? 0 : KIND == XF ? 1 : KIND == FX ? 2 : 3;
}

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

template <bool TABLE, bool BWD, int SIDES, typename T>
__device__ __forceinline__ Cross<T> cross_terms(const RowQ<T>& a, const RowQ<T>& b, int ra,
                                                int cb, const CrossTables<T>& ct) {
  Cross<T> c{};
  if (TABLE) {
    if (SIDES & 1) c.f2 = ct.erf[0][a.g][cb];
    if (SIDES & 2) c.f4 = ct.erf[1][b.g][ra];
    if (BWD) {
      c.p2 = ct.phi[0][a.g][cb];
      c.p4 = ct.phi[1][b.g][ra];
    }
  } else {
    const T u2 = b.tl + a.gam, u4 = a.tl + b.gam;
    if (SIDES & 1) c.f2 = erf_(u2);
    if (SIDES & 2) c.f4 = erf_(u4);
    if (BWD) {
      c.p2 = T(TWO_OVER_SQRT_PI) * exp_(-(u2 * u2));
      c.p4 = T(TWO_OVER_SQRT_PI) * exp_(-(u4 * u4));
    }
  }
  return c;
}

// Lists the distinct gammas of each side in SIDES (warp 0 the rows, warp 1
// the columns) and, when no such side has more than GCAP, fills its
// tables. Every thread calls it; returns whether the tables hold
// (CTA-uniform).
template <typename T, bool BWD, int SIDES>
__device__ __forceinline__ bool cross_tables(const T (*tab)[2 * STILE], int* gslot,
                                             T (*dgam)[GCAP], int* ndist,
                                             const CrossTables<T>& ct) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp < 2) {
    const int base = warp * STILE;
    const T g0 = tab[QGAM][base + lane], g1 = tab[QGAM][base + 32 + lane];
    const bool used = (SIDES >> warp) & 1;  // warp-uniform
    int i0 = used ? -1 : 0, i1 = used ? -1 : 0, nd = 0;
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
// _hoisted_entries writes the same arithmetic in PyTorch).
template <typename T>
struct Mid {
  T delta, x, u1, u3, X1, X2, A1, A2, Pa, Pb, q, U, Q1, Q2, kff;
};

template <int KIND, bool BWD, typename T>
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
  const T s1 = erf_(m.u1) + c.f2, s3 = erf_(m.u3) + c.f4;
  m.A1 = m.X1 * s1;
  m.A2 = m.X2 * s3;
  if constexpr (KIND == XX && sizeof(T) == 4) {
    // Both contractions written out: left to the compiler, its choice of
    // which product to fuse moved with the code around it and changed the
    // last bits of K2's float 'xx' Gram. These are the forms K2 and its
    // backward were first measured with (the backward, where A1 and A2
    // have further uses, fuses r e in both).
    m.Pa = fma_(-a.r, b.e, m.A1);
    m.Pb = BWD ? fma_(-b.r, a.e, m.A2) : fma_(m.X2, s3, -(b.r * a.e));
  } else {
    m.Pa = m.A1 - a.r * b.e;
    m.Pb = m.A2 - b.r * a.e;
  }
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
  const Mid<T> m = mid<KIND, false>(a, b, k, c);
  if (KIND == XX) return a.S * b.S * m.U;
  if (KIND == FF) return m.kff;
  const Weights<T> w = weights(a.f, b.f);
  return w.xx * (a.S * b.S * m.U) + w.ff * m.kff + w.xf * (a.S * m.Q1) + w.fx * (b.S * m.Q2);
}

// One entry of any kind: 'xf' is k_xf(t_a, t_b) = C_a A1 and 'fx' is
// k_fx = C_b A2, each one exp and its side's erf terms; the other kinds
// are K2's.
template <int KIND, typename T>
__device__ __forceinline__ T entry_value(const RowQ<T>& a, const RowQ<T>& b, const Scale<T>& k,
                                         const Cross<T>& c) {
  if constexpr (KIND == XF || KIND == FX) {
    const T delta = a.t - b.t;
    const T x = div_rn(delta, k.l, k.il);
    if constexpr (KIND == XF) return a.C * (exp_(-a.D * delta) * (erf_(x - a.gam) + c.f2));
    else return b.C * (exp_(b.D * delta) * (erf_(-x - b.gam) + c.f4));
  } else {
    return sym_value<KIND>(a, b, k, c);
  }
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

// Whether a 4 x 4 block at (r0, c0) lies inside the rows x cols matrix and
// its rows can take 16-byte accesses (a row length of whole 16-byte units).
template <typename T>
__device__ __forceinline__ bool vector_block(int rows, int cols, int r0, int c0) {
  return cols % (16 / (int)sizeof(T)) == 0 && r0 + 3 < rows && c0 + 3 < cols;
}

// Store the 4 x 4 block v (or its transpose) at (r0, c0) of the row-major
// rows x cols matrix, masked at its edges.
template <typename T, bool TRANSPOSE>
__device__ __forceinline__ void store_block(T* __restrict__ out, int rows, int cols, int r0,
                                            int c0, const T (&v)[4][4]) {
  const bool vec = vector_block<T>(rows, cols, r0, c0);
#pragma unroll
  for (int rr = 0; rr < 4; ++rr) {
    T x[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) x[k] = TRANSPOSE ? v[k][rr] : v[rr][k];
    T* p = out + (size_t)(r0 + rr) * cols + c0;
    if (vec) {
      st4(p, x[0], x[1], x[2], x[3]);
    } else if (r0 + rr < rows) {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (c0 + k < cols) p[k] = x[k];
    }
  }
}

// Load the 4 x 4 block of the n x n matrix g at (r0, c0), zero outside n.
template <typename T>
__device__ __forceinline__ void load_block(const T* __restrict__ g, int n, int r0, int c0,
                                           T (&v)[4][4]) {
  const bool vec = vector_block<T>(n, n, r0, c0);
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
template <int KIND, bool TABLE, int NQT, typename T>
__device__ __forceinline__ void tile_block(const T (*tab)[2 * STILE], const int* gslot,
                                           const CrossTables<T>& ct, const Owner& o,
                                           const Scale<T>& k, T (&v)[4][4]) {
  RowQ<T> b[4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) b[kk] = row_q<T, NQT>(tab, gslot, STILE + 4 * o.cg + kk);
#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    const RowQ<T> a = row_q<T, NQT>(tab, gslot, 4 * o.rg + ii);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const Cross<T> c = cross_terms<TABLE, false, cross_sides<KIND>()>(
          a, b[kk], 4 * o.rg + ii, 4 * o.cg + kk, ct);
      v[ii][kk] = entry_value<KIND>(a, b[kk], k, c);
    }
  }
}

// The shared memory of one forward tile: the per-row table, the
// (gamma, time) tables and each side's distinct gammas.
template <typename T, int NQT>
struct ForwardTile {
  __align__(16) T tab[NQT][2 * STILE];
  T cerf[2][GCAP][STILE];
  T dgam[2][GCAP];
  int gslot[2 * STILE];
  int ndist[2];
};

// One forward tile (i, j): stages the rows' and the (gamma, time) tables,
// then this thread's 4 x 4 block into v. Every thread calls it (it holds
// barriers); an inactive one computes no block.
template <typename T, int NQT, int KIND, typename Src>
__device__ __forceinline__ void forward_tile(ForwardTile<T, NQT>& sm, const Src& rows,
                                             const Src& cols, int i, int j, T l,
                                             const Owner& o, bool active, T (&v)[4][4]) {
  fill_table<T, NQT, KIND>(sm.tab, nullptr, rows, cols, nullptr, 1, i, j, l);
  __syncthreads();
  const CrossTables<T> ct{sm.cerf, nullptr};
  const bool table =
      KIND != FF && cross_tables<T, false, cross_sides<KIND>()>(sm.tab, sm.gslot, sm.dgam,
                                                                sm.ndist, ct);
  if (!active) return;
  const Scale<T> k = scale(l);
  if (table)
    tile_block<KIND, true, NQT>(sm.tab, sm.gslot, ct, o, k, v);
  else
    tile_block<KIND, false, NQT>(sm.tab, sm.gslot, ct, o, k, v);
}

// K1: one CTA per 64 x 64 tile (blockIdx.y, blockIdx.x) of the (n, m)
// covariance between the rows x1 and x2 ((n, 3) and (m, 3)).
template <typename T, int KIND>
__global__ void __launch_bounds__(STHREADS, sizeof(T) == 4 ? K2_MIN_CTAS : 1)
gram_rect_kernel(const T* __restrict__ x1, int n, const T* __restrict__ x2, int m,
                 const T* __restrict__ decay, const T* __restrict__ sens, int G,
                 const T* __restrict__ ell, T* __restrict__ out) {
  __shared__ ForwardTile<T, NQ_RECT> sm;
  const int i = blockIdx.y, j = blockIdx.x;
  const Owner o = owner();
  T v[4][4];
  forward_tile<T, NQ_RECT, KIND>(sm, GatherRows<T>{x1, n, decay, sens, G},
                                 GatherRows<T>{x2, m, decay, sens, G}, i, j, *ell, o, true, v);
  store_block<T, false>(out, n, m, i * STILE + 4 * o.rg, j * STILE + 4 * o.cg, v);
}

// K2: one CTA per lower tile (i, j); writes tile (i, j) and, off the
// diagonal, its transpose (j, i), both from registers.
template <typename T, int KIND>
__global__ void __launch_bounds__(STHREADS, sizeof(T) == 4 ? K2_MIN_CTAS : 1)
gram_sym_kernel(const T* __restrict__ meta, int n, const T* __restrict__ ell,
                T* __restrict__ out) {
  __shared__ ForwardTile<T, NQ_SYM> sm;
  int i, j;
  tril_tile(blockIdx.x, &i, &j);
  const Owner o = owner();
  const PackedRows<T> rows{meta, n};
  T v[4][4];
  // In a diagonal tile a block above the diagonal is the mirror of one below.
  const bool active = !(i == j && o.rg < o.cg);
  forward_tile<T, NQ_SYM, KIND>(sm, rows, rows, i, j, *ell, o, active, v);
  if (!active) return;
  const int r0 = i * STILE + 4 * o.rg, c0 = j * STILE + 4 * o.cg;
  if (r0 == c0) {  // a block on the diagonal: its lower half, mirrored
#pragma unroll
    for (int ii = 0; ii < 4; ++ii)
#pragma unroll
      for (int kk = ii + 1; kk < 4; ++kk) v[ii][kk] = v[kk][ii];
    store_block<T, false>(out, n, n, r0, c0, v);
    return;
  }
  store_block<T, false>(out, n, n, r0, c0, v);
  store_block<T, true>(out, n, n, c0, r0, v);
}

template <typename T, int KIND>
void launch_rect_k(const T* x1, int n, const T* x2, int m, const T* decay, const T* sens,
                   int G, const T* ell, T* out, cudaStream_t stream) {
  const dim3 grid((m + STILE - 1) / STILE, (n + STILE - 1) / STILE);
  gram_rect_kernel<T, KIND><<<grid, STHREADS, 0, stream>>>(x1, n, x2, m, decay, sens, G, ell,
                                                           out);
}

template <typename T>
int launch_rect(const T* x1, int n, const T* x2, int m, const T* decay, const T* sens, int G,
                const T* ell, T* out, int kind, cudaStream_t stream) {
  if (n <= 0 || m <= 0) return (int)cudaGetLastError();
  if (G <= 0 || (n + STILE - 1) / STILE > 65535) return (int)cudaErrorInvalidValue;
  switch (kind) {
    case XX: launch_rect_k<T, XX>(x1, n, x2, m, decay, sens, G, ell, out, stream); break;
    case FF: launch_rect_k<T, FF>(x1, n, x2, m, decay, sens, G, ell, out, stream); break;
    case XF: launch_rect_k<T, XF>(x1, n, x2, m, decay, sens, G, ell, out, stream); break;
    case FX: launch_rect_k<T, FX>(x1, n, x2, m, decay, sens, G, ell, out, stream); break;
    case MIXED: launch_rect_k<T, MIXED>(x1, n, x2, m, decay, sens, G, ell, out, stream); break;
    default: return (int)cudaErrorInvalidValue;
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
  const Mid<T> m = mid<KIND, true>(a, b, k, c);
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
      if (vector_block<T>(n, n, r0, c0)) {
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
        const Cross<T> c =
            cross_terms<TABLE, true, 3>(a, b[kk], 4 * o.rg + ii, 4 * o.cg + kk, ct);
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
  const PackedRows<T> rows{meta, n};
  const int tiles = (int)lower_tiles(n);
  double acc_l = 0.0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    int i, j;
    tril_tile(tile, &i, &j);
    __syncthreads();  // the previous tile's tables and partials are read
    fill_table<T, NQ, KIND>(tab, key, rows, rows, gene, G, i, j, l);
    __syncthreads();
    const bool table = KIND != FF && cross_tables<T, true, 3>(tab, gslot, dgam, ndist, ct);
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

int simm_gram_rect_f32(const float* x1, int n, const float* x2, int m, const float* decay,
                       const float* sens, int G, const float* ell, float* out, int kind,
                       cudaStream_t stream) {
  return launch_rect<float>(x1, n, x2, m, decay, sens, G, ell, out, kind, stream);
}

int simm_gram_rect_f64(const double* x1, int n, const double* x2, int m, const double* decay,
                       const double* sens, int G, const double* ell, double* out, int kind,
                       cudaStream_t stream) {
  return launch_rect<double>(x1, n, x2, m, decay, sens, G, ell, out, kind, stream);
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

// Kernel `which` for chip_smoke.py: 0..9 K1 (f32 then f64, kinds xx, ff,
// xf, fx, mixed); 10..15 K2 (f32 then f64, kinds xx, ff, mixed); 16..21
// K2's backward (the same order). Its name into *name, its registers,
// local and static shared bytes into attrs[0..2]; -1 past the last kernel.
#define ATTRS(kernel, label) \
  do {                       \
    *name = label;           \
    return func_attrs(kernel, attrs); \
  } while (0)
int kernel_attrs(int which, const char** name, int* attrs) {
  switch (which) {
    case 0: ATTRS((gram_rect_kernel<float, XX>), "gram_rect_kernel<float, xx>");
    case 1: ATTRS((gram_rect_kernel<float, FF>), "gram_rect_kernel<float, ff>");
    case 2: ATTRS((gram_rect_kernel<float, XF>), "gram_rect_kernel<float, xf>");
    case 3: ATTRS((gram_rect_kernel<float, FX>), "gram_rect_kernel<float, fx>");
    case 4: ATTRS((gram_rect_kernel<float, MIXED>), "gram_rect_kernel<float, mixed>");
    case 5: ATTRS((gram_rect_kernel<double, XX>), "gram_rect_kernel<double, xx>");
    case 6: ATTRS((gram_rect_kernel<double, FF>), "gram_rect_kernel<double, ff>");
    case 7: ATTRS((gram_rect_kernel<double, XF>), "gram_rect_kernel<double, xf>");
    case 8: ATTRS((gram_rect_kernel<double, FX>), "gram_rect_kernel<double, fx>");
    case 9: ATTRS((gram_rect_kernel<double, MIXED>), "gram_rect_kernel<double, mixed>");
    case 10: ATTRS((gram_sym_kernel<float, XX>), "gram_sym_kernel<float, xx>");
    case 11: ATTRS((gram_sym_kernel<float, FF>), "gram_sym_kernel<float, ff>");
    case 12: ATTRS((gram_sym_kernel<float, MIXED>), "gram_sym_kernel<float, mixed>");
    case 13: ATTRS((gram_sym_kernel<double, XX>), "gram_sym_kernel<double, xx>");
    case 14: ATTRS((gram_sym_kernel<double, FF>), "gram_sym_kernel<double, ff>");
    case 15: ATTRS((gram_sym_kernel<double, MIXED>), "gram_sym_kernel<double, mixed>");
    case 16: ATTRS((gram_sym_bwd_kernel<float, XX>), "gram_sym_bwd_kernel<float, xx>");
    case 17: ATTRS((gram_sym_bwd_kernel<float, FF>), "gram_sym_bwd_kernel<float, ff>");
    case 18: ATTRS((gram_sym_bwd_kernel<float, MIXED>), "gram_sym_bwd_kernel<float, mixed>");
    case 19: ATTRS((gram_sym_bwd_kernel<double, XX>), "gram_sym_bwd_kernel<double, xx>");
    case 20: ATTRS((gram_sym_bwd_kernel<double, FF>), "gram_sym_bwd_kernel<double, ff>");
    case 21: ATTRS((gram_sym_bwd_kernel<double, MIXED>), "gram_sym_bwd_kernel<double, mixed>");
    default: return -1;
  }
}
#undef ATTRS

}  // extern "C"
