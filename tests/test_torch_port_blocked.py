"""The port's blocked Cholesky engine held to the JAX package on the CPU.

``dis_project_tpu_torch.ops.cuda_cholesky`` against
``dis_project_tpu.ops.pallas_cholesky`` and the ``'blocked'`` MLL engine
against the JAX one. Inputs are made with numpy from a seed and handed to
both packages. float64 comparisons hold the port to the JAX functions at
1e-10; float32 comparisons hold the plain versions of K4/K5 (what the
wrappers take on a CPU tensor) to the Pallas kernels in interpret mode, as
``tests/test_pallas.py`` runs them, at that file's tolerances. The CUDA
kernels themselves are held to these plain versions on the card by
``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dis_project_tpu.models import simm as jsimm
from dis_project_tpu.ops import mll as jmll
from dis_project_tpu.ops import pallas_cholesky as pc
from dis_project_tpu_torch.models import simm
from dis_project_tpu_torch.ops import cuda_cholesky as cc
from dis_project_tpu_torch.ops import gram as tgram
from dis_project_tpu_torch.ops import mll as tmll
from dis_project_tpu_torch.training import generic

G = 5


def _real_sigma(n, seed=0, noise=0.05):
    """A real SIMM Σ (cond ~1e3) on n expression rows, float64 numpy (the
    port's closed form, held to JAX's at 1e-12 in test_torch_port_kernels)."""
    rng = np.random.default_rng(seed)
    x = np.stack([rng.uniform(0, 12, n), rng.integers(0, G, n), np.ones(n)], 1)
    d, s = rng.uniform(0.2, 1.0, G), rng.uniform(0.5, 1.5, G)
    K = tgram.cross_covariance(*(torch.as_tensor(a) for a in (x, x, d, s, 2.5)))
    return K.numpy() + noise * np.eye(n)


def _spd(n, seed=0):
    """A random ``M Mᵀ + n I`` (the matrices of tests/test_pallas.py)."""
    M = np.random.default_rng(seed).standard_normal((n, n))
    return M @ M.T + n * np.eye(n)


def _close(got, ref, tol):
    """Max abs difference within ``tol`` of the largest reference entry."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    err = np.abs(got - ref).max()
    assert err <= tol * np.abs(ref).max(), err


def _t(a):
    return torch.as_tensor(np.array(a))


# ---------------------------------------------------------------------------
# Triangular inverses, float64, port vs JAX at 1e-10.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [300, 1100])
@pytest.mark.parametrize("leaf", ["solve", "doubling"])
def test_tri_inv_matches_jax(n, leaf):
    """Both leaves, a power-of-two split (1100 = 1024 + 76) and a plain
    doubling size; random SPD factors, as the JAX package tests the
    doubling leaf (it diverges on real factors beyond the 128 scale)."""
    L = np.linalg.cholesky(_spd(n, seed=n))
    ref = pc.tri_inv(jnp.asarray(L), leaf=leaf)
    got = cc.tri_inv(_t(L), leaf=leaf)
    _close(got, ref, 1e-10)
    assert np.abs(got.numpy() @ L - np.eye(n)).max() < 1e-8


def test_tri_inv_panels_matches_jax():
    L = np.linalg.cholesky(_real_sigma(700))
    ref = pc.tri_inv_panels(jnp.asarray(L), panel=256, base=128)
    got = cc.tri_inv_panels(_t(L), panel=256, base=128)
    _close(got, ref, 1e-10)


def _jax_blocked(n, block=128):
    A = _real_sigma(n, seed=n)
    L, dinvs = pc.blocked_cholesky(jnp.asarray(A), block=block, return_diag_inv=True)
    return A, np.asarray(L), np.asarray(dinvs)


@pytest.mark.parametrize("n", [512, 700])
def test_tri_inv_from_diag_matches_jax(n):
    """512: the pairwise combine reaches one block; 700 (padded to 768):
    combine 6 -> 3 blocks, then the row-panel sweep."""
    _, L, dinvs = _jax_blocked(n)
    ref = pc.tri_inv_from_diag(jnp.asarray(L), jnp.asarray(dinvs))
    got = cc.tri_inv_from_diag(_t(L), _t(dinvs))
    _close(got, ref, 1e-10)


# ---------------------------------------------------------------------------
# Factorisers, float64, port vs JAX at 1e-10.
# ---------------------------------------------------------------------------


def test_blocked_cholesky_matches_jax():
    """diag='xla', n=700 padded to 768 at block 256, with the diagonal
    inverses (identity on the padded tail)."""
    A = _real_sigma(700, seed=1)
    L_ref, d_ref = pc.blocked_cholesky(jnp.asarray(A), block=256, return_diag_inv=True)
    L, dinvs = cc.blocked_cholesky(_t(A), block=256, return_diag_inv=True)
    _close(L, L_ref, 1e-10)
    _close(dinvs, d_ref, 1e-10)
    assert torch.equal(L, cc.blocked_cholesky(_t(A), block=256))


def test_blocked_cholesky_bf16_operands_match_jax():
    """matmul_dtype=bfloat16 rounds the panel products' operands to bf16,
    as JAX does: both factors sit ~1.3e-2 (of the largest entry) from the
    f64 factor, against ~2e-6 in float32 (measured), and 3e-4 from each
    other (XLA:CPU and torch sum the products differently); 2e-2 and 2e-3."""
    A = _real_sigma(640, seed=14, noise=1.0).astype(np.float32)
    truth = np.linalg.cholesky(A.astype(np.float64))
    ref = pc.blocked_cholesky(jnp.asarray(A), block=256, matmul_dtype=jnp.bfloat16)
    got = cc.blocked_cholesky(_t(A), block=256, matmul_dtype=torch.bfloat16)
    _close(got, ref, 2e-3)
    _close(got.double(), truth, 2e-2)
    _close(np.asarray(ref, np.float64), truth, 2e-2)
    _close(cc.blocked_cholesky(_t(A), block=256).double(), truth, 1e-5)


def test_blocked_cholesky_bf16_rounds_the_correction_operands():
    """The float64 correction of the second block column takes the
    operands that matmul_dtype rounded: its diagonal block equals the
    factor of A22 - r(L21) r(L21)ᵀ (r: rounding to bf16, the product in
    float64), and lies far from the factor of the unrounded correction."""
    B = 128
    A = torch.as_tensor(_real_sigma(2 * B, seed=15, noise=1.0).astype(np.float32))
    L = cc.blocked_cholesky(A, block=B, matmul_dtype=torch.bfloat16)
    L21 = L[B:, :B]

    def second_block(left):
        left = left.double()
        c = (A[B:, B:].double() - left @ left.T).to(torch.float32)
        return torch.linalg.cholesky(c)

    rounded = second_block(L21.to(torch.bfloat16).to(torch.float32))
    _close(L[B:, B:], rounded.numpy(), 1e-6)
    far = float((L[B:, B:] - second_block(L21)).abs().max()) / float(rounded.abs().max())
    assert far > 1e-4, far


@pytest.mark.parametrize("n,block,inner", [(700, 256, 128), (300, None, 64)])
def test_blocked_cholesky_t_matches_jax(n, block, inner):
    """The upper factor (JAX leaves junk below the diagonal of its diagonal
    blocks; the port's Lt is exactly upper) and the diagonal inverses."""
    A = _real_sigma(n, seed=2)
    Lt_ref, d_ref = pc.blocked_cholesky_t(jnp.asarray(A), block=block, inner=inner,
                                          return_diag_inv=True)
    Lt, dinvs = cc.blocked_cholesky_t(_t(A), block=block, inner=inner, return_diag_inv=True)
    _close(Lt, np.triu(np.asarray(Lt_ref)), 1e-10)
    _close(dinvs, d_ref, 1e-10)
    assert torch.equal(Lt, torch.triu(Lt))
    _close(Lt.T @ Lt, A, 1e-12)


def test_blocked_cholesky_t_probe_eps_and_guard():
    A = _t(_spd(256, seed=3))
    Lt = cc.blocked_cholesky_t(A, inner=128)
    Lt2 = cc.blocked_cholesky_t(A, inner=128, probe_eps=1e-30)
    assert torch.allclose(Lt, Lt2, rtol=0, atol=1e-12)
    with pytest.raises(ValueError, match="multiple of"):
        cc.blocked_cholesky_t(A, block=300, inner=128)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_mll_cholesky_blocked_matches_jax(dtype):
    """ops.mll.cholesky(impl='blocked'): the lower factor from the
    transposed engine (float32) or the left-looking one (float64), at n=700
    (two blocks): JAX at 1e-10 in f64; the f64 factor at 1e-4 in f32."""
    A = _real_sigma(700, seed=13)
    if dtype == torch.float64:
        ref = jmll.cholesky(jnp.asarray(A), "blocked")
        _close(tmll.cholesky(_t(A), impl="blocked"), ref, 1e-10)
    else:
        L = tmll.cholesky(_t(A).float(), impl="blocked")
        assert torch.equal(L, torch.tril(L))
        _close(L.double(), np.linalg.cholesky(A), 1e-4)


@pytest.mark.parametrize("with_diag_inv", [False, True])
def test_inv_from_factor_tril_matches_jax(with_diag_inv):
    A, L, dinvs = _jax_blocked(700)
    kw_ref = {"diag_inv": jnp.asarray(dinvs)} if with_diag_inv else {}
    kw = {"diag_inv": _t(dinvs)} if with_diag_inv else {}
    ref = pc.inv_from_factor_tril(jnp.asarray(L), **kw_ref)
    got = cc.inv_from_factor_tril(_t(L), **kw)
    _close(got, ref, 1e-10)
    assert np.all(np.triu(got.numpy(), 1) == 0)
    _close(got, np.tril(np.linalg.inv(A)), 1e-8)


def test_blocked_chol_solve_and_inv_from_factor_match_jax():
    A = _real_sigma(300, seed=4)
    L = np.linalg.cholesky(A)
    b = np.random.default_rng(4).standard_normal((300, 3))
    _close(cc.blocked_chol_solve(_t(L), _t(b)), pc.blocked_chol_solve(jnp.asarray(L), b), 1e-10)
    _close(cc.inv_from_factor(_t(L)), pc.inv_from_factor(jnp.asarray(L)), 1e-10)


def test_inv_from_factor_tril_f32_panel_branch():
    """The float32 route above N=2048, both Li routes (tri_inv_from_diag over
    the port's own blocked_cholesky_t inverses, and tri_inv_panels), then
    the SYRK's plain version: the f64 truth tril(Σ⁻¹) at 1e-3 of its
    largest entry (float32 eps times this Σ's condition number, ~1e4;
    measured 1.2e-4). A wrong block or panel is an O(1) error."""
    n = 2112
    A = _real_sigma(n, seed=5, noise=0.1)
    Lt, dinvs = cc.blocked_cholesky_t(_t(A).float(), block=512, return_diag_inv=True)
    L = Lt.T.contiguous()
    truth = np.tril(np.linalg.inv(A))
    for kw in ({"diag_inv": dinvs}, {}):
        _close(cc.inv_from_factor_tril(L, **kw).double(), truth, 1e-3)


@pytest.fixture(scope="module")
def sigma_2048():
    """One real SIMM Σ at N = 2048, built once: the Σ⁻¹-route tests take
    its leading principal blocks, each SPD."""
    return _real_sigma(2048, seed=16)


@pytest.mark.parametrize("n", [300, 2 * cc.SIGMA_INV_BLOCK, 2 * cc.SIGMA_INV_BLOCK + 37])
def test_sigma_inv_panels_matches_jax(sigma_2048, n):
    """The float64 Σ⁻¹ recurrence below one block, at an exact multiple of
    the block and with a ragged last block, on real SIMM factors: the JAX
    package's inv_from_factor at 1e-10, and exactly symmetric."""
    L = np.linalg.cholesky(sigma_2048[:n, :n])
    ref = jax.jit(pc.inv_from_factor)(jnp.asarray(L))
    got = cc.sigma_inv_panels(_t(L))
    _close(got, ref, 1e-10)
    assert torch.equal(got, got.T)


# ---------------------------------------------------------------------------
# The blocked MLL engine.
# ---------------------------------------------------------------------------


def test_mvn_logpdf_blocked_matches_jax():
    """float64, n=600 (two blocks of 512, identity-padded): value at rtol
    1e-12, gradients at 1e-10, the Σ cotangent compared by its symmetric
    part (the blocked backward emits the mirror-free tril form)."""
    n = 600
    A = _real_sigma(n, seed=6)
    rng = np.random.default_rng(6)
    y, mu = rng.standard_normal(n), rng.standard_normal(n)
    ref_v, ref_g = jax.jit(jax.value_and_grad(
        lambda y, m, s: jmll.mvn_logpdf(y, m, s, impl="blocked"), argnums=(0, 1, 2)))(
        *(jnp.asarray(a) for a in (y, mu, A)))
    yt, mt, St = (_t(a).requires_grad_(True) for a in (y, mu, A))
    val = tmll.mvn_logpdf(yt, mt, St, impl="blocked")
    gy, gm, gs = torch.autograd.grad(val, (yt, mt, St))
    assert float(val.detach()) == pytest.approx(float(ref_v), rel=1e-12)
    _close(gy, ref_g[0], 1e-10)
    _close(gm, ref_g[1], 1e-10)
    sym = np.asarray(ref_g[2])
    _close(0.5 * (gs + gs.T), 0.5 * (sym + sym.T), 1e-10)


@pytest.mark.parametrize("impl, dtype, n, engages", [
    ("xla", torch.float64, tmll._TRI_INV_MIN_N, True),
    ("xla", torch.float32, tmll._TRI_INV_MIN_N, False),
    ("xla", torch.float64, tmll._TRI_INV_MIN_N - 1, False),
    ("blocked", torch.float64, tmll._TRI_INV_MIN_N, False),
])
def test_mvn_logpdf_panel_route_engages_only_for_f64_xla_from_2048(sigma_2048, impl, dtype,
                                                                   n, engages):
    """The backward takes sigma_inv_panels for float64 'xla' from N = 2048
    and nowhere else (the route counter); there the Σ cotangent is the
    dense symmetric form, the symmetric part of JAX's tril form at 1e-10."""
    A = sigma_2048[:n, :n]
    y = np.random.default_rng(16).standard_normal(n)
    S = _t(A).to(dtype).requires_grad_(True)
    before = cc.ROUTES["sigma_inv_panels"]
    val = tmll.mvn_logpdf(_t(y).to(dtype), torch.zeros(n, dtype=dtype), S, impl=impl)
    (gs,) = torch.autograd.grad(val, S)
    assert cc.ROUTES["sigma_inv_panels"] - before == int(engages)
    if engages:
        ref = np.asarray(jax.jit(jax.grad(jmll.mvn_logpdf, argnums=2))(
            jnp.asarray(y), jnp.zeros(n), jnp.asarray(A)))
        _close(gs, 0.5 * (ref + ref.T), 1e-10)


def test_mvn_logpdf_blocked_f32_matches_xla_f32():
    """The float32 engine (transposed factor, Lt-native solves) against the
    port's 'xla' engine in float32, as tests/test_pallas.py holds the JAX
    engines: value rtol 2e-5, Σ cotangent's symmetric part 2e-4."""
    n = 320
    A = _real_sigma(n, seed=7, noise=1.01).astype(np.float32)
    y = np.random.default_rng(7).standard_normal(n).astype(np.float32)
    out = {}
    for impl in ("xla", "blocked"):
        S = _t(A).requires_grad_(True)
        v = tmll.mvn_logpdf(_t(y), torch.zeros(n), S, impl=impl)
        (g,) = torch.autograd.grad(v, S)
        out[impl] = (float(v.detach()), 0.5 * (g + g.T))
    assert out["blocked"][0] == pytest.approx(out["xla"][0], rel=2e-5)
    _close(out["blocked"][1], out["xla"][1].numpy(), 2e-4)


def test_exact_simm_blocked_matches_jax_model():
    """ExactSIMM(chol_impl='blocked') on a small dense grid (5 genes x 60
    times, N=300): MLL and raw-parameter gradients against the JAX model at
    1e-10 (the multi-block engine is held by test_mvn_logpdf_blocked_matches_jax)."""
    Gd, T = 5, 60
    rng = np.random.default_rng(8)
    t = np.tile(np.linspace(0, 12, T), Gd)
    X = np.stack([t, np.repeat(np.arange(Gd), T), np.ones(Gd * T)], 1)
    y = rng.standard_normal(Gd * T)
    p = jsimm.init_params(Gd)
    raw = jsimm.unconstrain(p._replace(decay=p.decay * jnp.asarray(rng.uniform(0.7, 1.5, Gd))))
    jmodel = jsimm.ExactSIMM(num_genes=Gd, jitter=1e-4, canonical_rows=True,
                             gram_impl="xla", chol_impl="blocked")
    ref_v, ref_g = jax.jit(jax.value_and_grad(
        lambda r: jmodel.mll(jsimm.constrain(r), jnp.asarray(X), jnp.asarray(y))))(raw)
    tmodel = simm.ExactSIMM(num_genes=Gd, jitter=1e-4, canonical_rows=True, chol_impl="blocked")
    traw = simm.SIMMParams(*(_t(a) for a in raw))
    got_v, got_g = generic.value_and_grad(
        lambda r: tmodel.mll(simm.constrain(r), _t(X), _t(y)), traw)
    assert float(got_v) == pytest.approx(float(ref_v), rel=1e-10)
    for g, r in zip(got_g, ref_g):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_non_pd_sigma_gives_nan_loss_on_blocked_engine(dtype):
    """A non-PD Σ gives a NaN loss (the trainer's finite guard), never an
    exception, on both precisions of the blocked engine."""
    n = 200
    A = np.eye(n)
    A[150, 150] = -1.0
    val = tmll.mvn_logpdf(torch.zeros(n, dtype=dtype), torch.zeros(n, dtype=dtype),
                          _t(A).to(dtype), impl="blocked")
    assert torch.isnan(val)
    assert torch.isnan(cc.blocked_cholesky_t(_t(A).to(dtype), inner=64)).any()


# ---------------------------------------------------------------------------
# K4 and K5: the plain versions vs the Pallas kernels in interpret mode, f32.
# ---------------------------------------------------------------------------


def test_k5_chol_unblocked_matches_pallas():
    """B=96: L Lᵀ vs A at rtol 2e-5 / atol 2e-4 and a zero upper triangle
    (tests/test_pallas.py's bounds), and the Pallas factor at the same."""
    A = _spd(96, seed=9).astype(np.float32)
    ref = np.asarray(pc.chol_unblocked(jnp.asarray(A), interpret=True))
    L = cc.chol_unblocked(_t(A))
    np.testing.assert_allclose((L @ L.T).numpy(), A, rtol=2e-5, atol=2e-4)
    assert float(torch.triu(L, 1).abs().max()) == 0.0
    np.testing.assert_allclose(L.numpy(), ref, rtol=2e-5, atol=2e-4)


@pytest.mark.parametrize("B", [128, 256])
def test_k4_chol_inv_unblocked_matches_pallas(B):
    """The port's L and Li against the Pallas kernel's on the same block: L
    at 1e-4 and Li at 5e-5 (tests/test_pallas.py's bounds for L against the
    f64 factor and for Li·L - I), and the port's own L against the f64
    factor and Li·L - I at those bounds."""
    A = _spd(B, seed=10).astype(np.float32)
    truth = np.linalg.cholesky(A.astype(np.float64))
    L, Li = (t.numpy() for t in cc.chol_inv_unblocked(_t(A)))
    L_ref, Li_ref = (np.asarray(t) for t in pc.chol_inv_unblocked(jnp.asarray(A), interpret=True))
    np.testing.assert_allclose(L, L_ref, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(Li, Li_ref, rtol=5e-5, atol=5e-5)
    np.testing.assert_allclose(L, truth, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(Li @ L, np.eye(B), atol=5e-5)
    assert np.all(np.triu(Li, 1) == 0)


@pytest.mark.parametrize("diag", ["pallas", "pallas_inv"])
def test_blocked_cholesky_kernel_diag_matches_pallas(diag):
    """n=640 at block 256 through each kernel option: the port's factor
    against the JAX package's (Pallas in interpret mode) and against the
    f64 factor, both at 2e-4."""
    A = _spd(640, seed=11).astype(np.float32)
    truth = np.linalg.cholesky(A.astype(np.float64))
    got = cc.blocked_cholesky(_t(A), block=256, diag=diag).numpy()
    ref = np.asarray(pc.blocked_cholesky(jnp.asarray(A), block=256, diag=diag, interpret=True))
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got, truth, rtol=2e-4, atol=2e-4)


# ---------------------------------------------------------------------------
# Dispatch.
# ---------------------------------------------------------------------------


def test_resolve_chol_impl_on_cpu():
    """'auto' is 'xla' at every size and dtype, as the JAX package's rule
    off its chip; explicit choices pass through."""
    for n, dt, jdt in ((4096, torch.float32, jnp.float32), (100, torch.float64, jnp.float64)):
        assert tmll.resolve_chol_impl(n, dt, "cpu") == jmll.resolve_chol_impl(n, jdt) == "xla"
    # On the card too: the blocked step has not measured faster there by more
    # than the step-to-step spread (PERF.md).
    assert tmll.resolve_chol_impl(10_000, torch.float32, "cuda") == "xla"
    for impl in ("auto", "xla", "blocked"):
        model = simm.ExactSIMM(chol_impl=impl)
        want = "xla" if impl == "auto" else impl
        assert model._resolve_chol(4096, torch.float32, torch.device("cpu")) == want
    with pytest.raises(ValueError, match="impl must be"):
        tmll.mvn_logpdf(torch.zeros(2), torch.zeros(2), torch.eye(2), impl="cg")


def test_pallas_inv_routing(monkeypatch):
    """diag='pallas_inv' reaches K4's wrapper only for float32 blocks that
    are multiples of 128 up to 512; float64, odd blocks and a single block
    of another size take 'xla' (API rules), with the same factor."""
    calls = []
    real = cc.chol_inv_unblocked

    def counting(a):
        calls.append(a.shape[0])
        return real(a)

    monkeypatch.setattr(cc, "chol_inv_unblocked", counting)
    A = _t(_spd(400, seed=12))
    for dtype, block, n, want in ((torch.float32, 256, 400, [256, 256]),
                                  (torch.float64, 256, 400, []),
                                  (torch.float32, 192, 400, []),
                                  (torch.float32, 1024, 400, []),
                                  (torch.float32, 512, 384, [384])):
        calls.clear()
        a = A[:n, :n].to(dtype)
        L = cc.blocked_cholesky(a, block=block, diag="pallas_inv")
        assert calls == want, (dtype, block, n)
        ref = cc.blocked_cholesky(a, block=block, diag="xla")
        torch.testing.assert_close(L, ref, rtol=0, atol=1e-4 if dtype == torch.float32 else 0)
