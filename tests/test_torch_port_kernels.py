"""The PyTorch port's kernel modules held to the JAX package on the CPU.

On the CPU each kernel wrapper of ``dis_project_tpu_torch`` takes its plain
PyTorch version; the JAX side runs its Pallas kernels in interpret mode, as
``tests/test_pallas.py`` does. Inputs are made with numpy from a seed and
handed to both packages. The CUDA kernels themselves are held to these
plain versions on the card by ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dis_project_tpu.ops import gram as jgram
from dis_project_tpu.ops import mll as jmll
from dis_project_tpu.ops import pallas_cholesky as pc
from dis_project_tpu.ops import pallas_gram as pg
from dis_project_tpu_torch.ops import cuda_cholesky, cuda_gram
from dis_project_tpu_torch.ops import gram as tgram
from dis_project_tpu_torch.ops import mll as tmll

G = 5
# Row populations (x1 flag, x2 flag) that match each declared kind.
KIND_FLAGS = {"xx": (1, 1), "ff": (0, 0), "xf": (1, 0), "fx": (0, 1), "mixed": (None, None)}


def _rows(rng, n, flag):
    """(n, 3) rows; expression rows use genes 0..G (G is out of range and
    must clamp to G-1), force rows carry gene -1."""
    t = rng.uniform(0, 12, n)
    f = rng.integers(0, 2, n) if flag is None else np.full(n, flag)
    g = np.where(f == 1, rng.integers(0, G + 1, n), -1)
    return np.stack([t, g, f], axis=1).astype(np.float64)


def _kinetics(rng):
    return rng.uniform(0.2, 1.0, G), rng.uniform(0.5, 1.5, G), np.float64(2.5)


def _t(a, dtype):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def _j(a, dtype):
    return jnp.asarray(np.asarray(a), dtype=dtype)


# ---------------------------------------------------------------------------
# K1 / K2 values: port (plain on CPU) vs the Pallas kernels in interpret mode,
# in f32. Tolerance atol 1e-3: the h-term multiplies a sum of erfs that
# cancels by exp(D |t - t'|) <= e^12 on rows spread over [0, 12], so any f32
# evaluation of the closed form lies up to ~3e-4 from its f64 value on these
# rows (measured for both the Pallas kernel, with its A&S 7.1.26 erf, and
# the port's torch.erf). A wrong branch, gene or tile is an O(0.1) error.
# The f64 closed forms agree to 1e-12 (test_plain_gram_matches_jax_row_gram_f64).
# ---------------------------------------------------------------------------

F32_ATOL = 1e-3


@pytest.mark.parametrize("n", [35, 70])
@pytest.mark.parametrize("kind", list(KIND_FLAGS))
def test_k1_cross_covariance_matches_pallas(kind, n):
    rng = np.random.default_rng(n)
    f1, f2 = KIND_FLAGS[kind]
    x1, x2 = _rows(rng, n, f1), _rows(rng, n + 13, f2)
    d, s, l = _kinetics(rng)
    ref = pg.cross_covariance(
        _j(x1, jnp.float32), _j(x2, jnp.float32), _j(d, jnp.float32),
        _j(s, jnp.float32), _j(l, jnp.float32),
        kind=kind, tile_m=32, tile_n=128, interpret=True,
    )
    got = cuda_gram.cross_covariance(
        _t(x1, torch.float32), _t(x2, torch.float32), _t(d, torch.float32),
        _t(s, torch.float32), _t(l, torch.float32), kind,
    )
    assert got.shape == (n, n + 13)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=F32_ATOL)


@pytest.mark.parametrize("n", [35, 70])
@pytest.mark.parametrize("kind", list(cuda_gram.SYM_KINDS))
def test_k2_gram_sym_matches_pallas(kind, n):
    """The port's symmetric Gram equals ``gram_sym`` and is exactly
    symmetric, for every kind a square Gram can take (the others raise:
    test_k2_refuses_asymmetric_kinds)."""
    rng = np.random.default_rng(100 + n)
    x = _rows(rng, n, KIND_FLAGS[kind][0])
    d, s, l = _kinetics(rng)
    ref = pg.gram_sym(
        _j(x, jnp.float32), _j(d, jnp.float32), _j(s, jnp.float32),
        _j(l, jnp.float32), kind=kind, tile=32, interpret=True,
    )
    got = cuda_gram.gram_sym(
        _t(x, torch.float32), _t(d, torch.float32), _t(s, torch.float32),
        _t(l, torch.float32), kind,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=F32_ATOL)
    assert torch.equal(got, got.T)


@pytest.mark.parametrize("kind", ["xf", "fx"])
def test_k2_refuses_asymmetric_kinds(kind):
    """'xf'/'fx' over one row set is no covariance; the Pallas kernel's
    output for it depends on its tile size, so the port refuses it."""
    x = torch.zeros(4, 3)
    d = torch.ones(G)
    with pytest.raises(ValueError, match="square Gram"):
        cuda_gram.gram_sym(x, d, d, torch.tensor(1.0), kind)


# ---------------------------------------------------------------------------
# K1 / K2 gradients: the autograd.Function backward vs JAX's VJP of the
# same closed form (what the Pallas custom_vjp differentiates), f64, 1e-10.
# ---------------------------------------------------------------------------


def _grad_pair(kind, n, square):
    rng = np.random.default_rng(7 + n)
    f1, f2 = KIND_FLAGS[kind]
    x1 = _rows(rng, n, f1)
    x2 = x1 if square else _rows(rng, n + 5, f2)
    d, s, l = _kinetics(rng)
    w = rng.standard_normal((n, x2.shape[0]))

    def jloss(d, s, l):
        K = jgram.cross_covariance_kind(jnp.asarray(x1), jnp.asarray(x2), d, s, l, kind)
        return jnp.sum(K * w)

    ref = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(
        jnp.asarray(d), jnp.asarray(s), jnp.asarray(l))
    dt, st, lt = (_t(a, torch.float64).requires_grad_(True) for a in (d, s, l))
    if square:
        K = cuda_gram.gram_sym(_t(x1, torch.float64), dt, st, lt, kind)
    else:
        K = cuda_gram.cross_covariance(_t(x1, torch.float64), _t(x2, torch.float64),
                                       dt, st, lt, kind)
    got = torch.autograd.grad((K * _t(w, torch.float64)).sum(), (dt, st, lt),
                              allow_unused=True)
    for g, r in zip(got, ref):
        g = np.zeros_like(np.asarray(r)) if g is None else g.numpy()
        np.testing.assert_allclose(g, np.asarray(r), rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("kind", list(KIND_FLAGS))
def test_k1_backward_matches_jax_vjp(kind):
    _grad_pair(kind, 30, square=False)


@pytest.mark.parametrize("kind", ["xx", "ff", "mixed"])
def test_k2_backward_matches_jax_vjp(kind):
    _grad_pair(kind, 30, square=True)


def test_plain_gram_matches_jax_row_gram_f64():
    """ops.gram closed forms (the plain versions) vs JAX's, f64 at 1e-12,
    including the gene clamp on out-of-range and force (-1) rows."""
    rng = np.random.default_rng(3)
    x1, x2 = _rows(rng, 40, None), _rows(rng, 33, None)
    d, s, l = _kinetics(rng)
    ref = jax.jit(jgram.cross_covariance)(*(jnp.asarray(a) for a in (x1, x2, d, s, l)))
    got = tgram.cross_covariance(*(_t(a, torch.float64) for a in (x1, x2, d, s, l)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-12, atol=1e-12)


# ---------------------------------------------------------------------------
# K3: the SYRK and the Sigma^{-1} route of the MLL backward.
# ---------------------------------------------------------------------------


def _real_factor(n, dtype=np.float64):
    """Cholesky factor of a real SIMM Sigma (cond ~1e3), not A A^T + n I."""
    rng = np.random.default_rng(n)
    x = _rows(rng, n, 1)
    x[:, 1] = rng.integers(0, G, n)
    d, s, l = _kinetics(rng)
    K = np.asarray(jax.jit(jgram.gram)(*(jnp.asarray(a) for a in (x, d, s, l))))
    return np.linalg.cholesky(K + 0.05 * np.eye(n)).astype(dtype)


@pytest.mark.parametrize("n", [96, 100])
def test_k3_inv_from_factor_tril_matches_jax_f64(n):
    """f64 on the CPU: both sides take tri-inverse + the recursive product;
    1e-10 relative to the largest entry."""
    L = _real_factor(n)
    ref = np.asarray(jax.jit(pc.inv_from_factor_tril)(jnp.asarray(L)))
    got = cuda_cholesky.inv_from_factor_tril(torch.as_tensor(L)).numpy()
    assert np.abs(got - ref).max() <= 1e-10 * np.abs(ref).max()
    assert np.all(np.triu(got, 1) == 0)


@pytest.mark.parametrize("n,tile", [(96, 32), (100, 32)])
def test_k3_syrk_matches_pallas_interpret(n, tile):
    """f32 vs the Pallas SYRK in interpret mode. Interpret mode loses the
    kernel's split-bf16 3-pass precision (XLA:CPU accumulates the bf16
    passes in bf16), so the bound is bf16-class: rel 2e-2 of the largest
    entry, as tests/test_pallas.py holds the kernel to. A missing tile
    triple would be an O(1) error."""
    Li = np.linalg.inv(_real_factor(n)).astype(np.float32)
    Li = np.tril(Li)
    ref = np.asarray(pc.syrk_ltl_tril(jnp.asarray(Li), tile=tile, interpret=True), np.float64)
    got = cuda_cholesky.syrk_ltl_tril(torch.as_tensor(Li)).numpy().astype(np.float64)
    assert np.abs(got - ref).max() / np.abs(ref).max() < 2e-2
    dense = cuda_cholesky.syrk_ltl(torch.as_tensor(Li))
    assert torch.equal(dense, dense.T)
    exact = Li.astype(np.float64).T @ Li.astype(np.float64)
    # The plain f32 product itself is f32-faithful: 1e-5 of the largest entry.
    assert np.abs(dense.numpy() - exact).max() <= 1e-5 * np.abs(exact).max()


def test_k3_backward_matches_autograd():
    """The SYRK Function's backward (plain VJP) vs autograd of the dense
    product, f64 at 1e-12."""
    rng = np.random.default_rng(11)
    Li = torch.as_tensor(np.tril(rng.standard_normal((40, 40))))
    w = torch.as_tensor(rng.standard_normal((40, 40)))
    a = Li.clone().requires_grad_(True)
    b = Li.clone().requires_grad_(True)
    (ga,) = torch.autograd.grad((cuda_cholesky.syrk_ltl_tril(a) * w).sum(), a)
    (gb,) = torch.autograd.grad((torch.tril(b.T @ b) * w).sum(), b)
    torch.testing.assert_close(ga, gb, rtol=1e-12, atol=1e-12)


# ---------------------------------------------------------------------------
# The MLL core: value and both cotangent forms vs JAX's custom VJP.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [64, 2048])
def test_mvn_logpdf_value_and_cotangents_match_jax(n):
    """n=64 takes the dense cotangent, n=2048 the tril symmetric-equivalent
    form (both packages switch at 2048). f64: value 1e-10 relative, each
    cotangent 1e-8 of its largest entry (Sigma^{-1} of a cond-1e3 matrix
    through two different triangular-inverse routes)."""
    L = _real_factor(n)
    sigma = L @ L.T
    rng = np.random.default_rng(5)
    y, mu = rng.standard_normal(n), rng.standard_normal(n)
    ref_v, ref_g = jax.jit(jax.value_and_grad(jmll.mvn_logpdf, argnums=(0, 1, 2)))(
        *(jnp.asarray(a) for a in (y, mu, sigma)))
    yt, mt, St = (torch.as_tensor(a).requires_grad_(True) for a in (y, mu, sigma))
    val = tmll.mvn_logpdf(yt, mt, St)
    got_g = torch.autograd.grad(val, (yt, mt, St))
    assert float(val.detach()) == pytest.approx(float(ref_v), rel=1e-10)
    for g, r in zip(got_g, ref_g):
        r = np.asarray(r)
        assert np.abs(g.numpy() - r).max() <= 1e-8 * np.abs(r).max()


def test_mvn_logpdf_non_pd_is_nan_not_raise():
    """An indefinite Sigma gives a NaN log-density (as jnp.linalg.cholesky
    does) — the trainer's finite guard relies on it."""
    sigma = torch.tensor([[1.0, 2.0], [2.0, 1.0]], dtype=torch.float64)
    val = tmll.mvn_logpdf(torch.zeros(2, dtype=torch.float64),
                          torch.zeros(2, dtype=torch.float64), sigma)
    assert torch.isnan(val)


def test_kernel_launchers_refuse_cpu_tensors():
    """A launcher never computes on the CPU: the wrappers route CPU tensors
    to the plain versions before reaching it."""
    x = torch.zeros(4, 3)
    d = torch.ones(G)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_gram.gram_rect_kernel(x, x, d, d, torch.tensor(1.0), "xx")
    with pytest.raises(ValueError, match="CUDA"):
        cuda_gram.gram_sym_kernel(x, d, d, torch.tensor(1.0), "xx")
    with pytest.raises(ValueError, match="CUDA"):
        cuda_cholesky.syrk_ltl_tril_kernel(torch.eye(4))
    with pytest.raises(ValueError, match="CUDA"):
        cuda_cholesky.chol_inv_unblocked_kernel(torch.eye(128))
    with pytest.raises(ValueError, match="CUDA"):
        cuda_cholesky.chol_unblocked_kernel(torch.eye(96))
