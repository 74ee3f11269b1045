"""The port's second-order (spring-damper) family held to the JAX package on
the CPU: the complex erf (``ops/special.py``), the order-2 closed forms and
table Gram (``ops/lfm_kernels2.py``), ``models/simm2.py`` and the
second-order data generator (``data/synthetic.py``).

The same numpy inputs (seeded) go through both packages; float64 unless
stated. The JAX references are compiled at XLA's lowest CPU optimisation
level, several at once where they share inputs: the complex-erf closed
forms are costly to compile.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dis_project_tpu.data import synthetic as jsynth
from dis_project_tpu.models import simm2 as jsimm2
from dis_project_tpu.ops import lfm_kernels as jlfk
from dis_project_tpu.ops import lfm_kernels2 as jlfk2
from dis_project_tpu.ops import special as jspecial
from dis_project_tpu_torch import convert
from dis_project_tpu_torch.data import synthetic as tsynth
from dis_project_tpu_torch.models import simm2
from dis_project_tpu_torch.ops import lfm_kernels as lfk
from dis_project_tpu_torch.ops import lfm_kernels2 as lfk2
from dis_project_tpu_torch.ops import special
from dis_project_tpu_torch.training import generic

F32, F64 = torch.float32, torch.float64
FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


def _jit(fn, **kw):
    return jax.jit(fn, compiler_options=FAST_COMPILE, **kw)


def _t(a, dtype=F64):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def _rel_err(got, ref):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    return float(np.max(np.abs(got - ref)) / np.max(np.abs(ref)))


# ---------------------------------------------------------------------------
# The complex erf.
# ---------------------------------------------------------------------------


def _erf_domain(dtype):
    """The order-2 kernels' working domain (|Re| <= 26, |Im| <= 5), with a
    dense patch around 0 where 1 - exp(-z^2) w(iz) cancels."""
    rng = np.random.default_rng(7)
    z = np.concatenate([
        rng.uniform(-26, 26, 3000) + 1j * rng.uniform(-5, 5, 3000),
        rng.uniform(-1, 1, 500) + 1j * rng.uniform(-1, 1, 500),
        np.array([0.0, 1e-9, -1e-9j, 26.0 + 5j, -26.0 - 5j]),
    ])
    return z.astype(dtype)


@pytest.mark.parametrize("dtype", [np.complex128, np.complex64], ids=["c128", "c64"])
def test_erf_complex_matches_jax(dtype):
    """complex128 within 1e-13 relative (1e-13 absolute where |erf| < 1);
    complex64 (40 terms) within 1e-5 x max(1, |erf|)."""
    z = _erf_domain(dtype)
    ref = np.asarray(_jit(jspecial.erf_complex)(jnp.asarray(z)))
    got = special.erf_complex(torch.as_tensor(z)).numpy()
    assert got.dtype == dtype
    err = np.abs(got.astype(np.complex128) - ref)
    mag = np.abs(ref)
    if dtype == np.complex128:
        assert np.max(err[mag >= 1] / mag[mag >= 1]) <= 1e-13
        assert np.max(err[mag < 1]) <= 1e-13
    else:
        assert np.max(err / np.maximum(1.0, mag)) <= 1e-5


def test_faddeeva_and_erfc_match_jax_in_both_half_planes():
    z = _erf_domain(np.complex128)
    z = z[np.abs(z.imag) <= 4]  # w(z) = 2 exp(-z^2) - w(-z) grows like exp(Im^2)
    ref_w = np.asarray(_jit(jspecial.faddeeva)(jnp.asarray(z)))
    got_w = special.faddeeva(torch.as_tensor(z)).numpy()
    assert np.max(np.abs(got_w - ref_w) / np.maximum(1.0, np.abs(ref_w))) <= 1e-13
    ref_c = np.asarray(_jit(jspecial.erfc_complex)(jnp.asarray(z)))
    got_c = special.erfc_complex(torch.as_tensor(z)).numpy()
    assert np.max(np.abs(got_c - ref_c) / np.maximum(1.0, np.abs(ref_c))) <= 1e-13


def test_erf_complex_takes_real_inputs_as_complex():
    x = np.linspace(-3.0, 3.0, 13)
    got = special.erf_complex(_t(x))
    assert got.dtype == torch.complex128
    np.testing.assert_allclose(got.real.numpy(), torch.erf(_t(x)).numpy(), rtol=0, atol=1e-14)
    assert special.erf_complex(_t(x, F32)).dtype == torch.complex64


@pytest.mark.parametrize("scale", [1.0, 4.0], ids=["near", "wide"])
def test_erf_complex_gradients_match_jax(scale):
    """d/dRe z and d/dIm z of a real function of erf(z) against
    ``jax.grad`` (the analytic JVP), at 1e-12 of max|g|: a backward that
    multiplied by erf'(z) without the conjugate gives the wrong sign on one
    of the two."""
    rng = np.random.default_rng(11)
    x = scale * rng.uniform(-1.5, 1.5, 40)
    y = scale / 2 * rng.uniform(-1.0, 1.0, 40)
    w = rng.normal(size=(3, 40))

    def jloss(x, y):
        e = jspecial.erf_complex(x + 1j * y)
        return jnp.sum(w[0] * e.real + w[1] * e.imag + w[2] * jnp.abs(e) ** 2)

    ref = [np.asarray(g) for g in _jit(jax.grad(jloss, argnums=(0, 1)))(x, y)]
    xl, yl = _t(x).requires_grad_(True), _t(y).requires_grad_(True)
    e = special.erf_complex(torch.complex(xl, yl))
    loss = torch.sum(_t(w[0]) * e.real + _t(w[1]) * e.imag + _t(w[2]) * e.abs() ** 2)
    got = torch.autograd.grad(loss, (xl, yl))
    for g, r in zip(got, ref):
        assert np.max(np.abs(g.numpy() - r)) <= 1e-12 * max(1.0, np.abs(r).max())


def test_erf_complex_backward_keeps_no_polynomial_graph():
    """The whole Faddeeva evaluation runs without a graph: the unselected
    reflection branches (exp(zr^2) overflows far from the axis in complex64)
    never meet autograd, so the gradient stays finite there."""
    z = torch.tensor([26.0 + 4.0j, -26.0 + 0.5j, 3.0 - 4.0j], dtype=torch.complex64,
                     requires_grad=True)
    (g,) = torch.autograd.grad(special.erf_complex(z).real.sum(), z)
    assert bool(torch.isfinite(g).all())


# ---------------------------------------------------------------------------
# The order-2 closed forms, the table Gram and the chunked build.
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _kin(G, seed):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.2, 0.9, G), rng.uniform(0.5, 1.5, G), rng.uniform(0.5, 1.5, G),
            np.asarray(1.7))


def _rows(n, G, rng):
    """Mixed (t, gene, flag) rows: force rows carry gene -1; genes past G
    are clamped."""
    f = rng.integers(0, 2, n).astype(float)
    g = np.where(f == 0, -1.0, rng.integers(0, G + 1, n).astype(float))
    return np.stack([rng.uniform(0, 12, n), g, f], axis=1)


@pytest.fixture(scope="module")
def kernel_case():
    """One compiled JAX program for every closed-form reference."""
    G = 3
    a, w, s, ell = _kin(G, 0)
    rng = np.random.default_rng(1)
    t1, t2 = np.linspace(0.0, 12.0, 7), np.linspace(0.3, 13.0, 5)
    x1, x2 = _rows(24, G, rng), _rows(19, G, rng)
    tt, tp = rng.uniform(0, 12, (4, 6)), rng.uniform(0, 12, (4, 6))

    def refs(a, w, s, ell):
        return {
            "k_xx2": jlfk2.k_xx2(tt, tp, a[0], w[0], a[1], w[1], s[0], s[1], ell),
            "k_xf2": jlfk2.k_xf2(tt, tp, a[2], w[2], s[2], ell),
            "k_ff2": jlfk2.k_ff2(tt, tp, ell),
            "k_xx2_block": jlfk2.k_xx2_block(t1, t2, a, w, s, ell),
            "k_xf2_block": jlfk2.k_xf2_block(t1, t2, a, w, s, ell),
            "cross_covariance2": jlfk2.cross_covariance2(x1, x2, a, w, s, ell),
            "table": jlfk2.gram_xx2_blocked_fast(jnp.asarray(t1), a, w, s, ell),
        }

    ref = {k: np.asarray(v) for k, v in _jit(refs)(a, w, s, ell).items()}
    return dict(a=a, w=w, s=s, ell=ell, t1=t1, t2=t2, x1=x1, x2=x2, tt=tt, tp=tp, ref=ref)


def test_k_xx2_matches_jax(kernel_case):
    c = kernel_case
    a, w, s = (_t(v) for v in (c["a"], c["w"], c["s"]))
    got = lfk2.k_xx2(_t(c["tt"]), _t(c["tp"]), a[0], w[0], a[1], w[1], s[0], s[1], _t(c["ell"]))
    assert _rel_err(got, c["ref"]["k_xx2"]) <= 1e-12


def test_k_xf2_and_k_ff2_match_jax(kernel_case):
    c = kernel_case
    got = lfk2.k_xf2(_t(c["tt"]), _t(c["tp"]), _t(c["a"][2]), _t(c["w"][2]), _t(c["s"][2]),
                     _t(c["ell"]))
    assert _rel_err(got, c["ref"]["k_xf2"]) <= 1e-12
    assert _rel_err(lfk2.k_ff2(_t(c["tt"]), _t(c["tp"]), _t(c["ell"])), c["ref"]["k_ff2"]) <= 1e-14


@pytest.mark.parametrize("name", ["k_xx2_block", "k_xf2_block"])
def test_block_builders_match_jax(kernel_case, name):
    c = kernel_case
    got = getattr(lfk2, name)(_t(c["t1"]), _t(c["t2"]), _t(c["a"]), _t(c["w"]), _t(c["s"]),
                              _t(c["ell"]))
    assert got.shape == c["ref"][name].shape
    assert _rel_err(got, c["ref"][name]) <= 1e-12


@pytest.mark.parametrize("f1, f2", [(1, 1), (1, 0), (0, 1), (0, 0)],
                         ids=["xx", "xf", "fx", "ff"])
def test_cross_covariance2_matches_jax_on_every_flag_pair(kernel_case, f1, f2):
    """Every (flag, flag) block of the mixed-row covariance, genes clamped,
    at 1e-12 of the block's max|K|."""
    c = kernel_case
    got = lfk2.cross_covariance2(_t(c["x1"]), _t(c["x2"]), _t(c["a"]), _t(c["w"]), _t(c["s"]),
                                 _t(c["ell"])).numpy()
    rows, cols = c["x1"][:, 2] == f1, c["x2"][:, 2] == f2
    assert rows.any() and cols.any()
    ref = c["ref"]["cross_covariance2"][np.ix_(rows, cols)]
    assert _rel_err(got[np.ix_(rows, cols)], ref) <= 1e-12


def test_table_gram_matches_jax_and_the_block_builder(kernel_case):
    c = kernel_case
    args = (_t(c["a"]), _t(c["w"]), _t(c["s"]), _t(c["ell"]))
    got = lfk2.gram_xx2_blocked_fast(_t(c["t1"]), *args)
    assert _rel_err(got, c["ref"]["table"]) <= 1e-11
    own = lfk2.k_xx2_block(_t(c["t1"]), _t(c["t1"]), *args)
    assert _rel_err(got, own) <= 1e-11


def test_table_gram_gradient_matches_the_block_builder(kernel_case):
    """The table Gram's reassociated contractions differentiate as the
    closed form does: d/d(alpha, omega, S, l) of a weighted sum, 1e-11."""
    c = kernel_case
    t = _t(c["t1"])
    wts = _t(np.random.default_rng(4).normal(size=(21, 21)))
    grads = []
    for build in (lambda *p: lfk2.gram_xx2_blocked_fast(t, *p),
                  lambda *p: lfk2.k_xx2_block(t, t, *p)):
        leaves = [_t(c[k]).requires_grad_(True) for k in ("a", "w", "s", "ell")]
        grads.append(torch.autograd.grad(torch.sum(wts * build(*leaves)), leaves))
    for g_table, g_block in zip(*grads):
        scale = max(1.0, float(g_block.abs().max()))
        assert float((g_table - g_block).abs().max()) <= 1e-11 * scale


def test_table_gram_float32_stays_near_float64(kernel_case):
    c = kernel_case
    args = [_t(c[k]) for k in ("a", "w", "s", "ell")]
    k64 = lfk2.gram_xx2_blocked_fast(_t(c["t1"]), *args)
    k32 = lfk2.gram_xx2_blocked_fast(_t(c["t1"], F32), *(v.float() for v in args))
    assert k32.dtype == F32
    assert _rel_err(k32.double(), k64) <= 1e-5


def test_table_gram_refuses_an_irregular_grid(kernel_case):
    c = kernel_case
    t = np.array([0.0, 1.0, 2.0, 4.0, 6.0])
    with pytest.raises(ValueError, match="UNIFORM time grid"):
        lfk2.gram_xx2_blocked_fast(_t(t), _t(c["a"]), _t(c["w"]), _t(c["s"]), _t(c["ell"]))


def test_cross_covariance2_chunked_equals_the_unchunked_build(kernel_case):
    """A chunk smaller than N (and not dividing it): value and gradient
    equal to the unchunked build at 1e-13."""
    c = kernel_case
    wts = _t(np.random.default_rng(5).normal(size=(24, 19)))
    out = []
    for build in (lambda *p: lfk2.cross_covariance2_chunked(*p, chunk=7),
                  lfk2.cross_covariance2):
        leaves = [_t(c[k]).requires_grad_(True) for k in ("a", "w", "s", "ell")]
        K = build(_t(c["x1"]), _t(c["x2"]), *leaves)
        out.append((K.detach(), torch.autograd.grad(torch.sum(wts * K), leaves)))
    (k_c, g_c), (k_u, g_u) = out
    assert float((k_c - k_u).abs().max()) <= 1e-13
    for a, b in zip(g_c, g_u):
        assert float((a - b).abs().max()) <= 1e-13 * max(1.0, float(b.abs().max()))


def test_first_order_forms_keep_torch_erf_and_k_ff_consistent_matches_jax():
    """``erf_fn`` defaults to ``torch.erf`` (first-order values unchanged);
    the Lawrence-convention prior against JAX's."""
    t, tp = np.linspace(0, 12, 9), np.linspace(0.5, 11, 6)
    ref = np.asarray(jlfk.k_ff_consistent_block(jnp.asarray(t), jnp.asarray(tp), 1.7))
    assert _rel_err(lfk.k_ff_consistent_block(_t(t), _t(tp), _t(1.7)), ref) <= 1e-15
    args = (_t(t)[:, None], _t(tp)[None, :], _t(0.4), _t(0.9), _t(1.1), _t(0.8), _t(2.5))
    assert torch.equal(lfk.k_xx(*args), lfk.k_xx(*args, erf_fn=torch.erf))


# ---------------------------------------------------------------------------
# The model.
# ---------------------------------------------------------------------------


def _p2(G, seed):
    """Kinetics off the init point (SIMM2Params as numpy by field name)."""
    rng = np.random.default_rng(seed)
    return {
        "basal": 0.05 + 0.02 * rng.uniform(size=G),
        "sensitivity": rng.uniform(0.7, 1.3, G),
        "alpha": rng.uniform(0.3, 0.9, G),
        "omega": rng.uniform(0.6, 1.4, G),
        "lengthscale": np.asarray(1.8),
        "obs_stddev": np.asarray(0.4),
    }


@pytest.fixture(scope="module")
def model_case():
    """A gene-major uniform grid (G = 3, T = 6), its rows, observations and
    per-point variances; latent and output test rows; every JAX model
    reference from one compiled program."""
    G, T = 3, 6
    p = _p2(G, 2)
    rng = np.random.default_rng(3)
    t = np.linspace(0.0, 12.0, T)
    X = np.stack([np.tile(t, G), np.repeat(np.arange(G), T).astype(float), np.ones(G * T)], 1)
    y = np.repeat(p["basal"] / (p["alpha"] ** 2 + p["omega"] ** 2), T) + rng.normal(size=G * T)
    var = rng.uniform(0.01, 0.05, G * T)
    tf = np.stack([np.linspace(0, 13, 9), -np.ones(9), np.zeros(9)], 1)
    to = np.stack([rng.uniform(0, 12, 7), rng.integers(0, G, 7).astype(float), np.zeros(7)], 1)
    jp = jsimm2.SIMM2Params(**{k: jnp.asarray(v) for k, v in p.items()})
    model = jsimm2.SecondOrderSIMM(num_genes=G, jitter=1e-4)
    raw = jsimm2.unconstrain(jp)

    jX, jy, jvar, jtf, jto = (jnp.asarray(a) for a in (X, y, var, tf, to))

    def refs(raw):
        mll, g = jax.value_and_grad(lambda r: model.mll(jsimm2.constrain(r), jX, jy))(raw)
        mllg, gg = jax.value_and_grad(
            lambda r: model.mll_gridded(jsimm2.constrain(r), jnp.asarray(t), jy))(raw)
        pc = jsimm2.constrain(raw)
        lat = model.latent_predict(pc, jtf, jX, jy, jvar)
        out = model.output_predict(pc, jto, jX, jy, jvar)
        return (mll, g, mllg, gg, lat.mean, lat.cov, out.mean, out.cov,
                model.mean_function(pc, jto))

    ref = [jax.tree.map(np.asarray, r) for r in _jit(refs)(raw)]
    return dict(G=G, p=p, t=t, X=X, y=y, var=var, tf=tf, to=to, ref=ref,
                raw=convert.simm2_params_from_numpy(jax.tree.map(np.asarray, raw)._asdict(),
                                                    device="cpu"))


def _model(case, **kw):
    return simm2.SecondOrderSIMM(num_genes=case["G"], jitter=1e-4, **kw)


def _grads_close(got, ref, tol):
    scale = max(np.abs(np.asarray(getattr(ref, f))).max() for f in ref._fields)
    for f in ref._fields:
        err = np.abs(getattr(got, f).numpy() - np.asarray(getattr(ref, f))).max()
        assert err <= tol * scale, (f, err, scale)


def test_mll_and_raw_gradients_match_jax(model_case):
    c = model_case
    model = _model(c)
    loss, grads = generic.value_and_grad(
        lambda r: model.mll(simm2.constrain(r), _t(c["X"]), _t(c["y"])), c["raw"])
    assert abs(float(loss) - float(c["ref"][0])) <= 1e-10
    _grads_close(grads, c["ref"][1], 1e-9)


def test_mll_gridded_matches_jax_and_the_row_mll(model_case):
    c = model_case
    model = _model(c)
    loss, grads = generic.value_and_grad(
        lambda r: model.mll_gridded(simm2.constrain(r), _t(c["t"]), _t(c["y"])), c["raw"])
    assert abs(float(loss) - float(c["ref"][2])) <= 1e-10
    assert abs(float(loss) - float(c["ref"][0])) <= 1e-10
    _grads_close(grads, c["ref"][3], 1e-9)


def test_latent_predict_matches_jax(model_case):
    c = model_case
    p = simm2.constrain(c["raw"])
    post = _model(c).latent_predict(p, _t(c["tf"]), _t(c["X"]), _t(c["y"]), _t(c["var"]))
    np.testing.assert_allclose(post.mean.numpy(), c["ref"][4], rtol=0, atol=1e-9)
    np.testing.assert_allclose(post.cov.numpy(), c["ref"][5], rtol=0, atol=1e-9)


def test_output_predict_and_mean_function_match_jax(model_case):
    c = model_case
    p = simm2.constrain(c["raw"])
    model = _model(c)
    post = model.output_predict(p, _t(c["to"]), _t(c["X"]), _t(c["y"]), _t(c["var"]))
    np.testing.assert_allclose(post.mean.numpy(), c["ref"][6], rtol=0, atol=1e-9)
    np.testing.assert_allclose(post.cov.numpy(), c["ref"][7], rtol=0, atol=1e-9)
    # The test rows are force rows: mean_function is 0 on them, B/k once
    # output_predict has set their flag.
    np.testing.assert_allclose(model.mean_function(p, _t(c["to"])).numpy(), c["ref"][8],
                               rtol=0, atol=1e-15)


def test_gram_takes_the_chunked_build_from_its_threshold(model_case, monkeypatch):
    c = model_case
    p = simm2.constrain(c["raw"])
    full = _model(c).gram(p, _t(c["X"]))
    monkeypatch.setattr(simm2.SecondOrderSIMM, "CHUNKED_GRAM_MIN_N", 8)
    calls = []
    real = lfk2.cross_covariance2_chunked
    monkeypatch.setattr(lfk2, "cross_covariance2_chunked",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    chunked = _model(c).gram(p, _t(c["X"]))
    assert calls and float((chunked - full).abs().max()) <= 1e-13


def test_params_bijectors_and_physical_constants_match_jax():
    p = _p2(4, 9)
    jp = jsimm2.SIMM2Params(**{k: jnp.asarray(v) for k, v in p.items()})
    tp = convert.simm2_params_from_numpy(p, device="cpu")
    for name, ref in jsimm2.unconstrain(jp)._asdict().items():
        np.testing.assert_allclose(getattr(simm2.unconstrain(tp), name).numpy(), ref,
                                   rtol=1e-14, atol=1e-14)
    back = simm2.constrain(simm2.unconstrain(tp))
    for name in tp._fields:
        np.testing.assert_allclose(getattr(back, name).numpy(), p[name], rtol=1e-13)
    np.testing.assert_allclose(simm2.damping(tp).numpy(), np.asarray(jsimm2.damping(jp)))
    np.testing.assert_allclose(simm2.spring(tp).numpy(), np.asarray(jsimm2.spring(jp)))
    init, jinit = simm2.init_params(4), jsimm2.init_params(4)
    for name in init._fields:
        np.testing.assert_array_equal(getattr(init, name).numpy(), np.asarray(getattr(jinit, name)))
    assert simm2.init_params(4, dtype=F32).alpha.dtype == F32


# ---------------------------------------------------------------------------
# The second-order data generator.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [F64, F32], ids=["f64", "f32"])
def test_ode2_from_draws_with_jax_draws_matches_generate_ode2(dtype):
    """JAX's own draws (its key split: kinetics, force normals, noise,
    alpha, omega) into ``ode2_from_draws``: every array at 1e-12 of JAX's
    ``generate_ode2`` (float32: at the type's rounding)."""
    jdt = jnp.float64 if dtype == F64 else jnp.float32
    cfg = jsynth.SyntheticConfig(num_genes=4, num_timepoints=9, num_replicates=2, noise_std=0.1)
    key = jax.random.PRNGKey(5)
    ref = jsynth.generate_ode2(key, cfg, oversample=4, dtype=jdt)
    kp, kf, kn, ka, kw = jax.random.split(key, 5)
    base = jsynth._sample_kinetics(kp, cfg, jdt)
    alpha = jax.random.uniform(ka, (4,), jdt, 0.2, 0.8)
    omega = jax.random.uniform(kw, (4,), jdt, 0.6, 1.6)
    eps = jax.random.normal(kf, ((9 - 1) * 4 + 1,), jnp.float32)
    noise = jax.random.normal(kn, (2, 4, 9), jnp.float32)
    tcfg = tsynth.SyntheticConfig(num_genes=4, num_timepoints=9, num_replicates=2,
                                  noise_std=0.1)
    got = tsynth.ode2_from_draws(*(np.asarray(v) for v in (base["basal"], base["sensitivity"],
                                                         alpha, omega, eps, noise)),
                                 tcfg, oversample=4, dtype=dtype)
    tol = 1e-12 if dtype == F64 else 1e-6
    for name in ("gene_expressions", "gene_variances", "f_true", "timepoints"):
        r = np.asarray(getattr(ref, name))
        g = getattr(got, name)
        assert g.dtype == dtype and tuple(g.shape) == r.shape, name
        assert np.max(np.abs(g.numpy() - r)) <= tol * max(1.0, np.abs(r).max()), name
    for g, r in zip(got.params_ground_truth(), ref.params_ground_truth()):
        np.testing.assert_array_equal(g, np.asarray(r))
    assert len(got) == len(ref) == 8 and got.gene_names == ref.gene_names
    assert tuple(got.f_observed.shape) == tuple(ref.f_observed.shape)


def test_generate_ode2_draws_from_the_generator():
    """The same seed gives the same data, another seed other data; the
    ground truth carries alpha/omega in their ranges."""
    cfg = tsynth.SyntheticConfig(num_genes=3, num_timepoints=7)

    def make(seed):
        return tsynth.generate_ode2(torch.Generator().manual_seed(seed), cfg, oversample=2,
                                    device="cpu")

    a, b, c = make(0), make(0), make(1)
    assert torch.equal(a.gene_expressions, b.gene_expressions)
    assert not torch.equal(a.gene_expressions, c.gene_expressions)
    basal, sens, alpha, omega = a.params_ground_truth()
    assert np.all((alpha >= 0.2) & (alpha <= 0.8)) and np.all((omega >= 0.6) & (omega <= 1.6))
    assert a.gene_expressions.shape == (1, 3, 7) and a.f_true.shape == (7,)
    draws = tsynth.ode2_draws(torch.Generator().manual_seed(0), cfg, oversample=2)
    assert [tuple(d.shape) for d in draws] == [(3,), (3,), (3,), (3,), (13,), (1, 3, 7)]
