"""The port's order-2 state-space engine (``build_lfm2_ssm``, ``lfm2_mll_ss``
and ``lfm2_predict_ss`` in ``dis_project_tpu_torch/ops/statespace.py``) held
to the JAX package on the CPU, and to the port's own exact second-order MLL
on the JAX package's test problem.

Float64; the JAX references are compiled at XLA's lowest CPU optimisation
level. Smoothed moments are held at max(1e-9, JAX's own union-vs-bridge
distance on the same inputs), the floor the first-order smoother tests use
(``tests/test_torch_port_statespace.py``: two LAPACK builds' ``eigh`` move
the RTS pseudo-solve by ~1e-9-1e-8).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dis_project_tpu.models import simm2 as jsimm2
from dis_project_tpu.ops import statespace as jss
from dis_project_tpu_torch import convert
from dis_project_tpu_torch.models import simm2
from dis_project_tpu_torch.ops import statespace as ss
from dis_project_tpu_torch.ops.precision import pin_full_fp32
from dis_project_tpu_torch.training import generic

F32, F64 = torch.float32, torch.float64
FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


def _jit(fn, **kw):
    return jax.jit(fn, compiler_options=FAST_COMPILE, **kw)


def _t(a, dtype=F64):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def _close(got, ref, tol, what):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    err = float(np.max(np.abs(got - np.asarray(ref))))
    assert err <= tol, f"{what}: max abs error {err:.3e} > {tol:.3e}"


@pytest.fixture(autouse=True)
def _full_fp32():
    pin_full_fp32()


@functools.lru_cache(maxsize=None)
def _problem(G=3, T=9, seed=1):
    """The JAX package's order-2 test problem (tests/test_statespace.py,
    TestSecondOrderFamily._problem): init parameters with three genes'
    alpha, omega and S set, a 9-point grid on [0, 12], normal observations.
    Returns the JAX params, the port's, t, y and the gene-major rows."""
    p = {k: np.asarray(v) for k, v in jsimm2.init_params(G)._asdict().items()}
    p.update(alpha=np.array([0.4, 0.7, 1.0]), omega=np.array([0.8, 1.2, 0.5]),
             sensitivity=np.array([1.0, 0.7, 1.3]))
    t = np.linspace(0.0, 12.0, T)
    y = np.random.default_rng(seed).normal(size=(G * T,))
    X = np.stack([np.tile(t, G), np.repeat(np.arange(G), T).astype(float), np.ones(G * T)], 1)
    jp = jsimm2.SIMM2Params(**{k: jnp.asarray(v) for k, v in p.items()})
    return jp, convert.simm2_params_from_numpy(p, device="cpu"), t, y, X


# ---------------------------------------------------------------------------
# The builder.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("force_kernel, order", [("rbf", 8), ("rbf", 10), ("matern32", 10)])
def test_build_lfm2_ssm_matches_jax(force_kernel, order):
    """(F, P_inf, P0, h_force) at 1e-12, and the gradient of a weighted sum
    of F and P_inf in alpha, omega, S and l against jax.grad at 1e-10."""
    jp, tp, _, _, _ = _problem()
    m = (order if force_kernel == "rbf" else 2) + 6
    w = np.random.default_rng(order).normal(size=(2, m, m))

    def jscalar(a, om, s, ell):
        f, p_inf, _, _ = jss.build_lfm2_ssm(a, om, s, ell, order, force_kernel)
        return jnp.sum(w[0] * f) + jnp.sum(w[1] * p_inf)

    args = (jp.alpha, jp.omega, jp.sensitivity, jp.lengthscale)
    ref = _jit(lambda *x: jss.build_lfm2_ssm(*x, order, force_kernel))(*args)
    ref_g = _jit(jax.grad(jscalar, argnums=(0, 1, 2, 3)))(*args)
    leaves = [v.clone().requires_grad_(True)
              for v in (tp.alpha, tp.omega, tp.sensitivity, tp.lengthscale)]
    got = ss.build_lfm2_ssm(*leaves, order=order, force_kernel=force_kernel)
    for name, g_, r_ in zip(("F", "P_inf", "P0", "h_force"), got, ref):
        assert tuple(g_.shape) == r_.shape, name
        _close(g_, r_, 1e-12 * max(1.0, float(np.abs(np.asarray(r_)).max())), name)
    tg = torch.autograd.grad(torch.sum(_t(w[0]) * got[0]) + torch.sum(_t(w[1]) * got[1]), leaves)
    for name, g_, r_ in zip(("alpha", "omega", "sens", "lengthscale"), tg, ref_g):
        _close(g_, r_, 1e-10 * max(1.0, float(np.abs(np.asarray(r_)).max())), name)


def test_stationary_covariance_is_lyapunov_consistent():
    """F P_inf + P_inf F^T vanishes outside the force block (the gene
    blocks solve the Lyapunov equation) and is negative semi-definite on
    it; P_inf is symmetric positive semi-definite."""
    _, tp, _, _, _ = _problem()
    f, p_inf, _, _ = ss.build_lfm2_ssm(tp.alpha, tp.omega, tp.sensitivity, tp.lengthscale,
                                       order=8)
    resid = (f @ p_inf + p_inf @ f.T).numpy()
    assert np.abs(resid[8:, :]).max() < 1e-12 and np.abs(resid[:, 8:]).max() < 1e-12
    assert np.linalg.eigvalsh(-resid[:8, :8]).min() > -1e-10
    assert torch.equal(p_inf, p_inf.T)
    assert float(torch.linalg.eigvalsh(p_inf).min()) > -1e-10


# ---------------------------------------------------------------------------
# The MLL.
# ---------------------------------------------------------------------------


CASES = {
    "sequential": dict(parallel=False),
    "associative": dict(parallel=True),
    "blocked": dict(parallel="blocked"),
    "stationary_after": dict(parallel=False, stationary_after=4),
    "obs_mask": dict(parallel=False, mask=True),
    "matern32 replicates": dict(parallel=False, force_kernel="matern32", replicates=2),
}


@pytest.mark.parametrize("case", list(CASES))
def test_lfm2_mll_ss_matches_jax(case):
    """The MLL at 1e-9 x max(1, |MLL|) and its raw gradients at
    1e-8 x max(1, max|g|), under each schedule, the frozen-gain tail, a
    NaN-masked obs_mask and an exact Matern prior on two replicates."""
    kw = dict(CASES[case])
    jp, tp, t, y, _ = _problem()
    reps = kw.pop("replicates", 1)
    if reps > 1:
        y = np.concatenate([y, y + np.random.default_rng(2).normal(size=y.shape)])
    if kw.pop("mask", False):
        mask = (np.random.default_rng(3).uniform(size=y.shape) > 0.25).astype(float)
        y = np.where(mask > 0, y, np.nan)
        kw["obs_mask"] = mask
    jraw = jsimm2.unconstrain(jp)

    def jloss(r):
        return jss.lfm2_mll_ss(jsimm2.constrain(r), jnp.asarray(t), jnp.asarray(y), jitter=1e-4,
                               replicates=reps, **kw)

    ref, ref_g = _jit(jax.value_and_grad(jloss))(jraw)
    raw = convert.simm2_params_from_numpy(jax.tree.map(np.asarray, jraw)._asdict(), device="cpu")
    tkw = {k: (_t(v) if k == "obs_mask" else v) for k, v in kw.items()}
    loss, grads = generic.value_and_grad(
        lambda r: ss.lfm2_mll_ss(simm2.constrain(r), _t(t), _t(y), jitter=1e-4,
                                 replicates=reps, **tkw), raw)
    assert abs(float(loss) - float(ref)) <= 1e-9 * max(1.0, abs(float(ref)))
    scale = max(1.0, max(float(np.abs(np.asarray(v)).max()) for v in ref_g))
    for name in raw._fields:
        _close(getattr(grads, name), getattr(ref_g, name), 1e-8 * scale, name)


def test_lfm2_mll_ss_float32_stays_near_float64():
    _, tp, t, y, _ = _problem()
    l64 = float(ss.lfm2_mll_ss(tp, _t(t), _t(y), jitter=1e-4, parallel=False))
    p32 = type(tp)(*(v.float() for v in tp))
    l32 = ss.lfm2_mll_ss(p32, _t(t, F32), _t(y, F32), jitter=1e-4, parallel=False)
    assert l32.dtype == F32
    assert abs(float(l32) - l64) <= 1e-4 * abs(l64)


def test_order_10_mll_matches_the_exact_second_order_mll():
    """On the JAX package's own problem, the port's ss MLL against the
    port's ``SecondOrderSIMM.mll`` (the complex-erf closed forms) at the JAX
    package's tolerances: orders 8 / 10 / 12 within 1e-3 / 2e-4 / 3e-5, and
    the raw gradients of the order-10 MLL within 1e-2 relative."""
    _, tp, t, y, X = _problem()
    model = simm2.SecondOrderSIMM(num_genes=3, jitter=1e-4)
    exact = float(model.mll(tp, _t(X), _t(y)))
    for order, tol in ((8, 1e-3), (10, 2e-4), (12, 3e-5)):
        v = float(ss.lfm2_mll_ss(tp, _t(t), _t(y), jitter=1e-4, order=order, parallel=False))
        assert abs(v - exact) < tol, (order, v, exact)
    raw = simm2.unconstrain(tp)
    _, g_ss = generic.value_and_grad(
        lambda r: ss.lfm2_mll_ss(simm2.constrain(r), _t(t), _t(y), jitter=1e-4, parallel=False),
        raw)
    _, g_ex = generic.value_and_grad(lambda r: model.mll(simm2.constrain(r), _t(X), _t(y)), raw)
    for name in raw._fields:
        a, b = getattr(g_ss, name).numpy(), getattr(g_ex, name).numpy()
        assert np.abs(a - b).max() / (np.abs(b).max() + 1e-12) < 1e-2, name


# ---------------------------------------------------------------------------
# Smoothing.
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def predict_case():
    """JAX's union and bridge predictions with per-entry noise variances in
    [1e-3, 1e-2] (the first-order smoother tests' noise), and the floor."""
    jp, tp, t, y, _ = _problem()
    tt = np.linspace(0.0, 13.0, 40)
    nv = np.random.default_rng(4).uniform(1e-3, 1e-2, size=(9, 3))

    def both(p):
        return {interp: jss.lfm2_predict_ss(p, jnp.asarray(t), jnp.asarray(y), jnp.asarray(tt),
                                            noise_var=jnp.asarray(nv), order=10, interp=interp)
                for interp in ("union", "bridge")}

    ref = {k: [np.asarray(a) for a in v] for k, v in _jit(both)(jp).items()}
    floor = [max(1e-9, float(np.abs(u - b).max())) for u, b in zip(ref["union"], ref["bridge"])]
    return tp, t, y, tt, nv, ref, floor


@pytest.mark.parametrize("interp", ["union", "bridge"])
def test_lfm2_predict_ss_matches_jax(predict_case, interp):
    tp, t, y, tt, nv, ref, floor = predict_case
    got = ss.lfm2_predict_ss(tp, _t(t), _t(y), _t(tt), noise_var=_t(nv), order=10,
                             interp=interp)
    assert tuple(got[2].shape) == (40, 3) and tuple(got[3].shape) == (40, 3)
    for name, g_, r_, tol in zip(("f_mean", "f_var", "x_mean", "x_var"), got, ref[interp], floor):
        _close(g_, r_, tol, f"{interp} {name}")


def test_lfm2_predict_ss_matches_the_dense_latent_posterior():
    """The smoothed force against ``SecondOrderSIMM.latent_predict`` at
    order 14 (the JAX package's test: near-noiseless conditioning amplifies
    the SDE error), mean and variance within 3e-3; positions finite."""
    _, tp, t, y, X = _problem()
    tt = np.linspace(0.0, 13.0, 40)
    rows = np.stack([tt, -np.ones_like(tt), np.zeros_like(tt)], axis=-1)
    model = simm2.SecondOrderSIMM(num_genes=3, jitter=1e-4)
    post = model.latent_predict(tp, _t(rows), _t(X), _t(y), _t(np.full(27, 1e-3)))
    f_mean, f_var, x_mean, x_var = ss.lfm2_predict_ss(tp, _t(t), _t(y), _t(tt),
                                                      noise_var=1e-3 + 1e-4, order=14)
    assert float((post.mean - f_mean).abs().max()) < 3e-3
    assert float((torch.diagonal(post.cov) - f_var).abs().max()) < 3e-3
    assert float(f_var.min()) > 0.0
    assert bool(torch.isfinite(x_mean).all()) and bool((x_var >= 0).all())
