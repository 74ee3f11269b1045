"""The port's state-space engine (``dis_project_tpu_torch/ops/statespace.py``
and ``run_dense --mll-engine ss``) held to the JAX package's on the CPU.

The same numpy inputs (seeded) go through both packages; float64 unless
stated. The JAX references compile at XLA's lowest CPU optimisation level.

Smoothed moments are held to JAX at 1e-9 or at the JAX package's own
noise floor on the same inputs, whichever is larger: the RTS and bridge
gains invert eigenvalues of the predicted covariance down to 1e-12 of the
largest (``_pseudo_gain``), so two LAPACK builds' ``eigh`` (PyTorch's
MKL, JAX's OpenBLAS-based LAPACK) move the smoothed moments by ~1e-9–1e-8; the floor is
the distance between JAX's two routes to the same posterior (union grid
and bridge), which the JAX package's own tests allow at 1e-5 relative.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dis_project_tpu.data import synthetic as jsynth
from dis_project_tpu.data.dataset import train_arrays as jtrain_arrays
from dis_project_tpu.models import simm as jsimm
from dis_project_tpu.ops import statespace as jss
from dis_project_tpu_torch import convert
from dis_project_tpu_torch import main as tmain
from dis_project_tpu_torch.data import synthetic as tsynth
from dis_project_tpu_torch.models import simm
from dis_project_tpu_torch.ops import statespace as ss
from dis_project_tpu_torch.ops.precision import pin_full_fp32
from dis_project_tpu_torch.training import generic

F32, F64 = torch.float32, torch.float64
FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


def _jit(fn, **kw):
    return jax.jit(fn, compiler_options=FAST_COMPILE, **kw)


def _np(tree):
    return {k: np.asarray(v) for k, v in tree._asdict().items()}


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
def _problem(G, T, seed, t0=0.5, t_end=12.0):
    """Perturbed kinetics (JAX SIMMParams and the port's), a grid and
    observations around the prior mean, from numpy."""
    rng = np.random.default_rng(seed)
    p = {
        "basal": 0.05 + 0.02 * rng.uniform(size=G),
        "sensitivity": rng.uniform(0.8, 1.2, G),
        "decay": 0.4 * rng.uniform(0.7, 1.5, G),
        "lengthscale": np.asarray(1.7),
        "obs_stddev": np.asarray(0.3),
    }
    t = np.linspace(t0, t_end, T)
    y = np.repeat(p["basal"] / p["decay"], T) + rng.normal(size=G * T)
    jp = jsimm.SIMMParams(**{k: jnp.asarray(v) for k, v in p.items()})
    return jp, convert.params_from_numpy(p, device="cpu"), t, y


# ---------------------------------------------------------------------------
# Host constants, builders, discretization.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("order", [6, 8, 10, 12])
def test_canonical_system_matches_jax(order):
    for got, ref in zip(ss.canonical_system(order), jss.canonical_system(order)):
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12)


@pytest.mark.parametrize("kind", ["matern12", "matern32", "matern52"])
def test_matern_canonical_system_matches_jax(kind):
    for got, ref in zip(ss.matern_canonical_system(kind), jss.matern_canonical_system(kind)):
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12)


def test_unknown_force_kernel_raises_jax_message():
    with pytest.raises(ValueError, match="unknown force kernel 'matern72'"):
        ss.matern_canonical_system("matern72")


@pytest.mark.parametrize("force_kernel, order", [("rbf", 12), ("matern52", 10)])
def test_build_lfm_ssm_and_discretize_match_jax(force_kernel, order):
    """(F, P_inf, P0, h_force) and the transitions of a scalar step and of
    a step vector with repeats (bucketed), at 1e-12; the gradient of the
    builder and a scalar step's transition in decay, sensitivity and
    lengthscale against jax.grad."""
    rng = np.random.default_rng(order)
    d, s, l = rng.uniform(0.3, 1.2, 4), rng.uniform(0.5, 1.5, 4), 1.9
    dts = np.array([0.5, 0.06, 0.5, 3.0, 0.06, 0.0])
    p = order if force_kernel == "rbf" else {"matern32": 2, "matern52": 3}[force_kernel]
    w = rng.normal(size=(4 + p, 4 + p))

    def pieces(build, disc, d, s, l):
        f, p_inf, p0, h_force = build(d, s, l, order, force_kernel)
        a1, q1 = disc(f, p_inf, 0.37)
        a, q = disc(f, p_inf, dts)
        return (f, p_inf, p0, h_force, a1, q1, a, q)

    def jscalar(d, s, l):
        f, p_inf, _, _ = jss.build_lfm_ssm(d, s, l, order, force_kernel)
        a1, q1 = jss.discretize(f, p_inf, 0.37)
        return jnp.sum(w * (p_inf + a1 + q1 + f))

    ref, ref_g = _jit(lambda *x: (pieces(jss.build_lfm_ssm, jss.discretize, *x),
                                  jax.grad(jscalar, argnums=(0, 1, 2))(*x)))(
        jnp.asarray(d), jnp.asarray(s), jnp.asarray(l))
    leaves = [_t(d).requires_grad_(), _t(s).requires_grad_(), _t(l).requires_grad_()]
    got = pieces(ss.build_lfm_ssm, ss.discretize, *leaves)
    for name, g_, r_ in zip(("F", "P_inf", "P0", "h_force", "A", "Q", "A(dts)", "Q(dts)"),
                            got, ref):
        _close(g_, r_, 1e-12, name)
    f, p_inf, _, _, a1, q1, a, q = got
    tg = torch.autograd.grad(torch.sum(_t(w) * (p_inf + a1 + q1 + f)), leaves)
    for name, g_, r_ in zip(("decay", "sens", "lengthscale"), tg, ref_g):
        np.testing.assert_allclose(g_.numpy(), np.asarray(r_), rtol=1e-10, atol=1e-12,
                                   err_msg=name)


def test_discretize_max_unique_is_a_checked_bound():
    f, p_inf, _, _ = ss.build_lfm_ssm(_t([0.4, 0.8]), _t([1.0, 0.9]), _t(2.0), 6)
    dts = _t([0.0, 0.5, 0.5, 0.25, 0.5])
    a, q = ss.discretize(f, p_inf, dts, max_unique=3)
    a_free, _ = ss.discretize(f, p_inf, dts)
    assert a.shape == (5, 8, 8) and torch.equal(a, a_free) and torch.equal(a[1], a[4])
    with pytest.raises(ValueError, match="3 distinct values, more than max_unique=2"):
        ss.discretize(f, p_inf, dts, max_unique=2)


# ---------------------------------------------------------------------------
# The filter and the MLL.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["selection", "dense_h_2_replicates", "obs_mask_nan",
                                  "per_step_aq_masked"])
def test_kalman_filter_matches_jax(case):
    """Filtered means and covariances at 1e-10, the log-likelihood at
    1e-10 relative, on the same (A, Q): the selection update, a
    2-replicate H, per-entry missingness with NaN observations, and
    per-step transitions with a step mask."""
    rng = np.random.default_rng(7)
    G, T, order = 3, 20, 8
    reps = 2 if case == "dense_h_2_replicates" else 1
    f, p_inf, p0, _ = ss.build_lfm_ssm(_t(rng.uniform(0.3, 1.0, G)),
                                       _t(rng.uniform(0.5, 1.5, G)), _t(1.6), order)
    steps = _t(rng.uniform(0.0, 0.8, T)) if case == "per_step_aq_masked" else 0.6
    a, q = (x.numpy() for x in ss.discretize(f, p_inf, steps))
    h = ss.gene_observation_matrix(order, G, reps).numpy()
    n_o = G * reps
    ys = rng.normal(size=(T, n_o))
    rv = rng.uniform(0.01, 0.1, size=(T, n_o))
    extra = {}
    if case == "selection":
        extra = {"obs_slice": order}
    elif case == "obs_mask_nan":
        om = (rng.uniform(size=(T, n_o)) > 0.3).astype(np.float64)
        ys = np.where(om > 0, ys, np.nan)
        extra = {"obs_mask": om}
    elif case == "per_step_aq_masked":
        extra = {"mask": (rng.uniform(size=T) > 0.4).astype(np.float64)}
    args = (a, q, h, rv, ys, p0.numpy())
    rm, rp, rl = _jit(lambda *x: jss.kalman_filter(*x, **{
        k: (v if k == "obs_slice" else jnp.asarray(v)) for k, v in extra.items()}))(*args)
    gm, gp, gl = ss.kalman_filter(*(_t(x) for x in args), **{
        k: (v if k in ("obs_slice", "mask") else _t(v)) for k, v in extra.items()})
    _close(gm, rm, 1e-10, "means")
    _close(gp, rp, 1e-10, "covariances")
    assert float(gl) == pytest.approx(float(rl), rel=1e-10)


def test_kalman_filter_nan_on_an_indefinite_innovation():
    """A non-PD innovation covariance gives a NaN likelihood, as JAX's
    Cholesky does, and never raises (cholesky_ex, no host check)."""
    f, p_inf, p0, _ = ss.build_lfm_ssm(_t([0.4, 0.8]), _t([1.0, 0.9]), _t(2.0), 6)
    a, q = ss.discretize(f, p_inf, 0.5)
    h = ss.gene_observation_matrix(6, 2)
    _, _, ll = ss.kalman_filter(a, q, h, _t([-5.0, 0.1]), torch.zeros(4, 2, dtype=F64), p0)
    assert torch.isnan(ll)


MLL_VARIANTS = {"uniform": {}, "stationary_after": {"stationary_after": 9},
                "uniform_false": {"uniform": False}}
MLL_CASES = [(fk, v) for fk in ("rbf", "matern12", "matern32", "matern52")
             for v in MLL_VARIANTS if v != "uniform_false" or fk == "rbf"]
# The raw-parameter gradient is checked on these (kernel, variant) pairs.
GRAD_CASES = {"rbf": "uniform", "matern32": "stationary_after"}


@functools.lru_cache(maxsize=None)
def _jax_mll_refs(force_kernel):
    """JAX's MLL of one problem for each variant of ``force_kernel``, and
    the raw gradient of the pair in GRAD_CASES (one compile)."""
    p, _, t, y = _problem(4, 24, seed=11)
    variants = [v for fk, v in MLL_CASES if fk == force_kernel]

    def mll(p, variant):
        return jss.lfm_mll_ss(p, jnp.asarray(t), jnp.asarray(y), jitter=1e-4,
                              force_kernel=force_kernel, **MLL_VARIANTS[variant])

    def refs(raw):
        out = {v: mll(jsimm.constrain(raw), v) for v in variants}
        if force_kernel in GRAD_CASES:
            out["grad"] = jax.grad(lambda r: mll(jsimm.constrain(r),
                                                 GRAD_CASES[force_kernel]))(raw)
        return out

    return _jit(refs)(jsimm.unconstrain(p))


@pytest.mark.parametrize("force_kernel, variant", MLL_CASES,
                         ids=[f"{fk}-{v}" for fk, v in MLL_CASES])
def test_lfm_mll_ss_matches_jax(force_kernel, variant):
    _, tp, t, y = _problem(4, 24, seed=11)
    ref = float(_jax_mll_refs(force_kernel)[variant])
    got = ss.lfm_mll_ss(tp, _t(t), _t(y), jitter=1e-4, force_kernel=force_kernel,
                        **MLL_VARIANTS[variant])
    assert abs(float(got) - ref) <= 1e-9 * max(1.0, abs(ref))


@pytest.mark.parametrize("force_kernel", list(GRAD_CASES))
def test_lfm_mll_ss_raw_gradients_match_jax(force_kernel):
    p, _, t, y = _problem(4, 24, seed=11)
    kw = MLL_VARIANTS[GRAD_CASES[force_kernel]]
    ref_g = _jax_mll_refs(force_kernel)["grad"]
    got_v, got_g = generic.value_and_grad(lambda r: ss.lfm_mll_ss(
        simm.constrain(r), _t(t), _t(y), jitter=1e-4, force_kernel=force_kernel, **kw),
        convert.params_from_numpy(_np(jsimm.unconstrain(p)), device="cpu"))
    ref_v = float(_jax_mll_refs(force_kernel)[GRAD_CASES[force_kernel]])
    assert float(got_v) == pytest.approx(ref_v, rel=1e-9)
    for name in got_g._fields:
        ref_n = np.asarray(getattr(ref_g, name))
        np.testing.assert_allclose(getattr(got_g, name).numpy(), ref_n, rtol=1e-7,
                                   atol=1e-9 * np.abs(ref_n).max(), err_msg=name)


@pytest.mark.parametrize("case", ["2_replicates", "obs_mask_nan", "order_6_grid_from_0"])
def test_lfm_mll_ss_variants_match_jax(case):
    p, tp, t, y = _problem(3, 16, seed=5, t0=0.0 if case == "order_6_grid_from_0" else 0.5)
    kw = {"order": 6} if case == "order_6_grid_from_0" else {}
    om = None
    if case == "2_replicates":
        y = np.concatenate([y, y + np.random.default_rng(2).normal(size=y.shape)])
        kw["replicates"] = 2
    elif case == "obs_mask_nan":
        om = (np.random.default_rng(3).uniform(size=y.shape) > 0.25).astype(np.float64)
        y = np.where(om > 0, y, np.nan)
    ref = float(_jit(lambda p: jss.lfm_mll_ss(
        p, jnp.asarray(t), jnp.asarray(y), jitter=1e-4,
        obs_mask=None if om is None else jnp.asarray(om), **kw))(p))
    got = ss.lfm_mll_ss(tp, _t(t), _t(y), jitter=1e-4,
                        obs_mask=None if om is None else _t(om), **kw)
    assert np.isfinite(float(got))
    assert abs(float(got) - ref) <= 1e-9 * max(1.0, abs(ref))


def test_lfm_mll_ss_float32_matches_jax():
    """float32: the port against JAX's float32 and against JAX's float64
    value, rel 1e-4."""
    p, _, t, y = _problem(5, 40, seed=17)
    p32 = jax.tree.map(lambda a: a.astype(jnp.float32), p)
    ref32, ref64 = _jit(lambda p32, p: (
        jss.lfm_mll_ss(p32, jnp.asarray(t, jnp.float32), jnp.asarray(y, jnp.float32),
                       jitter=1e-4),
        jss.lfm_mll_ss(p, jnp.asarray(t), jnp.asarray(y), jitter=1e-4)))(p32, p)
    assert ref32.dtype == jnp.float32
    got = ss.lfm_mll_ss(convert.params_from_numpy(_np(p32), device="cpu", dtype=F32),
                        _t(t, F32), _t(y, F32), jitter=1e-4)
    assert got.dtype == F32
    assert float(got) == pytest.approx(float(ref32), rel=1e-4)
    assert float(got) == pytest.approx(float(ref64), rel=1e-4)


def test_ss_entry_points_refuse_tf32():
    _, tp, t, y = _problem(2, 6, seed=1)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with pytest.raises(RuntimeError, match="ops.statespace needs full-FP32"):
            ss.lfm_mll_ss(tp, _t(t), _t(y), jitter=1e-4)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.parametrize("parallel", [True, "blocked", 8, 1])
def test_schedules_run_or_refuse(parallel):
    """The associative-scan, blocked and block-8 schedules give the
    sequential MLL (1e-9); an int block length below 2 raises; ``shard=``
    (the temporally-sharded filter) is refused as not yet ported."""
    _, tp, t, y = _problem(2, 6, seed=1)
    if parallel == 1 and not isinstance(parallel, bool):
        with pytest.raises(ValueError, match=">= 2"):
            ss.lfm_mll_ss(tp, _t(t), _t(y), jitter=1e-4, parallel=parallel)
    else:
        seq = float(ss.lfm_mll_ss(tp, _t(t), _t(y), jitter=1e-4, parallel=False))
        got = float(ss.lfm_mll_ss(tp, _t(t), _t(y), jitter=1e-4, parallel=parallel))
        assert abs(got - seq) <= 1e-9 * max(1.0, abs(seq))
    with pytest.raises(NotImplementedError, match="not yet ported"):
        ss.lfm_mll_ss(tp, _t(t), _t(y), jitter=1e-4, shard=("mesh", "t"))


def test_stationary_after_guards_match_jax():
    _, tp, t, y = _problem(2, 6, seed=1)
    with pytest.raises(ValueError, match="requires uniform=True"):
        ss.lfm_mll_ss(tp, _t(t), _t(y), jitter=1e-4, uniform=False, stationary_after=3)
    with pytest.raises(ValueError, match="no shard and no obs_mask"):
        ss.lfm_mll_ss(tp, _t(t), _t(y), jitter=1e-4, stationary_after=3,
                      obs_mask=torch.ones(12, dtype=F64))
    # K = T - 1 leaves no tail: the exact filter.
    exact = ss.lfm_mll_ss(tp, _t(t), _t(y), jitter=1e-4)
    assert float(ss.lfm_mll_ss(tp, _t(t), _t(y), jitter=1e-4, stationary_after=5)) == float(exact)


# ---------------------------------------------------------------------------
# Smoothing and prediction.
# ---------------------------------------------------------------------------


PREDICT_GRID = np.sort(np.concatenate([np.linspace(0.0, 13.0, 31), [0.25, 6.0, 12.0, 12.5]]))


def _jax_predict(p, t, y, tt, noise_var, interps=("union", "bridge")):
    """JAX's lfm_predict_ss for each of ``interps`` (one compile)."""
    out = _jit(lambda p: {interp: jss.lfm_predict_ss(
        p, jnp.asarray(t), jnp.asarray(y), jnp.asarray(tt), noise_var=jnp.asarray(noise_var),
        interp=interp) for interp in interps})(p)
    return {k: [np.asarray(a) for a in v] for k, v in out.items()}


def _projected(m_s, p_s, h_force, p):
    """(f mean, f var, x means, x vars) of smoothed states."""
    m_s, p_s, h_force = (np.asarray(a) for a in (m_s, p_s, h_force))
    return (m_s @ h_force, np.einsum("i,tij,j->t", h_force, p_s, h_force), m_s[:, p:],
            np.diagonal(p_s, axis1=1, axis2=2)[:, p:])


@pytest.fixture(scope="module")
def predict_case():
    """JAX's union and bridge predictions at one problem; their distance,
    per output, is the JAX package's own noise floor on these inputs."""
    p, tp, t, y = _problem(4, 24, seed=21)
    nv = np.random.default_rng(4).uniform(1e-3, 1e-2, size=(24, 4))
    ref = _jax_predict(p, t, y, PREDICT_GRID, nv)
    floor = [max(1e-9, float(np.abs(u - b).max())) for u, b in zip(ref["union"], ref["bridge"])]
    return p, tp, t, y, nv, ref, floor


@pytest.mark.parametrize("interp", ["union", "bridge"])
def test_lfm_predict_ss_matches_jax(predict_case, interp):
    p, tp, t, y, nv, ref, floor = predict_case
    got = ss.lfm_predict_ss(tp, _t(t), _t(y), _t(PREDICT_GRID), noise_var=_t(nv), interp=interp)
    for name, g_, r_, tol in zip(("f_mean", "f_var", "x_mean", "x_var"), got, ref[interp], floor):
        assert not g_.requires_grad
        _close(g_, r_, tol, f"{interp} {name}")
    assert float(got[1].min()) > 0.0


def test_rts_smoother_matches_jax(predict_case):
    """The smoother on identical filtered inputs on the train grid: the
    smoothed force and gene moments within the floor."""
    p, tp, t, y, nv, _, floor = predict_case
    f, p_inf, p0, h_force = ss.build_lfm_ssm(tp.decay, tp.sensitivity, tp.lengthscale)
    a, q = ss.discretize(f, p_inf, torch.diff(_t(t), prepend=torch.zeros(1, dtype=F64)))
    ys = _t(y).reshape(4, 24).T - (tp.basal / tp.decay)[None, :]
    ms, ps, _ = ss.kalman_filter(a, q, ss.gene_observation_matrix(10, 4), _t(nv), ys, p0)
    args = [x.numpy() for x in (a, q, ms, ps)]
    ref = _jit(jss.rts_smoother)(*args)
    got = ss.rts_smoother(*(_t(x) for x in args))
    for name, g_, r_, tol in zip(("f_mean", "f_var", "x_mean", "x_var"),
                                 _projected(*got, h_force, 10), _projected(*ref, h_force, 10),
                                 floor):
        _close(g_, r_, tol, f"smoothed {name}")


def test_chol_gain_knob_matches_pseudo_on_benign_problem():
    """``rts_smoother(chol_gain_from=k)``, the research knob, pinned as the
    JAX package pins it (tests/test_statespace.py:413): on an order-6
    problem its shifted-Cholesky tail agrees with the pseudo-solve within
    1e-7, for a split at the start, inside, at the end and past it."""
    rng = np.random.default_rng(9)
    f, p_inf, p0, _ = ss.build_lfm_ssm(torch.full((3,), 0.4, dtype=F64),
                                       torch.ones(3, dtype=F64), _t(2.5), order=6)
    T = 19
    t = _t(np.linspace(0.5, 12.0, T))
    a, q = ss.discretize(f, p_inf, torch.diff(t, prepend=torch.zeros(1, dtype=F64)))
    ms, ps, _ = ss.kalman_filter(a, q, ss.gene_observation_matrix(6, 3), torch.full((3,), 0.2),
                                 _t(rng.normal(size=(T, 3))), p0)
    sm0, sp0 = ss.rts_smoother(a, q, ms, ps)
    for k in (0, 4, T - 1, T + 7):
        sm1, sp1 = ss.rts_smoother(a, q, ms, ps, chol_gain_from=k)
        _close(sm1, sm0, 1e-7, f"means, split {k}")
        _close(sp1, sp0, 1e-7, f"covariances, split {k}")


def test_unique_dts_is_a_checked_bound_per_mode():
    """'union' counts the union grid's distinct steps, 'bridge' the train
    grid's; both count the step from 0. An understated bound raises."""
    _, tp, t, y = _problem(2, 8, seed=3, t0=0.5, t_end=4.0)
    tt = np.array([1.25, 2.0])
    union_n = np.unique(np.diff(np.sort(np.concatenate([t, tt])), prepend=0.0)).size
    train_n = np.unique(np.diff(t, prepend=0.0)).size
    assert train_n < union_n
    for interp, n in (("union", union_n), ("bridge", train_n)):
        ok = ss.lfm_predict_ss(tp, _t(t), _t(y), _t(tt), noise_var=0.01, interp=interp,
                               unique_dts=n)
        free = ss.lfm_predict_ss(tp, _t(t), _t(y), _t(tt), noise_var=0.01, interp=interp)
        assert all(torch.equal(a, b) for a, b in zip(ok, free))
        with pytest.raises(ValueError, match="more than max_unique"):
            ss.lfm_predict_ss(tp, _t(t), _t(y), _t(tt), noise_var=0.01, interp=interp,
                              unique_dts=n - 1)


CONTRACT_T = np.array([9.0, 1.0, 13.0, 4.5, 0.2, -1.5, 0.0])  # unsorted, one negative


@pytest.fixture(scope="module")
def contract_case():
    """JAX's union on the non-negative times (unsorted) and bridge on all
    of them, and the floor: JAX's union against its bridge there."""
    p, tp, t, y = _problem(3, 12, seed=8)
    tt = CONTRACT_T[CONTRACT_T >= 0]
    out = _jit(lambda p: (
        jss.lfm_predict_ss(p, jnp.asarray(t), jnp.asarray(y), jnp.asarray(tt), noise_var=0.01),
        jss.lfm_predict_ss(p, jnp.asarray(t), jnp.asarray(y), jnp.asarray(CONTRACT_T),
                           noise_var=0.01, interp="bridge")))(p)
    union, bridge = ([np.asarray(a) for a in r] for r in out)
    order = np.argsort(tt, kind="stable")
    floor = [max(1e-9, float(np.abs(u - b[CONTRACT_T >= 0][order]).max()))
             for u, b in zip(union, bridge)]
    return tp, t, y, union, bridge, floor


def test_order_of_returned_points_is_jaxs(contract_case):
    """Unsorted t_test: 'union' returns time-sorted order, 'bridge' t_test's
    own order, each as JAX does."""
    tp, t, y, union, bridge, floor = contract_case
    tt = CONTRACT_T[CONTRACT_T >= 0]
    got_u = ss.lfm_predict_ss(tp, _t(t), _t(y), _t(tt), noise_var=0.01)
    got_b = ss.lfm_predict_ss(tp, _t(t), _t(y), _t(CONTRACT_T), noise_var=0.01, interp="bridge")
    for name, gu, gb, ru, rb, tol in zip(("f_mean", "f_var", "x_mean", "x_var"), got_u, got_b,
                                         union, bridge, floor):
        _close(gu, ru, tol, f"union {name}")
        _close(gb, rb, tol, f"bridge {name}")
    # union's first point is the earliest time; bridge's is t_test[0] = 9.0
    order = np.argsort(tt, kind="stable")
    np.testing.assert_allclose(got_u[0].numpy(), got_b[0].numpy()[CONTRACT_T >= 0][order],
                               atol=floor[0])


def test_negative_t_test_union_raises_bridge_clamps(contract_case):
    tp, t, y, *_ = contract_case
    with pytest.raises(ValueError, match="t_test >= 0"):
        ss.lfm_predict_ss(tp, _t(t), _t(y), _t(CONTRACT_T), noise_var=0.01)
    got = ss.lfm_predict_ss(tp, _t(t), _t(y), _t(CONTRACT_T), noise_var=0.01, interp="bridge")
    for g_ in got:  # -1.5 (index 5) clamped to the t=0 node (index 6)
        assert torch.equal(g_[5], g_[6])


# ---------------------------------------------------------------------------
# The route.
# ---------------------------------------------------------------------------


def _jax_ss_route(data, G, steps, force_kernel):
    """The JAX package's ss training loop (dis_project_tpu/main.py:1364-1428)."""
    X, y, _ = jtrain_arrays(data)
    timepoints = jnp.asarray(data.timepoints, X.dtype)
    optimizer = optax.adam(0.01)

    def fit(raw):
        def step(carry, _):
            raw, opt_state = carry
            loss, grads = jax.value_and_grad(lambda r: -jss.lfm_mll_ss(
                jsimm.constrain(r), timepoints, y, jitter=1e-4, force_kernel=force_kernel))(raw)
            updates, opt_state = optimizer.update(grads, opt_state)
            return (optax.apply_updates(raw, updates), opt_state), loss

        (raw, _), hist = jax.lax.scan(step, (raw, optimizer.init(raw)), None, length=steps)
        return raw, hist

    return _jit(fit)(jsimm.unconstrain(jsimm.init_params(G)))


@pytest.mark.parametrize("force_kernel", ["rbf", "matern32"])
def test_dense_ss_route_matches_jax(force_kernel, monkeypatch, capsys):
    """``run_dense(--mll-engine ss)`` at 4 genes x 32 times, 6 Adam steps in
    float64 on JAX's sample_prior arrays: JAX's losses to rel 1e-9, the
    engine line, and the smoothed latent force on the 200-point grid."""
    G, T, steps = 4, 32, 6
    scfg = jsynth.SyntheticConfig(num_genes=G, num_timepoints=T, num_replicates=1, noise_std=0.1)
    jdata = jsynth.sample_prior(jax.random.PRNGKey(0), scfg)
    _, ref_hist = _jax_ss_route(jdata, G, steps, force_kernel)

    def jax_data(genes, timepoints, seed, dtype, device):
        return tsynth.SyntheticLFMData(
            _t(jdata.timepoints, dtype), _t(jdata.gene_expressions, dtype),
            _t(jdata.gene_variances, dtype),
            {k: _t(v) for k, v in jdata.params_true.items()}, _t(jdata.f_true, dtype))

    monkeypatch.setattr(tmain, "synthetic_dense_data", jax_data)
    out = tmain.run_dense(tmain.cfg.RunConfig(
        preset="dense10k", synth_genes=G, synth_timepoints=T, num_iters=steps, device="cpu",
        mll_engine="ss", force_kernel=force_kernel))
    np.testing.assert_allclose(out.result.history.numpy(), np.asarray(ref_hist), rtol=1e-9)
    text = capsys.readouterr().out
    prior = "order-10 SDE" if force_kernel == "rbf" else "EXACT matern32 prior"
    assert f"Training (full-batch exact MLL, state-space Kalman engine (O(T), {prior}))..." in text
    assert "host us per filter step" in text and len(out.ss_stats) == steps
    assert out.lf_grid.shape == out.lf_mean.shape == out.lf_var.shape == (200,)
    assert float(out.lf_grid[-1]) == pytest.approx(12.0 * 13.0 / 12.0)
    assert bool(torch.isfinite(out.lf_mean).all()) and float(out.lf_var.min()) > 0.0


def test_dense_ss_route_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible: the default device exists")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmain.run_dense(tmain.cfg.RunConfig(preset="dense10k", synth_genes=2,
                                            synth_timepoints=3, num_iters=1, mll_engine="ss"))


def test_cli_dense_ss_route_on_cpu(tmp_path, capsys):
    out = tmain.main(["--preset", "dense10k", "--mll-engine", "ss", "--device", "cpu",
                      "--no-x64", "--synth-genes", "3", "--synth-timepoints", "16",
                      "--num-iters", "3", "--stationary-after", "8",
                      "--out-dir", str(tmp_path)])
    assert out.X.dtype == F32 and out.lf_mean.dtype == F32
    hist = out.result.history.numpy()
    assert np.all(np.isfinite(hist)) and hist[-1] < hist[0]
    text = capsys.readouterr().out
    assert "steady-state gain after 8 warmup steps" in text
    assert "Ground-truth recovery" in text


@pytest.mark.parametrize("argv, msg", [
    (["--preset", "dense10k", "--ss-shard"], "--ss-shard requires --mll-engine ss"),
    (["--preset", "dense10k", "--stationary-after", "8"],
     "--stationary-after requires --mll-engine ss"),
    (["--preset", "dense10k", "--mll-engine", "ss", "--ss-shard", "--stationary-after", "8"],
     "--stationary-after is incompatible with --ss-shard"),
    (["--preset", "dense10k", "--mll-engine", "ss", "--stationary-after", "0"],
     "--stationary-after must be >= 1"),
    (["--preset", "dense10k", "--force-kernel", "matern32"],
     "--force-kernel requires --mll-engine ss"),
    (["--mll-engine", "ss"], "only supported by the dense10k route"),
])
def test_cli_ss_guards_with_jax_messages(argv, msg):
    with pytest.raises(SystemExit, match=msg):
        tmain.main(argv + ["--device", "cpu"])


@pytest.mark.parametrize("argv", [
    ["--preset", "dense10k", "--mll-engine", "ss", "--ss-shard"],
])
def test_cli_refuses_ss_options_not_ported(argv):
    with pytest.raises(SystemExit, match="not yet ported"):
        tmain.main(argv + ["--device", "cpu"])


def test_cli_dense_ss_posterior_reaches_the_sampler(tmp_path, monkeypatch):
    """``--preset dense10k --mll-engine ss --posterior-samples 10``: the
    dense-scale posterior (``kinetics_posterior_ss``) with JAX's arguments
    (10 warmup, 10 draws, 10 leapfrog steps, --seed + 7)."""
    from test_torch_port_hmc_routes import sampler_call

    monkeypatch.chdir(tmp_path)
    seen = sampler_call(monkeypatch, ["--preset", "dense10k", "--mll-engine", "ss",
                                      "--posterior-samples", "10", "--synth-genes", "3",
                                      "--synth-timepoints", "9", "--num-iters", "1"])
    assert seen["num_warmup"] == seen["num_samples"] == 10
    assert (seen["num_leapfrog"], seen["num_chains"], seen["seed"]) == (10, 1, 7)
