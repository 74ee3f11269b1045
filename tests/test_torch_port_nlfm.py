"""The port's nonlinear-response family (``dis_project_tpu_torch/ops/
odeint.py``, ``models/nlfm.py``, ``data/synthetic.generate_ode_nonlinear``,
``convert.nlfm_params_from_numpy`` and ``main.run_nonlinear``) held to the
JAX package on the CPU in float64.

Tolerances: the responses, the trapezoid scan and the gene curves at
1e-12 x max(1, max|ref|); ``curves_at`` and ``log_joint`` at 1e-10 x
max(1, max|ref|), the raw gradient of the negative log-joint at the larger
of 1e-10 and eps cond(K_ff + jitter I) (1.6e-9: its path back through the
grid prior's Cholesky factor) x max(1, max|ref|); the
Laplace means at 1e-10 and covariances at 1e-8 (x max(1, max|ref|)) at
Q = 25; the 30-step pinned Adam fit (history, gradient norms, constrained
leaves) at rel 1e-9, three L-BFGS steps at rel 1e-8; checkpoint and resume
bitwise; the generator at 1e-12; the route's metrics file and
``hyperparams.csv`` at rel 1e-8. The JAX references are compiled at XLA's
lowest CPU optimisation level. The route writes ``hyperparams.csv`` into
the working directory, so each test that drives one runs in its own
temporary directory.
"""

import csv
import functools
import json

import jax
import jax.numpy as jnp
from jax._src import core as jax_core
import numpy as np
import pytest
import torch

from dis_project_tpu import config as jcfg
from dis_project_tpu import main as jmain
from dis_project_tpu.data import synthetic as jsynth
from dis_project_tpu.data.dataset import P53Data as JP53Data
from dis_project_tpu.models import nlfm as jnlfm
from dis_project_tpu.ops import odeint as jodeint
from dis_project_tpu.reporting import plotter as jplotter
from dis_project_tpu.training import generic as jgeneric
from dis_project_tpu_torch import config as cfg
from dis_project_tpu_torch import convert
from dis_project_tpu_torch import main as tmain
from dis_project_tpu_torch.data import synthetic as tsynth
from dis_project_tpu_torch.data.dataset import P53Data
from dis_project_tpu_torch.models import nlfm
from dis_project_tpu_torch.ops import odeint

F32, F64 = torch.float32, torch.float64
FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}
RESPONSES = odeint.RESPONSE_NAMES
Q, ITERS = 25, 30


def _fast_jit(mp):
    """Compile every ``jax.jit`` (the JAX routes' own included) at XLA's
    lowest CPU optimisation level while ``mp`` is active. optax is imported
    first: its module-level jits are nested in the routes' programs, where
    no compiler options may be given."""
    import optax  # noqa: F401

    real = jax.jit

    def jit(fun=None, **kw):
        if fun is None:
            return functools.partial(jit, **kw)
        if not jax_core.trace_state_clean():  # a nested jit takes no compiler options
            return real(fun, **kw)
        return real(fun, compiler_options=FAST_COMPILE, **kw)

    mp.setattr(jax, "jit", jit)


def _jit(fn, **kw):
    return jax.jit(fn, compiler_options=FAST_COMPILE, **kw)


def _t(a, dtype=F64):
    return torch.as_tensor(np.array(a), dtype=dtype)


def _close(got, ref, rtol, what):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    err = float(np.max(np.abs(got - ref)))
    tol = rtol * max(1.0, float(np.abs(ref).max()))
    assert err <= tol, f"{what}: max abs error {err:.3e} > {tol:.3e}"


# ---------------------------------------------------------------------------
# ops/odeint.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("xp", ["torch", "numpy"])
@pytest.mark.parametrize("name", RESPONSES)
def test_response_fn_matches_jax(name, xp):
    """Each response on torch and on numpy against JAX's on jnp: 1e-12,
    over |f| <= 30 (softplus through logaddexp(0, f))."""
    f = np.linspace(-30.0, 30.0, 241)
    ref = np.asarray(jodeint.response_fn(name)(jnp.asarray(f)))
    if xp == "torch":
        got = odeint.response_fn(name)(_t(f))
    else:
        got = odeint.response_fn(name, xp=np)(f)
    _close(got, ref, 1e-12, name)


def test_unknown_response_raises_jax_message():
    with pytest.raises(ValueError) as ref:
        jodeint.response_fn("tanh")
    with pytest.raises(ValueError) as got:
        odeint.response_fn("tanh")
    assert str(got.value) == str(ref.value)


def test_trapezoid_and_gene_curves_match_jax_with_batch_axes():
    """``decay_propagated_trapezoid`` on (2, 3, Q) response values (two
    leading batch axes, odd and even grid lengths) and ``gene_curves``:
    1e-12; J starts at 0."""
    rng = np.random.default_rng(0)
    decay, basal, sens = rng.uniform(0.2, 2.0, 4), rng.uniform(0.02, 0.1, 4), rng.uniform(
        0.5, 1.5, 4)
    for q in (25, 32):
        g = np.exp(rng.normal(size=(2, 3, q)))
        ref = _jit(lambda g, d: jodeint.decay_propagated_trapezoid(g, d, 0.37))(
            jnp.asarray(g), jnp.asarray(decay))
        got = odeint.decay_propagated_trapezoid(_t(g), _t(decay), 0.37)
        _close(got, ref, 1e-12, f"J, Q={q}")
        assert got.shape == (2, 3, 4, q) and bool((got[..., 0] == 0).all())
    ref = jodeint.gene_curves(jnp.asarray(g[0, 0]), jnp.asarray(basal), jnp.asarray(sens),
                              jnp.asarray(decay), 0.37)
    got = odeint.gene_curves(_t(g[0, 0]), _t(basal), _t(sens), _t(decay), 0.37)
    _close(got, ref, 1e-12, "gene_curves")


def test_no_overflow_in_float32_at_large_decay_times():
    """JAX's test: D t up to 300 in float32 (D = 1.5 on [0, 200]) stays
    finite and reaches the steady state 1/D within 2e-3; the float32 scan
    within 1e-5 of the float64 one."""
    t = np.linspace(0.0, 200.0, 4001)
    J32 = odeint.decay_propagated_trapezoid(torch.ones(4001, dtype=F32), _t([1.5], F32),
                                            float(t[1] - t[0]))
    J64 = odeint.decay_propagated_trapezoid(torch.ones(4001, dtype=F64), _t([1.5]),
                                            float(t[1] - t[0]))
    assert bool(torch.isfinite(J32).all())
    assert abs(float(J32[0, -1]) - 1.0 / 1.5) <= 2e-3 / 1.5
    assert float((J32.double() - J64).abs().max()) <= 1e-5


# ---------------------------------------------------------------------------
# models/nlfm.py
# ---------------------------------------------------------------------------


def _p53():
    data = P53Data(replicate=None, source="synthetic", seed=0)
    return data.timepoints, data.gene_expressions, data.gene_variances


T_QUERY = np.array([-0.5, 0.0, 0.3, 2.0, 5.7, 11.99, 12.0, 12.5])


def _point(response, seed=1):
    """A point away from the init: random kinetics and force values."""
    rng = np.random.default_rng(seed)
    kin = dict(basal=rng.uniform(0.02, 0.1, 5), sensitivity=rng.uniform(0.5, 1.5, 5),
               decay=rng.uniform(0.3, 1.0, 5), lengthscale=np.array(2.2),
               obs_stddev=np.array(0.4))
    return dict(kinetics=kin, w=0.5 * rng.normal(size=Q))


@pytest.fixture(scope="module")
def refs():
    """JAX's ``curves_at`` (on query times beyond both ends and on grid
    points), ``log_joint`` on the three replicates, the raw gradient of the
    negative log-joint and both Laplace posteriors, for every response, in
    one compiled program."""
    t, Y, V = _p53()
    pts = {r: _point(r) for r in RESPONSES}

    def all_refs(jp_by_resp):
        out = {}
        for r in RESPONSES:
            m = jnlfm.NonlinearLFM(num_genes=5, response=r, t_max=12.0, num_quad=Q)
            jp = jp_by_resp[r]
            lap, bands = m.laplace_posteriors(jp, jnp.asarray(t), jnp.asarray(Y), jnp.asarray(V))
            grad = jax.grad(lambda raw: -m.log_joint(jnlfm.constrain(raw), jnp.asarray(t),
                                                     jnp.asarray(Y), jnp.asarray(V)))(
                jnlfm.unconstrain(jp))
            out[r] = dict(curves_at=m.curves_at(jp, jnp.asarray(T_QUERY)),
                          log_joint=m.log_joint(jp, jnp.asarray(t), jnp.asarray(Y),
                                                jnp.asarray(V)),
                          grad=grad, lap_mean=lap.mean, lap_cov=lap.cov, band_mean=bands.mean,
                          band_cov=bands.cov)
        return out

    jps = {r: jnlfm.NLFMParams(
        kinetics=jnlfm.simm.SIMMParams(**{k: jnp.asarray(v) for k, v in p["kinetics"].items()}),
        w=jnp.asarray(p["w"])) for r, p in pts.items()}
    return jax.tree.map(np.asarray, _jit(all_refs)(jps)), pts


def _model(response):
    return nlfm.NonlinearLFM(num_genes=5, response=response, t_max=12.0, num_quad=Q)


@pytest.mark.parametrize("response", RESPONSES)
def test_curves_at_and_log_joint_match_jax(response, refs):
    """``curves_at`` at times before, on and after the grid (jnp.interp's
    end clamping) and ``log_joint`` with Y of 3 replicates: 1e-10."""
    ref, pts = refs[0][response], refs[1][response]
    tp = convert.nlfm_params_from_numpy(pts, device="cpu")
    t, Y, V = _p53()
    m = _model(response)
    _close(m.curves_at(tp, _t(T_QUERY)), ref["curves_at"], 1e-10, "curves_at")
    _close(m.log_joint(tp, _t(t), _t(Y), _t(V)), ref["log_joint"], 1e-10, "log_joint")


def _prior_cond(lengthscale, jitter=1e-6):
    """cond(K_ff + jitter I) of the grid prior at Q = 25 (numpy, float64)."""
    t = np.linspace(0.0, 12.0, Q)
    K = np.exp(-((t[:, None] - t[None, :]) ** 2) / lengthscale**2) + jitter * np.eye(Q)
    return float(np.linalg.cond(K))


@pytest.mark.parametrize("response", RESPONSES)
def test_raw_gradient_matches_jax_grad(response, refs):
    """The gradient of the negative log-joint in every raw leaf (the five
    kinetics and w) against jax.grad: 1e-10, or eps cond(K_ff + jitter I)
    where that is larger. The gradient goes back through the Cholesky
    factor of the grid prior (cond 7.4e6 at l = 2.2 and the route's jitter
    1e-6), where two LAPACK builds' factors differ by eps cond: measured
    1.9e-10 to 2.6e-10 x max|g| on the lengthscale, 1e-13 at jitter 1e-3."""
    from dis_project_tpu_torch.training import generic

    ref, pts = refs[0][response], refs[1][response]
    tp = convert.nlfm_params_from_numpy(pts, device="cpu")
    t, Y, V = _p53()
    m = _model(response)
    _, grads = generic.value_and_grad(
        lambda r: -m.log_joint(nlfm.constrain(r), _t(t), _t(Y), _t(V)), nlfm.unconstrain(tp))
    tol = max(1e-10, np.finfo(np.float64).eps * _prior_cond(2.2))
    for name in grads.kinetics._fields:
        _close(getattr(grads.kinetics, name), getattr(ref["grad"].kinetics, name), tol, name)
    _close(grads.w, ref["grad"].w, tol, "w")


@pytest.mark.parametrize("response", RESPONSES)
def test_laplace_posteriors_match_jax(response, refs):
    """Both Gaussians from one Hessian (``torch.func.hessian``; the bands'
    Jacobian by ``jacfwd``) at Q = 25: means 1e-10, covariances 1e-8; the
    one-Hessian pair equals the individual calls bitwise."""
    ref, pts = refs[0][response], refs[1][response]
    tp = convert.nlfm_params_from_numpy(pts, device="cpu")
    t, Y, V = (_t(a) for a in _p53())
    m = _model(response)
    lap, bands = m.laplace_posteriors(tp, t, Y, V)
    _close(lap.mean, ref["lap_mean"], 1e-10, "force mean")
    _close(lap.cov, ref["lap_cov"], 1e-8, "force cov")
    _close(bands.mean, ref["band_mean"], 1e-10, "band mean")
    _close(bands.cov, ref["band_cov"], 1e-8, "band cov")
    assert bands.mean.shape == (5 * Q,)
    alone = m.laplace_force_posterior(tp, t, Y, V)
    assert torch.equal(alone.mean, lap.mean) and torch.equal(alone.cov, lap.cov)


def test_init_params_and_convert_round_trip():
    """``init_params`` equals JAX's exactly; ``nlfm_params_from_numpy``
    carries a JAX point across exactly; constrain(unconstrain(p)) = p
    within 1e-14."""
    ref = jnlfm.init_params(5, Q, jnp.float64)
    p = nlfm.init_params(5, Q)
    for a, b in zip(jax.tree.leaves(ref), (*p.kinetics, p.w)):
        _close(b, a, 0.0, "init")
    pt = _point("exp")
    tp = convert.nlfm_params_from_numpy(pt, device="cpu")
    assert isinstance(tp, nlfm.NLFMParams) and tp.w.dtype == F64
    for name, v in pt["kinetics"].items():
        _close(getattr(tp.kinetics, name), v, 0.0, name)
    _close(tp.w, pt["w"], 0.0, "w")
    back = nlfm.constrain(nlfm.unconstrain(tp))
    for a, b in zip((*back.kinetics, back.w), (*tp.kinetics, tp.w)):
        _close(a, b.numpy(), 1e-14, "round trip")


def test_failed_prior_factor_is_nan_not_an_exception():
    """A lengthscale whose jittered grid prior is not positive definite
    (no jitter, l = 50) gives a NaN factor and a NaN log-joint, as JAX's."""
    m = nlfm.NonlinearLFM(num_genes=5, num_quad=Q, jitter=0.0)
    assert bool(torch.isnan(m.force_chol(_t(50.0))).all())
    p = nlfm.init_params(5, Q)
    p = p._replace(kinetics=p.kinetics._replace(lengthscale=_t(50.0)))
    t, Y, V = (_t(a) for a in _p53())
    assert bool(torch.isnan(m.log_joint(p, t, Y, V)))


# ---------------------------------------------------------------------------
# fit, checkpoints, the generator and the route.
# ---------------------------------------------------------------------------


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def jax_route(tmp_path_factory):
    """JAX's ``run_nonlinear`` (Q = 25, 30 Adam steps, the p21 pin, the
    metrics file, ``hyperparams.csv`` in a temporary working directory):
    the ``LoopResult`` of its ``generic.fit_loop`` and the CSV rows; and
    three L-BFGS steps of ``nlfm.fit`` from the init."""
    tmp = tmp_path_factory.mktemp("jax_nlfm")
    captured, plots = {}, []
    real_fit_loop = jgeneric.fit_loop

    def capture(*args, **kw):
        captured["result"] = real_fit_loop(*args, **kw)
        return captured["result"]

    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(tmp)
        _fast_jit(mp)
        mp.setattr(jgeneric, "fit_loop", capture)
        mp.setattr(jplotter, "plot_lf", lambda *a, **kw: plots.append("lf"))
        mp.setattr(jplotter, "plot_gene_predictions", lambda *a, **kw: plots.append("gxpr"))
        jmain.run_nonlinear(jcfg.RunConfig(model="nlfm", num_iters=ITERS, num_quad=Q,
                                           metrics_path=str(tmp / "jax.jsonl")))
        route = captured["result"]
        data = JP53Data(replicate=0, source="synthetic")
        m = jnlfm.NonlinearLFM(num_genes=5, response="exp", t_max=12.0, num_quad=Q,
                               jitter=cfg.SPARSE_JITTER)
        lbfgs = jnlfm.fit(m, jnlfm.init_params(5, Q), jnp.asarray(data.timepoints),
                          jnp.asarray(data.gene_expressions), jnp.asarray(data.gene_variances),
                          num_iters=3, fix_params=True, optimizer="lbfgs", full_result=True)
    with open(tmp / "hyperparams.csv") as f:
        rows = list(csv.reader(f))
    assert plots == ["lf", "gxpr"]
    return dict(result=route, lbfgs=lbfgs, metrics=_records(tmp / "jax.jsonl"), csv=rows)


def _fit(**kw):
    data = P53Data(replicate=0, source="synthetic", seed=0)
    m = nlfm.NonlinearLFM(num_genes=5, response="exp", t_max=12.0, num_quad=Q,
                          jitter=cfg.SPARSE_JITTER)
    args = (_t(data.timepoints), _t(data.gene_expressions), _t(data.gene_variances))
    return nlfm.fit(m, nlfm.init_params(5, Q), *args, fix_params=True, clamp_gene=3,
                    full_result=True, **kw)


def _assert_rel(got, ref, rtol, what):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), rtol=rtol, err_msg=what)


def test_pinned_fit_matches_jax(jax_route):
    """``nlfm.fit(fix_params=True, clamp_gene=3)``, 30 Adam steps on the p53
    data at Q = 25: history, gradient norms and every constrained leaf at
    rel 1e-9 of JAX's ``fit(full_result=True)``; p21's S and D pinned."""
    res = _fit(num_iters=ITERS)
    ref = jax_route["result"]
    _assert_rel(res.history, ref.history, 1e-9, "history")
    _assert_rel(res.grad_norms, ref.grad_norms, 1e-9, "grad norms")
    for name in res.params.kinetics._fields:
        _assert_rel(getattr(res.params.kinetics, name), getattr(ref.params.kinetics, name),
                    1e-9, name)
    _assert_rel(res.params.w, ref.params.w, 1e-9, "w")
    np.testing.assert_allclose([float(res.params.kinetics.sensitivity[3]),
                                float(res.params.kinetics.decay[3])], [1.0, 0.8], rtol=1e-15)


def test_lbfgs_fit_matches_jax(jax_route):
    """Three L-BFGS steps (the zoom line search) over the nested
    parameters: history and constrained leaves at rel 1e-8."""
    res = _fit(num_iters=3, optimizer="lbfgs")
    ref = jax_route["lbfgs"]
    _assert_rel(res.history, ref.history, 1e-8, "history")
    _assert_rel(res.params.w, ref.params.w, 1e-8, "w")
    for name in res.params.kinetics._fields:
        _assert_rel(getattr(res.params.kinetics, name), getattr(ref.params.kinetics, name),
                    1e-8, name)


def test_checkpoint_then_resume_is_bitwise(tmp_path):
    """Under ``checkpoint_dir`` (segments of 4) the fit equals the plain
    fit bitwise; a run stopped after 4 steps and resumed to 7 ends where
    the straight run does, bitwise (raw leaves, Adam moments)."""
    from dis_project_tpu_torch.training import generic

    full = _fit(num_iters=7)
    seg = _fit(num_iters=7, checkpoint_dir=str(tmp_path / "a"), checkpoint_every=4)
    assert torch.equal(seg.history, full.history)
    _fit(num_iters=4, checkpoint_dir=str(tmp_path / "b"), checkpoint_every=4)
    rest = _fit(num_iters=7, checkpoint_dir=str(tmp_path / "b"), checkpoint_every=4)
    assert torch.equal(rest.history, full.history[4:])
    for a, b in zip(generic.tree_leaves((rest.raw, rest.opt_state.mu, rest.opt_state.nu)),
                    generic.tree_leaves((full.raw, full.opt_state.mu, full.opt_state.nu))):
        assert torch.equal(a, b)
    assert isinstance(rest.raw, nlfm.NLFMParams) and rest.opt_state.count == 7


@pytest.mark.parametrize("response", RESPONSES)
def test_generate_ode_nonlinear_matches_jax(response):
    """``ode_from_draws`` with ``response_fn(name, xp=np)`` on JAX's draws
    equals JAX's ``generate_ode_nonlinear`` within 1e-12 (expressions,
    f_true); the port's generator is that construction on its own draws,
    and with 'identity' it is ``generate_ode`` bit for bit."""
    scfg = jsynth.SyntheticConfig(num_genes=4, num_timepoints=15, num_replicates=2,
                                  noise_std=0.1)
    key = jax.random.PRNGKey(7)
    kp, kf, kn = jax.random.split(key, 3)
    kin = jsynth._sample_kinetics(kp, scfg, jnp.float64)
    eps = jax.random.normal(kf, (14 * 4 + 1,), jnp.float32)
    noise = jax.random.normal(kn, (2, 4, 15), jnp.float32)
    ref = jsynth.generate_ode_nonlinear(key, scfg, response=response, oversample=4,
                                        dtype=jnp.float64)
    tcfg = tsynth.SyntheticConfig(num_genes=4, num_timepoints=15, num_replicates=2,
                                  noise_std=0.1)
    got = tsynth.ode_from_draws(*(np.asarray(a) for a in (kin["basal"], kin["sensitivity"],
                                                          kin["decay"], eps, noise)),
                                tcfg, oversample=4, response=odeint.response_fn(response, xp=np))
    _close(got.gene_expressions, ref.gene_expressions, 1e-12, "expressions")
    _close(got.f_true, ref.f_true, 1e-12, "f_true")
    mine = tsynth.generate_ode_nonlinear(torch.Generator().manual_seed(3), tcfg,
                                         response=response, oversample=4, device="cpu")
    draws = tsynth.ode_draws(torch.Generator().manual_seed(3), tcfg, 4)
    same = tsynth.ode_from_draws(*draws, tcfg, oversample=4,
                                 response=odeint.response_fn(response, xp=np))
    assert torch.equal(mine.gene_expressions, same.gene_expressions)
    if response == "identity":
        lin = tsynth.generate_ode(torch.Generator().manual_seed(3), tcfg, oversample=4,
                                  device="cpu")
        assert torch.equal(mine.gene_expressions, lin.gene_expressions)
        assert torch.equal(mine.f_true, lin.f_true)


def test_run_nonlinear_matches_jax(jax_route, tmp_path, monkeypatch, capsys):
    """The route on the CPU in a temporary working directory (Q = 25, 30
    steps): the metrics file at rel 1e-8 (final loss included),
    ``hyperparams.csv`` (header and gene names equal, numbers at rel 1e-8),
    the exp note, p21 pinned; both plots where matplotlib is installed."""
    monkeypatch.chdir(tmp_path)
    path = tmp_path / "port.jsonl"
    out = tmain.main(["--model", "nlfm", "--num-iters", str(ITERS), "--num-quad", str(Q),
                      "--device", "cpu", "--metrics-path", str(path),
                      "--out-dir", str(tmp_path / "plots")])
    assert isinstance(out, tmain.NonlinearRun)
    got, ref = _records(path), jax_route["metrics"]
    assert [sorted(r) for r in got] == [sorted(r) for r in ref] == [
        ["grad_norm", "loss", "step"]] * ITERS
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose([r[key] for r in got], [r[key] for r in ref], rtol=1e-8)
    with open(tmp_path / "hyperparams.csv") as f:
        rows = list(csv.reader(f))
    jrows = jax_route["csv"]
    assert rows[0] == jrows[0] and [r[0] for r in rows] == [r[0] for r in jrows]
    np.testing.assert_allclose(np.array([r[1:] for r in rows[1:]], float),
                               np.array([r[1:] for r in jrows[1:]], float), rtol=1e-8)
    assert out.latent.mean.shape == (Q,) and out.bands.mean.shape == (5 * Q,)
    assert bool(torch.isfinite(out.latent.cov).all() and torch.isfinite(out.bands.cov).all())
    text = capsys.readouterr().out
    assert "NOTE: the exp response has an exact (f+c, S*e^-c) shift" in text
    assert "Training nonlinear-response LFM (g=exp, Q=25) by MAP" in text
    if tmain._have_matplotlib():
        assert sorted(f.name for f in (tmp_path / "plots").iterdir()) == [
            "gxpr_nlfm.png", "lf_nlfm.png"]
