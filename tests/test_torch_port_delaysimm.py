"""The port's delayed-response family (``dis_project_tpu_torch/models/
delaysimm.py`` and ``main.run_delay``) held to the JAX package on the CPU in
float64, and its zero-delay reduction to the port's ``ExactSIMM``.

Tolerances: the warp exactly, its gradient at a tie exactly (0.5, as
``jnp.maximum`` splits it); values at 1e-12 x max(1, max|ref|), raw
gradients (the delays' included) at 1e-10 x max(1, max|ref|); with every
delay 0 the port's methods equal ``ExactSIMM``'s bitwise; the 20-step
clamped fit history and gradient norms at rel 1e-9; the route's metrics
file and ``hyperparams.csv`` at rel 1e-8 and its latent force at 1e-8. The
JAX references are compiled at XLA's lowest CPU optimisation level. The
routes write ``hyperparams.csv`` into the working directory, so every test
that drives one runs in its own temporary directory.
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
from dis_project_tpu.models import delaysimm as jdelay
from dis_project_tpu.reporting import plotter as jplotter
from dis_project_tpu.training import generic as jgeneric
from dis_project_tpu_torch import config as cfg
from dis_project_tpu_torch import convert
from dis_project_tpu_torch import main as tmain
from dis_project_tpu_torch.data.dataset import P53Data, train_arrays
from dis_project_tpu_torch.models import delaysimm, simm
from dis_project_tpu_torch.training import generic

F64 = torch.float64
FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}
ITERS = 20


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


def _rows(t, genes, flag):
    return np.stack([np.tile(t, len(genes)), np.repeat(genes, len(t)).astype(float),
                     np.full(len(t) * len(genes), float(flag))], axis=1)


def _problem():
    """Four genes on a 9-point grid from 0, delays (0.5, 0.05, 1.3, 1.5):
    gene 3's delay equals the grid's second time (a tie, t - delta = 0) and
    every gene clamps its first row to t = 0; per-point variances, force
    rows, an expression grid."""
    G, T = 4, 9
    t = np.linspace(0.0, 12.0, T)
    rng = np.random.default_rng(5)
    p = dict(basal=rng.uniform(0.02, 0.1, G), sensitivity=np.array([1.0, 0.8, 1.2, 0.9]),
             decay=np.array([0.4, 0.9, 0.6, 0.7]), lengthscale=np.array(2.2),
             obs_stddev=np.array(0.6), delay=np.array([0.5, 0.05, 1.3, 1.5]))
    X = _rows(t, np.arange(G), 1)
    F = np.stack([np.linspace(0.0, 13.0, 15), -np.ones(15), np.zeros(15)], axis=1)
    grid = _rows(np.linspace(0.0, 13.0, 8), np.arange(G), 0)
    return p, X, F, grid, rng.normal(size=G * T), rng.uniform(1e-3, 1e-2, G * T)


def test_warp_rows_matches_jax_and_splits_a_tie():
    """Expression rows warped to max(t - delta_g, 0), force rows untouched,
    exactly JAX's; the gradient of the warped times in the delays equals
    jax.grad's, 0.5 on the tied row (t = delta)."""
    p, X, F, _, _, _ = _problem()
    rows = np.concatenate([X, F])
    w = np.random.default_rng(0).normal(size=rows.shape[0])

    def jwarp(d):
        out = jdelay.warp_rows(jnp.asarray(rows), d, 4)
        return out, jnp.sum(w * out[:, 0])

    ref = _jit(jwarp)(jnp.asarray(p["delay"]))[0]
    ref_g = _jit(jax.grad(lambda d: jwarp(d)[1]))(jnp.asarray(p["delay"]))
    d = _t(p["delay"]).requires_grad_()
    got = delaysimm.warp_rows(_t(rows), d, 4)
    assert torch.equal(got.detach(), _t(ref))
    (g,) = torch.autograd.grad(torch.sum(_t(w) * got[:, 0]), d)
    assert torch.equal(g, _t(ref_g))
    # The tie alone: row (t = 1.5, gene 3), a unit cotangent.
    (g_tie,) = torch.autograd.grad(delaysimm.warp_rows(_t(X[28:29]), d, 4)[0, 0], d)
    assert X[28, 0] == 1.5 and torch.equal(g_tie, _t([0.0, 0.0, 0.0, -0.5]))


@pytest.fixture(scope="module")
def case():
    """JAX's values and raw gradient of ``ExactDelaySIMM`` on the problem,
    in one compiled program."""
    p, X, F, grid, y, var = _problem()
    jmodel = jdelay.ExactDelaySIMM(num_genes=4, jitter=1e-4)
    jp = jdelay.DelaySIMMParams(**{k: jnp.asarray(v) for k, v in p.items()})
    a = {k: jnp.asarray(v) for k, v in dict(X=X, F=F, grid=grid, y=y, var=var).items()}

    def ref(jp):
        lat = jmodel.latent_predict(jp, a["F"], a["X"], a["y"], a["var"])
        gene = jmodel.multi_gene_predict(jp, a["grid"], a["X"], a["y"], a["var"])
        grad = jax.grad(lambda r: jmodel.mll(jdelay.constrain(r), a["X"], a["y"]))(
            jdelay.unconstrain(jp))
        return dict(gram=jmodel.gram(jp, a["X"]), ccov=jmodel.cross_covariance(jp, a["X"], a["F"]),
                    mll=jmodel.mll(jp, a["X"], a["y"]), lat_mean=lat.mean, lat_cov=lat.cov,
                    gene_mean=gene.mean, gene_cov=gene.cov, grad=grad)

    return dict(ref=jax.tree.map(np.asarray, _jit(ref)(jp)), p=p,
                tp=convert.delaysimm_params_from_numpy(p, device="cpu"),
                model=delaysimm.ExactDelaySIMM(num_genes=4, jitter=1e-4),
                X=_t(X), F=_t(F), grid=_t(grid), y=_t(y), var=_t(var))


def test_values_match_jax(case):
    """gram, cross_covariance, mll, latent_predict and multi_gene_predict at
    the warped rows: 1e-12."""
    m, tp, ref = case["model"], case["tp"], case["ref"]
    lat = m.latent_predict(tp, case["F"], case["X"], case["y"], case["var"])
    gene = m.multi_gene_predict(tp, case["grid"], case["X"], case["y"], case["var"])
    got = dict(gram=m.gram(tp, case["X"]), ccov=m.cross_covariance(tp, case["X"], case["F"]),
               mll=m.mll(tp, case["X"], case["y"]), lat_mean=lat.mean, lat_cov=lat.cov,
               gene_mean=gene.mean, gene_cov=gene.cov)
    for name, value in got.items():
        _close(value, ref[name], 1e-12, name)


def test_raw_gradients_match_jax_delays_included(case):
    """The MLL's gradient in every raw parameter, the delays' through the
    Gram's rows, against jax.grad: 1e-10; every delay's gradient nonzero."""
    m = case["model"]
    _, grads = generic.value_and_grad(
        lambda r: m.mll(delaysimm.constrain(r), case["X"], case["y"]),
        delaysimm.unconstrain(case["tp"]))
    for name in delaysimm.DelaySIMMParams._fields:
        _close(getattr(grads, name), getattr(case["ref"]["grad"], name), 1e-10, name)
    assert bool((grads.delay != 0).all())


def test_zero_delay_is_exact_simm_bitwise(case):
    """With every delay 0 the warp is the identity on t >= 0, so the MLL,
    the Gram and both posteriors equal the port's ``ExactSIMM``'s bitwise."""
    tp = case["tp"]._replace(delay=torch.zeros(4, dtype=F64))
    sp = simm.SIMMParams(*tp[:5])
    m, s = case["model"], simm.ExactSIMM(num_genes=4, jitter=1e-4)
    X, y, var = case["X"], case["y"], case["var"]
    assert torch.equal(m.mll(tp, X, y), s.mll(sp, X, y))
    assert torch.equal(m.gram(tp, X), s.gram(sp, X))
    for a, b in ((m.latent_predict(tp, case["F"], X, y, var),
                  s.latent_predict(sp, case["F"], X, y, var)),
                 (m.multi_gene_predict(tp, case["grid"], X, y, var),
                  s.multi_gene_predict(sp, case["grid"], X, y, var))):
        assert torch.equal(a.mean, b.mean) and torch.equal(a.cov, b.cov)


def test_init_params_match_jax_and_round_trip():
    p = delaysimm.init_params(5)
    ref = jdelay.init_params(5, dtype=jnp.float64)
    for name in delaysimm.DelaySIMMParams._fields:
        _close(getattr(p, name), getattr(ref, name), 0.0, name)
    for a, b in zip(delaysimm.constrain(delaysimm.unconstrain(p)), p):
        _close(a, b.numpy(), 1e-14, "round trip")


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def jax_route(tmp_path_factory):
    """JAX's ``run_delay`` (20 iterations, p21 pinned, the metrics file, its
    ``hyperparams.csv`` in a temporary working directory): the
    ``LoopResult`` of its ``generic.fit_loop``, the latent force it plots,
    the CSV rows."""
    tmp = tmp_path_factory.mktemp("jax_delay")
    captured, posts = {}, []
    real_fit_loop = jgeneric.fit_loop

    def capture(*args, **kw):
        captured["result"] = real_fit_loop(*args, **kw)
        return captured["result"]

    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(tmp)
        _fast_jit(mp)
        mp.setattr(jgeneric, "fit_loop", capture)
        mp.setattr(jplotter, "plot_lf", lambda rows, post, **kw: posts.append(post))
        jmain.run_delay(jcfg.RunConfig(model="delaysimm", num_iters=ITERS,
                                       metrics_path=str(tmp / "jax.jsonl")))
    with open(tmp / "hyperparams.csv") as f:
        rows = list(csv.reader(f))
    return dict(result=captured["result"], post=posts[0], metrics=_records(tmp / "jax.jsonl"),
                csv=rows)


def _p53():
    data = P53Data(replicate=0, source="synthetic", seed=0)
    X, y, _ = train_arrays(data, "cpu", F64)
    return delaysimm.ExactDelaySIMM(num_genes=5, jitter=cfg.EXACT_JITTER), X, y


def test_clamped_fit_matches_jax(jax_route):
    """``delaysimm.fit(fix_params=True, clamp_gene=3)`` on the p53 data, 20
    Adam steps: history and gradient norms rel 1e-9, trained parameters rel
    1e-9; p21's raw S, D and delay at their pins."""
    model, X, y = _p53()
    res = delaysimm.fit(model, delaysimm.init_params(5), X, y, num_iters=ITERS,
                        fix_params=True, clamp_gene=3, full_result=True)
    ref = jax_route["result"]
    np.testing.assert_allclose(res.history.numpy(), np.asarray(ref.history), rtol=1e-9)
    np.testing.assert_allclose(res.grad_norms.numpy(), np.asarray(ref.grad_norms), rtol=1e-9)
    for name in delaysimm.DelaySIMMParams._fields:
        np.testing.assert_allclose(getattr(res.params, name).numpy(),
                                   np.asarray(getattr(ref.params, name)), rtol=1e-9)
    assert float(res.raw.delay[3]) == delaysimm.ZERO_DELAY_RAW
    np.testing.assert_allclose([float(res.params.sensitivity[3]), float(res.params.decay[3])],
                               [1.0, 0.8], rtol=1e-15)


def test_clamped_fit_checkpointed_equals_the_unsegmented_fit(tmp_path):
    """Under ``checkpoint_dir`` (segments of 4 and 2) the clamp holds on
    every step and the result equals the plain fit's bitwise."""
    model, X, y = _p53()
    kw = dict(num_iters=6, fix_params=True, clamp_gene=3, full_result=True)
    full = delaysimm.fit(model, delaysimm.init_params(5), X, y, **kw)
    seg = delaysimm.fit(model, delaysimm.init_params(5), X, y, checkpoint_dir=str(tmp_path),
                        checkpoint_every=4, **kw)
    assert torch.equal(seg.history, full.history)
    assert all(torch.equal(a, b) for a, b in zip(seg.raw, full.raw))
    assert float(seg.raw.delay[3]) == delaysimm.ZERO_DELAY_RAW


def test_run_delay_matches_jax(jax_route, tmp_path, monkeypatch, capsys):
    """The route on the CPU in a temporary working directory: the metrics
    file at rel 1e-8, ``hyperparams.csv`` (its header and gene names equal,
    its numbers at rel 1e-8), the delay table with p21 pinned, the latent
    force on the 100-point grid within 1e-8 of JAX's, one plot."""
    monkeypatch.chdir(tmp_path)
    path = tmp_path / "port.jsonl"
    out = tmain.run_delay(cfg.RunConfig(model="delaysimm", num_iters=ITERS, device="cpu",
                                        metrics_path=str(path), out_dir=str(tmp_path / "plots")))
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
    _close(out.latent.mean, jax_route["post"].mean, 1e-8, "latent mean")
    _close(out.latent.cov, jax_route["post"].cov, 1e-8, "latent cov")
    text = capsys.readouterr().out
    assert "per-gene transcriptional delays (anchor: p21 pinned to 0):" in text
    assert "  p21        0.0000" in text
    assert sorted(f.name for f in (tmp_path / "plots").iterdir()) == ["lf_delay.png"]
