"""The port's extended-Kalman engine of the nonlinear-response family
(``nlfm_mll_ekf``, ``_joseph_update_solve``, ``_ekf_propagate`` and
``nlfm_predict_ekf`` in ``dis_project_tpu_torch/ops/statespace.py``),
``main.run_dense --model nlfm --mll-engine ss`` and the nlfm flags and
guards of the CLI, held to the JAX package on the CPU in float64.

Tolerances: the EKF marginal and its raw gradient at 1e-10 x max(1,
max|ref|) for every response, both orders, one and three replicates and a
Matern-3/2 prior; with the identity response the marginal against the
port's ``lfm_mll_ss`` at the JAX package's 5e-4 and 5e-6 (substeps 4 and
8); the smoothed moments at 5e-9 x max(1, max|ref|) (the RTS pseudo-solve's
``eigh`` moves them by ~1.5e-9 between LAPACK builds); the dense route's
metrics file at rel 1e-8; the guards' messages word for word. The data are
``generate_ode_nonlinear`` draws, on which the filter is well posed. The
JAX references are compiled at XLA's lowest CPU optimisation level.
"""

import argparse
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
from dis_project_tpu.models import simm as jsimm
from dis_project_tpu.ops import statespace as jss
from dis_project_tpu_torch import config as cfg
from dis_project_tpu_torch import convert
from dis_project_tpu_torch import main as tmain
from dis_project_tpu_torch.data import synthetic as tsynth
from dis_project_tpu_torch.models import simm
from dis_project_tpu_torch.ops import statespace as ss
from dis_project_tpu_torch.ops.precision import pin_full_fp32
from dis_project_tpu_torch.training import generic

F64 = torch.float64
FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


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


@pytest.fixture(autouse=True)
def _full_fp32():
    pin_full_fp32()


@functools.lru_cache(maxsize=None)
def _data(response, G, T, R):
    """JAX's ``generate_ode_nonlinear`` draw (oversample 4): the grid and
    the gene-major flat observations, replicate-major."""
    scfg = jsynth.SyntheticConfig(num_genes=G, num_timepoints=T, num_replicates=R,
                                  noise_std=0.1)
    d = jsynth.generate_ode_nonlinear(jax.random.PRNGKey(G * T + R), scfg, response=response,
                                      oversample=4, dtype=jnp.float64)
    return np.asarray(d.timepoints), np.asarray(d.gene_expressions).reshape(-1)


def _params(G):
    """Kinetics away from the init, shared by both packages."""
    rng = np.random.default_rng(G)
    return dict(basal=rng.uniform(0.02, 0.1, G), sensitivity=rng.uniform(0.6, 1.4, G),
                decay=rng.uniform(0.3, 1.0, G), lengthscale=np.array(2.2),
                obs_stddev=np.array(0.3))


# (response, G, T, replicates, order, force_kernel)
CASES = {
    "identity": ("identity", 3, 9, 1, 8, "rbf"),
    "exp": ("exp", 3, 9, 1, 8, "rbf"),
    "softplus": ("softplus", 3, 9, 1, 8, "rbf"),
    "sigmoid": ("sigmoid", 3, 9, 1, 8, "rbf"),
    "exp order 10, 3 replicates": ("exp", 2, 7, 3, 10, "rbf"),
    "softplus order 10, matern32": ("softplus", 3, 9, 1, 10, "matern32"),
}


@pytest.fixture(scope="module")
def mll_refs():
    """JAX's EKF marginal and its raw gradient for every case, in one
    compiled program."""
    data = {name: _data(*c[:4]) for name, c in CASES.items()}

    def all_cases(raws):
        out = {}
        for name, (resp, G, T, R, order, fk) in CASES.items():
            t, y = data[name]
            out[name] = jax.value_and_grad(lambda r: jss.nlfm_mll_ekf(
                jsimm.constrain(r), jnp.asarray(t), jnp.asarray(y), response=resp,
                jitter=1e-4, replicates=R, order=order, force_kernel=fk))(raws[name])
        return out

    raws = {name: jsimm.unconstrain(jsimm.SIMMParams(
        **{k: jnp.asarray(v) for k, v in _params(c[1]).items()})) for name, c in CASES.items()}
    return jax.tree.map(np.asarray, _jit(all_cases)(raws))


@pytest.mark.parametrize("case", list(CASES))
def test_nlfm_mll_ekf_matches_jax(case, mll_refs):
    """Value and every raw gradient leaf at 1e-10 x max(1, max|ref|),
    substeps 4."""
    resp, G, T, R, order, fk = CASES[case]
    ref, ref_g = mll_refs[case]
    t, y = _data(resp, G, T, R)
    raw = simm.unconstrain(convert.params_from_numpy(_params(G), device="cpu"))
    loss, grads = generic.value_and_grad(lambda r: ss.nlfm_mll_ekf(
        simm.constrain(r), _t(t), _t(y), response=resp, jitter=1e-4, replicates=R,
        order=order, force_kernel=fk), raw)
    _close(loss, ref, 1e-10, "mll")
    for name in raw._fields:
        _close(getattr(grads, name), getattr(ref_g, name), 1e-10, name)


def test_identity_matches_the_linear_engine_by_substeps():
    """The JAX package's test on the port: with g = identity the EKF is the
    linear filter up to RK4-vs-expm integration error, under 5e-4 at 4
    substeps and 5e-6 at 8, falling."""
    G, T = 3, 9
    t = torch.linspace(0.0, 12.0, T, dtype=F64)
    y = _t(np.random.default_rng(5).normal(size=(G * T,))) + 1.0
    params = simm.init_params(G)._replace(decay=_t([0.4, 0.9, 0.6]),
                                          sensitivity=_t([1.0, 0.8, 1.2]))
    v_lin = float(ss.lfm_mll_ss(params, t, y, jitter=1e-4, order=10, parallel=False))
    errs = [abs(v_lin - float(ss.nlfm_mll_ekf(params, t, y, response="identity", jitter=1e-4,
                                              order=10, substeps=sub))) for sub in (4, 8)]
    assert errs[0] < 5e-4 and errs[1] < 5e-6 and errs[1] < errs[0]


@pytest.mark.parametrize("response", ["identity", "exp", "softplus", "sigmoid"])
def test_nlfm_predict_ekf_matches_jax(response):
    """Force and gene moments at 11 test times (t = 0 shared with the train
    grid, one beyond it), per-entry noise variances, against JAX's: within
    5e-9 x max(1, max|ref|); the variances nonnegative. Not 1e-9: the RTS
    pseudo-solve's relative eigenvalue cutoff moves the smoothed force
    variance with the LAPACK build of ``eigh`` (measured 1.4e-9 to 1.6e-9
    against JAX, and 1.4e-9 between the port and itself with numpy's
    ``eigh``; everything else within 1e-9 x max(1, max|ref|))."""
    G, T = 3, 9
    t, y = _data(response, G, T, 1)
    tt = np.linspace(0.0, 13.0, 11)
    nv = np.random.default_rng(4).uniform(5e-3, 2e-2, size=(T, G))
    p = _params(G)
    jp = jsimm.SIMMParams(**{k: jnp.asarray(v) for k, v in p.items()})
    ref = _jit(lambda q: jss.nlfm_predict_ekf(q, jnp.asarray(t), jnp.asarray(y), jnp.asarray(tt),
                                              response=response, noise_var=jnp.asarray(nv),
                                              order=10))(jp)
    got = ss.nlfm_predict_ekf(convert.params_from_numpy(p, device="cpu"), _t(t), _t(y), _t(tt),
                              response=response, noise_var=_t(nv), order=10)
    assert tuple(got[0].shape) == (11,) and tuple(got[2].shape) == (11, G)
    for name, g_, r_ in zip(("f_mean", "f_var", "x_mean", "x_var"), got, ref):
        _close(g_, r_, 5e-9, name)
    assert float(got[1].min()) >= 0.0 and float(got[3].min()) >= 0.0


def test_joseph_update_solve_on_an_indefinite_innovation_covariance():
    """An indefinite S (a predicted covariance with a negative eigenvalue
    larger than the noise): the LU gain is finite and equals JAX's, the
    log-density is NaN, and nothing raises."""
    m = 4
    p_pred = np.diag([1.0, -2.0, 0.5, 0.3])
    h = np.eye(m)[1:3]
    r_var, y, m_pred = np.array([0.1, 0.1]), np.array([0.3, -0.2]), np.zeros(m)
    ref = jss._joseph_update_solve(*(jnp.asarray(a) for a in (m_pred, p_pred, h, r_var, y)))
    got = ss._joseph_update_solve(*(_t(a) for a in (m_pred, p_pred, h, r_var, y)))
    assert bool(torch.isfinite(got[0]).all() and torch.isfinite(got[1]).all())
    assert bool(torch.isnan(got[2])) and bool(jnp.isnan(ref[2]))
    _close(got[0], ref[0], 1e-14, "mean")
    _close(got[1], ref[1], 1e-14, "cov")


def test_ekf_steps_are_read_from_the_grid_once():
    """``_host_steps`` gives Python numbers in the grid's dtype: the steps of
    the filter loop, read before it."""
    t = torch.tensor([0.5, 1.0, 2.5], dtype=torch.float32)
    steps = ss._host_steps(t)
    assert steps == [0.5, 0.5, 1.5] and all(isinstance(s, float) for s in steps)


# ---------------------------------------------------------------------------
# The dense route and the CLI.
# ---------------------------------------------------------------------------


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_run_dense_nlfm_matches_jax(tmp_path, monkeypatch, capsys):
    """``run_dense --model nlfm --mll-engine ss`` at 4 x 24, 6 plain Adam
    steps, on JAX's ``generate_ode_nonlinear`` data: the metrics file within
    rel 1e-8 of JAX's own route's, equal to the run's history; the
    recovery line printed."""
    G, T, iters = 4, 24, 6
    jpath, tpath = tmp_path / "jax.jsonl", tmp_path / "port.jsonl"
    _fast_jit(monkeypatch)
    jmain.run_dense(jcfg.RunConfig(preset="dense10k", model="nlfm", synth_genes=G,
                                   synth_timepoints=T, num_iters=iters, mll_engine="ss",
                                   metrics_path=str(jpath)))
    scfg = jsynth.SyntheticConfig(num_genes=G, num_timepoints=T, num_replicates=1,
                                  noise_std=0.1)
    jdata = jsynth.generate_ode_nonlinear(jax.random.PRNGKey(0), scfg, response="exp",
                                          oversample=4)

    def jax_data(genes, timepoints, seed, response, dtype, device):
        assert (genes, timepoints, seed, response) == (G, T, 0, "exp")
        return tsynth.SyntheticLFMData(
            _t(jdata.timepoints, dtype), _t(jdata.gene_expressions, dtype),
            _t(jdata.gene_variances, dtype),
            {k: _t(v) for k, v in jdata.params_true.items()}, _t(jdata.f_true, dtype))

    monkeypatch.setattr(tmain, "synthetic_nlfm_data", jax_data)
    out = tmain.main(["--preset", "dense10k", "--model", "nlfm", "--mll-engine", "ss",
                      "--synth-genes", str(G), "--synth-timepoints", str(T), "--num-iters",
                      str(iters), "--device", "cpu", "--metrics-path", str(tpath)])
    ref, got = _records(jpath), _records(tpath)
    assert [r["step"] for r in got] == [r["step"] for r in ref] == list(range(iters))
    assert [sorted(r) for r in got] == [["loss", "step"]] * iters
    np.testing.assert_allclose([r["loss"] for r in got], [r["loss"] for r in ref], rtol=1e-8)
    assert [r["loss"] for r in got] == out.result.history.tolist()
    text = capsys.readouterr().out
    assert "extended Kalman engine (O(T), order-10 SDE)" in text
    assert "Ground-truth recovery: corr(decay)=" in text and "corr(sensitivity)=" in text


GUARDS = [
    ["--preset", "dense10k", "--model", "nlfm"],
    ["--preset", "dense10k", "--model", "nlfm", "--mll-engine", "ss", "--ss-shard"],
    ["--preset", "alfi-parity", "--model", "nlfm"],
    ["--preset", "dense10k", "--model", "nlfm", "--mll-engine", "ss", "--stationary-after",
     "8"],
    ["--model", "nlfm", "--shared-kinetics"],
    ["--model", "nlfm", "--num-quad", "2"],
    ["--model", "nlfm", "--mll-engine", "cg"],
]


@pytest.mark.parametrize("argv", GUARDS, ids=lambda a: " ".join(a))
def test_cli_guards_match_jax(argv):
    """Each of the JAX CLI's refusals on the nlfm routes, word for word
    (JAX's ``main`` refuses them before it computes anything)."""
    with pytest.raises(SystemExit) as ref:
        jmain.main(argv)
    with pytest.raises(SystemExit) as got:
        tmain.main(argv + ["--device", "cpu"])
    assert str(got.value) == str(ref.value) and str(ref.value)


def _jax_parser():
    parser = argparse.ArgumentParser(allow_abbrev=False)
    jcfg.add_cli_args(parser)
    return parser


@pytest.mark.parametrize("argv", [
    ["--model", "nlfm"], [], ["--model", "simm2"],
    ["--model", "nlfm", "--response", "sigmoid", "--num-quad", "49", "--num-iters", "7"],
    ["--preset", "dense10k", "--model", "nlfm", "--mll-engine", "ss", "--response", "softplus"],
], ids=lambda a: " ".join(a) or "defaults")
def test_flag_parsing_matches_jax(argv):
    """``--num-iters`` defaults to 2000 on ``--model nlfm`` and 150
    elsewhere; ``--response`` and ``--num-quad`` parse as JAX's; every
    field the two configs share agrees."""
    parser = argparse.ArgumentParser(allow_abbrev=False)
    cfg.add_cli_args(parser)
    got = cfg.config_from_args(parser.parse_args(argv))
    ref = jcfg.config_from_args(_jax_parser().parse_args(argv))
    for name in sorted(set(cfg.RunConfig.__dataclass_fields__)
                       & set(jcfg.RunConfig.__dataclass_fields__)):
        assert getattr(got, name) == getattr(ref, name), name
    want = 7 if "7" in argv else (2000 if "nlfm" in argv else 150)
    assert got.num_iters == want


@pytest.mark.parametrize("argv", [
    ["--model", "nlfm", "--num-iters", "1", "--num-quad", "5"],
    ["--preset", "dense10k", "--model", "nlfm", "--mll-engine", "ss", "--synth-genes", "2",
     "--synth-timepoints", "5", "--num-iters", "1"],
], ids=["p53", "dense10k"])
def test_routes_need_a_card_unless_told_cpu(argv, monkeypatch):
    """Without ``--device`` both routes run on the card, and raise when
    none is visible; nothing falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device is visible"):
        tmain.main(argv)
