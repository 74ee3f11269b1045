"""The port's multi-force state-space engine (``build_multiforce_ssm``,
``multisimm_mll_ss`` and ``multisimm_predict_ss`` in
``dis_project_tpu_torch/ops/statespace.py``), its generator
(``data/synthetic.py``: ``multi_draws`` / ``multi_from_draws``) and
``main.run_dense --model multisimm --mll-engine ss``, held to the JAX
package on the CPU in float64, and to the port's exact multi-force MLL on
the JAX package's test problem.

Tolerances: ``build_multiforce_ssm`` at 1e-12 (its gradient at 1e-10), the MLL at
1e-9 x max(1, |MLL|) and its raw gradients at 1e-8 x max(1, max|g|) on
every schedule, the generator at 1e-12, the dense route's metrics file at
rel 1e-8. Smoothed moments are held at max(1e-9, JAX's own
union-vs-bridge distance on the same inputs), the floor of the first-order
smoother tests (two LAPACK builds' ``eigh`` move the RTS pseudo-solve by
~1e-9-1e-8). The JAX references are compiled at XLA's lowest CPU
optimisation level.
"""

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
from dis_project_tpu.models import multisimm as jmulti
from dis_project_tpu.ops import statespace as jss
from dis_project_tpu_torch import config as cfg
from dis_project_tpu_torch import convert
from dis_project_tpu_torch import main as tmain
from dis_project_tpu_torch.data import synthetic as tsynth
from dis_project_tpu_torch.models import multisimm
from dis_project_tpu_torch.ops import statespace as ss
from dis_project_tpu_torch.ops.precision import pin_full_fp32
from dis_project_tpu_torch.training import generic

F32, F64 = torch.float32, torch.float64
FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


def _jit(fn, **kw):
    return jax.jit(fn, compiler_options=FAST_COMPILE, **kw)


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

def _t(a, dtype=F64):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def _close(got, ref, tol, what):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == np.shape(ref), (what, got.shape, np.shape(ref))
    err = float(np.max(np.abs(got - np.asarray(ref))))
    assert err <= tol, f"{what}: max abs error {err:.3e} > {tol:.3e}"


@pytest.fixture(autouse=True)
def _full_fp32():
    pin_full_fp32()


@functools.lru_cache(maxsize=None)
def _problem(seed=1):
    """The JAX package's multi-force test problem (tests/test_statespace.py,
    TestMultiForceFamily._problem): G = 3, R = 2, sensitivities uniform on
    [0.4, 1.4], lengthscales (1.2, 3.0), decays (0.4, 0.8, 1.2), a 9-point
    grid on [0, 12], normal observations. Returns the JAX params, the
    port's, t, y and the gene-major rows."""
    G, R, T = 3, 2, 9
    p = {k: np.asarray(v) for k, v in jmulti.init_params(G, R, dtype=jnp.float64)._asdict().items()}
    p.update(sensitivity=np.random.default_rng(0).uniform(0.4, 1.4, (G, R)),
             lengthscale=np.array([1.2, 3.0]), decay=np.array([0.4, 0.8, 1.2]))
    t = np.linspace(0.0, 12.0, T)
    y = np.random.default_rng(seed).normal(size=(G * T,))
    X = np.stack([np.tile(t, G), np.repeat(np.arange(G), T).astype(float), np.ones(G * T)], 1)
    jp = jmulti.MultiSIMMParams(**{k: jnp.asarray(v) for k, v in p.items()})
    return jp, convert.multisimm_params_from_numpy(p, device="cpu"), t, y, X


# ---------------------------------------------------------------------------
# The augmented model.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kinds", [("rbf", "rbf"), ("rbf", "matern12", "matern52")],
                         ids=["rbf", "ragged"])
def test_build_multiforce_ssm_matches_jax(kinds):
    """(F, P_inf, P0, h_forces) at 1e-12, and the gradient of a weighted
    sum of F and P_inf in decay, S and the lengthscales against jax.grad at
    1e-10, all-RBF (order 8) and with ragged force blocks (R = 3)."""
    R = len(kinds)
    rng = np.random.default_rng(R)
    decay, sens = np.array([0.4, 0.8, 1.2]), rng.uniform(0.4, 1.4, (3, R))
    ell = np.linspace(1.0, 3.0, R)
    m = sum(8 if k == "rbf" else {"matern12": 1, "matern32": 2, "matern52": 3}[k]
            for k in kinds) + 3
    w = rng.normal(size=(2, m, m))

    def jfun(d, s, lv):
        f, p_inf, p0, h = jss.build_multiforce_ssm(d, s, lv, order=8, force_kernels=kinds)
        return (f, p_inf, p0, h), jnp.sum(w[0] * f) + jnp.sum(w[1] * p_inf)

    def jall(d, s, lv):
        out, _ = jfun(d, s, lv)
        return out, jax.grad(lambda *a: jfun(*a)[1], argnums=(0, 1, 2))(d, s, lv)

    ref, ref_g = _jit(jall)(jnp.asarray(decay), jnp.asarray(sens), jnp.asarray(ell))
    leaves = [_t(decay).requires_grad_(), _t(sens).requires_grad_(), _t(ell).requires_grad_()]
    got = ss.build_multiforce_ssm(*leaves, order=8, force_kernels=kinds)
    for name, g_, r_ in zip(("F", "P_inf", "P0", "h_forces"), got, ref):
        _close(g_, r_, 1e-12, name)
    loss = torch.sum(_t(w[0]) * got[0]) + torch.sum(_t(w[1]) * got[1])
    for name, g_, r_ in zip(("decay", "S", "l"), torch.autograd.grad(loss, leaves), ref_g):
        _close(g_, r_, 1e-10 * max(1.0, float(np.abs(np.asarray(r_)).max())), name)


def test_build_multiforce_ssm_refuses_a_kernel_count_mismatch():
    _, tp, _, _, _ = _problem()
    with pytest.raises(ValueError, match="3 entries for 2 forces"):
        ss.build_multiforce_ssm(tp.decay, tp.sensitivity, tp.lengthscale,
                                force_kernels=("rbf",) * 3)


def test_stationary_covariance_is_lyapunov_consistent():
    """F P_inf + P_inf F^T vanishes outside the force blocks and is
    negative semi-definite on them; P_inf is symmetric PSD; one force
    reduces to ``build_lfm_ssm`` within 1e-14."""
    _, tp, _, _, _ = _problem()
    f, p_inf, _, h = ss.build_multiforce_ssm(tp.decay, tp.sensitivity, tp.lengthscale, order=8)
    resid = (f @ p_inf + p_inf @ f.T).numpy()
    assert np.abs(resid[16:, :]).max() < 1e-12 and np.abs(resid[:, 16:]).max() < 1e-12
    assert np.linalg.eigvalsh(-resid[:16, :16]).min() > -1e-10
    assert float((p_inf - p_inf.T).abs().max()) < 1e-14
    assert float(torch.linalg.eigvalsh(p_inf).min()) > -1e-10
    one = ss.build_multiforce_ssm(tp.decay, tp.sensitivity[:, :1], tp.lengthscale[:1], order=8)
    ref = ss.build_lfm_ssm(tp.decay, tp.sensitivity[:, 0], tp.lengthscale[0], order=8)
    for a, b in zip(one, (ref[0], ref[1], ref[2], ref[3][None, :])):
        _close(a, b.numpy(), 1e-14, "R = 1")


# ---------------------------------------------------------------------------
# The MLL.
# ---------------------------------------------------------------------------


CASES = {
    "sequential": dict(parallel=False),
    "associative": dict(parallel=True),
    "blocked": dict(parallel="blocked"),
    "blocked L=8": dict(parallel=8),
    "stationary_after": dict(parallel=False, stationary_after=4),
    "obs_mask": dict(parallel=False, mask=True),
}


def _case_inputs(case):
    """The keyword arguments and observations of one case (the obs_mask
    case NaN-masks a quarter of y)."""
    kw = dict(CASES[case])
    _, _, _, y, _ = _problem()
    if kw.pop("mask", False):
        mask = (np.random.default_rng(3).uniform(size=y.shape) > 0.25).astype(float)
        y = np.where(mask > 0, y, np.nan)
        kw["obs_mask"] = mask
    return kw, y


@pytest.fixture(scope="module")
def mll_refs():
    """JAX's MLL and raw gradient for every case, in one compiled program."""
    jp, _, t, _, _ = _problem()

    def all_cases(r):
        out = {}
        for case in CASES:
            kw, y = _case_inputs(case)
            out[case] = jax.value_and_grad(lambda r: jss.multisimm_mll_ss(
                jmulti.constrain(r), jnp.asarray(t), jnp.asarray(y), jitter=1e-4, **kw))(r)
        return out

    return _jit(all_cases)(jmulti.unconstrain(jp))


@pytest.mark.parametrize("case", list(CASES))
def test_multisimm_mll_ss_matches_jax(case, mll_refs):
    """The MLL at 1e-9 x max(1, |MLL|) and its raw gradients at
    1e-8 x max(1, max|g|), under each schedule, the frozen-gain tail and a
    NaN-masked obs_mask."""
    kw, y = _case_inputs(case)
    _, _, t, _, _ = _problem()
    ref, ref_g = mll_refs[case]
    raw = convert.multisimm_params_from_numpy(
        jax.tree.map(np.asarray, jmulti.unconstrain(_problem()[0]))._asdict(), device="cpu")
    tkw = {k: (_t(v) if k == "obs_mask" else v) for k, v in kw.items()}
    loss, grads = generic.value_and_grad(
        lambda r: ss.multisimm_mll_ss(multisimm.constrain(r), _t(t), _t(y), jitter=1e-4, **tkw),
        raw)
    assert abs(float(loss) - float(ref)) <= 1e-9 * max(1.0, abs(float(ref)))
    scale = max(1.0, max(float(np.abs(np.asarray(v)).max()) for v in ref_g))
    for name in raw._fields:
        _close(getattr(grads, name), getattr(ref_g, name), 1e-8 * scale, name)


def test_multisimm_mll_ss_float32_and_shard():
    """float32 within rel 1e-4 of float64; ``shard=`` refused as not yet
    ported."""
    _, tp, t, y, _ = _problem()
    l64 = float(ss.multisimm_mll_ss(tp, _t(t), _t(y), jitter=1e-4, parallel=False))
    p32 = type(tp)(*(v.float() for v in tp))
    l32 = ss.multisimm_mll_ss(p32, _t(t, F32), _t(y, F32), jitter=1e-4, parallel=False)
    assert l32.dtype == F32 and abs(float(l32) - l64) <= 1e-4 * abs(l64)
    with pytest.raises(NotImplementedError, match="item 17"):
        ss.multisimm_mll_ss(tp, _t(t), _t(y), jitter=1e-4, shard=("mesh", "t"))


def test_mll_ss_matches_the_exact_multiforce_mll():
    """The JAX package's tolerances against ``ExactMultiSIMM.mll`` (the
    port's): orders 8 / 10 within 2e-3 / 5e-4, the error falling; the
    raw gradients of the order-10 MLL within 1e-2 relative."""
    _, tp, t, y, X = _problem()
    model = multisimm.ExactMultiSIMM(num_genes=3, num_forces=2, jitter=1e-4)
    exact = float(model.mll(tp, _t(X), _t(y)))
    prev = np.inf
    for order, tol in ((8, 2e-3), (10, 5e-4)):
        err = abs(float(ss.multisimm_mll_ss(tp, _t(t), _t(y), jitter=1e-4, order=order,
                                            parallel=False)) - exact)
        assert err < tol and err < prev + 1e-12, (order, err)
        prev = err
    raw = multisimm.unconstrain(tp)
    _, g_ss = generic.value_and_grad(lambda r: ss.multisimm_mll_ss(
        multisimm.constrain(r), _t(t), _t(y), jitter=1e-4, parallel=False), raw)
    _, g_ex = generic.value_and_grad(lambda r: model.mll(multisimm.constrain(r), _t(X), _t(y)),
                                     raw)
    for name in raw._fields:
        a, b = getattr(g_ss, name).numpy(), getattr(g_ex, name).numpy()
        assert np.abs(a - b).max() / (np.abs(b).max() + 1e-12) < 1e-2, name


# ---------------------------------------------------------------------------
# Smoothing.
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def predict_case():
    """JAX's union and bridge predictions with per-entry noise variances in
    [1e-3, 1e-2] and mixed priors (RBF and Matern-3/2), and the floor."""
    jp, tp, t, y, _ = _problem()
    tt = np.linspace(0.0, 13.0, 40)
    nv = np.random.default_rng(4).uniform(1e-3, 1e-2, size=(9, 3))
    kinds = ("rbf", "matern32")

    def both(p):
        return {interp: jss.multisimm_predict_ss(
            p, jnp.asarray(t), jnp.asarray(y), jnp.asarray(tt), noise_var=jnp.asarray(nv),
            order=10, force_kernels=kinds, interp=interp) for interp in ("union", "bridge")}

    ref = {k: [np.asarray(a) for a in v] for k, v in _jit(both)(jp).items()}
    floor = [max(1e-9, float(np.abs(u - b).max())) for u, b in zip(ref["union"], ref["bridge"])]
    return tp, t, y, tt, nv, kinds, ref, floor


@pytest.mark.parametrize("interp", ["union", "bridge"])
def test_multisimm_predict_ss_matches_jax(predict_case, interp):
    tp, t, y, tt, nv, kinds, ref, floor = predict_case
    got = ss.multisimm_predict_ss(tp, _t(t), _t(y), _t(tt), noise_var=_t(nv), order=10,
                                  force_kernels=kinds, interp=interp)
    assert tuple(got[0].shape) == (2, 40) and tuple(got[2].shape) == (40, 3)
    for name, g_, r_, tol in zip(("f_mean", "f_var", "x_mean", "x_var"), got, ref[interp], floor):
        _close(g_, r_, tol, f"{interp} {name}")


def test_multisimm_predict_ss_matches_the_dense_latent_posterior():
    """Both forces in one pass against ``ExactMultiSIMM.latent_predict``
    at order 12 (the JAX package's test): mean and variance within 3e-3."""
    _, tp, t, y, X = _problem()
    tt = np.linspace(0.0, 13.0, 40)
    model = multisimm.ExactMultiSIMM(num_genes=3, num_forces=2, jitter=1e-4)
    f_mean, f_var, x_mean, x_var = ss.multisimm_predict_ss(tp, _t(t), _t(y), _t(tt),
                                                           noise_var=1e-3 + 1e-4, order=12)
    for r in range(2):
        post = model.latent_predict(tp, multisimm.force_rows(_t(tt), r), _t(X), _t(y),
                                    _t(np.full(27, 1e-3)))
        assert float((post.mean - f_mean[r]).abs().max()) < 3e-3
        assert float((torch.diagonal(post.cov) - f_var[r]).abs().max()) < 3e-3
    assert float(f_var.min()) > 0.0
    assert bool(torch.isfinite(x_mean).all()) and bool((x_var >= 0).all())


# ---------------------------------------------------------------------------
# The generator and the dense route.
# ---------------------------------------------------------------------------


def _jax_multi(G, T, R, seed=0, oversample=4, dtype=jnp.float64):
    """JAX's ``generate_ode_multi`` and the draws it made (its key split)."""
    scfg = jsynth.SyntheticConfig(num_genes=G, num_timepoints=T, num_replicates=1,
                                  noise_std=0.1)
    key = jax.random.PRNGKey(seed)
    data = jsynth.generate_ode_multi(key, scfg, num_forces=R, oversample=oversample, dtype=dtype)
    _, _, kf, kn = jax.random.split(key, 4)
    eps = np.asarray(jax.random.normal(kf, (R, (T - 1) * oversample + 1), jnp.float32))
    noise = np.asarray(jax.random.normal(kn, (1, G, T), jnp.float32))
    return scfg, data, eps, noise


@pytest.mark.parametrize("R", [1, 3])
def test_multi_from_draws_with_jax_draws_matches_generate_ode_multi(R):
    """Expressions and f_true (R, T) within 1e-12, variances and every
    ground-truth parameter exactly, the grid within 1e-14 (``torch.linspace``
    and ``jnp.linspace`` round differently)."""
    scfg, ref, eps, noise = _jax_multi(4, 12, R)
    pt = ref.params_true
    cfg_t = tsynth.SyntheticConfig(num_genes=4, num_timepoints=12, num_replicates=1,
                                   noise_std=0.1)
    got = tsynth.multi_from_draws(np.asarray(pt["basal"]), np.asarray(pt["decay"]),
                                  np.asarray(pt["sensitivity"]), eps, noise, cfg_t, oversample=4)
    _close(got.gene_expressions, ref.gene_expressions, 1e-12, "expressions")
    _close(got.f_true, ref.f_true, 1e-12, "f_true")
    _close(got.gene_variances, ref.gene_variances, 0.0, "variances")
    _close(got.timepoints, ref.timepoints, 1e-14, "timepoints")
    for k in ("basal", "sensitivity", "decay", "lengthscale"):
        _close(got.params_true[k], pt[k], 0.0, k)


def test_generate_ode_multi_draws_from_the_generator():
    """One seed gives one dataset; the draws have the documented shapes."""
    scfg = tsynth.SyntheticConfig(num_genes=3, num_timepoints=6, num_replicates=2)
    a = tsynth.generate_ode_multi(torch.Generator().manual_seed(3), scfg, num_forces=2,
                                  oversample=2, device="cpu")
    b = tsynth.generate_ode_multi(torch.Generator().manual_seed(3), scfg, num_forces=2,
                                  oversample=2, device="cpu")
    assert torch.equal(a.gene_expressions, b.gene_expressions)
    assert tuple(a.gene_expressions.shape) == (2, 3, 6) and tuple(a.f_true.shape) == (2, 6)
    assert tuple(a.params_true["sensitivity"].shape) == (3, 2)
    draws = tsynth.multi_draws(torch.Generator().manual_seed(3), scfg, 2, 2)
    assert [tuple(d.shape) for d in draws] == [(3,), (3,), (3, 2), (2, 11), (2, 3, 6)]


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_run_dense_multiforce_matches_jax(tmp_path, monkeypatch, capsys):
    """``run_dense --model multisimm --mll-engine ss`` at 6 x 30, R = 2,
    5 Adam steps, on JAX's ``generate_ode_multi`` data: the metrics file
    within rel 1e-8 of the one JAX's own route writes, and equal to the
    run's history; the matched recovery line printed."""
    G, T, iters = 6, 30, 5
    jpath, tpath = tmp_path / "jax.jsonl", tmp_path / "port.jsonl"
    _fast_jit(monkeypatch)
    jmain.run_dense(jcfg.RunConfig(
        preset="dense10k", model="multisimm", synth_genes=G, synth_timepoints=T,
        num_iters=iters, mll_engine="ss", metrics_path=str(jpath)))
    _, jdata, _, _ = _jax_multi(G, T, 2)

    def jax_data(genes, timepoints, num_forces, seed, dtype, device):
        return tsynth.SyntheticLFMData(
            _t(jdata.timepoints, dtype), _t(jdata.gene_expressions, dtype),
            _t(jdata.gene_variances, dtype),
            {k: _t(v) for k, v in jdata.params_true.items()}, _t(jdata.f_true, dtype))

    monkeypatch.setattr(tmain, "synthetic_multi_data", jax_data)
    out = tmain.run_dense(cfg.RunConfig(
        preset="dense10k", model="multisimm", synth_genes=G, synth_timepoints=T,
        num_iters=iters, device="cpu", mll_engine="ss", metrics_path=str(tpath)))
    ref, got = _records(jpath), _records(tpath)
    assert [r["step"] for r in got] == [r["step"] for r in ref] == list(range(iters))
    assert [sorted(r) for r in got] == [["loss", "step"]] * iters
    np.testing.assert_allclose([r["loss"] for r in got], [r["loss"] for r in ref], rtol=1e-8)
    assert [r["loss"] for r in got] == out.result.history.tolist()
    assert "corr(S[:,0])" in capsys.readouterr().out and len(out.ss_stats) == iters


def test_matched_force_correlations_pairs_each_force_once():
    """The greedy matching takes the largest |corr| first, each true column
    once: swapped columns are matched back."""
    rng = np.random.default_rng(0)
    s_true = rng.uniform(size=(8, 3))
    corr = tmain.matched_force_correlations(s_true[:, [2, 0, 1]], s_true)
    np.testing.assert_allclose(corr, [1.0, 1.0, 1.0])
