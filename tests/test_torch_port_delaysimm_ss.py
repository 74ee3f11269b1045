"""The port's delayed-response state-space engine (``_delay_event_grid``,
``delaysimm_mll_ss``, ``_scalar_obs_filter_ll`` and ``delaysimm_predict_ss``
in ``dis_project_tpu_torch/ops/statespace.py``), its generator
(``data/synthetic.py``: ``delay_draws`` / ``delay_from_draws``) and
``main.run_dense --model delaysimm --mll-engine ss``, held to the JAX package
on the CPU in float64, and to the port's exact delayed MLL on the JAX
package's test problem.

Tolerances: the event grid exactly; the MLL at 1e-9 x max(1, |MLL|) and
its raw gradients (the delays' included) at 1e-8 x max(1, max|g|) on the
scalar route and on every masked schedule; the scalar route against the
masked one at the JAX package's 1e-9 (value) and 1e-8 x (max|g| + 1) per
gradient leaf; the smoothed moments at 5e-9 from t = 2 on and at 5e-8
near t = 0, where a run of zero steps meets the RTS pseudo-solve's cutoff
(two LAPACK builds' ``eigh`` move it by ~1e-9-1e-8); the generator at 1e-12; the
dense route's metrics file at rel 1e-8. The JAX references are compiled at
XLA's lowest CPU optimisation level.
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
from dis_project_tpu.models import delaysimm as jdelay
from dis_project_tpu.ops import statespace as jss
from dis_project_tpu_torch import config as cfg
from dis_project_tpu_torch import convert
from dis_project_tpu_torch import main as tmain
from dis_project_tpu_torch.data import synthetic as tsynth
from dis_project_tpu_torch.models import delaysimm, simm
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
    return torch.as_tensor(np.array(a), dtype=dtype)


def _close(got, ref, tol, what):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == np.shape(ref), (what, got.shape, np.shape(ref))
    err = float(np.max(np.abs(got - np.asarray(ref))))
    assert err <= tol, f"{what}: max abs error {err:.3e} > {tol:.3e}"


@pytest.fixture(autouse=True)
def _full_fp32():
    pin_full_fp32()


@functools.lru_cache(maxsize=None)
def _problem():
    """The JAX package's delay test problem (tests/test_statespace.py,
    TestDelayFamily.problem): G = 3 on a 9-point grid over [0, 12], delays
    (0.5, 0, 1.3), decays (0.4, 0.9, 0.6), S (1, 0.8, 1.2). Returns the
    JAX params, the port's, t, y and the gene-major rows."""
    G, T = 3, 9
    t = np.linspace(0.0, 12.0, T)
    y = np.random.default_rng(5).normal(size=(G * T,))
    p = {k: np.asarray(v) for k, v in jdelay.init_params(G, dtype=jnp.float64)._asdict().items()}
    p.update(delay=np.array([0.5, 0.0, 1.3]), decay=np.array([0.4, 0.9, 0.6]),
             sensitivity=np.array([1.0, 0.8, 1.2]))
    X = np.stack([np.tile(t, G), np.repeat(np.arange(G), T).astype(float), np.ones(G * T)], 1)
    jp = jdelay.DelaySIMMParams(**{k: jnp.asarray(v) for k, v in p.items()})
    return jp, convert.delaysimm_params_from_numpy(p, device="cpu"), t, y, X


def test_delay_event_grid_matches_jax_with_ties():
    """Sorted warped times, timepoint indices, one-gene selectors and the
    permutation exactly JAX's, two replicates, with ties: eight events
    clamped to t = 0 over the first three times and two genes sharing a
    delay."""
    t = np.array([0.0, 0.4, 1.0, 2.5, 4.0])
    delay = np.array([0.6, 0.0, 0.6, 1.5])
    jp = jdelay.init_params(4, dtype=jnp.float64)._replace(delay=jnp.asarray(delay))
    ref = [np.asarray(a) for a in jss._delay_event_grid(jp, jnp.asarray(t), 2)]
    got = ss._delay_event_grid(delaysimm.init_params(4)._replace(delay=_t(delay)), _t(t), 2)
    for name, g_, r_ in zip(("ev_t", "step_ids", "gene_sel", "order_idx"), got, ref):
        assert np.array_equal(g_.numpy(), r_), name
    assert int((got[0] == 0).sum()) == 8


CASES = {
    "scalar": dict(parallel=False),
    "associative": dict(parallel=True),
    "blocked": dict(parallel="blocked"),
    "masked sequential": dict(parallel=False, mask=True),
}


def _case_inputs(case):
    """The keyword arguments and observations of one case (the masked case
    NaN-masks a quarter of y)."""
    kw = dict(CASES[case])
    _, _, _, y, _ = _problem()
    if kw.pop("mask", False):
        mask = (np.random.default_rng(3).uniform(size=y.shape) > 0.25).astype(float)
        y = np.where(mask > 0, y, np.nan)
        kw["obs_mask"] = mask
    return kw, y


@pytest.fixture(scope="module")
def mll_refs():
    """JAX's MLL and raw gradient for every case at delays (0.5, 0.05,
    1.3), in one compiled program; and the raw point."""
    jp, _, t, _, _ = _problem()
    jraw = jdelay.unconstrain(jp._replace(delay=jnp.asarray([0.5, 0.05, 1.3])))

    def all_cases(r):
        out = {}
        for case in CASES:
            kw, y = _case_inputs(case)
            out[case] = jax.value_and_grad(lambda r: jss.delaysimm_mll_ss(
                jdelay.constrain(r), jnp.asarray(t), jnp.asarray(y), jitter=1e-4, order=8,
                **kw))(r)
        return out

    return _jit(all_cases)(jraw), jraw


@pytest.mark.parametrize("case", list(CASES))
def test_delaysimm_mll_ss_matches_jax(case, mll_refs):
    """Value at 1e-9 x max(1, |MLL|) and raw gradients, the delays'
    included, at 1e-8 x max(1, max|g|): the scalar route (sequential, no
    obs_mask), the masked chain under the associative and blocked
    schedules, and the masked sequential chain with a NaN-masked
    obs_mask."""
    refs, jraw = mll_refs
    ref, ref_g = refs[case]
    kw, y = _case_inputs(case)
    _, _, t, _, _ = _problem()
    raw = convert.delaysimm_params_from_numpy(jax.tree.map(np.asarray, jraw)._asdict(),
                                              device="cpu")
    tkw = {k: (_t(v) if k == "obs_mask" else v) for k, v in kw.items()}
    loss, grads = generic.value_and_grad(
        lambda r: ss.delaysimm_mll_ss(delaysimm.constrain(r), _t(t), _t(y), jitter=1e-4,
                                      order=8, **tkw), raw)
    assert abs(float(loss) - float(ref)) <= 1e-9 * max(1.0, abs(float(ref)))
    scale = max(1.0, max(float(np.abs(np.asarray(v)).max()) for v in ref_g))
    for name in raw._fields:
        _close(getattr(grads, name), getattr(ref_g, name), 1e-8 * scale, name)


def test_scalar_route_equals_the_masked_route():
    """The JAX package's test on its own problem (G = 4, T = 11 from 0.3,
    y + 1): the scalar event chain against the masked associative one at
    1e-9 on the value and 1e-8 x (max|g| + 1) on every gradient leaf, the
    delays included; the masked sequential chain (a one-entry obs_mask)
    too."""
    rng = np.random.default_rng(3)
    t = _t(np.linspace(0.3, 12.0, 11))
    params = delaysimm.init_params(4)._replace(delay=_t([0.0, 0.4, 0.9, 0.2]))
    y = _t(rng.normal(size=44) + 1.0)
    raw = delaysimm.unconstrain(params._replace(delay=_t([1e-3, 0.4, 0.9, 0.2])))

    def vg(**kw):
        return generic.value_and_grad(lambda r: ss.delaysimm_mll_ss(
            delaysimm.constrain(r), t, y, jitter=1e-4, order=8, **kw), raw)

    v_sc, g_sc = vg(parallel=False)
    for kw in (dict(parallel=True), dict(parallel=False, obs_mask=torch.ones(44, dtype=F64))):
        v_dn, g_dn = vg(**kw)
        assert abs(float(v_sc) - float(v_dn)) < 1e-9
        for name in raw._fields:
            a, b = getattr(g_sc, name), getattr(g_dn, name)
            assert float((a - b).abs().max()) < 1e-8 * (float(a.abs().max()) + 1.0), name


def test_mll_ss_matches_the_exact_delayed_mll_and_reduces_at_zero_delay():
    """Against the port's ``ExactDelaySIMM.mll``: orders 8 / 12 within
    5e-3 / 2e-4, the error falling; the order-12 raw gradients, delays
    included, within 5e-4 x (max|g| + 1); with every delay 0 equal to
    ``lfm_mll_ss`` within 1e-9 x max(1, |MLL|); ``shard=`` refused."""
    _, tp, t, y, X = _problem()
    tp = tp._replace(delay=_t([0.5, 0.05, 1.3]))
    model = delaysimm.ExactDelaySIMM(num_genes=3, jitter=1e-4)
    dense = float(model.mll(tp, _t(X), _t(y)))
    errs = [abs(dense - float(ss.delaysimm_mll_ss(tp, _t(t), _t(y), jitter=1e-4, order=o,
                                                   parallel=False))) for o in (8, 12)]
    assert errs[0] < 5e-3 and errs[1] < 2e-4 and errs[1] < errs[0]
    raw = delaysimm.unconstrain(tp)
    _, gd = generic.value_and_grad(lambda r: model.mll(delaysimm.constrain(r), _t(X), _t(y)),
                                   raw)
    _, gs = generic.value_and_grad(lambda r: ss.delaysimm_mll_ss(
        delaysimm.constrain(r), _t(t), _t(y), jitter=1e-4, order=12, parallel=False), raw)
    for name in raw._fields:
        a, b = getattr(gd, name), getattr(gs, name)
        assert float((a - b).abs().max()) < 5e-4 * (float(a.abs().max()) + 1.0), name
    p0 = tp._replace(delay=torch.zeros(3, dtype=F64))
    v1 = float(ss.lfm_mll_ss(simm.SIMMParams(*p0[:5]), _t(t), _t(y), jitter=1e-4, parallel=False))
    v2 = float(ss.delaysimm_mll_ss(p0, _t(t), _t(y), jitter=1e-4, parallel=False))
    assert abs(v1 - v2) < 1e-9 * max(1.0, abs(v1))
    with pytest.raises(NotImplementedError, match="item 17"):
        ss.delaysimm_mll_ss(tp, _t(t), _t(y), jitter=1e-4, shard=("mesh", "t"))


@pytest.mark.parametrize("parallel", [False, "blocked"], ids=["sequential", "blocked"])
def test_delaysimm_predict_ss_matches_jax(parallel):
    """Force and gene posteriors at 20 test times with per-entry noise
    variances, against JAX's under the same schedule: within 5e-8 at every
    time, and within 5e-9 from t = 2 on. The looser limit is the RTS
    pseudo-solve's ``eigh`` noise at the first events, where genes clamped
    to t = 0 and the reads at t = 0 make a run of zero steps (its cutoff
    acts there; JAX's own sequential and blocked pairs differ by ~3e-9)."""
    jp, tp, t, y, _ = _problem()
    tt = np.linspace(0.0, 13.0, 20)
    nv = np.random.default_rng(4).uniform(1e-3, 1e-2, size=(9, 3))
    ref = _jit(lambda p: jss.delaysimm_predict_ss(
        p, jnp.asarray(t), jnp.asarray(y), jnp.asarray(tt), noise_var=jnp.asarray(nv), order=10,
        parallel=parallel))(jp)
    got = ss.delaysimm_predict_ss(tp, _t(t), _t(y), _t(tt), noise_var=_t(nv), order=10,
                                  parallel=parallel)
    assert tuple(got[0].shape) == (20,) and tuple(got[2].shape) == (20, 3)
    late = tt >= 2.0
    for name, g_, r_ in zip(("f_mean", "f_var", "x_mean", "x_var"), got, ref):
        _close(g_, r_, 5e-8, name)
        _close(g_[late], np.asarray(r_)[late], 5e-9, f"{name} from t = 2")


def test_delaysimm_predict_ss_matches_the_dense_posteriors():
    """The JAX package's check against the port's ``ExactDelaySIMM``: the
    smoothed force's correlation with ``latent_predict``'s mean > 0.9999,
    the gene means within 1e-3 of ``multi_gene_predict``'s (noise
    conventions matched per path), variances positive."""
    _, tp, t, y, X = _problem()
    model = delaysimm.ExactDelaySIMM(num_genes=3, jitter=1e-4)
    tt = np.linspace(0.0, 13.0, 20)
    rows = _t(np.stack([tt, -np.ones(20), np.zeros(20)], axis=1))
    var_pp = _t(np.full(27, 1e-3 - 1e-4))
    post = model.latent_predict(tp, rows, _t(X), _t(y), var_pp)
    fm, fv, _, _ = ss.delaysimm_predict_ss(tp, _t(t), _t(y), _t(tt), noise_var=1e-3, order=12,
                                           parallel=False)
    assert np.corrcoef(post.mean.numpy(), fm.numpy())[0, 1] > 0.9999 and float(fv.min()) > 0
    grows = _t(np.stack([np.tile(tt, 3), np.repeat(np.arange(3.0), 20), np.ones(60)], axis=1))
    gpost = model.multi_gene_predict(tp, grows, _t(X), _t(y), var_pp)
    _, _, xm, xv = ss.delaysimm_predict_ss(tp, _t(t), _t(y), _t(tt), noise_var=1e-3 + 1.0,
                                           order=12, parallel=False)
    assert float((gpost.mean.reshape(3, 20).T - xm).abs().max()) < 1e-3
    assert float(xv.min()) >= 0.0


# ---------------------------------------------------------------------------
# The generator and the dense route.
# ---------------------------------------------------------------------------


def _jax_delay(G, T, seed=0, oversample=4):
    """JAX's ``generate_ode_delay`` and the draws it made (its key split and
    its off-stream delay key)."""
    scfg = jsynth.SyntheticConfig(num_genes=G, num_timepoints=T, num_replicates=1,
                                  noise_std=0.1)
    key = jax.random.PRNGKey(seed)
    data = jsynth.generate_ode_delay(key, scfg, oversample=oversample, dtype=jnp.float64)
    _, kf, kn = jax.random.split(key, 3)
    eps = np.asarray(jax.random.normal(kf, ((T - 1) * oversample + 1,), jnp.float32))
    noise = np.asarray(jax.random.normal(kn, (1, G, T), jnp.float32))
    return data, eps, noise


def test_delay_from_draws_with_jax_draws_matches_generate_ode_delay():
    """Expressions and f_true within 1e-12, the ground truth exactly (gene
    0's delay 0), the grid within 1e-14."""
    ref, eps, noise = _jax_delay(5, 12)
    pt = ref.params_true
    cfg_t = tsynth.SyntheticConfig(num_genes=5, num_timepoints=12, num_replicates=1,
                                   noise_std=0.1)
    got = tsynth.delay_from_draws(*(np.asarray(pt[k]) for k in ("basal", "sensitivity", "decay")),
                                  eps, noise, np.asarray(pt["delay"]), cfg_t, oversample=4)
    _close(got.gene_expressions, ref.gene_expressions, 1e-12, "expressions")
    _close(got.f_true, ref.f_true, 1e-12, "f_true")
    _close(got.timepoints, ref.timepoints, 1e-14, "timepoints")
    for k in ("basal", "sensitivity", "decay", "lengthscale", "delay"):
        _close(got.params_true[k], pt[k], 0.0, k)
    assert float(got.params_true["delay"][0]) == 0.0


def test_generate_ode_delay_draws_from_the_generator():
    """One seed gives one dataset; the delays come after every other draw
    (the kinetics, force and noise draws equal ``ode`` draws without them),
    lie in the range, gene 0's pinned to 0."""
    scfg = tsynth.SyntheticConfig(num_genes=4, num_timepoints=6, num_replicates=1)
    a = tsynth.generate_ode_delay(torch.Generator().manual_seed(7), scfg, oversample=2,
                                  device="cpu")
    b = tsynth.generate_ode_delay(torch.Generator().manual_seed(7), scfg, oversample=2,
                                  device="cpu")
    assert torch.equal(a.gene_expressions, b.gene_expressions)
    d = a.params_true["delay"]
    assert float(d[0]) == 0.0 and bool(((d >= 0) & (d < 2)).all())
    draws = tsynth.delay_draws(torch.Generator().manual_seed(7), scfg, 2)
    gen = torch.Generator().manual_seed(7)
    k = tsynth._sample_kinetics(gen, scfg, F64)
    assert torch.equal(draws[0], k["basal"]) and torch.equal(draws[2], k["decay"])
    assert torch.equal(draws[3], torch.randn(11, generator=gen, dtype=F32))


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_run_dense_delay_matches_jax(tmp_path, monkeypatch, capsys):
    """``run_dense --model delaysimm --mll-engine ss`` at 4 x 20, 3 Adam
    steps, on JAX's ``generate_ode_delay`` data: the metrics file within rel
    1e-8 of JAX's own route's, equal to the run's history; gene 0's raw
    delay at -20 after every step; the recovery line printed."""
    G, T, iters = 4, 20, 3
    jpath, tpath = tmp_path / "jax.jsonl", tmp_path / "port.jsonl"
    _fast_jit(monkeypatch)
    jmain.run_dense(jcfg.RunConfig(
        preset="dense10k", model="delaysimm", synth_genes=G, synth_timepoints=T,
        num_iters=iters, mll_engine="ss", metrics_path=str(jpath)))
    jdata, _, _ = _jax_delay(G, T)

    def jax_data(genes, timepoints, seed, dtype, device):
        return tsynth.SyntheticLFMData(
            _t(jdata.timepoints, dtype), _t(jdata.gene_expressions, dtype),
            _t(jdata.gene_variances, dtype),
            {k: _t(v) for k, v in jdata.params_true.items()}, _t(jdata.f_true, dtype))

    monkeypatch.setattr(tmain, "synthetic_delay_data", jax_data)
    out = tmain.run_dense(cfg.RunConfig(
        preset="dense10k", model="delaysimm", synth_genes=G, synth_timepoints=T,
        num_iters=iters, device="cpu", mll_engine="ss", metrics_path=str(tpath)))
    ref, got = _records(jpath), _records(tpath)
    assert [r["step"] for r in got] == [r["step"] for r in ref] == list(range(iters))
    assert [sorted(r) for r in got] == [["loss", "step"]] * iters
    np.testing.assert_allclose([r["loss"] for r in got], [r["loss"] for r in ref], rtol=1e-8)
    assert [r["loss"] for r in got] == out.result.history.tolist()
    assert float(out.result.raw.delay[0]) == delaysimm.ZERO_DELAY_RAW
    assert "corr(delay)=" in capsys.readouterr().out
