"""The port's optimizers, checkpoints and resumable fits
(``training/generic.py``, ``training/checkpoint.py``,
``training/trainer.py``, ``convert.py``) held to the JAX package and optax
on the CPU, float64.

L-BFGS is held to ``optax.lbfgs()`` with equal objective-call counts: on a
Rosenbrock function (the same gradients on both sides) to 1e-8, and on
the p53 fit for 30 iterations, where the two stacks' gradients differ by
~5e-15 relative and the quasi-Newton updates amplify that to ~5e-8 on the
raw parameters by iteration 30 (the same line-search steps at every
iteration): history and parameters to 1e-7, the final loss to 1e-8.
Resume is bitwise.
"""

import importlib.util
import pathlib
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dis_project_tpu.data.dataset import P53Data as JP53Data
from dis_project_tpu.data.dataset import dataset_3d as jdataset_3d
from dis_project_tpu.models import simm as jsimm
from dis_project_tpu.training import trainer as jtr
from dis_project_tpu_torch import convert
from dis_project_tpu_torch import main as tmain
from dis_project_tpu_torch.data.dataset import P53Data, dataset_3d
from dis_project_tpu_torch.models import simm
from dis_project_tpu_torch.training import checkpoint as ckpt
from dis_project_tpu_torch.training import generic
from dis_project_tpu_torch.training import trainer as tr

REPO = pathlib.Path(__file__).resolve().parents[1]
FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _np(tree):
    return {k: np.asarray(v) for k, v in tree._asdict().items()}


def _tree_close(got, ref, rtol):
    for name in got._fields:
        np.testing.assert_allclose(getattr(got, name).detach().numpy(),
                                   np.asarray(getattr(ref, name)), rtol=rtol, err_msg=name)


def _tree_equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.fixture(scope="module")
def p53():
    """Replicate 0 in both packages, canonical gene-major rows."""
    jdata = JP53Data(replicate=0, source="synthetic", seed=0)
    X, y, _ = jdataset_3d(jdata)
    data = P53Data(replicate=0, source="synthetic", seed=0)
    tX, ty, _ = dataset_3d(data, "cpu")
    return (jdata, X, y), (data, tX, ty)


def _jax_fit(X, y, jdata, cfg, model=None, **kw):
    """The JAX trainer's fit, compiled at the fast level; returns
    ``(history, params, raw_params, opt_state, guard_state, param_trace)``."""
    model = model or jsimm.ExactSIMM(num_genes=5, jitter=1e-4)

    def run(p, init_state):
        r = jtr.fit(model, p, X, y, cfg, gridded=(jdata.timepoints, jdata.num_replicates),
                    init_state=init_state, **kw)
        return r.history, r.params, r.raw_params, r.opt_state, r.guard_state, r.param_trace

    init_state = kw.pop("init_state", None)
    return jax.jit(run, compiler_options=FAST_COMPILE)(jsimm.init_params(5), init_state)


@pytest.fixture(scope="module")
def jax150(p53):
    """JAX's canonical 150-step fit with its parameter trace."""
    (jdata, X, y), _ = p53
    return _jax_fit(X, y, jdata, jtr.TrainConfig(track_parameters=True))


def _port_fit(tX, ty, data, cfg, model=None, **kw):
    model = model or simm.ExactSIMM(num_genes=5, jitter=1e-4)
    return tr.fit(model, simm.init_params(5), tX, ty, cfg,
                  gridded=(data.timepoints, data.num_replicates), **kw)


# ---------------------------------------------------------------------------
# L-BFGS, clipping.
# ---------------------------------------------------------------------------


class _P(NamedTuple):
    x: object
    y: object


def _rosenbrock(p, lib):
    x = p.x
    return lib.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1 - x[:-1]) ** 2) + 3.0 * (p.y - 2.0) ** 2


def test_lbfgs_matches_optax_on_rosenbrock():
    calls = {"jax": 0, "port": 0}

    def jloss(p):
        jax.debug.callback(lambda: calls.__setitem__("jax", calls["jax"] + 1))
        return _rosenbrock(p, jnp)

    def tloss(p):
        calls["port"] += 1
        return _rosenbrock(p, torch)

    x0, y0 = np.array([-1.2, 1.0, -0.5, 0.8]), np.array(0.3)
    opt, topt = optax.lbfgs(), generic.LBFGS()
    raw, traw = _P(jnp.asarray(x0), jnp.asarray(y0)), _P(torch.tensor(x0), torch.tensor(y0))
    state, tstate = opt.init(raw), topt.init(traw)

    @jax.jit
    def step(raw, state):
        value, grad = jax.value_and_grad(jloss)(raw)
        updates, state = opt.update(grad, state, raw, value=value, grad=grad, value_fn=jloss)
        return optax.apply_updates(raw, updates), state, value

    hist, thist, steps = [], [], []
    for _ in range(40):
        raw, state, value = step(raw, state)
        tvalue, tgrad = generic.value_and_grad(tloss, traw)
        updates, tstate = topt.update(tgrad, tstate, traw, tvalue, grad=tgrad, value_fn=tloss)
        traw = generic.apply_updates(traw, updates)
        hist.append(float(value))
        thist.append(float(tvalue))
        steps.append((int(state[2].info.num_linesearch_steps), tstate.linesearch_steps))
    assert calls["jax"] == calls["port"] > 40
    assert all(a == b for a, b in steps) and max(a for a, _ in steps) >= 2
    np.testing.assert_allclose(thist, hist, rtol=1e-8)
    for got, ref in zip(traw, raw):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-8)
    assert hist[-1] < 1e-3 * hist[0]


def test_lbfgs_p53_fit_matches_optax(p53):
    """trainer.fit with optimizer='lbfgs', 30 iterations on the p53 route
    (table Gram, step-0 clamp): equal objective calls; the JAX final loss
    is the golden pinned in chip_smoke.py."""
    (jdata, X, y), (data, tX, ty) = p53
    calls = {"jax": 0, "port": 0}

    class JCounting(jsimm.ExactSIMM):
        def mll_replicated(self, *a, **k):
            jax.debug.callback(lambda: calls.__setitem__("jax", calls["jax"] + 1))
            return super().mll_replicated(*a, **k)

    class TCounting(simm.ExactSIMM):
        def mll_replicated(self, *a, **k):
            calls["port"] += 1
            return super().mll_replicated(*a, **k)

    cfg_kw = dict(num_iters=30, optimizer="lbfgs")
    hist, params, *_ = _jax_fit(X, y, jdata, jtr.TrainConfig(**cfg_kw),
                                JCounting(num_genes=5, jitter=1e-4))
    got = _port_fit(tX, ty, data, tr.TrainConfig(**cfg_kw), TCounting(num_genes=5, jitter=1e-4))
    assert calls["jax"] == calls["port"] > 30
    np.testing.assert_allclose(got.history.numpy(), np.asarray(hist), rtol=1e-7)
    _tree_close(got.params, params, rtol=1e-7)
    # The goldens chip_smoke.py holds the card's run to: JAX's evaluation
    # count, first ten losses and final loss (two XLA compilations of the
    # same JAX fit differ by ~2e-9 there).
    smoke = _chip_smoke()
    assert calls["jax"] == smoke.LBFGS30_CALLS
    np.testing.assert_allclose(np.asarray(hist)[:10], smoke.LBFGS30_HISTORY_HEAD, rtol=1e-10)
    assert float(hist[-1]) == pytest.approx(smoke.LBFGS30_FINAL_LOSS, rel=1e-8)
    assert float(got.history[-1]) == pytest.approx(smoke.LBFGS30_FINAL_LOSS, rel=1e-8)


@pytest.mark.parametrize("scale", [0.1, 100.0])
def test_clip_by_global_norm_matches_optax(scale):
    g = {"a": np.array([3.0, -4.0]) * scale, "b": np.array(12.0) * scale}
    ref, _ = optax.clip_by_global_norm(10.0).update({k: jnp.asarray(v) for k, v in g.items()},
                                                     optax.EmptyState())
    got, _ = generic.ClipByGlobalNorm(10.0).update(_P(torch.tensor(g["a"]), torch.tensor(g["b"])),
                                                   ())
    np.testing.assert_allclose(got.x.numpy(), np.asarray(ref["a"]), rtol=1e-15)
    np.testing.assert_allclose(got.y.numpy(), np.asarray(ref["b"]), rtol=1e-15)


def test_chain_clip_adam_matches_optax():
    g = {"a": np.array([30.0, -40.0]), "b": np.array(12.0)}
    p = {"a": np.array([0.5, 0.1]), "b": np.array(-0.2)}
    opt = optax.chain(optax.clip_by_global_norm(10.0), optax.adam(0.01))
    state = opt.init({k: jnp.asarray(v) for k, v in p.items()})
    topt = generic.Chain(generic.ClipByGlobalNorm(10.0), generic.Adam(0.01))
    tstate = topt.init(_P(torch.tensor(p["a"]), torch.tensor(p["b"])))
    for k in range(3):
        gk = {n: v * (k + 1) for n, v in g.items()}
        ref, state = opt.update({n: jnp.asarray(v) for n, v in gk.items()}, state)
        got, tstate = topt.update(_P(torch.tensor(gk["a"]), torch.tensor(gk["b"])), tstate)
        np.testing.assert_allclose(got.x.numpy(), np.asarray(ref["a"]), rtol=1e-14)
        np.testing.assert_allclose(got.y.numpy(), np.asarray(ref["b"]), rtol=1e-14)


def test_make_optimizer():
    assert isinstance(generic.make_optimizer("adam", 0.1), generic.Adam)
    assert isinstance(generic.make_optimizer("lbfgs", 0.1), generic.LBFGS)
    with pytest.raises(ValueError, match="unknown optimizer"):
        generic.make_optimizer("sgd", 0.1)


# ---------------------------------------------------------------------------
# Checkpoints and bitwise resume.
# ---------------------------------------------------------------------------


def test_checkpoint_round_trip_is_bitwise(tmp_path):
    raw = simm.unconstrain(simm.init_params(5))
    tree = {"raw": raw, "opt_state": generic.LBFGS().init(raw), "step": 7, "none": None}
    ckpt.save(tmp_path, tree, step=7)
    ckpt.save(tmp_path, tree, step=12)
    assert ckpt.latest_step(tmp_path) == 12 and ckpt.latest_step(tmp_path / "no") is None
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_12.pt", "step_7.pt"]
    back = ckpt.restore(tmp_path, 7, template=tree)
    assert type(back["raw"]) is type(raw) and _tree_equal(back["raw"], raw)
    assert back["opt_state"].weights_memory == tree["opt_state"].weights_memory
    assert _tree_equal(back["opt_state"].diff_params_memory, tree["opt_state"].diff_params_memory)
    assert back["step"] == 7 and back["none"] is None
    plain = ckpt.restore(tmp_path, 7)
    assert torch.equal(plain["raw"]["decay"], raw.decay)
    with pytest.raises(ValueError, match="structure"):
        ckpt.restore(tmp_path, 7, template={"params": raw, "step": 0})


def _assert_same_run(a, b_hist, b_raw, b_opt, b_guard):
    assert torch.equal(a.history, b_hist)
    assert _tree_equal(a.raw_params, b_raw)
    assert a.opt_state.count == b_opt.count
    assert _tree_equal(a.opt_state.mu, b_opt.mu) and _tree_equal(a.opt_state.nu, b_opt.nu)
    (good_raw, good_opt), streak, count = a.guard_state
    assert _tree_equal(good_raw, b_guard[0][0]) and _tree_equal(good_opt.mu, b_guard[0][1].mu)
    assert (streak, count) == b_guard[1:]


def test_resume_through_a_checkpoint_is_bitwise(p53, tmp_path):
    """150 canonical steps straight through equal 75 steps, a checkpoint
    file and 75 resumed steps: history, raw parameters, Adam moments and
    guard carry."""
    _, (data, tX, ty) = p53
    full = _port_fit(tX, ty, data, tr.TrainConfig())
    half = _port_fit(tX, ty, data, tr.TrainConfig(num_iters=75))
    ckpt.save(tmp_path, {"raw": half.raw_params, "opt_state": half.opt_state, "step": 75,
                         "guard": half.guard_state}, step=75)
    back = ckpt.restore(tmp_path, 75, template={
        "raw": half.raw_params, "opt_state": half.opt_state, "step": 0,
        "guard": half.guard_state})
    rest = _port_fit(tX, ty, data, tr.TrainConfig(num_iters=75),
                     init_state=(back["raw"], back["opt_state"]), step_offset=back["step"],
                     init_guard=back["guard"])
    _assert_same_run(full, torch.cat([half.history, rest.history]), rest.raw_params,
                     rest.opt_state, rest.guard_state)
    assert torch.equal(full.params.decay, rest.params.decay)


def test_fit_checkpointed_is_bitwise_and_resumes(p53, tmp_path):
    _, (data, tX, ty) = p53
    model = simm.ExactSIMM(num_genes=5, jitter=1e-4)
    grid = (data.timepoints, 1)
    full = _port_fit(tX, ty, data, tr.TrainConfig())
    seg = tr.fit_checkpointed(model, simm.init_params(5), tX, ty, tr.TrainConfig(),
                              tmp_path / "a", checkpoint_every=50, gridded=grid)
    assert ckpt.latest_step(tmp_path / "a") == 150
    _assert_same_run(full, seg.history, seg.raw_params, seg.opt_state, seg.guard_state)
    # A run killed after 100 steps, then rerun to 150: resumed from step 100.
    tr.fit_checkpointed(model, simm.init_params(5), tX, ty, tr.TrainConfig(num_iters=100),
                        tmp_path / "b", checkpoint_every=50, gridded=grid)
    rest = tr.fit_checkpointed(model, simm.init_params(5), tX, ty, tr.TrainConfig(),
                               tmp_path / "b", checkpoint_every=50, gridded=grid)
    assert rest.history.shape == (50,)
    assert torch.equal(rest.history, full.history[100:])
    assert _tree_equal(rest.raw_params, full.raw_params)
    # Already complete on entry: nothing trained, the same parameters.
    done = tr.fit_checkpointed(model, simm.init_params(5), tX, ty, tr.TrainConfig(),
                               tmp_path / "b", checkpoint_every=50, gridded=grid)
    assert done.history.shape == (0,) and torch.equal(done.params.decay, full.params.decay)
    # A checkpoint without the guard carry (the older layout) still resumes.
    ckpt.save(tmp_path / "c", {"raw": rest.raw_params, "opt_state": rest.opt_state,
                               "step": 100}, step=100)
    old = tr.fit_checkpointed(model, simm.init_params(5), tX, ty, tr.TrainConfig(),
                              tmp_path / "c", checkpoint_every=50, gridded=grid)
    assert old.history.shape == (50,) and bool(torch.isfinite(old.history).all())


class _PocketSIMM(simm.ExactSIMM):
    """The canonical MLL with a NaN pocket on the trajectory's
    lengthscale (2.600–2.612, crossed near step 15)."""

    def mll_replicated(self, params, *a, **k):
        out = super().mll_replicated(params, *a, **k)
        inside = (params.lengthscale > 2.600) & (params.lengthscale < 2.612)
        return torch.where(inside, torch.full_like(out, float("nan")), out)


def test_segmented_fit_carries_the_guard(p53):
    _, (data, tX, ty) = p53
    model = _PocketSIMM(num_genes=5, jitter=1e-4)
    full = _port_fit(tX, ty, data, tr.TrainConfig(num_iters=40), model)
    fired = full.guard_flags.nonzero().flatten().tolist()
    assert full.guard_count >= 1
    k = fired[0] + 1  # split right after the first guard event
    a = _port_fit(tX, ty, data, tr.TrainConfig(num_iters=k), model)
    b = _port_fit(tX, ty, data, tr.TrainConfig(num_iters=40 - k), model,
                  init_state=(a.raw_params, a.opt_state), step_offset=k,
                  init_guard=a.guard_state)
    assert torch.equal(torch.cat([a.history, b.history]), full.history)
    assert torch.equal(torch.cat([a.guard_flags, b.guard_flags]), full.guard_flags)
    assert _tree_equal(b.raw_params, full.raw_params) and b.guard_state[1:] == full.guard_state[1:]


def test_jax_run_continued_by_the_port(p53, jax150):
    """75 JAX steps, carried across by convert.py (raw parameters, optax's
    Adam state, the guard carry), finished by the port: JAX's 150-step run
    to 1e-9."""
    (jdata, X, y), (data, tX, ty) = p53
    hist150, params150, *_ = jax150
    _, _, raw75, opt75, guard75, _ = _jax_fit(X, y, jdata, jtr.TrainConfig(num_iters=75))
    adam = opt75[0]

    def adam_triple(s):
        return s.count, _np(s.mu), _np(s.nu)

    (g_raw, g_opt), streak, count = guard75
    init_state = (convert.params_from_numpy(_np(raw75), "cpu"),
                  convert.adam_state_from_numpy(*adam_triple(adam), device="cpu"))
    init_guard = convert.guard_from_numpy(_np(g_raw), adam_triple(g_opt[0]), streak, count,
                                          device="cpu")
    assert init_state[1].count == 75 and init_guard[1:] == (0, 0)
    rest = _port_fit(tX, ty, data, tr.TrainConfig(num_iters=75), init_state=init_state,
                     step_offset=75, init_guard=init_guard)
    np.testing.assert_allclose(rest.history.numpy(), np.asarray(hist150)[75:], rtol=1e-9)
    _tree_close(rest.params, params150, rtol=1e-9)


def test_legacy_checkpoint_warm_start(p53, tmp_path, capsys):
    """A ``{params, step}`` checkpoint: the route restores the parameters
    and starts Adam afresh, as the JAX route does (``fit`` from them with a
    fresh optimizer state, which test_jax_run_continued_by_the_port holds
    to JAX)."""
    _, (data, tX, ty) = p53
    p = simm.constrain(_port_fit(tX, ty, data, tr.TrainConfig(num_iters=40)).raw_params)
    ckpt.save(tmp_path, {"params": p, "step": 40}, step=40)
    out = tmain.fit_and_predict(tmain.cfg.RunConfig(
        num_iters=20, device="cpu", checkpoint_dir=str(tmp_path), resume=True))
    assert "legacy checkpoint step 40" in capsys.readouterr().out
    raw = simm.unconstrain(p)
    want = _port_fit(tX, ty, data, tr.TrainConfig(num_iters=20),
                     init_state=(raw, generic.Adam(0.01).init(raw)), step_offset=40)
    assert torch.equal(out.result.history, want.history)
    assert torch.equal(out.result.params.decay, want.params.decay)
    assert ckpt.latest_step(tmp_path) == 60


def test_param_trace_matches_jax(p53, jax150):
    _, (data, tX, ty) = p53
    *_, trace = jax150
    got = _port_fit(tX, ty, data, tr.TrainConfig(track_parameters=True))
    assert got.param_trace.decay.shape == (150, 5)
    for name in got.param_trace._fields:
        np.testing.assert_allclose(getattr(got.param_trace, name).numpy(),
                                   np.asarray(getattr(trace, name)), rtol=0, atol=1e-9,
                                   err_msg=name)
