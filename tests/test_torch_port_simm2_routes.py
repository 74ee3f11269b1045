"""The port's generic training loops (``training/generic.py``: ``fit_loop``,
``fit_checkpointed``, ``LoopResult``) and its ``--model simm2`` routes
(``main.run_second_order`` and ``main.run_dense --model simm2``) held to the
JAX package on the CPU, and the second-order CLI guards with the JAX
package's messages.

The JAX p53 route is run once (module fixture) with its training loop
compiled at XLA's lowest CPU optimisation level and its result captured,
so that one compile serves the route test and the loop test; its
``latent_predict`` is replaced by a stub there (the complex-erf posterior
costs ~20 s to compile, and ``tests/test_torch_port_simm2.py`` holds the
port's ``latent_predict`` to JAX's). The dense routes run JAX's
``generate_ode2`` data through both packages (``main.synthetic_ode2_data``
patched), as ``tests/test_torch_port_faults.py`` does for the first-order
route.
"""

import json
import types
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dis_project_tpu import config as jcfg
from dis_project_tpu import main as jmain
from dis_project_tpu.data import synthetic as jsynth
from dis_project_tpu.models import simm2 as jsimm2
from dis_project_tpu.models.base import Gaussian as JGaussian
from dis_project_tpu.training import generic as jgeneric
from dis_project_tpu_torch import config as cfg
from dis_project_tpu_torch import main as tmain
from dis_project_tpu_torch.data import synthetic as tsynth
from dis_project_tpu_torch.data.dataset import P53Data, train_arrays
from dis_project_tpu_torch.models import simm2
from dis_project_tpu_torch.training import generic

F64 = torch.float64
FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}
ITERS = 10


class _FastJax(types.ModuleType):
    """``jax`` as the JAX package's ``training.generic`` sees it, with its
    top-level ``jax.jit`` compiled at XLA's lowest CPU optimisation level."""

    def __getattr__(self, name):
        return getattr(jax, name)

    @staticmethod
    def jit(fun, **kw):
        return jax.jit(fun, compiler_options=FAST_COMPILE, **kw)


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def _t(a, dtype=F64):
    return torch.as_tensor(np.array(a), dtype=dtype)


@pytest.fixture(scope="module")
def jax_route(tmp_path_factory):
    """JAX's ``run_second_order`` (10 iterations, the metrics file, the
    parameter trace) and the ``LoopResult`` of its ``generic.fit_loop``."""
    tmp = tmp_path_factory.mktemp("jax_simm2")
    captured = {}
    real_fit_loop = jgeneric.fit_loop

    def capture(*args, **kw):
        captured["result"] = real_fit_loop(*args, **kw)
        return captured["result"]

    def stub_latent(self, params, test_rows, x, y, variances):
        n = test_rows.shape[0]
        return JGaussian(mean=jnp.zeros((n,)), cov=jnp.eye(n))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jgeneric, "jax", _FastJax("jax"))
        mp.setattr(jgeneric, "fit_loop", capture)
        mp.setattr(jsimm2.SecondOrderSIMM, "latent_predict", stub_latent)
        params, hist = jmain.run_second_order(jcfg.RunConfig(
            model="simm2", num_iters=ITERS, track_parameters=True,
            metrics_path=str(tmp / "jax.jsonl"), out_dir=str(tmp / "plots")))
    return dict(params=params, history=np.asarray(hist), result=captured["result"],
                metrics=_records(tmp / "jax.jsonl"))


def test_run_second_order_matches_jax(jax_route, tmp_path):
    """The p53 route, 10 iterations, float64: the final loss within rel
    1e-8 of JAX's and the metrics file line by line (steps, keys; loss and
    gradient norm at rel 1e-8); the trained kinetics at rel 1e-8; the
    latent force on the 100-point grid finite."""
    path = tmp_path / "port.jsonl"
    out = tmain.run_second_order(cfg.RunConfig(
        model="simm2", num_iters=ITERS, device="cpu", track_parameters=True,
        metrics_path=str(path), out_dir=str(tmp_path / "plots")))
    final = float(out.result.history[-1])
    assert abs(final - jax_route["history"][-1]) <= 1e-8 * abs(jax_route["history"][-1])
    got, ref = _records(path), jax_route["metrics"]
    assert len(got) == len(ref) == ITERS
    keys = [["grad_norm", "loss", "step"]] * ITERS
    assert [sorted(r) for r in got] == [sorted(r) for r in ref] == keys
    assert [r["step"] for r in got] == [r["step"] for r in ref]
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose([r[key] for r in got], [r[key] for r in ref], rtol=1e-8)
    for name in simm2.SIMM2Params._fields:
        np.testing.assert_allclose(getattr(out.result.params, name).numpy(),
                                   np.asarray(getattr(jax_route["params"], name)), rtol=1e-8)
    assert out.latent.mean.shape == (100,) and bool(torch.isfinite(out.latent.mean).all())
    assert sorted(f.name for f in (tmp_path / "plots").iterdir()) == [
        "lf_simm2.png", "param_trace_simm2.png"]


def _p53_loss():
    data = P53Data(replicate=0, source="synthetic", seed=0)
    X, y, _ = train_arrays(data, "cpu", F64)
    model = simm2.SecondOrderSIMM(num_genes=5, jitter=cfg.EXACT_JITTER)
    raw = simm2.unconstrain(simm2.init_params(5))
    return (lambda r: -model.mll(simm2.constrain(r), X, y)), raw


def test_fit_loop_matches_jax_on_the_simm2_loss(jax_route):
    """10 Adam steps of ``fit_loop`` on the simm2 p53 loss against JAX's
    (the one its route ran): history and gradient norms rel 1e-9, guard
    flags equal, the per-step constrained trace rel 1e-9, the final raw and
    Adam moments rel 1e-9."""
    loss, raw = _p53_loss()
    res = generic.fit_loop(loss, raw, num_iters=ITERS, constrain_fn=simm2.constrain,
                           track_parameters=True)
    ref = jax_route["result"]
    np.testing.assert_allclose(res.history.numpy(), np.asarray(ref.history), rtol=1e-9)
    np.testing.assert_allclose(res.grad_norms.numpy(), np.asarray(ref.grad_norms), rtol=1e-9)
    np.testing.assert_array_equal(res.guard_flags.numpy(), np.asarray(ref.guard_flags))
    assert res.guard_count == ref.guard_count == 0
    for name in simm2.SIMM2Params._fields:
        np.testing.assert_allclose(getattr(res.param_trace, name).numpy(),
                                   np.asarray(getattr(ref.param_trace, name)), rtol=1e-9)
        np.testing.assert_allclose(getattr(res.raw, name).numpy(),
                                   np.asarray(getattr(ref.raw, name)), rtol=1e-9)
    adam = ref.opt_state[0]
    for mine, theirs in ((res.opt_state.mu, adam.mu), (res.opt_state.nu, adam.nu)):
        for leaf, name in zip(mine, simm2.SIMM2Params._fields):
            np.testing.assert_allclose(leaf.numpy(), np.asarray(getattr(theirs, name)),
                                       rtol=1e-9, atol=1e-300)
    assert res.opt_state.count == int(adam.count) == ITERS


class _Pocket(NamedTuple):
    x: object
    z: object


def _pocket_loss(lib):
    """(x - 5)^2 + z^2 with a NaN pocket at 2.3 < x < 2.6 on the way (the
    JAX package's guard test, over a two-leaf tuple)."""
    def loss(r):
        val = (r.x - 5.0) ** 2 + (r.z - 1.0) ** 2
        bad = (r.x > 2.3) & (r.x < 2.6)
        return lib.where(bad, lib.full_like(val, float("nan")), val).sum()
    return loss


def test_fit_loop_guard_matches_jax_through_a_nan_pocket():
    """The guard's backtrack ladder: 60 Adam steps (lr 0.5) through a NaN
    pocket, against JAX's ``generic.fit_loop`` on the same loss: guard flags
    equal, history rel 1e-9, the final raw rel 1e-9."""
    ref = jgeneric.fit_loop(_pocket_loss(jnp), _Pocket(jnp.zeros(()), jnp.zeros((2,))),
                            num_iters=60, learning_rate=0.5)
    res = generic.fit_loop(_pocket_loss(torch), _Pocket(_t(0.0), _t([0.0, 0.0])),
                           num_iters=60, learning_rate=0.5)
    assert res.guard_count == ref.guard_count >= 1
    np.testing.assert_array_equal(res.guard_flags.numpy(), np.asarray(ref.guard_flags))
    np.testing.assert_allclose(res.history.numpy(), np.asarray(ref.history), rtol=1e-9)
    for a, b in zip(res.raw, ref.raw):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-9)


def test_fit_checkpointed_resumed_mid_run_equals_the_unsegmented_run(tmp_path):
    """6 steps with a checkpoint every 4 (segments of 4 and 2), then a new
    call for 10 that resumes from step 6: histories, raw parameters, Adam
    state and guard carry bitwise equal to one unsegmented run; a call on a
    finished directory runs no step."""
    loss, raw = _p53_loss()
    full = generic.fit_loop(loss, raw, num_iters=ITERS, constrain_fn=simm2.constrain,
                            track_parameters=True)
    kw = dict(directory=str(tmp_path), checkpoint_every=4, constrain_fn=simm2.constrain,
              track_parameters=True)
    first = generic.fit_checkpointed(loss, raw, num_iters=6, **kw)
    second = generic.fit_checkpointed(loss, raw, num_iters=ITERS, **kw)
    assert torch.equal(torch.cat([first.history, second.history]), full.history)
    assert torch.equal(torch.cat([first.grad_norms, second.grad_norms]), full.grad_norms)
    assert torch.equal(torch.cat([first.guard_flags, second.guard_flags]), full.guard_flags)
    for name in simm2.SIMM2Params._fields:
        assert torch.equal(getattr(second.raw, name), getattr(full.raw, name))
        assert torch.equal(getattr(second.params, name), getattr(full.params, name))
        assert torch.equal(torch.cat([getattr(first.param_trace, name),
                                      getattr(second.param_trace, name)]),
                           getattr(full.param_trace, name))
    for a, b in zip(second.opt_state.mu + second.opt_state.nu,
                    full.opt_state.mu + full.opt_state.nu):
        assert torch.equal(a, b)
    assert second.opt_state.count == full.opt_state.count
    good, streak, count = second.guard_state
    assert (streak, count) == full.guard_state[1:]
    assert all(torch.equal(a, b) for a, b in zip(good[0], full.guard_state[0][0]))
    done = generic.fit_checkpointed(loss, raw, num_iters=ITERS, **kw)
    assert done.history.numel() == 0
    assert all(torch.equal(a, b) for a, b in zip(done.raw, full.raw))


def test_fit_loop_runs_lbfgs_and_clamp_raw():
    """``'lbfgs'`` takes the loss for its line search; ``clamp_raw``
    projects before the optimizer starts and after every update."""
    loss = _pocket_loss(torch)
    raw = _Pocket(_t(3.0), _t([0.0, 0.0]))
    res = generic.fit_loop(loss, raw, num_iters=5, optimizer="lbfgs")
    assert res.history[-1] < 1e-8 * res.history[0] and abs(float(res.raw.x) - 5.0) < 1e-4
    clamp = lambda r: r._replace(z=torch.clamp(r.z, max=0.25))  # noqa: E731
    res = generic.fit_loop(loss, _Pocket(_t(3.0), _t([0.9, 0.0])), num_iters=3,
                           clamp_raw=clamp, track_parameters=True)
    assert float(res.param_trace.z.max()) <= 0.25 and float(res.raw.z.max()) <= 0.25


@pytest.mark.parametrize("engine", ["cholesky", "ss"])
def test_run_dense_second_order_matches_jax(engine, tmp_path, monkeypatch):
    """``run_dense --model simm2`` at 4 x 20, 10 Adam steps, on JAX's
    ``generate_ode2`` data: the metrics file within rel 1e-8 of the one
    JAX's own route writes, and equal to the run's history."""
    G, T = 4, 20
    jpath, tpath = tmp_path / "jax.jsonl", tmp_path / "port.jsonl"
    jmain.run_dense(jcfg.RunConfig(
        preset="dense10k", model="simm2", synth_genes=G, synth_timepoints=T,
        num_iters=ITERS, mll_engine=engine, metrics_path=str(jpath)))
    scfg = jsynth.SyntheticConfig(num_genes=G, num_timepoints=T, num_replicates=1, noise_std=0.1)
    jdata = jsynth.generate_ode2(jax.random.PRNGKey(0), scfg, oversample=4)

    def jax_data(genes, timepoints, seed, dtype, device):
        return tsynth.SyntheticLFMData(
            _t(jdata.timepoints, dtype), _t(jdata.gene_expressions, dtype),
            _t(jdata.gene_variances, dtype),
            {k: _t(v) for k, v in jdata.params_true.items()}, _t(jdata.f_true, dtype))

    monkeypatch.setattr(tmain, "synthetic_ode2_data", jax_data)
    out = tmain.run_dense(cfg.RunConfig(
        preset="dense10k", model="simm2", synth_genes=G, synth_timepoints=T, num_iters=ITERS,
        device="cpu", mll_engine=engine, metrics_path=str(tpath)))
    ref, got = _records(jpath), _records(tpath)
    assert [r["step"] for r in got] == [r["step"] for r in ref] == list(range(ITERS))
    assert [sorted(r) for r in got] == [["loss", "step"]] * ITERS
    np.testing.assert_allclose([r["loss"] for r in got], [r["loss"] for r in ref], rtol=1e-8)
    assert [r["loss"] for r in got] == out.result.history.tolist()
    assert isinstance(out.result, generic.LoopResult)


def test_run_dense_second_order_ss_reports_its_step():
    """The ss engine prints the state-space step line and keeps each
    step's host times."""
    out = tmain.run_dense(cfg.RunConfig(
        preset="dense10k", model="simm2", synth_genes=3, synth_timepoints=8, num_iters=2,
        device="cpu", mll_engine="ss", force_kernel="matern32"))
    assert len(out.ss_stats) == 2 and all(set(s) == {"forward_host_s", "value_and_grad_host_s"}
                                          for s in out.ss_stats)
    assert np.all(np.isfinite(out.result.history.numpy()))


# ---------------------------------------------------------------------------
# The CLI.
# ---------------------------------------------------------------------------


REFUSALS = [
    ["--model", "simm2", "--preset", "alfi-parity"],
    ["--model", "simm2", "--preset", "p53-replicates"],
    ["--model", "simm2", "--preset", "dense10k", "--mll-engine", "cg"],
    ["--model", "simm2", "--preset", "dense10k", "--mll-engine", "dist"],
    ["--model", "simm2", "--mll-engine", "ss"],
    ["--model", "simm2", "--posterior-samples", "4"],
    ["--model", "simm2", "--preset", "dense10k", "--mll-engine", "ss", "--posterior-samples", "4"],
    ["--model", "simm2", "--force-kernel", "matern32"],
    ["--model", "simm2", "--preset", "dense10k", "--force-kernel", "matern32"],
    ["--model", "simm2", "--preset", "dense10k", "--stationary-after", "8"],
    ["--model", "simm2", "--no-fix-params"],
]


@pytest.mark.parametrize("argv", REFUSALS, ids=lambda a: " ".join(a))
def test_cli_refuses_simm2_combinations_with_jax_messages(argv):
    """Each refusal of the JAX CLI for the second-order family, word for
    word (JAX's ``main`` refuses them before it computes anything)."""
    with pytest.raises(SystemExit) as ref:
        jmain.main(argv)
    with pytest.raises(SystemExit) as got:
        tmain.main(argv + ["--device", "cpu"])
    assert str(got.value) == str(ref.value) and str(ref.value)


NOT_YET_PORTED = {
    "multisimm": (["--preset", "sparse100k", "--dp-shard"],
                  r"--dp-shard \(data-parallel SVI\) is not yet ported"),
}


@pytest.mark.parametrize("model", ["multisimm"])
def test_cli_refuses_the_families_not_yet_ported(model):
    """Of the multi-force family, the sparse route's data-parallel SVI is
    not ported."""
    extra, msg = NOT_YET_PORTED[model]
    with pytest.raises(SystemExit, match=msg):
        tmain.main(["--model", model, *extra, "--device", "cpu"])


@pytest.mark.parametrize("model", ["nlfm", "delaysimm"])
def test_cli_family_posterior_reaches_the_sampler(model, tmp_path, monkeypatch):
    """``--posterior-samples 4`` on the nonlinear and delay families' p53
    routes calls their posterior with JAX's arguments (4 warmup, 4 draws,
    24 leapfrog steps, one chain, --seed + 7)."""
    from test_torch_port_hmc_routes import sampler_call

    monkeypatch.chdir(tmp_path)
    extra = ["--num-quad", "25"] if model == "nlfm" else []
    seen = sampler_call(monkeypatch, ["--model", model, "--posterior-samples", "4",
                                      "--num-iters", "2", *extra])
    assert seen["num_warmup"] == seen["num_samples"] == 4
    assert (seen["num_leapfrog"], seen["num_chains"], seen["seed"]) == (24, 1, 7)


def test_cli_runs_simm2_on_the_cpu(tmp_path, capsys):
    out = tmain.main(["--model", "simm2", "--num-iters", "2", "--device", "cpu", "--out-dir",
                      str(tmp_path)])
    assert isinstance(out, tmain.FamilyRun) and out.result.history.shape == (2,)
    text = capsys.readouterr().out
    assert "Alpha     Omega     Damping   Spring" in text and "Trained 2 iters" in text


@pytest.mark.parametrize("preset", ["p53", "dense10k"])
def test_simm2_routes_need_a_card_unless_given_the_cpu(preset):
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the routes run there")
    with pytest.raises(RuntimeError, match="no CUDA device is visible"):
        if preset == "p53":
            tmain.run_second_order(cfg.RunConfig(model="simm2", num_iters=1))
        else:
            tmain.run_dense(cfg.RunConfig(preset=preset, model="simm2", num_iters=1))
