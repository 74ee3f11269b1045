"""The port's multi-force family (``dis_project_tpu_torch/models/multisimm.py``
and ``main.run_multiforce``) held to the JAX package on the CPU in float64,
its R = 1 reduction to the port's ``ExactSIMM``, and the CLI guards of the
multi-force and delayed-response families with the JAX package's messages.

Tolerances: values at 1e-12 x max(1, max|ref|), raw gradients at 1e-10 x
max(1, max|ref|), the 20-step fit history and gradient norms at rel 1e-9,
the route's metrics file at rel 1e-8. The JAX references are compiled at
XLA's lowest CPU optimisation level, one program per case.
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
from dis_project_tpu.data.dataset import P53Data as JP53Data
from dis_project_tpu.data.dataset import train_arrays as jtrain_arrays
from dis_project_tpu.models import multisimm as jmulti
from dis_project_tpu.reporting import plotter as jplotter
from dis_project_tpu.training import generic as jgeneric
from dis_project_tpu_torch import config as cfg
from dis_project_tpu_torch import convert
from dis_project_tpu_torch import main as tmain
from dis_project_tpu_torch.data.dataset import P53Data, train_arrays
from dis_project_tpu_torch.models import multisimm, simm
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
    """Gene-major ``(t, gene, flag)`` rows."""
    return np.stack([np.tile(t, len(genes)), np.repeat(genes, len(t)).astype(float),
                     np.full(len(t) * len(genes), float(flag))], axis=1)


def _problem(R, G=3, T=7):
    """R-force parameters in the bijectors' support, 3 genes on a 7-point
    grid, per-point variances, the R forces' rows on 11 points, and a mixed
    row set (every other expression row and every force row)."""
    rng = np.random.default_rng(10 + R)
    p = dict(basal=rng.uniform(0.02, 0.1, G), sensitivity=rng.uniform(0.4, 1.4, (G, R)),
             decay=rng.uniform(0.3, 1.2, G), lengthscale=rng.uniform(0.8, 3.2, R),
             obs_stddev=np.array(0.7))
    X = _rows(np.linspace(0.0, 12.0, T), np.arange(G), 1)
    F = _rows(np.linspace(0.0, 13.0, 11), np.arange(R), 0)
    M = np.concatenate([X[::2], F])
    grid = _rows(np.linspace(0.0, 13.0, 9), np.arange(G), 0)  # flag forced to 1 in the predict
    y = rng.normal(size=G * T)
    var = rng.uniform(1e-3, 1e-2, G * T)
    return p, X, F, M, grid, y, var


@pytest.fixture(scope="module")
def refs():
    """JAX's values and raw MLL gradient for R = 1, 2 and 3, in one compiled
    program."""
    def one(R):
        p, X, F, M, grid, y, var = _problem(R)
        jmodel = jmulti.ExactMultiSIMM(num_genes=3, num_forces=R, jitter=1e-4)
        jp = jmulti.MultiSIMMParams(**{k: jnp.asarray(v) for k, v in p.items()})
        a = {k: jnp.asarray(v) for k, v in dict(X=X, F=F, M=M, grid=grid, y=y, var=var).items()}
        lat = jmodel.latent_predict(jp, a["F"], a["X"], a["y"], a["var"])
        gene = jmodel.multi_gene_predict(jp, a["grid"], a["X"], a["y"], a["var"])
        grad = jax.grad(lambda r: jmodel.mll(jmulti.constrain(r), a["X"], a["y"]))(
            jmulti.unconstrain(jp))
        return dict(ccov=jmodel.cross_covariance(jp, a["M"], a["M"]),
                    gram=jmodel.gram(jp, a["X"]), mll=jmodel.mll(jp, a["X"], a["y"]),
                    mean_fn=jmodel.mean_function(jp, a["M"]), lat_mean=lat.mean,
                    lat_cov=lat.cov, gene_mean=gene.mean, gene_cov=gene.cov, grad=grad)

    return jax.tree.map(np.asarray, _jit(lambda: {R: one(R) for R in (1, 2, 3)})())


@pytest.fixture(params=[1, 2, 3], ids=lambda r: f"R{r}")
def case(request, refs):
    """One R's port model, inputs and JAX reference."""
    R = request.param
    p, X, F, M, grid, y, var = _problem(R)
    model = multisimm.ExactMultiSIMM(num_genes=3, num_forces=R, jitter=1e-4)
    tp = convert.multisimm_params_from_numpy(p, device="cpu")
    return dict(R=R, p=p, tp=tp, model=model, ref=refs[R], X=_t(X), F=_t(F), M=_t(M),
                grid=_t(grid), y=_t(y), var=_t(var))


def test_values_match_jax(case):
    """cross_covariance on mixed rows (all four flag branches), gram, mll,
    mean_function, latent_predict at every force's rows and
    multi_gene_predict: 1e-12."""
    m, tp, ref = case["model"], case["tp"], case["ref"]
    lat = m.latent_predict(tp, case["F"], case["X"], case["y"], case["var"])
    gene = m.multi_gene_predict(tp, case["grid"], case["X"], case["y"], case["var"])
    got = dict(ccov=m.cross_covariance(tp, case["M"], case["M"]), gram=m.gram(tp, case["X"]),
               mll=m.mll(tp, case["X"], case["y"]), mean_fn=m.mean_function(tp, case["M"]),
               lat_mean=lat.mean, lat_cov=lat.cov, gene_mean=gene.mean, gene_cov=gene.cov)
    for name, value in got.items():
        _close(value, ref[name], 1e-12, f"R={case['R']} {name}")


def test_raw_gradients_match_jax(case):
    """The gradient of the MLL in the raw parameters against jax.grad: 1e-10."""
    m = case["model"]
    _, grads = generic.value_and_grad(
        lambda r: m.mll(multisimm.constrain(r), case["X"], case["y"]),
        multisimm.unconstrain(case["tp"]))
    for name in multisimm.MultiSIMMParams._fields:
        _close(getattr(grads, name), getattr(case["ref"]["grad"], name), 1e-10, name)


def test_one_force_reduces_to_exact_simm():
    """R = 1 against the port's ``ExactSIMM`` on the same rows: the Gram,
    the MLL, the gene posterior and the latent posterior's mean and
    variance within 1e-12 x max(1, max|value|) (the two sum the same closed
    form in another order)."""
    p, X, F, _, grid, y, var = _problem(1)
    tp = convert.multisimm_params_from_numpy(p, device="cpu")
    sp = simm.SIMMParams(tp.basal, tp.sensitivity[:, 0], tp.decay, tp.lengthscale[0],
                         tp.obs_stddev)
    mm = multisimm.ExactMultiSIMM(num_genes=3, num_forces=1, jitter=1e-4)
    sm = simm.ExactSIMM(num_genes=3, jitter=1e-4)
    X, F, grid, y, var = map(_t, (X, F, grid, y, var))
    _close(mm.gram(tp, X), sm.gram(sp, X).numpy(), 1e-12, "gram")
    _close(mm.mll(tp, X, y), sm.mll(sp, X, y).numpy(), 1e-12, "mll")
    g1, g2 = mm.multi_gene_predict(tp, grid, X, y, var), sm.multi_gene_predict(sp, grid, X, y, var)
    _close(g1.mean, g2.mean.numpy(), 1e-12, "gene mean")
    _close(g1.cov, g2.cov.numpy(), 1e-12, "gene cov")
    l1, l2 = mm.latent_predict(tp, F, X, y, var), sm.latent_predict(sp, F, X, y, var)
    _close(l1.mean, l2.mean.numpy(), 1e-12, "latent mean")
    _close(torch.diagonal(l1.cov), torch.diagonal(l2.cov).numpy(), 1e-12, "latent variance")


@pytest.mark.parametrize("R", [1, 2, 4, 8])
def test_init_params_inside_the_bounds_and_round_trip(R):
    """The init lengthscales equal JAX's and lie strictly inside (0.5, 3.5);
    the unconstrained point is finite and maps back within 1e-14."""
    p = multisimm.init_params(4, R)
    ref = jmulti.init_params(4, R, dtype=jnp.float64)
    for name in multisimm.MultiSIMMParams._fields:
        _close(getattr(p, name), getattr(ref, name), 1e-15, name)
    assert float(p.lengthscale.min()) > 0.5 and float(p.lengthscale.max()) < 3.5
    raw = multisimm.unconstrain(p)
    assert all(bool(torch.isfinite(v).all()) for v in raw)
    for a, b in zip(multisimm.constrain(raw), p):
        _close(a, b.numpy(), 1e-14, "round trip")
    assert multisimm.force_rows(torch.linspace(0, 1, 5), R - 1)[:, 1].eq(R - 1).all()


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def jax_route(tmp_path_factory):
    """JAX's ``run_multiforce`` (R = 2, 20 iterations, the metrics file):
    the ``LoopResult`` of its ``generic.fit_loop`` and the per-force latent
    posteriors it plots."""
    tmp = tmp_path_factory.mktemp("jax_multisimm")
    captured, posts = {}, []
    real_fit_loop = jgeneric.fit_loop

    def capture(*args, **kw):
        captured["result"] = real_fit_loop(*args, **kw)
        return captured["result"]

    with pytest.MonkeyPatch.context() as mp:
        _fast_jit(mp)
        mp.setattr(jgeneric, "fit_loop", capture)
        mp.setattr(jplotter, "plot_lf", lambda rows, post, **kw: posts.append(post))
        jmain.run_multiforce(jcfg.RunConfig(model="multisimm", num_iters=ITERS,
                                            metrics_path=str(tmp / "jax.jsonl")))
    return dict(result=captured["result"], posts=posts, metrics=_records(tmp / "jax.jsonl"))


def test_fit_matches_jax(jax_route):
    """``multisimm.fit`` on the p53 data, 20 Adam steps, R = 2: history and
    gradient norms rel 1e-9, trained parameters rel 1e-9."""
    data = P53Data(replicate=0, source="synthetic", seed=0)
    X, y, _ = train_arrays(data, "cpu", F64)
    model = multisimm.ExactMultiSIMM(num_genes=5, num_forces=2, jitter=cfg.EXACT_JITTER)
    res = multisimm.fit(model, multisimm.init_params(5, 2), X, y, num_iters=ITERS,
                        full_result=True)
    ref = jax_route["result"]
    np.testing.assert_allclose(res.history.numpy(), np.asarray(ref.history), rtol=1e-9)
    np.testing.assert_allclose(res.grad_norms.numpy(), np.asarray(ref.grad_norms), rtol=1e-9)
    for name in multisimm.MultiSIMMParams._fields:
        np.testing.assert_allclose(getattr(res.params, name).numpy(),
                                   np.asarray(getattr(ref.params, name)), rtol=1e-9)


def test_run_multiforce_matches_jax(jax_route, tmp_path, capsys):
    """The route on the CPU: the metrics file line by line at rel 1e-8, the
    per-force latent posteriors ((R, 100)) within 1e-8 of JAX's, the
    lengthscale and kinetics table, one plot per force."""
    path = tmp_path / "port.jsonl"
    out = tmain.run_multiforce(cfg.RunConfig(model="multisimm", num_iters=ITERS, device="cpu",
                                             metrics_path=str(path),
                                             out_dir=str(tmp_path / "plots")))
    got, ref = _records(path), jax_route["metrics"]
    assert [sorted(r) for r in got] == [sorted(r) for r in ref] == [
        ["grad_norm", "loss", "step"]] * ITERS
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose([r[key] for r in got], [r[key] for r in ref], rtol=1e-8)
    assert out.latent.mean.shape == (2, 100) and out.latent.cov.shape == (2, 100, 100)
    for r, post in enumerate(jax_route["posts"]):
        _close(out.latent.mean[r], post.mean, 1e-8, f"force {r} mean")
        _close(out.latent.cov[r], post.cov, 1e-8, f"force {r} cov")
    text = capsys.readouterr().out
    assert "lengthscales:" in text and "S[f0]" in text and "S[f1]" in text
    assert sorted(f.name for f in (tmp_path / "plots").iterdir()) == [
        "lf_multiforce_f0.png", "lf_multiforce_f1.png"]


def test_checkpoint_refusal_on_both_sides(tmp_path):
    """The JAX package's ``multisimm.fit(checkpoint_dir=...)`` raises
    NameError (``raw0`` is undefined there); the port refuses the same call
    with NotImplementedError and the CLI flag with SystemExit, naming it."""
    data = JP53Data(replicate=0, source="synthetic", seed=0)
    X, y, _ = jtrain_arrays(data)
    jmodel = jmulti.ExactMultiSIMM(num_genes=5, num_forces=2, jitter=1e-4)
    with pytest.raises(NameError, match="raw0"):
        jmulti.fit(jmodel, jmulti.init_params(5, 2), X, y, checkpoint_dir=str(tmp_path))
    model = multisimm.ExactMultiSIMM(num_genes=5, num_forces=2, jitter=1e-4)
    with pytest.raises(NotImplementedError, match="NameError"):
        multisimm.fit(model, multisimm.init_params(5, 2), _t(X), _t(y),
                      checkpoint_dir=str(tmp_path))
    with pytest.raises(SystemExit) as got:
        tmain.main(["--model", "multisimm", "--checkpoint-dir", str(tmp_path), "--device", "cpu"])
    assert str(got.value) == multisimm.CHECKPOINT_REFUSAL
    assert not any(tmp_path.iterdir())


# ---------------------------------------------------------------------------
# The CLI guards of both families.
# ---------------------------------------------------------------------------


REFUSALS = [
    ["--model", "multisimm", "--preset", "alfi-parity"],
    ["--model", "multisimm", "--preset", "p53-replicates"],
    ["--model", "delaysimm", "--preset", "alfi-parity"],
    ["--model", "delaysimm", "--preset", "p53-replicates"],
    ["--model", "multisimm", "--preset", "dense10k"],
    ["--model", "delaysimm", "--preset", "dense10k"],
    ["--model", "multisimm", "--preset", "dense10k", "--mll-engine", "cg"],
    ["--model", "delaysimm", "--mll-engine", "ss"],
    ["--model", "delaysimm", "--preset", "dense10k", "--mll-engine", "ss",
     "--stationary-after", "8"],
    ["--model", "multisimm", "--posterior-samples", "4"],
    ["--model", "multisimm", "--preset", "dense10k", "--mll-engine", "ss",
     "--posterior-samples", "4"],
    ["--model", "multisimm", "--force-kernel", "matern32"],
    ["--model", "multisimm", "--no-fix-params"],
    ["--model", "multisimm", "--shared-kinetics"],
    ["--model", "delaysimm", "--shared-kinetics"],
    ["--model", "multisimm", "--num-forces", "0"],
    ["--preset", "dense10k", "--model", "multisimm", "--mll-engine", "ss", "--num-forces", "0"],
]


@pytest.mark.parametrize("argv", REFUSALS, ids=lambda a: " ".join(a))
def test_cli_refuses_family_combinations_with_jax_messages(argv):
    """Each refusal of the JAX CLI for the multi-force and delay families,
    word for word; the JAX package refuses each before it computes
    anything (the route flags and --num-forces at the routes' top)."""
    with pytest.raises(SystemExit) as ref:
        jmain.main(argv)
    with pytest.raises(SystemExit) as got:
        tmain.main(argv + ["--device", "cpu"])
    assert str(got.value) == str(ref.value) and str(ref.value)


def test_cli_dense_delay_posterior_reaches_the_sampler(tmp_path, monkeypatch):
    """``--preset dense10k --model delaysimm --mll-engine ss
    --posterior-samples 4`` calls ``delay_posterior_ss`` with JAX's
    arguments (4 warmup, 4 draws, 10 leapfrog steps, one chain, --seed + 7;
    the p53 routes' cases are in ``tests/test_torch_port_simm2_routes.py``)."""
    from test_torch_port_hmc_routes import sampler_call

    monkeypatch.chdir(tmp_path)
    seen = sampler_call(monkeypatch, ["--preset", "dense10k", "--model", "delaysimm",
                                      "--mll-engine", "ss", "--posterior-samples", "4",
                                      "--synth-genes", "3", "--synth-timepoints", "9",
                                      "--num-iters", "1"])
    assert seen["num_warmup"] == seen["num_samples"] == 4
    assert (seen["num_leapfrog"], seen["num_chains"], seen["seed"]) == (10, 1, 7)


@pytest.mark.parametrize("model", ["multisimm", "delaysimm"])
def test_family_routes_need_a_card_unless_given_the_cpu(model):
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the routes run there")
    with pytest.raises(RuntimeError, match="no CUDA device is visible"):
        tmain.main(["--model", model, "--num-iters", "1"])
