"""The rest of the port's canonical pipeline held to the JAX package on the
CPU: the plots (Agg backend; each module's ``save_plot`` captured to read
the drawn data), the metrics JSONL, the p53 route's variants
(``p53-replicates``, ``--genes``, ``--no-fix-params``,
``--shared-kinetics``), ``alfi-parity``, the port's copies of the
validation stack, and the CLI's flags. float64.
"""

import importlib.util
import json
import pathlib
import types

import jax
import jax.numpy as jnp
import matplotlib
import numpy as np
import pytest
import torch

from dis_project_tpu import config as jcfg
from dis_project_tpu import main as jmain
from dis_project_tpu.data.dataset import P53Data as JP53Data
from dis_project_tpu.data.dataset import dataset_3d as jdataset_3d
from dis_project_tpu.models import simm as jsimm
from dis_project_tpu.models.base import Gaussian as JGaussian
from dis_project_tpu.reporting import plotter as jplotter
from dis_project_tpu.training import trainer as jtr
from dis_project_tpu.validation import torch_lfm as jtorch_lfm
from dis_project_tpu.validation import torch_report as jtorch_report
from dis_project_tpu_torch import config as cfg
from dis_project_tpu_torch import main as tmain
from dis_project_tpu_torch.data.dataset import P53Data
from dis_project_tpu_torch.models.base import Gaussian
from dis_project_tpu_torch.reporting import plotter
from dis_project_tpu_torch.validation import torch_lfm, torch_report

matplotlib.use("Agg")
REPO = pathlib.Path(__file__).resolve().parents[1]
FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------------------
# Plots.
# ---------------------------------------------------------------------------


def _figure_data(fig):
    """What each axes draws: line data, filled bands and scatter offsets,
    bar heights, title."""
    out = []
    for ax in fig.axes:
        out.append({
            "lines": [np.asarray(line.get_xydata()) for line in ax.lines],
            "collections": [np.concatenate([p.vertices for p in c.get_paths()])
                            if c.get_paths() else np.asarray(c.get_offsets())
                            for c in ax.collections],
            "bars": [p.get_height() for p in ax.patches],
            "title": ax.get_title(),
        })
    return out


def _capture(monkeypatch, module):
    figs = []

    def save_plot(fig, name, out_dir="plots"):
        figs.append((name, _figure_data(fig)))
        return name

    monkeypatch.setattr(module, "save_plot", save_plot)
    return figs


def _assert_same_figures(got, ref):
    assert [n for n, _ in got] == [n for n, _ in ref]
    for (_, g_axes), (_, r_axes) in zip(got, ref):
        assert len(g_axes) == len(r_axes)
        for g, r in zip(g_axes, r_axes):
            assert g["title"] == r["title"] and len(g["lines"]) == len(r["lines"])
            for a, b in zip(g["lines"] + g["collections"], r["lines"] + r["collections"]):
                np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-12)
            np.testing.assert_allclose(g["bars"], r["bars"], rtol=1e-12)


@pytest.fixture(scope="module")
def plot_inputs():
    rng = np.random.default_rng(0)
    data = P53Data(replicate=None, source="synthetic")
    t = np.linspace(0, 13, 30)
    grid = np.stack([np.tile(t, 5), np.repeat(np.arange(5.0), 30), np.ones(150)], -1)
    a = rng.normal(size=(150, 150))
    cov = a @ a.T / 150 + np.eye(150)
    lat = np.stack([t, -np.ones(30), np.zeros(30)], -1)
    trace = {k: rng.uniform(0.2, 1.0, size=(12, 5)) for k in ("basal", "sensitivity", "decay")}
    params = jsimm.init_params(5)._replace(decay=jnp.linspace(0.3, 0.9, 5))
    return dict(data=data, grid=grid, mean=rng.normal(size=150), cov=cov, lat=lat,
                trace=trace, params=params)


PLOTS = ("plot_lf", "plot_gene_predictions", "plot_comparison", "plot_param_trace",
         "plot_posterior_kinetics")


def _plot_call(name, inp, module):
    """One plot call with the same numpy inputs; the port gets tensors and
    its Gaussian where a caller of the port passes them."""
    port = module is plotter
    G = Gaussian if port else JGaussian

    def arr(a):
        return torch.as_tensor(np.asarray(a)) if port else jnp.asarray(a)

    d = inp["data"]
    if name == "plot_lf":
        dist = G(arr(inp["mean"][:30]), arr(inp["cov"][:30, :30]))
        return module.plot_lf(arr(inp["lat"]), dist, y_scatter=d.f_observed,
                              scatter_times=d.timepoints, title="t")
    if name == "plot_gene_predictions":
        return module.plot_gene_predictions(arr(inp["grid"]), G(arr(inp["mean"]),
                                                                arr(inp["cov"])), d)
    if name == "plot_comparison":
        p = inp["params"]
        return module.plot_comparison(type(p)(*(arr(v) for v in p)) if port else p, d)
    if name == "plot_param_trace":
        trace = {k: arr(v) for k, v in inp["trace"].items()} if port else inp["trace"]
        return module.plot_param_trace(trace, d.gene_names, save_name="x")
    return module.plot_posterior_kinetics(inp["trace"], d)


@pytest.mark.parametrize("name", PLOTS)
def test_plot_matches_jax_plotter(name, plot_inputs, monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)
    path = _plot_call(name, plot_inputs, plotter)  # the real save_plot
    assert (tmp_path / path).is_file() and path.startswith("plots/")
    got = _capture(monkeypatch, plotter)
    ref = _capture(monkeypatch, jplotter)
    _plot_call(name, plot_inputs, plotter)
    _plot_call(name, plot_inputs, jplotter)
    assert len(got) == len(ref) == 1
    _assert_same_figures(got, ref)


# ---------------------------------------------------------------------------
# The p53 route and its variants against JAX's.
# ---------------------------------------------------------------------------


def _jax_route_fit(config: jcfg.RunConfig):
    """What JAX's ``main.run`` trains for ``config`` (its data, model and
    TrainConfig, dis_project_tpu/main.py:298-381), compiled at the fast
    level: ``(history, grad_norms, params)``."""
    data = JP53Data(replicate=config.replicate, selected_genes=config.selected_genes,
                    source="synthetic", seed=config.seed)
    X, y, _ = jdataset_3d(data)
    model = jsimm.ExactSIMM(num_genes=data.num_genes, jitter=config.exact_jitter,
                            shared_kinetics=config.shared_kinetics)
    has_p21 = "p21" in data.gene_names
    train_cfg = jtr.TrainConfig(
        num_iters=config.num_iters, learning_rate=config.learning_rate,
        fix_params=config.fix_params and not config.shared_kinetics and has_p21,
        clamp_gene=data.gene_names.index("p21") if has_p21 else 0,
        num_steps_per_epoch=config.num_steps_per_epoch, optimizer=config.optimizer)

    def fit(p):
        r = jtr.fit(model, p, X, y, train_cfg, gridded=(data.timepoints, data.num_replicates))
        return r.history, r.grad_norms, r.params

    p0 = jsimm.init_params(data.num_genes, shared_kinetics=config.shared_kinetics)
    return jax.jit(fit, compiler_options=FAST_COMPILE)(p0)


ROUTES = {
    "p53-replicates": ["--preset", "p53-replicates"],
    "genes p21,DDB2 (clamp at index 1)": ["--genes", "p21,DDB2", "--num-iters", "40"],
    "genes DDB2,BIK --no-fix-params": ["--genes", "DDB2,BIK", "--no-fix-params",
                                       "--num-iters", "40"],
    "shared kinetics": ["--shared-kinetics", "--num-iters", "40", "--learning-rate", "0.02"],
}


@pytest.mark.parametrize("route", ROUTES)
def test_p53_route_variants_match_jax(route, monkeypatch):
    argv = ROUTES[route] + ["--data-source", "synthetic"]
    jconfig = jcfg.config_from_args(_jax_parser().parse_args(argv))
    if jconfig.preset == "p53-replicates":
        jconfig.replicate = None
    hist, _, params = _jax_route_fit(jconfig)
    seen = {}
    monkeypatch.setattr(tmain, "report", lambda config, out: seen.update(out=out))
    tmain.main(argv + ["--device", "cpu"])
    got = seen["out"]
    assert got.data.num_replicates == (3 if route == "p53-replicates" else 1)
    assert got.latent.mean.shape == (100,)
    assert float(got.result.history[-1]) == pytest.approx(float(hist[-1]), rel=1e-8)
    np.testing.assert_allclose(got.result.params.decay.numpy(), np.asarray(params.decay),
                               rtol=1e-8)
    if route == "p53-replicates":
        golden = _chip_smoke().P53_REPLICATES_FINAL_LOSS
        assert float(hist[-1]) == pytest.approx(golden, rel=1e-10)
        assert float(got.result.history[-1]) == pytest.approx(golden, abs=1e-8)
    if route.startswith("genes p21"):
        assert float(got.result.params.sensitivity[1]) == 1.0  # p21 clamped by name


def test_metrics_jsonl_matches_jax(tmp_path):
    config = cfg.RunConfig(num_iters=25, device="cpu", metrics_path=str(tmp_path / "m.jsonl"))
    tmain.fit_and_predict(config)
    hist, norms, _ = _jax_route_fit(jcfg.RunConfig(num_iters=25))
    # JAX's run writes these records (dis_project_tpu/main.py:383-387).
    jmain._write_metrics(str(tmp_path / "j.jsonl"), types.SimpleNamespace(
        history=hist, grad_norms=norms))
    got = [json.loads(line) for line in (tmp_path / "m.jsonl").read_text().splitlines()]
    ref = [json.loads(line) for line in (tmp_path / "j.jsonl").read_text().splitlines()]
    assert [r["step"] for r in got] == [r["step"] for r in ref] == list(range(25))
    assert sorted(got[0]) == sorted(ref[0]) == ["grad_norm", "loss", "step"]
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose([r[key] for r in got], [r[key] for r in ref], rtol=1e-9)


def test_cli_run_writes_every_artifact(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    tmain.main(["--device", "cpu", "--num-iters", "5", "--track-parameters",
                "--metrics-path", "m.jsonl", "--checkpoint-dir", "ck", "--out-dir", "out",
                "--save-name", "s"])
    assert sorted(p.name for p in (tmp_path / "out").iterdir()) == [
        "comparison_s.png", "gxpr_s.png", "lf_s.png", "param_trace_s.png"]
    assert len((tmp_path / "m.jsonl").read_text().splitlines()) == 5
    assert (tmp_path / "ck" / "step_5.pt").is_file()
    assert (tmp_path / "hyperparams.csv").read_text().startswith("Gene Name")
    out = tmain.main(["--device", "cpu", "--num-iters", "5", "--checkpoint-dir", "ck",
                      "--resume", "--out-dir", "out"])
    assert (tmp_path / "ck" / "step_10.pt").is_file() and out.result.history.shape == (5,)


def test_run_alfi_parity_passes_its_gates(tmp_path, capsys):
    corr = tmain.run_alfi_parity(cfg.RunConfig(preset="alfi-parity", num_iters=30,
                                               device="cpu", out_dir=str(tmp_path)))
    out = capsys.readouterr().out
    assert corr >= 0.95 and "Cross-framework parity OK" in out
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "comparison_torch.png", "gxpr_torch.png", "lf_torch.png", "param_trace_torch.png"]


def test_alfi_parity_gate_messages():
    base = dict(data=None, t_test=None, f_torch=None, f_var_torch=None, m_means=None,
                m_vars=None, param_trace=None, result=None)
    for kw, msg in ((dict(mll_delta=2e-6, corr0=1.0, corr=1.0), "|MLL delta|"),
                    (dict(mll_delta=0.0, corr0=0.99, corr=1.0), "fixed-params corr"),
                    (dict(mll_delta=0.0, corr0=1.0, corr=0.9), "trained corr")):
        with pytest.raises(SystemExit, match="cross-framework parity FAILED.*" +
                           msg.replace("|", r"\|")):
            tmain.check_alfi_parity(tmain.AlfiParity(**kw, **base))


# ---------------------------------------------------------------------------
# The validation stack's copies.
# ---------------------------------------------------------------------------


def _torch_simm(module, data, X, y, var):
    tm = module.TorchSIMM(num_genes=5, timepoints=torch.tensor(np.asarray(data.timepoints)),
                          variances=torch.tensor(np.asarray(var)).reshape(-1), jitter=1e-4,
                          num_replicates=data.num_replicates)
    tm.set_train_targets(torch.tensor(np.asarray(y)).reshape(-1))
    return tm


def test_validation_copies_are_bitwise_the_jax_packages(monkeypatch):
    jdata = JP53Data(replicate=0, source="synthetic")
    X, y, var = jdataset_3d(jdata)
    a = _torch_simm(jtorch_lfm, jdata, X, y, var)
    b = _torch_simm(torch_lfm, jdata, X, y, var)
    y_t = torch.tensor(np.asarray(y)).reshape(-1)
    t = torch.linspace(0, 13, 40, dtype=torch.float64)
    ha = a.fit(y_t, epochs=8, track_parameters=True)
    hb = b.fit(y_t, epochs=8, track_parameters=True)
    assert ha == hb
    assert torch.equal(a.gram(), b.gram()) and torch.equal(a.mll(y_t), b.mll(y_t))
    for fa, fb in zip(a.predict_f(t) + a.predict_m(t), b.predict_f(t) + b.predict_m(t)):
        assert torch.equal(fa, fb)
    assert [sorted(e) for e in a.param_trace] == [sorted(e) for e in b.param_trace]
    split = torch_lfm.split_indices(35, 0.2, 0.1, seed=3)
    assert all(torch.equal(p, q) for p, q in zip(split, jtorch_lfm.split_indices(35, 0.2, 0.1,
                                                                                  seed=3)))
    # torch_report draws the same figures through each package's plotter.
    f, fv = b.predict_f(t)
    m, mv = b.predict_m(t)
    figs = {}
    for name, mod, plot_mod in (("port", torch_report, plotter),
                                ("jax", jtorch_report, jplotter)):
        figs[name] = _capture(monkeypatch, plot_mod)
        mod.plot_lf_torch(t.numpy(), f.numpy(), fv.numpy(), jdata)
        mod.plot_gxpred_torch(t.numpy(), m.numpy(), mv.numpy(), jdata)
        mod.plot_comparison_torch(b.param_trace, jdata)
        mod.plot_param_trace_torch(b.param_trace, jdata)
    _assert_same_figures(figs["port"], figs["jax"])


# ---------------------------------------------------------------------------
# The CLI's flags.
# ---------------------------------------------------------------------------


def _jax_parser():
    import argparse

    parser = argparse.ArgumentParser()
    jcfg.add_cli_args(parser)
    return parser


ARGVS = [
    [],
    ["--preset", "p53-replicates", "--replicate", "all"],
    ["--replicate", "2", "--genes", "p21,DDB2", "--no-fix-params", "--seed", "3"],
    ["--shared-kinetics", "--learning-rate", "0.05", "--optimizer", "lbfgs",
     "--num-iters", "30", "--steps-per-epoch", "10", "--track-parameters"],
    ["--preset", "dense10k", "--mll-engine", "cg", "--no-x64", "--synth-genes", "10",
     "--synth-timepoints", "40", "--jitter", "1e-3"],
    ["--preset", "alfi-parity", "--data-source", "synthetic", "--data-dir", "d",
     "--out-dir", "o", "--save-name", "s", "--checkpoint-dir", "c", "--resume",
     "--metrics-path", "m.jsonl"],
    ["--preset", "sparse100k", "--num-inducing", "64", "--batch-size", "512",
     "--num-epochs", "3", "--dp-shard", "--jitter", "1e-5"],
]


@pytest.mark.parametrize("argv", ARGVS, ids=lambda a: " ".join(a) or "defaults")
def test_flag_parsing_matches_jax(argv):
    import argparse

    parser = argparse.ArgumentParser(allow_abbrev=False)
    cfg.add_cli_args(parser)
    got = cfg.config_from_args(parser.parse_args(argv))
    ref = jcfg.config_from_args(_jax_parser().parse_args(argv))
    common = set(cfg.RunConfig.__dataclass_fields__) & set(jcfg.RunConfig.__dataclass_fields__)
    assert common == set(cfg.RunConfig.__dataclass_fields__) - {"device"}
    for name in sorted(common):
        assert getattr(got, name) == getattr(ref, name), name
    assert got.exact_jitter == ref.exact_jitter
    assert got.sparse_jitter == ref.sparse_jitter


@pytest.mark.parametrize("argv", [
    # The sparse route is ported; its data-parallel SVI is not.
    pytest.param(["--preset", "sparse100k", "--dp-shard"], id="--preset sparse100k"),
    # The ss engine is ported; its temporally-sharded filter is not.
    pytest.param(["--preset", "dense10k", "--mll-engine", "ss", "--ss-shard"],
                 id="--preset dense10k --mll-engine ss"),
    ["--preset", "dense10k", "--mll-engine", "dist"],
    # The second-order sparse100k route is ported; its data-parallel SVI is not.
    pytest.param(["--model", "simm2", "--preset", "sparse100k", "--dp-shard"],
                 id="--model simm2"),
    ["--preset", "p53-replicates", "--ensemble"],
    ["--platform", "cpu"], ["--mesh-shape", "4,2"],
], ids=lambda a: " ".join(a))
def test_cli_refuses_flags_and_presets_not_ported(argv):
    with pytest.raises(SystemExit, match="not yet ported"):
        tmain.main(argv + ["--device", "cpu"])


def test_cli_posterior_samples_reaches_the_sampler(tmp_path, monkeypatch):
    """``--posterior-samples`` is ported: it passes the guards, and the
    canonical route calls the HMC sampler as JAX's does (n warmup and n
    draws, one chain, 24 leapfrog steps, the generator seeded with --seed +
    7)."""
    from test_torch_port_hmc_routes import sampler_call

    monkeypatch.chdir(tmp_path)
    seen = sampler_call(monkeypatch, ["--posterior-samples", "5", "--num-iters", "2"])
    assert seen["num_warmup"] == seen["num_samples"] == 5
    assert (seen["num_leapfrog"], seen["num_chains"], seen["seed"]) == (24, 1, 7)


@pytest.mark.parametrize("argv, msg", [
    (["--resume"], "--resume requires --checkpoint-dir"),
    (["--mll-engine", "cg"], "only supported by the dense10k route"),
])
def test_cli_guards(argv, msg):
    with pytest.raises(SystemExit, match=msg):
        tmain.main(argv + ["--device", "cpu"])
