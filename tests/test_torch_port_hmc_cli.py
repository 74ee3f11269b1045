"""The ``--posterior-samples`` / ``--posterior-chains`` CLI of the port
against the JAX package's: every guard of the two flags word for word, the
flags' parse, and each of the five routes end to end through
``main.main(..., --device cpu)`` at 10 training steps and 3 draws, with its
report lines and, where matplotlib is installed, its plots (the routes'
calls of the sampler are held in test_torch_port_hmc_routes.py).
"""

import importlib.util

import pytest
import torch

from dis_project_tpu import main as jmain
from dis_project_tpu_torch import main as tmain
from dis_project_tpu_torch.training import hmc
from test_torch_port_hmc_routes import ROUTES

HAVE_MPL = importlib.util.find_spec("matplotlib") is not None


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this file: its routes and chains are
    thousands of small operations, and test workers that each run a thread
    per core oversubscribe the cores (six workers at 8 threads each ran
    these route tests ~20x slower than at 1 thread each)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


GUARDS = [
    ["--posterior-chains", "0"],
    ["--posterior-chains", "-2", "--posterior-samples", "3"],
    ["--posterior-chains", "2"],
    ["--preset", "alfi-parity", "--posterior-samples", "3"],
    ["--preset", "sparse100k", "--posterior-samples", "3"],
    ["--preset", "dense10k", "--posterior-samples", "3"],
    ["--preset", "dense10k", "--mll-engine", "cg", "--posterior-samples", "3"],
    ["--preset", "dense10k", "--model", "nlfm", "--mll-engine", "ss", "--posterior-samples", "3"],
    ["--preset", "dense10k", "--model", "simm2", "--mll-engine", "ss",
     "--posterior-samples", "3", "--posterior-chains", "2"],
    ["--model", "multisimm", "--posterior-samples", "3", "--posterior-chains", "4"],
]


@pytest.mark.parametrize("argv", GUARDS, ids=lambda a: " ".join(a))
def test_cli_posterior_guards_with_jax_messages(argv):
    with pytest.raises(SystemExit) as ref:
        jmain.main(argv)
    with pytest.raises(SystemExit) as got:
        tmain.main(argv + ["--device", "cpu"])
    assert str(got.value) == str(ref.value) and str(ref.value)


@pytest.mark.parametrize("argv", [[], ["--posterior-samples", "5", "--posterior-chains", "3"]],
                         ids=["defaults", "set"])
def test_posterior_flags_parse_as_jax(argv):
    """Both flags' defaults and values equal the JAX package's parse."""
    import argparse

    from dis_project_tpu import config as jcfg
    from dis_project_tpu_torch import config as cfg

    parsers = [argparse.ArgumentParser(allow_abbrev=False) for _ in range(2)]
    cfg.add_cli_args(parsers[0])
    jcfg.add_cli_args(parsers[1])
    got = cfg.config_from_args(parsers[0].parse_args(argv))
    ref = jcfg.config_from_args(parsers[1].parse_args(argv))
    assert (got.posterior_samples, got.posterior_chains) == (ref.posterior_samples,
                                                            ref.posterior_chains)


@pytest.mark.parametrize("route", list(ROUTES))
def test_route_runs_on_the_cpu(route, tmp_path, monkeypatch, capsys):
    """Each route end to end at --posterior-samples 3: the sampling line,
    the accept line, the credible-interval table (and the delay table on
    the delay routes), the diagnostics line with 2 chains, the BMA or
    full-Bayes band line, finite constrained samples of the right shape
    and, where matplotlib is installed, the plots."""
    monkeypatch.chdir(tmp_path)
    argv, _, n_rows = ROUTES[route]
    chains = int(argv[argv.index("--posterior-chains") + 1]) if "--posterior-chains" in argv else 1
    out = tmain.main(argv + ["--posterior-samples", "3", "--device", "cpu", "--out-dir",
                             str(tmp_path / "plots")])
    text = capsys.readouterr().out
    assert "HMC draws (3 warmup)..." in text and "Sampled in " in text
    assert "Posterior kinetics (mean +/- std [5%, 95%]):" in text
    assert "UNCLAMPED" in text
    leaf = hmc.checkpoint.tree_leaves(out.posterior.samples)[0]
    lead = (chains, 3) if chains > 1 else (3,)
    assert tuple(leaf.shape[:len(lead)]) == lead
    assert all(torch.isfinite(a).all() for a in hmc.checkpoint.tree_leaves(out.posterior.samples))
    if chains > 1:
        assert f"convergence over {chains} chains: max split-R-hat" in text
    if "delay" in route:
        assert "Posterior delays" in text
    plots = {p.name for p in (tmp_path / "plots").glob("*.png")}
    if route == "nlfm":
        assert "HMC force band (3 draws)" in text or "skipping the full-Bayes" in text
        band = "lf_nlfm_hmc.png"
    elif route.startswith("dense"):
        band = "lf_dense_ss_bma.png" if route == "dense ss" else None
        if band:
            assert "BMA latent-force band" in text or "skipping the BMA band" in text
    else:
        assert "BMA latent-force band" in text or "skipping the BMA band" in text
        band = "lf_delay_bma.png" if route == "delaysimm" else "lf_bma.png"
    if out.bma is not None and n_rows is not None and route not in ("dense ss",):
        assert out.bma.mean.shape == (100,)
    if HAVE_MPL:
        kin_plot = {"p53": "posterior_kinetics.png", "p53-replicates": "posterior_kinetics.png",
                    "nlfm": "posterior_kinetics_nlfm.png", "delaysimm":
                    "posterior_kinetics_delay.png", "dense ss": "posterior_kinetics_dense_ss.png",
                    "dense delay ss": "posterior_kinetics_dense_delay_ss.png"}[route]
        assert kin_plot in plots, plots
        if band and out.bma is not None:
            assert band in plots, plots
