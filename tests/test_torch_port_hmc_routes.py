"""The port's HMC posteriors and its ``--posterior-samples`` /
``--posterior-chains`` routes, held to the JAX package on the CPU in
float64.

Each posterior runs on JAX's own random numbers (the draws of
``training.hmc.sample`` rebuilt from its key, ``test_torch_port_hmc.py``,
which also holds ``kinetics_posterior`` and ``nlfm.force_posterior_hmc``)
and is held to the JAX function at a few draws:
``delaysimm.kinetics_posterior`` at rel 1e-9 x max(1, max|ref|) from the
published kinetics (the reasons are ``kinetics_posterior``'s),
``kinetics_posterior_ss`` and ``delay_posterior_ss`` (3 genes x 9 times)
at 1e-8 (their likelihood matches JAX's at 1e-9 and its gradient at 1e-7
relative, tests/test_torch_port_statespace.py): samples, step size,
accept rate and log-probs. Each of the five routes calls its sampler with
JAX's arguments (test_torch_port_hmc_cli.py runs them end to end). The
JAX references compile at XLA's lowest CPU optimisation level.
"""

import numpy as np
import pytest
import torch

from dis_project_tpu.models import delaysimm as jdelay
from dis_project_tpu.models import simm as jsimm
from dis_project_tpu.training import hmc as jhmc
from dis_project_tpu_torch import convert
from dis_project_tpu_torch import main as tmain
from dis_project_tpu_torch.models import delaysimm
from dis_project_tpu_torch.training import hmc
from test_torch_port_hmc import NW, NS, _assert_result, _jtree, _kin, _p53, _run_jax

F64 = torch.float64
NW_SS, NS_SS = 4, 2  # warmup and sampling draws of the state-space posteriors


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


def sampler_call(monkeypatch, argv):
    """Run ``main.main(argv + --device cpu)`` until the route calls
    ``training.hmc.sample_constrained`` (every posterior's entry), and
    return what it was called with: the sampler's keyword arguments
    (``num_warmup``, ``num_samples``, ``num_leapfrog``), ``num_chains``,
    ``mesh`` and the generator's seed."""
    seen = {}

    class Reached(Exception):
        pass

    def fake(logdensity, raw0, generator, num_chains, mesh, constrain_fn, kw, draws=None,
             init_noise=None):
        seen.update(kw, num_chains=num_chains, mesh=mesh, seed=generator.initial_seed(),
                    logp=float(logdensity(raw0)))
        raise Reached

    monkeypatch.setattr(hmc, "sample_constrained", fake)
    with pytest.raises(Reached):
        tmain.main(argv + ["--device", "cpu"])
    return seen


# ---------------------------------------------------------------------------
# the posteriors against JAX's on JAX's draws
# ---------------------------------------------------------------------------


def test_delay_kinetics_posterior_matches_jax():
    pt = {**_kin(), "delay": np.array([0.3, 0.05, 0.2, 2e-9, 0.4])}
    X, y, var = _p53()
    jm = jdelay.ExactDelaySIMM(num_genes=5, jitter=1e-4)
    ref, draws = _run_jax(
        lambda p, k, nw, ns: jdelay.kinetics_posterior(jm, p, X, y, k, num_warmup=nw,
                                                       num_samples=ns),
        22, NW, NS, _jtree(jdelay.DelaySIMMParams, pt))
    tX, ty, _ = convert.arrays_from_numpy(X, y, var, device="cpu")
    got = delaysimm.kinetics_posterior(delaysimm.ExactDelaySIMM(num_genes=5, jitter=1e-4),
                                       convert.delaysimm_params_from_numpy(pt, device="cpu"),
                                       tX, ty, None, num_warmup=NW, num_samples=NS, draws=draws)
    assert got.samples.delay.shape == (NS, 5)
    _assert_result(got, ref, "delaysimm.kinetics_posterior", rtol=1e-9)


def _ss_problem(rng, G=3, T=9):
    kin = dict(basal=rng.uniform(0.02, 0.1, G), sensitivity=rng.uniform(0.6, 1.4, G),
               decay=rng.uniform(0.3, 0.9, G), lengthscale=np.array(2.2),
               obs_stddev=np.array(0.3))
    return kin, np.linspace(0.0, 12.0, T), rng.normal(size=G * T)


@pytest.mark.parametrize("family", ["simm", "delaysimm"])
def test_state_space_posteriors_match_jax(family):
    """``kinetics_posterior_ss`` (with stationary_after) and
    ``delay_posterior_ss`` at 3 genes x 9 times, 10 leapfrog steps."""
    rng = np.random.default_rng(8)
    kin, t, y = _ss_problem(rng)
    if family == "simm":
        pt, dim = kin, 11
        fn = lambda p, k, nw, ns: jhmc.kinetics_posterior_ss(  # noqa: E731
            p, t, y, k, jitter=1e-4, num_warmup=nw, num_samples=ns, stationary_after=5)
        jp = _jtree(jsimm.SIMMParams, pt)
    else:
        pt, dim = {**kin, "delay": np.array([2e-9, 0.4, 1.2])}, 14
        fn = lambda p, k, nw, ns: jhmc.delay_posterior_ss(  # noqa: E731
            p, t, y, k, jitter=1e-4, num_warmup=nw, num_samples=ns)
        jp = _jtree(jdelay.DelaySIMMParams, pt)
    ref, draws = _run_jax(fn, dim, NW_SS, NS_SS, jp)
    tt, ty = torch.as_tensor(t), torch.as_tensor(y)
    if family == "simm":
        got = hmc.kinetics_posterior_ss(convert.params_from_numpy(pt, device="cpu"), tt, ty,
                                        None, jitter=1e-4, num_warmup=NW_SS,
                                        num_samples=NS_SS, stationary_after=5, draws=draws)
    else:
        got = hmc.delay_posterior_ss(convert.delaysimm_params_from_numpy(pt, device="cpu"), tt,
                                     ty, None, jitter=1e-4, num_warmup=NW_SS,
                                     num_samples=NS_SS, draws=draws)
    _assert_result(got, ref, f"{family} ss posterior", rtol=1e-8)


# ---------------------------------------------------------------------------
# the routes' calls of the sampler
# ---------------------------------------------------------------------------

ROUTES = {
    "p53": (["--num-iters", "10", "--posterior-chains", "2"], 24, 35),
    "p53-replicates": (["--preset", "p53-replicates", "--num-iters", "10"], 24, 105),
    "nlfm": (["--model", "nlfm", "--num-iters", "10", "--num-quad", "25"], 24, None),
    "delaysimm": (["--model", "delaysimm", "--num-iters", "10"], 24, 35),
    "dense ss": (["--preset", "dense10k", "--mll-engine", "ss", "--synth-genes", "3",
                  "--synth-timepoints", "9", "--num-iters", "3", "--stationary-after", "4",
                  "--posterior-chains", "2"], 10, 27),
    "dense delay ss": (["--preset", "dense10k", "--model", "delaysimm", "--mll-engine", "ss",
                        "--synth-genes", "3", "--synth-timepoints", "9", "--num-iters", "3"],
                       10, 27),
}


@pytest.mark.parametrize("route", list(ROUTES))
def test_route_calls_its_sampler_with_jax_arguments(route, tmp_path, monkeypatch):
    """``num_warmup = num_samples = n``, the chains, 24 leapfrog steps on
    the exact routes and 10 on the state-space ones, no mesh, and the
    generator seeded with --seed + 7; the log-density is finite at the
    seed point."""
    monkeypatch.chdir(tmp_path)
    argv, leapfrog, _ = ROUTES[route]
    chains = int(argv[argv.index("--posterior-chains") + 1]) if "--posterior-chains" in argv else 1
    seen = sampler_call(monkeypatch, argv + ["--posterior-samples", "6", "--seed", "2",
                                             "--num-iters", "2"])
    assert seen["num_warmup"] == seen["num_samples"] == 6
    assert seen["num_leapfrog"] == leapfrog and seen["num_chains"] == chains
    assert seen["mesh"] is None and seen["seed"] == 9 and np.isfinite(seen["logp"])
