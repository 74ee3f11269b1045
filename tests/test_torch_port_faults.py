"""Two faults of the port against the JAX package, each held on the CPU:

- ``run_dense --metrics-path`` writes the JAX package's dense metrics file
  (one ``{"step", "loss"}`` line per step, ``dis_project_tpu/main.py``'s
  ``run_dense``) on every dense engine; the port's file is held to the one
  that JAX's own ``run_dense`` writes on the same data (JAX's
  ``sample_prior`` arrays), losses at rel 1e-9.
- ``discretize`` carries the gradient to the step sizes: ``A`` and ``Q``
  built from steps that require a gradient differentiate as JAX's traced
  branch (the per-step ``vmap``), at 1e-10 in float64.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dis_project_tpu import config as jcfg
from dis_project_tpu import main as jmain
from dis_project_tpu.data import synthetic as jsynth
from dis_project_tpu.ops import statespace as jss
from dis_project_tpu_torch import main as tmain
from dis_project_tpu_torch.data import synthetic as tsynth
from dis_project_tpu_torch.ops import statespace as ss
from dis_project_tpu_torch.ops.precision import pin_full_fp32

F64 = torch.float64
G, T, STEPS = 3, 12, 2


def _t(a, dtype=F64):
    return torch.as_tensor(np.array(a), dtype=dtype)


@pytest.fixture(autouse=True)
def _full_fp32():
    pin_full_fp32()


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


@pytest.mark.parametrize("engine", ["cholesky", "ss"])
def test_run_dense_metrics_file_matches_jax(engine, tmp_path, monkeypatch):
    """One line per step, JAX's keys and step numbers, the losses at rel
    1e-9 of JAX's file and equal to the run's own history."""
    jpath, tpath = tmp_path / "jax.jsonl", tmp_path / "port.jsonl"
    jmain.run_dense(jcfg.RunConfig(
        preset="dense10k", synth_genes=G, synth_timepoints=T, num_iters=STEPS,
        mll_engine=engine, metrics_path=str(jpath), out_dir=str(tmp_path / "jax_plots")))
    scfg = jsynth.SyntheticConfig(num_genes=G, num_timepoints=T, num_replicates=1, noise_std=0.1)
    jdata = jsynth.sample_prior(jax.random.PRNGKey(0), scfg)

    def jax_data(genes, timepoints, seed, dtype, device):
        return tsynth.SyntheticLFMData(
            _t(jdata.timepoints, dtype), _t(jdata.gene_expressions, dtype),
            _t(jdata.gene_variances, dtype),
            {k: _t(v) for k, v in jdata.params_true.items()}, _t(jdata.f_true, dtype))

    monkeypatch.setattr(tmain, "synthetic_dense_data", jax_data)
    out = tmain.run_dense(tmain.cfg.RunConfig(
        preset="dense10k", synth_genes=G, synth_timepoints=T, num_iters=STEPS, device="cpu",
        mll_engine=engine, metrics_path=str(tpath)))
    ref, got = _records(jpath), _records(tpath)
    assert len(ref) == len(got) == STEPS
    assert [sorted(r) for r in got] == [sorted(r) for r in ref] == [["loss", "step"]] * STEPS
    assert [r["step"] for r in got] == [r["step"] for r in ref] == list(range(STEPS))
    np.testing.assert_allclose([r["loss"] for r in got], [r["loss"] for r in ref], rtol=1e-9)
    assert [r["loss"] for r in got] == out.result.history.tolist()


def test_run_dense_metrics_file_on_the_cg_engine(tmp_path):
    """The CG engine writes the same format (its losses are its stochastic
    estimates, one per step, as JAX's CG route records them)."""
    path = tmp_path / "cg.jsonl"
    out = tmain.run_dense(tmain.cfg.RunConfig(
        preset="dense10k", synth_genes=G, synth_timepoints=T, num_iters=STEPS, device="cpu",
        mll_engine="cg", x64=False, metrics_path=str(path)))
    got = _records(path)
    assert got == [{"step": i, "loss": loss} for i, loss in enumerate(out.result.history.tolist())]


@pytest.fixture(scope="module")
def dts_case():
    rng = np.random.default_rng(3)
    f, p_inf, _, _ = ss.build_lfm_ssm(_t([0.4, 0.9, 0.7]), _t([1.0, 0.8, 1.1]), _t(1.6), 8)
    dts = np.array([0.3, 0.05, 0.3, 1.2, 0.0, 0.7])
    w = rng.normal(size=(2, len(dts)) + tuple(f.shape))
    return f.detach().numpy(), p_inf.detach().numpy(), dts, w


def test_discretize_carries_the_gradient_to_the_steps(dts_case):
    """d/d dts of a weighted sum of A and Q against ``jax.grad`` through
    JAX's traced (per-step) branch, at 1e-10; repeated steps included. The
    values equal the bucketed branch's to 1e-13."""
    f, p_inf, dts, w = dts_case

    def jloss(d):
        a, q = jss.discretize(jnp.asarray(f), jnp.asarray(p_inf), d)
        return jnp.sum(w[0] * a) + jnp.sum(w[1] * q)

    ref = np.asarray(jax.grad(jloss)(jnp.asarray(dts)))
    leaf = _t(dts).requires_grad_(True)
    a, q = ss.discretize(_t(f), _t(p_inf), leaf)
    assert a.requires_grad and q.requires_grad
    (got,) = torch.autograd.grad(torch.sum(_t(w[0]) * a) + torch.sum(_t(w[1]) * q), leaf)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-10 * max(1.0, np.abs(ref).max()))
    a_b, q_b = ss.discretize(_t(f), _t(p_inf), _t(dts))
    assert not a_b.requires_grad
    assert float((a.detach() - a_b).abs().max()) <= 1e-13
    assert float((q.detach() - q_b).abs().max()) <= 1e-13


def test_discretize_checks_max_unique_only_when_bucketing(dts_case):
    """``max_unique`` bounds the bucketed branch only, as JAX applies it to
    concrete steps only: differentiable steps take the per-step branch."""
    f, p_inf, dts, _ = dts_case
    with pytest.raises(ValueError, match="more than max_unique=2"):
        ss.discretize(_t(f), _t(p_inf), _t(dts), max_unique=2)
    a, _ = ss.discretize(_t(f), _t(p_inf), _t(dts).requires_grad_(True), max_unique=2)
    assert a.shape == (len(dts),) + f.shape
