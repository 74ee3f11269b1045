"""End-to-end pipelines of the port (``python -m dis_project_tpu_torch.main``).

Routes of ``dis_project_tpu/main.py``, on the card unless ``--device``
says otherwise:

- ``--preset p53`` (:func:`run`): Barenco data (synthetic seed 0 unless the
  CSVs are present), ExactSIMM(jitter=1e-4), negative conjugate MLL with
  Adam (or ``--optimizer lbfgs``) and the p21 clamp by name, through the
  Kronecker/table fast path; optional resume from ``--checkpoint-dir``,
  the metrics JSONL and a checkpoint; the latent-force posterior on a
  100-point grid and the per-gene expression posterior
  (:func:`fit_and_predict`, the device's work); then the hyperparameter
  table, ``hyperparams.csv`` and the plots ``lf.png``, ``gxpr.png``,
  ``comparison.png`` and, with ``--track-parameters``,
  ``param_trace.png`` (:func:`report`, the host's; plots need
  matplotlib).
- ``--preset p53-replicates``: :func:`run` on all three replicates (N =
  105), with the gene-subset, clamp and kinetics-sharing flags.
- ``--preset alfi-parity`` (:func:`run_alfi_parity`): the port's
  ExactSIMM against the independent torch validation stack
  (``validation.torch_lfm``), three gates.
- ``--preset dense10k`` (:func:`run_dense`): a synthetic draw at
  N = genes x timepoints (50 x 200 = 1e4 by default), full-batch training
  with ground-truth recovery metrics. ``--mll-engine cholesky`` (default):
  the exact MLL through the Gram the JAX package takes (:func:`dense_gram`):
  on the card in float32 the row Gram — the kernel K2 and its backward,
  the custom MLL backward with the SYRK kernel K3 — and elsewhere the table
  Gram of ``ExactSIMM.mll_gridded``; Adam. ``--mll-engine cg``: the
  matmul-only engine (``ExactSIMM.mll_iterative``: K2 and K2's backward on
  the card in float32, batched CG and stochastic Lanczos quadrature),
  gradient clipping and Adam (:func:`fit_cg`). ``--mll-engine ss``: the
  O(T) state-space Kalman engine (``ops.statespace.lfm_mll_ss``, with
  ``--force-kernel`` and ``--stationary-after``), Adam, then the smoothed
  latent force on a 200-point grid (``lfm_predict_ss``); its plot
  ``lf_dense_ss_lf.png`` is :func:`dense_ss_report`'s, drawn where
  matplotlib is installed.
- ``--model simm2`` (the second-order spring-damper family,
  ``models.simm2``): on the default preset :func:`run_second_order` (p53
  data, ``SecondOrderSIMM.mll`` with ``training.generic.fit_loop`` or
  ``fit_checkpointed``, the kinetics table with damping and spring, the
  latent force on a 100-point grid and its plot); with ``--preset
  dense10k`` :func:`run_dense_second_order` (quadrature-generated order-2
  data, ``--mll-engine cholesky``: ``mll_gridded``, the table Gram, then
  the MLL with K3 in its backward on the card in float32; ``--mll-engine
  ss``: ``ops.statespace.lfm2_mll_ss``; Adam; alpha/omega recovery).
- ``--model multisimm`` (R = ``--num-forces`` independent latent forces,
  ``models.multisimm``): on the default preset :func:`run_multiforce` (p53
  data, ``multisimm.fit``, the lengthscale and kinetics table, one latent
  posterior per force; ``--checkpoint-dir`` refused, the JAX package's
  branch raising ``NameError``); with ``--preset dense10k --mll-engine ss``
  :func:`run_dense_multiforce` (``generate_ode_multi`` data,
  ``ops.statespace.multisimm_mll_ss``, the matched per-force recovery).
- ``--model delaysimm`` (per-gene transcriptional delays,
  ``models.delaysimm``): on the default preset :func:`run_delay` (p53 data,
  ``delaysimm.fit`` with the p21 kinetics and delay pinned, ``hyperparams.csv``
  in the working directory, the delay table, the latent force; on the card
  K2, K2's backward and K1 at the warped rows); with ``--preset dense10k
  --mll-engine ss`` :func:`run_dense_delay` (``generate_ode_delay`` data,
  ``ops.statespace.delaysimm_mll_ss`` over T*G warped events, gene 0's delay
  pinned, decay and delay recovery).
- ``--model nlfm`` (the nonlinear response dx/dt = B + S g(f) - D x,
  ``--response`` identity|exp|softplus|sigmoid, ``models.nlfm``): on the
  default preset :func:`run_nonlinear` (p53 data, MAP over the kinetics and
  the whitened force on a ``--num-quad``-point grid, 2000 Adam steps unless
  ``--num-iters`` says otherwise, the p21 pin, ``hyperparams.csv``, the
  Laplace force and gene-curve bands from one Hessian and their plots);
  with ``--preset dense10k --mll-engine ss`` :func:`run_dense_nlfm`
  (``generate_ode_nonlinear`` data, the extended-Kalman marginal
  ``ops.statespace.nlfm_mll_ekf``, plain Adam, decay and sensitivity
  recovery).
- ``--posterior-samples n [--posterior-chains C]`` (``training.hmc``):
  after the fit, n warmup and n HMC draws over the hyperparameters on C
  chains in lockstep, from a generator seeded with ``--seed`` + 7, with
  the credible-interval report, split-R-hat / ESS for C > 1 and the
  hyperparameter-marginalised band: on the p53 and p53-replicates routes
  (:func:`kinetics_posterior`, the exact MLL, K2 and K2's backward every
  gradient on the card, the BMA band through K1 and K2), ``--model
  delaysimm`` (:func:`delay_posterior`), ``--model nlfm``
  (:func:`nonlinear_posterior`, the full-Bayes force band) and dense10k
  ``--mll-engine ss`` with simm (:func:`dense_ss_posterior`) or delaysimm
  (:func:`dense_delay_posterior`); refused elsewhere with the JAX
  package's message.

- ``--preset sparse100k`` (:func:`run_sparse`, BASELINE config 5): ODE
  quadrature data (``generate_ode``; ``generate_ode2`` with ``--model
  simm2``, ``generate_ode_multi`` with ``--model multisimm``) at 100 x 1000
  = 1e5 rows unless ``--synth-genes`` / ``--synth-timepoints`` say
  otherwise, minibatch SVI on the whitened inducing-point ELBO
  (``models.svlfm.SparseSIMM``, ``training.svtrainer.fit``: ``--num-inducing``,
  ``--batch-size``, ``--num-epochs``), the latent posterior on the
  timepoint grid, its recovery correlation (matched per force) and plot,
  the per-epoch metrics file. No hand-written kernel runs on it.

Every other preset, engine, model family and flag of the JAX CLI fails with
"not yet ported".
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import statistics
import time
from typing import Any, List, Optional

import numpy as np
import torch

from dis_project_tpu_torch import config as cfg

# The CG route's settings (dis_project_tpu/main.py:1244-1287): probes per
# step, Lanczos steps, the CG iteration cap and the gradient clip.
CG_PROBES, CG_LANCZOS_ITERS, CG_MAX_ITERS, CG_CLIP = 16, 24, 128, 10.0


@dataclasses.dataclass
class CanonicalRun:
    result: Any  # training.trainer.TrainResult
    latent: Any  # models.base.Gaussian over the 100-point latent grid
    expression: Any  # models.base.Gaussian over the expression grid
    data: Any  # data.dataset.P53Data
    t_grid: torch.Tensor
    x_grid: torch.Tensor
    model: Any = None  # models.simm.ExactSIMM
    X: Optional[torch.Tensor] = None
    y: Optional[torch.Tensor] = None
    var: Optional[torch.Tensor] = None
    # --posterior-samples: the HMC result (constrained draws) and the BMA band
    posterior: Any = None
    bma: Any = None


@dataclasses.dataclass
class DenseRun:
    result: Any  # training.trainer.TrainResult
    model: Any
    data: Any  # data.synthetic.SyntheticLFMData
    X: torch.Tensor
    y: torch.Tensor
    var: torch.Tensor
    step_seconds: List[float]
    # CG route: per step, batched_cg's stats; and the exact final loss
    cg_stats: Optional[List[dict]] = None
    final_loss: Optional[float] = None
    # ss route: per step, the host seconds of the loss and of value_and_grad;
    # the smoothed latent force (mean, variance) on its 200-point grid
    ss_stats: Optional[List[dict]] = None
    lf_grid: Optional[torch.Tensor] = None
    lf_mean: Optional[torch.Tensor] = None
    lf_var: Optional[torch.Tensor] = None
    # --posterior-samples: the HMC result (constrained draws) and the BMA band
    posterior: Any = None
    bma: Any = None


def _have_matplotlib() -> bool:
    return importlib.util.find_spec("matplotlib") is not None


def _final_loss(hist) -> float:
    return float(hist[-1]) if len(hist) else float("nan")


def _restore_for_resume(config, optimizer, params0, raw0):
    """``(init_state, start_step)`` from the latest checkpoint in
    ``--checkpoint-dir``: the full state (raw parameters, optimizer state,
    step), or from a legacy ``{params, step}`` checkpoint the parameters
    with a fresh optimizer (a warm start)."""
    from dis_project_tpu_torch.models import simm
    from dis_project_tpu_torch.training import checkpoint as ckpt

    latest = ckpt.latest_step(config.checkpoint_dir)
    if latest is None:
        return None, 0
    try:
        restored = ckpt.restore(config.checkpoint_dir, latest, template={
            "raw": raw0, "opt_state": optimizer.init(raw0), "step": 0})
        print(f"Resumed from checkpoint step {int(restored['step'])} "
              f"({config.checkpoint_dir})")
        return (restored["raw"], restored["opt_state"]), int(restored["step"])
    except ValueError:
        restored = ckpt.restore(config.checkpoint_dir, latest,
                                template={"params": params0, "step": 0})
        print(f"Resumed PARAMETERS from legacy checkpoint step {int(restored['step'])} "
              f"({config.checkpoint_dir}); optimizer state not in checkpoint — warm start")
        return ((simm.unconstrain(restored["params"]), optimizer.init(raw0)),
                int(restored["step"]))


def write_metrics(path: str, result) -> None:
    """Per-step ``{step, loss, grad_norm}`` records, one JSON line each."""
    with open(path, "w") as f:
        for i, (loss, gn) in enumerate(zip(result.history.tolist(),
                                           result.grad_norms.tolist())):
            f.write(json.dumps({"step": i, "loss": loss, "grad_norm": gn}) + "\n")


def write_dense_metrics(path: str, history) -> None:
    """The dense route's per-step ``{step, loss}`` records, one JSON line
    each, on every engine (the JAX package's dense format: no grad_norm)."""
    with open(path, "w") as f:
        for i, loss in enumerate(history.tolist()):
            f.write(json.dumps({"step": i, "loss": loss}) + "\n")


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def posterior_generator(config: cfg.RunConfig, device) -> torch.Generator:
    """The HMC routes' random stream: a generator on the sampler's device
    seeded with ``--seed`` + 7 (the JAX routes' ``PRNGKey(seed + 7)``)."""
    return torch.Generator(device=device).manual_seed(config.seed + 7)


def _finish_posterior(post, t0, config, data, save_name, kin_from=lambda s: s,
                      max_report_genes=None):
    """Shared tail of every HMC route: the timing and accept line (the
    sampler's one host read), split-R-hat / ESS when more than one chain
    ran, the chains pooled, and the credible-interval report. Returns the
    pooled constrained samples. ``kin_from`` extracts the SIMMParams-like
    kinetics view (``.kinetics`` on nlfm); ``max_report_genes`` caps the
    table and the histogram grid."""
    from dis_project_tpu_torch.training import checkpoint as ckpt
    from dis_project_tpu_torch.training import hmc

    acc = np.atleast_1d(_host(post.accept_rate))
    eps = np.atleast_1d(_host(post.step_size))
    print(f"Sampled in {time.perf_counter() - t0:.2f}s "
          f"(accept rate {', '.join(f'{a:.2f}' for a in acc)}; "
          f"step size {', '.join(f'{e:.4f}' for e in eps)})")
    samples = post.samples
    if config.posterior_chains > 1:
        rhat, ess = hmc.pytree_diagnostics(samples)
        total = config.posterior_chains * config.posterior_samples
        print(f"convergence over {config.posterior_chains} chains: "
              f"max split-R-hat {rhat:.4f} (converged: < ~1.05), "
              f"min ESS {ess:.0f} of {total} draws")
        samples = ckpt.tree_unflatten(samples, [
            a.reshape((-1,) + tuple(a.shape[2:])) for a in ckpt.tree_leaves(samples)])
    _report_kinetics_posterior(kin_from(samples), data, save_name, config.out_dir,
                               max_genes=max_report_genes)
    return samples


def _plot_bma_latent(predict_fn, samples, plugin_dist, t_grid, data, config, save_base, title):
    """Shared BMA tail of the exact, delay and dense ss posterior routes:
    marginalise the pooled draws through ``predict_fn``
    (``hmc.mixture_predict``, at most 64 components), report the band's
    widening against the plug-in predictive and any dropped non-PSD
    components, and write ``lf_<save_base>.png`` where matplotlib is.
    Returns the BMA Gaussian, or None when every component was dropped."""
    from dis_project_tpu_torch.training import checkpoint as ckpt
    from dis_project_tpu_torch.training import hmc

    max_components = 64
    requested = min(max_components, ckpt.tree_leaves(samples)[0].shape[0])
    bma, comp = hmc.mixture_predict(predict_fn, samples, max_components=max_components)
    if comp.shape[0] == 0:
        print("BMA latent force: every mixture component landed where the "
              "reference-convention covariance fails PSD (non-finite "
              "predictive) — skipping the BMA band")
        return None
    dropped = requested - comp.shape[0]
    drop_note = f"; {dropped} non-PSD draws dropped" if dropped else ""
    widen = float(torch.mean(bma.stddev() / plugin_dist.stddev()))
    print(f"BMA latent-force band ({comp.shape[0]} mixture components"
          f"{drop_note}): mean stddev {widen:.2f}x the plug-in band")
    if _have_matplotlib():
        from dis_project_tpu_torch.reporting import plotter

        plotter.plot_lf(t_grid, bma, y_scatter=data.f_observed, scatter_times=data.timepoints,
                        title=title, save_name=save_base, out_dir=config.out_dir)
    else:
        print("matplotlib is not installed: the BMA band is not drawn")
    return bma


class _KineticsReportView:
    """Gene-truncated view of a dataset for the posterior report plots:
    the two members ``plot_posterior_kinetics`` reads."""

    def __init__(self, gene_names, truth):
        self.gene_names = gene_names
        self._truth = truth

    def params_ground_truth(self):
        return self._truth


def _report_kinetics_posterior(kin_samples, data, save_name, out_dir, max_genes=None):
    """Unclamped-model note, credible-interval table and (where matplotlib
    is) the histogram grid ``posterior_kinetics[_<save_name>].png`` for HMC
    kinetics samples with stacked (draws, G) ``basal`` / ``sensitivity`` /
    ``decay``. ``max_genes`` truncates the table and the grid to the first
    K genes."""
    print(
        "NOTE: the posterior is over the UNCLAMPED model — the p21 "
        "identifiability clamp is a point constraint the full "
        "posterior does not impose, so scale-coupled parameters "
        "(S x force amplitude, and decays through them) show the "
        "broad/shifted intervals the clamp exists to resolve."
    )
    names = list(data.gene_names)
    kin = {k: _host(v) for k, v in kin_samples._asdict().items()}
    if max_genes is not None and len(names) > max_genes:
        print(f"(reporting the first {max_genes} of {len(names)} genes)")
        names = names[:max_genes]
        for k in ("basal", "sensitivity", "decay"):  # per-gene leaves only
            kin[k] = kin[k][..., :max_genes]
        truth = tuple(_host(v).ravel()[:max_genes] for v in data.params_ground_truth())
        data = _KineticsReportView(names, truth)
    print("\nPosterior kinetics (mean +/- std [5%, 95%]):")
    for key in ("basal", "sensitivity", "decay"):
        vals = kin[key]
        if vals.ndim == 1:
            vals = vals[:, None]
        for g, name in enumerate(names[: vals.shape[1]]):
            lo, hi = np.percentile(vals[:, g], [5, 95])
            print(f"  {key[:4]:<5} {name:<10} "
                  f"{vals[:, g].mean():.4f} +/- {vals[:, g].std():.4f} "
                  f"[{lo:.4f}, {hi:.4f}]")
    if _have_matplotlib():
        from dis_project_tpu_torch.reporting import plotter

        plotter.plot_posterior_kinetics({k: kin[k] for k in ("basal", "sensitivity", "decay")},
                                        data, save_name=save_name, out_dir=out_dir)
    else:
        print("matplotlib is not installed: the posterior histograms are not drawn")


def fit_and_predict(config: cfg.RunConfig) -> CanonicalRun:
    """The canonical route's device work: data, resume, the fit, the
    metrics JSONL and the checkpoint, and both posteriors."""
    from dis_project_tpu_torch.data.dataset import P53Data, dataset_3d
    from dis_project_tpu_torch.models import simm
    from dis_project_tpu_torch.ops.precision import default_device, dtype_for
    from dis_project_tpu_torch.training import checkpoint as ckpt
    from dis_project_tpu_torch.training import trainer as tr
    from dis_project_tpu_torch.utils.test_grids import expression_grid, latent_grid

    dev = default_device(config.device)
    dtype = dtype_for(config.x64)
    data = P53Data(replicate=config.replicate, data_dir=config.data_dir,
                   selected_genes=config.selected_genes, source=config.data_source,
                   seed=config.seed)
    X, y, var = dataset_3d(data, dev, dtype)
    model = simm.ExactSIMM(num_genes=data.num_genes, jitter=config.exact_jitter,
                           shared_kinetics=config.shared_kinetics)
    params0 = simm.init_params(data.num_genes, dtype=dtype, device=dev,
                               shared_kinetics=config.shared_kinetics)
    # The clamp targets p21 BY NAME: in a gene subset its index moves, or
    # it is absent; with tied kinetics the per-gene clamp is meaningless.
    has_p21 = "p21" in data.gene_names
    train_cfg = tr.TrainConfig(
        num_iters=config.num_iters,
        learning_rate=config.learning_rate,
        fix_params=config.fix_params and not config.shared_kinetics and has_p21,
        clamp_gene=data.gene_names.index("p21") if has_p21 else 0,
        num_steps_per_epoch=config.num_steps_per_epoch,
        track_parameters=config.track_parameters,
        optimizer=config.optimizer,
    )
    optimizer = tr.make_optimizer(train_cfg)
    raw0 = simm.unconstrain(params0)
    init_state, start_step = None, 0
    if config.resume and config.checkpoint_dir:
        init_state, start_step = _restore_for_resume(config, optimizer, params0, raw0)

    print(f"Training model on {dev} ({dtype})...")
    t0 = time.perf_counter()
    # dataset_3d rows are canonical gene-major grid blocks -> the
    # Kronecker/table fast path applies exactly.
    result = tr.fit(model, params0, X, y, train_cfg,
                    gridded=(data.timepoints, data.num_replicates), optimizer=optimizer,
                    init_state=init_state, step_offset=start_step)
    final = _final_loss(result.history)
    print(f"Trained {config.num_iters} iters in {time.perf_counter() - t0:.2f}s "
          f"(final loss {final:.6f})")
    if config.metrics_path:
        write_metrics(config.metrics_path, result)
    if config.checkpoint_dir:
        step = start_step + config.num_iters
        ckpt.save(config.checkpoint_dir, {"raw": result.raw_params,
                                          "opt_state": result.opt_state, "step": step},
                  step=step)

    print("Making predictions...")
    t_grid = latent_grid(100, dtype=dtype, device=dev)
    latent = model.latent_predict(result.params, t_grid, X, y, var)
    x_grid = expression_grid(data.num_genes, t=100, dtype=dtype, device=dev)
    expression = model.multi_gene_predict(result.params, x_grid, X, y, var)
    return CanonicalRun(result, latent, expression, data, t_grid, x_grid, model, X, y, var)


def kinetics_posterior(config: cfg.RunConfig, out: CanonicalRun) -> None:
    """``--posterior-samples`` on the canonical routes: HMC over the
    hyperparameters (``training.hmc.kinetics_posterior``: the exact MLL,
    on the card through K2 and K2's backward, a flat prior in constrained
    space, the chains seeded at the trained point), the report, and the
    hyperparameter-marginalised (BMA) latent force through
    ``latent_predict`` (K1 and K2 on the card) beside the plug-in band.
    Sets ``out.posterior`` and ``out.bma``."""
    from dis_project_tpu_torch.training import hmc

    n_draws = config.posterior_samples
    print(f"Sampling hyperparameter posterior: {n_draws} HMC draws "
          f"({n_draws} warmup)...")
    t0 = time.perf_counter()
    out.posterior = hmc.kinetics_posterior(
        out.model, out.result.params, out.X, out.y, posterior_generator(config, out.X.device),
        num_warmup=n_draws, num_samples=n_draws, num_chains=config.posterior_chains)
    samples = _finish_posterior(out.posterior, t0, config, out.data, config.save_name)
    out.bma = _plot_bma_latent(
        lambda p: out.model.latent_predict(p, out.t_grid, out.X, out.y, out.var),
        samples, out.latent, out.t_grid, out.data, config,
        f"{config.save_name}_bma" if config.save_name else "bma",
        "hyperparameters marginalised")


def report(config: cfg.RunConfig, out: CanonicalRun) -> None:
    """The canonical route's host work: the hyperparameter table and
    ``hyperparams.csv``, and the plots under ``--out-dir``; with
    ``--posterior-samples``, :func:`kinetics_posterior` between the
    predictive plots and the parameter trace (the JAX route's order)."""
    from dis_project_tpu_torch.reporting import plotter, tables

    data, params = out.data, out.result.params
    tables.print_hyperparams(params, data, csv_path="hyperparams.csv")
    kw = dict(save_name=config.save_name, out_dir=config.out_dir)
    plotter.plot_lf(out.t_grid, out.latent, y_scatter=data.f_observed,
                    scatter_times=data.timepoints, **kw)
    plotter.plot_gene_predictions(out.x_grid, out.expression, data, **kw)
    plotter.plot_comparison(params, data, **kw)
    if config.posterior_samples > 0:
        kinetics_posterior(config, out)
    trace = out.result.param_trace
    if config.track_parameters and trace is not None:
        plotter.plot_param_trace({"basal": trace.basal, "sensitivity": trace.sensitivity,
                                  "decay": trace.decay}, data.gene_names, **kw)
    print(f"Plots saved under {config.out_dir}/")


def run(config: cfg.RunConfig) -> CanonicalRun:
    """The canonical pipeline: :func:`fit_and_predict`, then :func:`report`."""
    out = fit_and_predict(config)
    report(config, out)
    return out


@dataclasses.dataclass
class AlfiParity:
    mll_delta: float  # |port - torch stack| MLL at the shared init
    corr0: float  # latent-posterior correlation at the shared init
    corr: float  # trained latent-posterior correlation
    data: Any
    t_test: np.ndarray
    f_torch: torch.Tensor
    f_var_torch: torch.Tensor
    m_means: torch.Tensor
    m_vars: torch.Tensor
    param_trace: list  # the torch stack's per-epoch trace
    result: Any  # the port's training.trainer.TrainResult


def alfi_parity(config: cfg.RunConfig) -> AlfiParity:
    """Train the port and the independent torch validation stack on the
    same data and measure their agreement (BASELINE config 3, the
    reference's GPJax-vs-GPyTorch check). The port runs on its device; the
    validation stack is float64 on the CPU, as written."""
    from dis_project_tpu_torch.data.dataset import P53Data, train_arrays
    from dis_project_tpu_torch.models import simm
    from dis_project_tpu_torch.ops.precision import default_device, dtype_for
    from dis_project_tpu_torch.training import trainer as tr
    from dis_project_tpu_torch.validation.torch_lfm import TorchSIMM

    dev = default_device(config.device)
    dtype = dtype_for(config.x64)
    data = P53Data(replicate=config.replicate, data_dir=config.data_dir,
                   source=config.data_source, seed=config.seed)
    X, y, var = train_arrays(data, dev, dtype)
    model = simm.ExactSIMM(num_genes=data.num_genes, jitter=config.exact_jitter)
    params0 = simm.init_params(data.num_genes, dtype=dtype, device=dev)
    y_host = torch.as_tensor(y.detach().cpu().numpy(), dtype=torch.float64)
    tm = TorchSIMM(
        num_genes=data.num_genes,
        timepoints=torch.tensor(np.asarray(data.timepoints)),
        variances=torch.as_tensor(var.detach().cpu().numpy(), dtype=torch.float64),
        jitter=config.exact_jitter,
        num_replicates=data.num_replicates,
    )
    tm.set_train_targets(y_host)
    t_test = np.linspace(0.0, 13.0, 80)
    rows = torch.as_tensor(np.stack([t_test, -np.ones(80), np.zeros(80)], axis=-1),
                           dtype=dtype, device=dev)

    # Gate 1: like-for-like MLL at the same fixed (init) parameters; the
    # torch MLL without the in-kernel measurement variances so that the
    # Sigma conventions match. Two f64 implementations of one formula.
    with torch.no_grad():
        mll_port = float(model.mll(params0, X, y))
        mll_torch = float(tm.mll(y_host, include_meas_var=False))
    mll_delta = abs(mll_port - mll_torch)
    print(f"Fixed-params MLL  port={mll_port:.9f}  torch={mll_torch:.9f}  "
          f"|delta|={mll_delta:.3e}  (gate: <= 1e-6)")

    # Gate 2: the latent-force posterior at the same fixed parameters.
    with torch.no_grad():
        f_port0 = model.latent_predict(params0, rows, X, y, var).mean.cpu().double().numpy()
    f_torch0, _ = tm.predict_f(torch.tensor(t_test))
    corr0 = float(np.corrcoef(f_torch0.numpy(), f_port0)[0, 1])
    max_diff0 = float(np.abs(f_torch0.numpy() - f_port0).max())
    print(f"Fixed-params latent posterior  corr={corr0:.6f}  "
          f"max|diff|={max_diff0:.3e}  (gate: corr >= 0.999)")

    # Trained agreement: each stack trains its own reference convention
    # (torch includes the measurement variances in its MLL): a recovery
    # check, not an implementation-parity bound.
    print("Training the port...")
    res = tr.fit(model, params0, X, y, tr.TrainConfig(num_iters=config.num_iters,
                                                      learning_rate=config.learning_rate))
    print("Training torch validation stack...")
    hist_t = tm.fit(y_host, epochs=config.num_iters, lr=config.learning_rate,
                    track_parameters=True)
    f_torch, f_var_torch = tm.predict_f(torch.tensor(t_test))
    with torch.no_grad():
        f_port = model.latent_predict(res.params, rows, X, y, var).mean.cpu().double().numpy()
    corr = float(np.corrcoef(f_torch.numpy(), f_port)[0, 1])
    print(f"\nFinal loss  port={_final_loss(res.history):.6f}  torch={hist_t[-1]:.6f}")
    print(f"Trained latent-force posterior correlation: {corr:.4f}")
    m_means, m_vars = tm.predict_m(torch.tensor(t_test))
    return AlfiParity(mll_delta, corr0, corr, data, t_test, f_torch, f_var_torch, m_means,
                      m_vars, tm.param_trace, res)


def alfi_parity_report(config: cfg.RunConfig, parity: AlfiParity) -> None:
    """The torch-side plots (the reference's ``plotter_alfi.py`` surface)."""
    from dis_project_tpu_torch.validation import torch_report

    p, out_dir = parity, config.out_dir
    torch_report.plot_lf_torch(p.t_test, p.f_torch.numpy(), p.f_var_torch.numpy(), p.data,
                               out_dir=out_dir)
    torch_report.plot_gxpred_torch(p.t_test, p.m_means.numpy(), p.m_vars.numpy(), p.data,
                                   out_dir=out_dir)
    torch_report.plot_comparison_torch(p.param_trace, p.data, out_dir=out_dir)
    torch_report.plot_param_trace_torch(p.param_trace, p.data, out_dir=out_dir)
    print(f"Torch-side plots saved under {out_dir}/ "
          "(lf_torch, gxpr_torch, comparison_torch, param_trace_torch)")


def check_alfi_parity(parity: AlfiParity) -> None:
    """The three gates; a failure exits with the JAX package's message."""
    if parity.mll_delta > 1e-6:
        raise SystemExit(
            f"cross-framework parity FAILED (fixed-params |MLL delta| "
            f"{parity.mll_delta:.3e} > 1e-6)"
        )
    if parity.corr0 < 0.999:
        raise SystemExit(
            f"cross-framework parity FAILED (fixed-params corr {parity.corr0:.6f} < 0.999)"
        )
    if parity.corr < 0.95:
        raise SystemExit(
            f"cross-framework parity FAILED (trained corr {parity.corr:.4f} < 0.95)"
        )
    print("Cross-framework parity OK")


def run_alfi_parity(config: cfg.RunConfig) -> float:
    """:func:`alfi_parity`, its plots, its gates; returns the trained
    correlation."""
    parity = alfi_parity(config)
    alfi_parity_report(config, parity)
    check_alfi_parity(parity)
    return parity.corr


def synthetic_dense_data(genes: int, timepoints: int, seed: int, dtype, device):
    """The dense route's dataset: an exact SIMM prior draw at
    genes x timepoints, one replicate, noise std 0.1, from ``seed``."""
    from dis_project_tpu_torch.data import synthetic

    scfg = synthetic.SyntheticConfig(
        num_genes=genes, num_timepoints=timepoints, num_replicates=1, noise_std=0.1
    )
    return synthetic.sample_prior(
        torch.Generator().manual_seed(seed), scfg, dtype=dtype, device=device
    )


def dense_gram(device, dtype) -> str:
    """The dense route's Gram: ``'row'`` (K2 and its backward kernel) on
    the card in float32, ``'gridded'`` (the table Gram) on the CPU or in
    float64 — the JAX package's choice, which takes the row Gram only on
    its accelerator in float32."""
    on_card_f32 = torch.device(device).type == "cuda" and dtype == torch.float32
    return "row" if on_card_f32 else "gridded"


def fit_cg(model, raw0, X, y, num_iters: int, learning_rate: float, probes_for_step):
    """The CG route's training loop: ``chain(clip_by_global_norm(10),
    Adam(learning_rate))`` on ``-model.mll_iterative`` with 24 Lanczos
    steps and at most 128 CG iterations, the probes of step ``i`` from
    ``probes_for_step(i)`` ((16, N) ±1). Returns ``(raw, opt_state, losses,
    stats, step_seconds)``, ``stats`` being each step's ``batched_cg``
    stats."""
    from dis_project_tpu_torch.models import simm
    from dis_project_tpu_torch.training import generic

    optimizer = generic.Chain(generic.ClipByGlobalNorm(CG_CLIP), generic.Adam(learning_rate))
    raw, opt_state = raw0, optimizer.init(raw0)
    losses, stats, step_seconds = [], [], []
    for i in range(num_iters):
        ts = time.perf_counter()
        probes, st = probes_for_step(i), {}

        def objective(r):
            return -model.mll_iterative(simm.constrain(r), X, y, probes,
                                        CG_LANCZOS_ITERS, CG_MAX_ITERS, st)

        loss, grads = generic.value_and_grad(objective, raw)
        updates, opt_state = optimizer.update(grads, opt_state, raw, loss)
        raw = generic.apply_updates(raw, updates)
        losses.append(float(loss))  # host fetch: the step has finished
        stats.append(st)
        step_seconds.append(time.perf_counter() - ts)
    return raw, opt_state, losses, stats, step_seconds


def fit_dense_adam(objective, raw, num_iters: int, learning_rate: float, ss_stats=None,
                   forward_s=None, clamp_raw=None):
    """The dense routes' training loop: Adam on ``objective(raw)``, a host
    fetch of each step's loss (the step's end). Returns ``(raw, opt_state,
    losses, norms, step_seconds)``. With ``ss_stats`` (a list) it appends
    each step's host seconds of the loss (the last entry of ``forward_s``,
    which the objective appends to) and of the value and gradient.
    ``clamp_raw`` projects the raw parameters after every update."""
    from dis_project_tpu_torch.training import generic

    optimizer = generic.Adam(learning_rate)
    opt_state = optimizer.init(raw)
    losses, norms, step_seconds = [], [], []
    for _ in range(num_iters):
        ts = time.perf_counter()
        loss, grads = generic.value_and_grad(objective, raw)
        vg_s = time.perf_counter() - ts
        updates, opt_state = optimizer.update(grads, opt_state)
        raw = generic.apply_updates(raw, updates)
        if clamp_raw is not None:
            raw = clamp_raw(raw)
        losses.append(float(loss))  # host fetch: the step has finished
        norms.append(float(generic.global_norm(grads)))
        step_seconds.append(time.perf_counter() - ts)
        if ss_stats is not None:
            ss_stats.append({"forward_host_s": forward_s[-1], "value_and_grad_host_s": vg_s})
    return raw, opt_state, losses, norms, step_seconds


def print_ss_step(ss_stats, step_seconds, T: int) -> None:
    """The ss routes' "State-space step" line: the loop enqueues without a
    sync, so on the card its host time per filter step, beside the step's
    wall, says who sets the pace."""
    fwd_us = statistics.median(1e6 * st["forward_host_s"] / T for st in ss_stats)
    vg_us = statistics.median(1e6 * st["value_and_grad_host_s"] / T for st in ss_stats)
    step_ms = statistics.median(1e3 * t for t in step_seconds)
    print(f"State-space step: median {step_ms:.3f} ms; host us per filter step "
          f"{fwd_us:.1f} (loss) / {vg_us:.1f} (loss and gradient); host share of the "
          f"step {vg_us * T / (1e3 * step_ms):.3f}")


def run_dense(config: cfg.RunConfig) -> DenseRun:
    """Dense exact-GP stress run: synthetic first-order data at
    N = genes x timepoints, full-batch training through the engine of
    ``--mll-engine``, and ground-truth kinetics recovery (``--model
    simm2``: :func:`run_dense_second_order`; ``multisimm``:
    :func:`run_dense_multiforce`; ``delaysimm``: :func:`run_dense_delay`;
    ``nlfm``: :func:`run_dense_nlfm`)."""
    from dis_project_tpu_torch.data.dataset import train_arrays
    from dis_project_tpu_torch.models import simm
    from dis_project_tpu_torch.ops import iterative
    from dis_project_tpu_torch.ops import statespace as ss_ops
    from dis_project_tpu_torch.ops.precision import default_device, dtype_for
    from dis_project_tpu_torch.training import trainer as tr

    if config.model != "simm":
        return {"simm2": run_dense_second_order, "multisimm": run_dense_multiforce,
                "delaysimm": run_dense_delay, "nlfm": run_dense_nlfm}[config.model](config)
    dev = default_device(config.device)
    dtype = dtype_for(config.x64)
    G, T = config.synth_genes, config.synth_timepoints
    print(f"Sampling synthetic LFM dataset: {G} genes x {T} timepoints "
          f"(N={G * T}) on {dev}...")
    data = synthetic_dense_data(G, T, config.seed, dtype, dev)
    X, y, var = train_arrays(data, dev, dtype)

    model = simm.ExactSIMM(num_genes=G, jitter=config.exact_jitter, canonical_rows=True)
    raw = simm.unconstrain(simm.init_params(G, dtype=dtype, device=dev))
    t0 = time.perf_counter()
    cg_stats = ss_stats = None
    if config.mll_engine == "cg":
        print(f"Training (full-batch exact MLL, CG/Lanczos engine, {dtype})...")
        gen = torch.Generator().manual_seed(config.seed + 1)
        raw, opt_state, losses, cg_stats, step_seconds = fit_cg(
            model, raw, X, y, config.num_iters, config.learning_rate,
            lambda _: iterative.rademacher(gen, CG_PROBES, X.shape[0], dtype, dev))
        norms = [0.0] * len(losses)
        params = simm.constrain(raw)
        with torch.no_grad():  # the exact final loss, one Cholesky evaluation
            final = float(-model.mll(params, X, y))
        iters = [s["cg_iters"] for s in cg_stats]
        us = [1e6 * s["cg_host_s"] / max(s["cg_iters"], 1) for s in cg_stats]
        print(f"CG iterations per step {iters} (cap {CG_MAX_ITERS}); columns converged "
              f"{[s['converged'] for s in cg_stats]} of {1 + CG_PROBES}; host us per "
              f"iteration {[round(u, 1) for u in us]}")
    else:
        timepoints = torch.as_tensor(data.timepoints, dtype=dtype, device=dev)
        forward_s = None
        if config.mll_engine == "ss":
            print(f"Training (full-batch exact MLL, {ss_engine(config)})...")
            ss_stats, forward_s = [], []
            objective = _ss_objective(lambda r: -ss_ops.lfm_mll_ss(
                simm.constrain(r), timepoints, y, jitter=model.jitter,
                force_kernel=config.force_kernel, stationary_after=config.stationary_after,
            ), forward_s)
        else:
            route = dense_gram(dev, dtype)
            print(f"Training (full-batch exact MLL, {route} Gram, Cholesky engine, {dtype})...")

            def objective(r):
                if route == "row":
                    return -model.mll(simm.constrain(r), X, y)
                return -model.mll_gridded(simm.constrain(r), timepoints, y)

        raw, opt_state, losses, norms, step_seconds = fit_dense_adam(
            objective, raw, config.num_iters, config.learning_rate, ss_stats, forward_s)
        params = simm.constrain(raw)
        final = _final_loss(losses)
        if ss_stats:
            print_ss_step(ss_stats, step_seconds, T)
    wall = time.perf_counter() - t0
    res = tr.TrainResult(
        params=params,
        history=torch.tensor(losses, dtype=torch.float64),
        grad_norms=torch.tensor(norms, dtype=torch.float64),
        raw_params=raw,
        opt_state=opt_state,
    )
    print(f"Trained {config.num_iters} iters in {wall:.2f}s "
          f"(final loss {final:.4f}, N={G * T})")
    if config.metrics_path:
        write_dense_metrics(config.metrics_path, res.history)

    b, s, d = data.params_ground_truth()
    trained_d = res.params.decay.detach().cpu().numpy()
    trained_s = res.params.sensitivity.detach().cpu().numpy()
    corr_d = float(np.corrcoef(trained_d, d)[0, 1])
    corr_s = float(np.corrcoef(trained_s, s)[0, 1])
    print(f"Ground-truth recovery: corr(decay)={corr_d:.3f} "
          f"corr(sensitivity)={corr_s:.3f}")
    out = DenseRun(res, model, data, X, y, var, step_seconds, cg_stats, final, ss_stats)
    if config.mll_engine == "ss":
        # The smoothed latent force: the dense conditional is O(N^3) at this
        # scale, the engine's RTS pass O(T) (JAX main.py:1429-1439).
        out.lf_grid = torch.linspace(float(timepoints[0]), float(timepoints[-1]) * 13.0 / 12.0,
                                     200, dtype=dtype, device=dev)
        nv = var.reshape(G, T).T + model.jitter
        out.lf_mean, out.lf_var, _, _ = ss_ops.lfm_predict_ss(
            params, timepoints, y, out.lf_grid, noise_var=nv, force_kernel=config.force_kernel)
    return out


def ss_engine(config: cfg.RunConfig) -> str:
    """The state-space route's engine description (JAX main.py:1303-1314)."""
    prior = ("order-10 SDE" if config.force_kernel == "rbf"
             else f"EXACT {config.force_kernel} prior")
    engine = f"state-space Kalman engine (O(T), {prior})"
    if config.stationary_after is not None:
        engine += f", steady-state gain after {config.stationary_after} warmup steps"
    return engine


def dense_ss_report(config: cfg.RunConfig, out: DenseRun) -> None:
    """The state-space route's host work: the smoothed latent force against
    the generating force (``lf_dense_ss_lf.png``), where matplotlib is
    installed; then, with ``--posterior-samples``,
    :func:`dense_ss_posterior`."""
    if _have_matplotlib():
        from dis_project_tpu_torch.models.base import Gaussian
        from dis_project_tpu_torch.reporting import plotter

        plotter.plot_lf(out.lf_grid[:, None],
                        Gaussian(mean=out.lf_mean, cov=torch.diag(out.lf_var)),
                        y_scatter=out.data.f_true, scatter_times=out.data.timepoints,
                        title="Smoothed latent force (state-space engine)",
                        save_name="dense_ss_lf", out_dir=config.out_dir)
        print(f"Smoothed latent-force plot saved under {config.out_dir}/")
    else:
        print("matplotlib is not installed: the smoothed latent-force plot is not drawn")
    if config.posterior_samples > 0:
        dense_ss_posterior(config, out)


def dense_ss_posterior(config: cfg.RunConfig, out: DenseRun) -> None:
    """``--preset dense10k --mll-engine ss --posterior-samples``: full-Bayes
    kinetics at dense scale through the O(T) likelihood
    (``training.hmc.kinetics_posterior_ss``, 10 leapfrog steps, with
    ``--force-kernel`` and ``--stationary-after``), the report capped at 10
    genes, and the BMA band of the smoothed force (``lfm_predict_ss`` per
    component, ``lf_dense_ss_bma.png``). Sets ``out.posterior`` and
    ``out.bma``."""
    from dis_project_tpu_torch.models.base import Gaussian
    from dis_project_tpu_torch.ops import statespace as ss_ops
    from dis_project_tpu_torch.training import hmc

    G, T = config.synth_genes, config.synth_timepoints
    dev, dtype = out.y.device, out.y.dtype
    timepoints = torch.as_tensor(out.data.timepoints, dtype=dtype, device=dev)
    nv = out.var.reshape(G, T).T + out.model.jitter
    n_draws = config.posterior_samples
    print(f"Sampling hyperparameter posterior at N={G * T} "
          f"via the O(T) state-space likelihood: {n_draws} HMC "
          f"draws ({n_draws} warmup)...")
    t0 = time.perf_counter()
    out.posterior = hmc.kinetics_posterior_ss(
        out.result.params, timepoints, out.y, posterior_generator(config, dev),
        jitter=out.model.jitter, num_warmup=n_draws, num_samples=n_draws,
        num_chains=config.posterior_chains, force_kernel=config.force_kernel,
        stationary_after=config.stationary_after)
    samples = _finish_posterior(out.posterior, t0, config, out.data, "dense_ss",
                                max_report_genes=10)

    def predict(p):
        fm, fv, _, _ = ss_ops.lfm_predict_ss(p, timepoints, out.y, out.lf_grid, noise_var=nv,
                                             force_kernel=config.force_kernel)
        return Gaussian(mean=fm, cov=torch.diag(fv))

    out.bma = _plot_bma_latent(
        predict, samples, Gaussian(mean=out.lf_mean, cov=torch.diag(out.lf_var)),
        out.lf_grid[:, None], out.data, config, "dense_ss_bma",
        "Smoothed latent force (BMA over the kinetics posterior)")


@dataclasses.dataclass
class FamilyRun:
    """A model family's p53 route: the fit, its latent posterior and data."""

    result: Any  # training.generic.LoopResult
    # models.base.Gaussian over the 100-point latent grid; the multi-force
    # route's holds the R forces, mean (R, 100) and covariance (R, 100, 100)
    latent: Any
    data: Any  # data.dataset.P53Data
    t_grid: torch.Tensor
    wall_s: float  # the fit's wall seconds
    # --posterior-samples: the HMC result (constrained draws) and the BMA
    # band (the nlfm route's: the full-Bayes force band)
    posterior: Any = None
    bma: Any = None


def _check_route_flags(config: cfg.RunConfig, route: str, rejected) -> None:
    """A family route's refusal of flags it does not implement, with the
    JAX package's message."""
    for flag, name in rejected:
        if flag:
            raise SystemExit(f"{name} is not supported by the --model {route} route")


def run_second_order(config: cfg.RunConfig) -> FamilyRun:
    """The second-order (spring-damper) LFM on the p53 data, the
    ``--model simm2`` route: ``SecondOrderSIMM.mll`` on the training rows,
    ``training.generic.fit_loop`` (or ``fit_checkpointed`` under
    ``--checkpoint-dir``), the metrics JSONL, the kinetics table with
    damping and spring, the latent force on ``latent_grid(100)``; with
    matplotlib, the parameter trace (``--track-parameters``) and the
    latent-force plot."""
    from dis_project_tpu_torch.data.dataset import P53Data, train_arrays
    from dis_project_tpu_torch.models import simm2
    from dis_project_tpu_torch.ops.precision import default_device, dtype_for
    from dis_project_tpu_torch.training import generic
    from dis_project_tpu_torch.utils.test_grids import latent_grid

    # The second-order kernels have no p21-style clamp: the toggle means
    # nothing here.
    _check_route_flags(config, "simm2", ((not config.fix_params, "--no-fix-params"),))
    dev = default_device(config.device)
    dtype = dtype_for(config.x64)
    data = P53Data(replicate=config.replicate, data_dir=config.data_dir,
                   selected_genes=config.selected_genes, source=config.data_source,
                   seed=config.seed)
    X, y, var = train_arrays(data, dev, dtype)
    model = simm2.SecondOrderSIMM(num_genes=data.num_genes, jitter=config.exact_jitter)
    raw = simm2.unconstrain(simm2.init_params(data.num_genes, dtype=dtype, device=dev))

    def loss(r):
        return -model.mll(simm2.constrain(r), X, y)

    print(f"Training second-order LFM on {dev} ({dtype})...")
    t0 = time.perf_counter()
    loop_kw = dict(num_iters=config.num_iters, learning_rate=config.learning_rate,
                   optimizer=config.optimizer, constrain_fn=simm2.constrain,
                   track_parameters=config.track_parameters)
    if config.checkpoint_dir:
        result = generic.fit_checkpointed(loss, raw, directory=config.checkpoint_dir,
                                          resume=config.resume, **loop_kw)
    else:
        result = generic.fit_loop(loss, raw, **loop_kw)
    final = _final_loss(result.history)
    wall = time.perf_counter() - t0
    print(f"Trained {config.num_iters} iters in {wall:.2f}s (final loss {final:.6f})")
    if config.metrics_path:
        write_metrics(config.metrics_path, result)
        print(f"Metrics written to {config.metrics_path}")
    plots = _have_matplotlib()
    trace = result.param_trace
    if config.track_parameters and trace is not None and plots:
        _plot_trace(config, {"basal": trace.basal, "sensitivity": trace.sensitivity,
                             "alpha": trace.alpha, "omega": trace.omega},
                    data.gene_names, "simm2")

    params = result.params
    damping, spring = simm2.damping(params), simm2.spring(params)
    print("\nGene       Basal     Sensitivity  Alpha     Omega     Damping   Spring")
    for i, g in enumerate(data.gene_names):
        print(f"{g:<10} {float(params.basal[i]):<9.4f} {float(params.sensitivity[i]):<12.4f} "
              f"{float(params.alpha[i]):<9.4f} {float(params.omega[i]):<9.4f} "
              f"{float(damping[i]):<9.4f} {float(spring[i]):<9.4f}")

    t_grid = latent_grid(100, dtype=dtype, device=dev)
    with torch.no_grad():
        latent = model.latent_predict(params, t_grid, X, y, var)
    if plots:
        from dis_project_tpu_torch.reporting import plotter

        plotter.plot_lf(t_grid, latent, y_scatter=data.f_observed,
                        scatter_times=data.timepoints,
                        save_name=config.save_name or "simm2", out_dir=config.out_dir)
        print(f"Latent-force plot saved under {config.out_dir}/")
    else:
        print("matplotlib is not installed: the latent-force plot is not drawn")
    return FamilyRun(result, latent, data, t_grid, wall)


def synthetic_ode2_data(genes: int, timepoints: int, seed: int, dtype, device):
    """The dense second-order route's dataset: ``generate_ode2`` at
    genes x timepoints, one replicate, noise std 0.1, oversample 4, from
    ``seed``."""
    from dis_project_tpu_torch.data import synthetic

    scfg = synthetic.SyntheticConfig(
        num_genes=genes, num_timepoints=timepoints, num_replicates=1, noise_std=0.1
    )
    return synthetic.generate_ode2(torch.Generator().manual_seed(seed), scfg, oversample=4,
                                   dtype=dtype, device=device)


def run_dense_second_order(config: cfg.RunConfig) -> DenseRun:
    """Dense exact second-order run: full-batch MLL on quadrature-generated
    spring-damper data at N = genes x timepoints, Adam, and the alpha/omega
    recovery correlations. ``--mll-engine cholesky``: the table Gram
    (``SecondOrderSIMM.mll_gridded``), cuSOLVER's factor and the MLL's
    custom backward (K3 on the card in float32 above N = 2048);
    ``--mll-engine ss``: ``ops.statespace.lfm2_mll_ss`` (order-10 SDE or an
    exact Matern force prior, ``--stationary-after``). The JAX package cuts
    this fit into 25-step device programs for its remote-TPU transport; the
    history is the same without the cut."""
    from dis_project_tpu_torch.data.dataset import train_arrays
    from dis_project_tpu_torch.models import simm2
    from dis_project_tpu_torch.ops import statespace as ss_ops
    from dis_project_tpu_torch.ops.precision import default_device, dtype_for
    from dis_project_tpu_torch.training import generic

    dev = default_device(config.device)
    dtype = dtype_for(config.x64)
    G, T = config.synth_genes, config.synth_timepoints
    print(f"Sampling synthetic order-2 ODE dataset: {G} x {T} (N={G * T}) on {dev}...")
    data = synthetic_ode2_data(G, T, config.seed, dtype, dev)
    X, y, var = train_arrays(data, dev, dtype)
    model = simm2.SecondOrderSIMM(num_genes=G, jitter=config.exact_jitter)
    raw = simm2.unconstrain(simm2.init_params(G, dtype=dtype, device=dev))
    tgrid = torch.as_tensor(data.timepoints, dtype=dtype, device=dev)

    ss_stats = forward_s = None
    if config.mll_engine == "ss":
        engine = ss_engine(config)
        ss_stats, forward_s = [], []
        objective = _ss_objective(lambda r: -ss_ops.lfm2_mll_ss(
            simm2.constrain(r), tgrid, y, jitter=config.exact_jitter,
            force_kernel=config.force_kernel, stationary_after=config.stationary_after),
            forward_s)
    else:
        engine = "order-2 table Gram, Cholesky engine"

        def objective(r):
            return -model.mll_gridded(simm2.constrain(r), tgrid, y)

    print(f"Training (full-batch exact second-order MLL, {engine})...")
    t0 = time.perf_counter()
    raw, opt_state, losses, norms, step_seconds = fit_dense_adam(
        objective, raw, config.num_iters, config.learning_rate, ss_stats, forward_s)
    if ss_stats:
        print_ss_step(ss_stats, step_seconds, T)
    f64 = torch.float64
    hist = torch.tensor(losses, dtype=f64)
    print(f"Trained {config.num_iters} iters in {time.perf_counter() - t0:.2f}s "
          f"(final loss {_final_loss(losses):.4f}, N={G * T})")
    params = simm2.constrain(raw)
    res = generic.LoopResult(raw=raw, params=params, history=hist,
                             grad_norms=torch.tensor(norms, dtype=f64), opt_state=opt_state)
    _, _, a_true, w_true = data.params_ground_truth()
    corr_a = float(np.corrcoef(params.alpha.detach().cpu().numpy(), a_true)[0, 1])
    corr_w = float(np.corrcoef(params.omega.detach().cpu().numpy(), w_true)[0, 1])
    print(f"Ground-truth recovery: corr(alpha)={corr_a:.3f} corr(omega)={corr_w:.3f}")
    if config.metrics_path:
        write_dense_metrics(config.metrics_path, hist)
    return DenseRun(res, model, data, X, y, var, step_seconds, final_loss=_final_loss(losses),
                    ss_stats=ss_stats)


@dataclasses.dataclass
class SparseRun:
    """The sparse route's fit, its latent posteriors and data."""

    result: Any  # training.svtrainer.SVTrainResult
    model: Any  # models.svlfm.SparseSIMM
    data: Any  # data.synthetic.SyntheticLFMData
    X: torch.Tensor
    y: torch.Tensor
    var: torch.Tensor
    history: np.ndarray  # (num_epochs, batches) negative ELBO, on the host
    t_grid: torch.Tensor
    latent: List[Any]  # one models.base.Gaussian per force
    corrs: List[float]  # each force's recovery correlation (matched when R > 1)
    data_s: float  # wall seconds of the data generation
    fit_s: float  # wall seconds of the fit, the history's read included


def synthetic_sparse_data(genes: int, timepoints: int, order: int, num_forces: int, seed: int,
                          dtype, device):
    """The sparse route's dataset: ``generate_ode`` (``generate_ode2`` for
    order 2, ``generate_ode_multi`` for R > 1 forces) at genes x timepoints,
    one replicate, noise std 0.1, oversample 4 (keeps the fine-grid force's
    Cholesky tractable at 1000 timepoints), from ``seed``."""
    from dis_project_tpu_torch.data import synthetic

    scfg = synthetic.SyntheticConfig(
        num_genes=genes, num_timepoints=timepoints, num_replicates=1, noise_std=0.1
    )
    gen = torch.Generator().manual_seed(seed)
    if num_forces > 1:
        return synthetic.generate_ode_multi(gen, scfg, num_forces=num_forces, oversample=4,
                                            dtype=dtype, device=device)
    if order == 2:
        return synthetic.generate_ode2(gen, scfg, oversample=4, dtype=dtype, device=device)
    return synthetic.generate_ode(gen, scfg, oversample=4, dtype=dtype, device=device)


def match_forces(cors: np.ndarray) -> dict:
    """The JAX route's unique greedy matching of posterior forces (rows) to
    generating forces (columns) by |corr|, best first: the ELBO does not
    change when the forces are relabelled, and an independent argmax per
    force could map two posteriors onto the same truth."""
    R = cors.shape[0]
    match, taken = {}, set()
    for r, j in sorted(((r, j) for r in range(R) for j in range(R)),
                       key=lambda rj: -abs(cors[rj])):
        if r not in match and j not in taken:
            match[r] = j
            taken.add(j)
    return match


def run_sparse(config: cfg.RunConfig) -> SparseRun:
    """Sparse variational stress run (BASELINE config 5): quadrature data
    at N up to 1e5 (:func:`synthetic_sparse_data`), minibatch SVI on the
    whitened ELBO with latent-force inducing points (``SparseSIMM`` with
    ``--jitter`` or 1e-6, ``svtrainer.fit``), the latent posterior on the
    T-point grid with its recovery correlation (R forces: JAX's unique
    greedy matching, one line and one plot per force), the plots where
    matplotlib is installed, and one ``{epoch, neg_elbo_mean}`` line per
    epoch in ``--metrics-path``."""
    from dis_project_tpu_torch.data import synthetic
    from dis_project_tpu_torch.data.dataset import train_arrays
    from dis_project_tpu_torch.models import svlfm
    from dis_project_tpu_torch.ops.precision import default_device, dtype_for
    from dis_project_tpu_torch.training import svtrainer

    dev = default_device(config.device)
    dtype = dtype_for(config.x64)
    G, T = config.synth_genes, config.synth_timepoints
    order = 2 if config.model == "simm2" else 1
    n_forces = config.num_forces if config.model == "multisimm" else 1
    kind = f"{n_forces}-force order-1" if n_forces > 1 else f"order-{order}"
    print(f"Sampling synthetic {kind} ODE dataset via quadrature: {G} x {T} (N={G * T})...")
    t0 = time.perf_counter()
    data = synthetic_sparse_data(G, T, order, n_forces, config.seed, dtype, dev)
    X, y, var = train_arrays(data, dev, dtype)
    data_s = time.perf_counter() - t0

    model = svlfm.SparseSIMM(num_genes=G, num_inducing=config.num_inducing,
                             jitter=config.sparse_jitter, order=order, num_forces=n_forces)
    t_max = synthetic.SyntheticConfig.t_max
    params = svlfm.init_params(G, config.num_inducing, t_max=t_max, dtype=dtype, order=order,
                               num_forces=n_forces, device=dev)
    print(f"Training SVI: {config.num_epochs} epochs, batch {config.batch_size}, "
          f"M={config.num_inducing} inducing points...")
    t0 = time.perf_counter()
    res = svtrainer.fit(model, params, X, y, var, svtrainer.SVTrainConfig(
        num_epochs=config.num_epochs, batch_size=config.batch_size,
        learning_rate=config.learning_rate, seed=config.seed))
    hist = res.history.detach().cpu().numpy()
    fit_s = time.perf_counter() - t0
    print(f"Trained {hist.size} minibatch steps in {fit_s:.2f}s "
          f"(neg-ELBO first epoch {hist[0].mean():.1f} -> "
          f"last epoch {hist[-1].mean():.1f})")

    t_grid = torch.as_tensor(np.linspace(0.0, t_max, T), dtype=dtype, device=dev)
    f_true = data.f_true.detach().cpu().numpy().reshape(n_forces, T)
    with torch.no_grad():
        posts = [model.latent_predict(res.params, t_grid, force=r) for r in range(n_forces)]
    means = [p.mean.detach().cpu().numpy() for p in posts]
    plots = _have_matplotlib()
    if plots:
        from dis_project_tpu_torch.reporting import plotter
    if n_forces > 1:
        cors = np.array([[float(np.corrcoef(m, f_true[j])[0, 1]) for j in range(n_forces)]
                         for m in means])
        match = match_forces(cors)
        corrs = []
        for r, post in enumerate(posts):
            best = match[r]
            corrs.append(float(cors[r, best]))
            print(f"Latent force {r} recovery: corr {cors[r, best]:+.3f} "
                  f"(vs generating force {best})")
            if plots:
                plotter.plot_lf(torch.stack([t_grid, torch.full_like(t_grid, r),
                                             torch.zeros_like(t_grid)], -1),
                                post, y_scatter=np.sign(cors[r, best]) * f_true[best],
                                scatter_times=data.timepoints, title=f"force {r}",
                                save_name=(config.save_name or "sparse_lf") + f"_f{r}",
                                out_dir=config.out_dir)
    else:
        corrs = [float(np.corrcoef(means[0], f_true[0])[0, 1])]
        print(f"Latent-force recovery correlation vs generating force: {corrs[0]:.3f}")
        if plots:
            plotter.plot_lf(torch.stack([t_grid, -torch.ones_like(t_grid),
                                         torch.zeros_like(t_grid)], -1),
                            posts[0], y_scatter=f_true.reshape(1, 1, -1),
                            scatter_times=data.timepoints,
                            save_name=config.save_name or "sparse_lf", out_dir=config.out_dir)
    if plots:
        print(f"Latent-force recovery plot saved under {config.out_dir}/")
    else:
        print("matplotlib is not installed: the latent-force recovery plot is not drawn")
    if config.metrics_path:
        with open(config.metrics_path, "w") as f:
            for e, row in enumerate(hist):
                f.write(json.dumps({"epoch": e, "neg_elbo_mean": float(row.mean())}) + "\n")
    return SparseRun(res, model, data, X, y, var, hist, t_grid, posts, corrs, data_s, fit_s)


def _plot_trace(config, trace, names, default_name) -> None:
    """A family route's parameter-trace plot, where matplotlib is installed."""
    from dis_project_tpu_torch.reporting import plotter

    plotter.plot_param_trace(trace, names, save_name=config.save_name or default_name,
                             out_dir=config.out_dir)
    print("Parameter trace plotted")


def run_multiforce(config: cfg.RunConfig) -> FamilyRun:
    """The R-force exact SIMM on the p53 data, the ``--model multisimm``
    route (``--num-forces`` R): ``multisimm.fit`` (``generic.fit_loop``),
    the metrics JSONL, the lengthscale and kinetics table, one latent
    posterior per force on ``linspace(0, 13, 100)``; with matplotlib, the
    per-force plots and the parameter trace. ``--checkpoint-dir`` is
    refused: the JAX package's ``multisimm.fit`` raises ``NameError`` on it
    (``multisimm.CHECKPOINT_REFUSAL``)."""
    from dis_project_tpu_torch.data.dataset import P53Data, train_arrays
    from dis_project_tpu_torch.models import multisimm
    from dis_project_tpu_torch.models.base import Gaussian
    from dis_project_tpu_torch.ops.precision import default_device, dtype_for

    # No p21 clamp (the distinct lengthscale inits identify the forces) and
    # no tied-kinetics variant.
    _check_route_flags(config, "multisimm", ((not config.fix_params, "--no-fix-params"),
                                             (config.shared_kinetics, "--shared-kinetics")))
    if config.num_forces < 1:
        raise SystemExit("--num-forces must be >= 1")
    if config.checkpoint_dir:
        raise SystemExit(multisimm.CHECKPOINT_REFUSAL)
    dev = default_device(config.device)
    dtype = dtype_for(config.x64)
    data = P53Data(replicate=config.replicate, data_dir=config.data_dir,
                   selected_genes=config.selected_genes, source=config.data_source,
                   seed=config.seed)
    X, y, var = train_arrays(data, dev, dtype)
    R = config.num_forces
    model = multisimm.ExactMultiSIMM(num_genes=data.num_genes, num_forces=R,
                                     jitter=config.exact_jitter)
    print(f"Training {R}-force exact SIMM on {dev} ({dtype})...")
    t0 = time.perf_counter()
    result = multisimm.fit(model, multisimm.init_params(data.num_genes, R, dtype, dev), X, y,
                           num_iters=config.num_iters, learning_rate=config.learning_rate,
                           optimizer=config.optimizer, track_parameters=config.track_parameters,
                           full_result=True)
    wall = time.perf_counter() - t0
    print(f"Trained {config.num_iters} iters in {wall:.2f}s "
          f"(final loss {_final_loss(result.history):.6f})")
    if config.metrics_path:
        write_metrics(config.metrics_path, result)
        print(f"Metrics written to {config.metrics_path}")
    plots = _have_matplotlib()
    tr = result.param_trace
    if config.track_parameters and tr is not None and plots:
        trace = {"basal": tr.basal, "decay": tr.decay,
                 **{f"sensitivity f{r}": tr.sensitivity[:, :, r] for r in range(R)}}
        _plot_trace(config, trace, data.gene_names, "multiforce")

    params = result.params
    print("\nlengthscales:", [round(float(ell), 4) for ell in params.lengthscale])
    print("Gene       Basal     Decay     " + "  ".join(f"S[f{r}]   " for r in range(R)))
    for i, g in enumerate(data.gene_names):
        srow = "  ".join(f"{float(params.sensitivity[i, r]):<8.4f}" for r in range(R))
        print(f"{g:<10} {float(params.basal[i]):<9.4f} {float(params.decay[i]):<9.4f} {srow}")

    t_lin = torch.linspace(0.0, 13.0, 100, dtype=dtype, device=dev)
    with torch.no_grad():
        posts = [model.latent_predict(params, multisimm.force_rows(t_lin, r, dtype, dev),
                                      X, y, var) for r in range(R)]
    if plots:
        from dis_project_tpu_torch.reporting import plotter

        for r, post in enumerate(posts):
            plotter.plot_lf(multisimm.force_rows(t_lin, r, dtype, dev), post,
                            y_scatter=data.f_observed, scatter_times=data.timepoints,
                            title=f"force {r}",
                            save_name=(config.save_name or "multiforce") + f"_f{r}",
                            out_dir=config.out_dir)
        print(f"Per-force latent plots saved under {config.out_dir}/")
    else:
        print("matplotlib is not installed: the per-force latent plots are not drawn")
    latent = Gaussian(mean=torch.stack([p.mean for p in posts]),
                      cov=torch.stack([p.cov for p in posts]))
    return FamilyRun(result, latent, data, t_lin, wall)


def synthetic_multi_data(genes: int, timepoints: int, num_forces: int, seed: int, dtype,
                         device):
    """The dense multi-force route's dataset: ``generate_ode_multi`` at
    genes x timepoints with R forces, one replicate, noise std 0.1,
    oversample 4, from ``seed``."""
    from dis_project_tpu_torch.data import synthetic

    scfg = synthetic.SyntheticConfig(
        num_genes=genes, num_timepoints=timepoints, num_replicates=1, noise_std=0.1
    )
    return synthetic.generate_ode_multi(torch.Generator().manual_seed(seed), scfg,
                                        num_forces=num_forces, oversample=4, dtype=dtype,
                                        device=device)


def matched_force_correlations(s_fit, s_true) -> List[float]:
    """Per-force sensitivity-column correlations under the JAX route's
    unique greedy |corr| matching (the MLL does not change when the forces
    are relabelled): fitted column r against its matched true column."""
    R = s_true.shape[1]
    cors = np.array([[float(np.corrcoef(s_fit[:, r], s_true[:, j])[0, 1]) for j in range(R)]
                     for r in range(R)])
    match = match_forces(cors)
    return [float(cors[r, match[r]]) for r in range(R)]


def _ss_objective(loss_of, forward_s):
    """A state-space route's objective, appending each loss's host seconds
    to ``forward_s``."""
    def objective(r):
        ts = time.perf_counter()
        loss = loss_of(r)
        forward_s.append(time.perf_counter() - ts)
        return loss
    return objective


def run_dense_multiforce(config: cfg.RunConfig) -> DenseRun:
    """Dense multi-force run, ``--preset dense10k --model multisimm
    --mll-engine ss``: ``generate_ode_multi`` data (R = ``--num-forces``,
    oversample 4) at N = genes x timepoints, full-batch Adam on
    ``ops.statespace.multisimm_mll_ss`` (``--force-kernel`` for every force,
    ``--stationary-after``), the decay and matched per-force sensitivity
    recovery, the dense metrics file. The JAX package cuts this fit into
    25-step device programs for its remote-TPU transport; the history is
    the same without the cut."""
    from dis_project_tpu_torch.data.dataset import train_arrays
    from dis_project_tpu_torch.models import multisimm
    from dis_project_tpu_torch.ops import statespace as ss_ops
    from dis_project_tpu_torch.ops.precision import default_device, dtype_for
    from dis_project_tpu_torch.training import generic

    R = config.num_forces
    if R < 1:
        raise SystemExit("--num-forces must be >= 1")
    dev = default_device(config.device)
    dtype = dtype_for(config.x64)
    G, T = config.synth_genes, config.synth_timepoints
    print(f"Sampling synthetic {R}-force ODE dataset via quadrature: {G} x {T} (N={G * T}) "
          f"on {dev}...")
    data = synthetic_multi_data(G, T, R, config.seed, dtype, dev)
    X, y, var = train_arrays(data, dev, dtype)
    tgrid = torch.as_tensor(data.timepoints, dtype=dtype, device=dev)
    raw = multisimm.unconstrain(multisimm.init_params(G, R, dtype, dev))
    fks = (config.force_kernel,) * R  # one prior for every force
    ss_stats, forward_s = [], []
    objective = _ss_objective(lambda r: -ss_ops.multisimm_mll_ss(
        multisimm.constrain(r), tgrid, y, jitter=config.exact_jitter, force_kernels=fks,
        stationary_after=config.stationary_after), forward_s)
    print(f"Training (full-batch exact {R}-force MLL, {ss_engine(config)})...")
    t0 = time.perf_counter()
    raw, opt_state, losses, norms, step_seconds = fit_dense_adam(
        objective, raw, config.num_iters, config.learning_rate, ss_stats, forward_s)
    print_ss_step(ss_stats, step_seconds, T)
    f64 = torch.float64
    hist = torch.tensor(losses, dtype=f64)
    print(f"Trained {config.num_iters} iters in {time.perf_counter() - t0:.2f}s "
          f"(final loss {_final_loss(losses):.4f}, N={G * T})")
    p = multisimm.constrain(raw)
    res = generic.LoopResult(raw=raw, params=p, history=hist,
                             grad_norms=torch.tensor(norms, dtype=f64), opt_state=opt_state)
    s_true = data.params_true["sensitivity"].detach().cpu().numpy()
    d_true = data.params_true["decay"].detach().cpu().numpy()
    corr_d = float(np.corrcoef(p.decay.detach().cpu().numpy(), d_true)[0, 1])
    corr_s = matched_force_correlations(p.sensitivity.detach().cpu().numpy(), s_true)
    print(f"Ground-truth recovery: corr(decay)={corr_d:.3f} "
          + " ".join(f"corr(S[:,{r}])={c:.3f}" for r, c in enumerate(corr_s)))
    if config.metrics_path:
        write_dense_metrics(config.metrics_path, hist)
    model = multisimm.ExactMultiSIMM(num_genes=G, num_forces=R, jitter=config.exact_jitter)
    return DenseRun(res, model, data, X, y, var, step_seconds, final_loss=_final_loss(losses),
                    ss_stats=ss_stats)


def run_delay(config: cfg.RunConfig) -> FamilyRun:
    """The delayed-response exact SIMM on the p53 data, the ``--model
    delaysimm`` route: ``delaysimm.fit`` with the p21 kinetics and delay
    pinned when p21 is present (``fit_checkpointed`` under
    ``--checkpoint-dir``), the metrics JSONL, the hyperparameter table and
    ``hyperparams.csv`` (written into the working directory, as the JAX
    route writes it), the delay table, the latent force on
    ``latent_grid(100)``; with matplotlib, the parameter trace and the
    latent-force plot. On the card the training Gram is K2 with K2's
    backward, the posterior's cross-covariance K1."""
    from dis_project_tpu_torch.data.dataset import P53Data, train_arrays
    from dis_project_tpu_torch.models import delaysimm
    from dis_project_tpu_torch.ops.precision import default_device, dtype_for
    from dis_project_tpu_torch.reporting import tables
    from dis_project_tpu_torch.utils.test_grids import latent_grid

    _check_route_flags(config, "delaysimm", ((config.shared_kinetics, "--shared-kinetics"),))
    dev = default_device(config.device)
    dtype = dtype_for(config.x64)
    data = P53Data(replicate=config.replicate, data_dir=config.data_dir,
                   selected_genes=config.selected_genes, source=config.data_source,
                   seed=config.seed)
    X, y, var = train_arrays(data, dev, dtype)
    model = delaysimm.ExactDelaySIMM(num_genes=data.num_genes, jitter=config.exact_jitter)
    has_p21 = "p21" in data.gene_names
    print(f"Training delayed-response exact SIMM on {dev} ({dtype})...")
    t0 = time.perf_counter()
    result = delaysimm.fit(
        model, delaysimm.init_params(data.num_genes, dtype, dev), X, y,
        num_iters=config.num_iters, learning_rate=config.learning_rate,
        fix_params=config.fix_params and has_p21,
        clamp_gene=data.gene_names.index("p21") if has_p21 else 0,
        optimizer=config.optimizer, track_parameters=config.track_parameters,
        checkpoint_dir=config.checkpoint_dir, resume=config.resume, full_result=True)
    wall = time.perf_counter() - t0
    print(f"Trained {config.num_iters} iters in {wall:.2f}s "
          f"(final loss {_final_loss(result.history):.6f})")
    if config.metrics_path:
        write_metrics(config.metrics_path, result)
        print(f"Metrics written to {config.metrics_path}")
    plots = _have_matplotlib()
    tr = result.param_trace
    if config.track_parameters and tr is not None and plots:
        _plot_trace(config, {"basal": tr.basal, "sensitivity": tr.sensitivity,
                             "decay": tr.decay, "delay": tr.delay}, data.gene_names, "delay")

    params = result.params
    tables.print_hyperparams(params, data, csv_path="hyperparams.csv")
    anchor = " (anchor: p21 pinned to 0)" if config.fix_params and has_p21 else ""
    print(f"\nper-gene transcriptional delays{anchor}:")
    for i, g in enumerate(data.gene_names):
        print(f"  {g:<10} {float(params.delay[i]):.4f}")

    t_grid = latent_grid(100, dtype=dtype, device=dev)
    with torch.no_grad():
        latent = model.latent_predict(params, t_grid, X, y, var)
    if plots:
        from dis_project_tpu_torch.reporting import plotter

        plotter.plot_lf(t_grid, latent, y_scatter=data.f_observed, scatter_times=data.timepoints,
                        title="delayed response", save_name=config.save_name or "delay",
                        out_dir=config.out_dir)
        print(f"Latent-force plot saved under {config.out_dir}/")
    else:
        print("matplotlib is not installed: the latent-force plot is not drawn")
    out = FamilyRun(result, latent, data, t_grid, wall)
    if config.posterior_samples > 0:
        delay_posterior(config, out, model, X, y, var)
    return out


def delay_posterior(config: cfg.RunConfig, out: FamilyRun, model, X, y, var) -> None:
    """``--model delaysimm --posterior-samples``: HMC over (kinetics,
    delays) (``models.delaysimm.kinetics_posterior``: on the card K2 and
    K2's backward at the warped rows every gradient), the kinetics report,
    the posterior-delay table and the BMA band through the warped-input
    ``latent_predict`` (``lf_<save-name or delay>_bma.png``). Sets
    ``out.posterior`` and ``out.bma``."""
    from dis_project_tpu_torch.models import delaysimm

    data, n_draws = out.data, config.posterior_samples
    print(f"Sampling (kinetics, delay) posterior: {n_draws} HMC draws "
          f"({n_draws} warmup)...")
    t0 = time.perf_counter()
    out.posterior = delaysimm.kinetics_posterior(
        model, out.result.params, X, y, posterior_generator(config, X.device),
        num_warmup=n_draws, num_samples=n_draws, num_chains=config.posterior_chains)
    pooled = _finish_posterior(out.posterior, t0, config, data, config.save_name or "delay")
    print("\nPosterior delays (mean +/- std [5%, 95%]):")
    dvals = _host(pooled.delay)
    for g, name in enumerate(data.gene_names[: dvals.shape[1]]):
        lo, hi = np.percentile(dvals[:, g], [5, 95])
        print(f"  delay {name:<10} "
              f"{dvals[:, g].mean():.4f} +/- {dvals[:, g].std():.4f} "
              f"[{lo:.4f}, {hi:.4f}]")
    out.bma = _plot_bma_latent(
        lambda p: model.latent_predict(p, out.t_grid, X, y, var), pooled, out.latent,
        out.t_grid, data, config, f"{config.save_name or 'delay'}_bma",
        "delayed response, hyperparameters marginalised")


def synthetic_delay_data(genes: int, timepoints: int, seed: int, dtype, device):
    """The dense delay route's dataset: ``generate_ode_delay`` at
    genes x timepoints, one replicate, noise std 0.1, oversample 4, from
    ``seed``."""
    from dis_project_tpu_torch.data import synthetic

    scfg = synthetic.SyntheticConfig(
        num_genes=genes, num_timepoints=timepoints, num_replicates=1, noise_std=0.1
    )
    return synthetic.generate_ode_delay(torch.Generator().manual_seed(seed), scfg, oversample=4,
                                        dtype=dtype, device=device)


def run_dense_delay(config: cfg.RunConfig) -> DenseRun:
    """Dense delayed-response run, ``--preset dense10k --model delaysimm
    --mll-engine ss``: ``generate_ode_delay`` data (oversample 4) at
    N = genes x timepoints, full-batch Adam on
    ``ops.statespace.delaysimm_mll_ss`` (T*G warped events,
    ``--force-kernel``) with gene 0's delay pinned to raw -20 after every
    update (the generator's anchor), the decay and delay recovery, the
    dense metrics file. One Adam loop: the JAX package's 25-step segments
    serve its remote-TPU transport only."""
    from dis_project_tpu_torch.data.dataset import train_arrays
    from dis_project_tpu_torch.models import delaysimm
    from dis_project_tpu_torch.ops import statespace as ss_ops
    from dis_project_tpu_torch.ops.precision import default_device, dtype_for
    from dis_project_tpu_torch.training import generic

    dev = default_device(config.device)
    dtype = dtype_for(config.x64)
    G, T = config.synth_genes, config.synth_timepoints
    print(f"Sampling synthetic delayed-ODE dataset via quadrature: {G} x {T} (N={G * T}) "
          f"on {dev}...")
    data = synthetic_delay_data(G, T, config.seed, dtype, dev)
    X, y, var = train_arrays(data, dev, dtype)
    tgrid = torch.as_tensor(data.timepoints, dtype=dtype, device=dev)
    raw = delaysimm.unconstrain(delaysimm.init_params(G, dtype, dev))

    def pin_gene0(r):
        dl = r.delay.clone()
        dl[0] = delaysimm.ZERO_DELAY_RAW
        return r._replace(delay=dl)

    ss_stats, forward_s = [], []
    objective = _ss_objective(lambda r: -ss_ops.delaysimm_mll_ss(
        delaysimm.constrain(r), tgrid, y, jitter=config.exact_jitter,
        force_kernel=config.force_kernel), forward_s)
    prior = ("order-10 SDE" if config.force_kernel == "rbf"
             else f"EXACT {config.force_kernel} prior")
    print(f"Training (full-batch exact delayed MLL, state-space Kalman engine (O(T G), "
          f"{prior}))...")
    t0 = time.perf_counter()
    raw, opt_state, losses, norms, step_seconds = fit_dense_adam(
        objective, raw, config.num_iters, config.learning_rate, ss_stats, forward_s,
        clamp_raw=pin_gene0)
    print_ss_step(ss_stats, step_seconds, T * G)
    f64 = torch.float64
    hist = torch.tensor(losses, dtype=f64)
    print(f"Trained {config.num_iters} iters in {time.perf_counter() - t0:.2f}s "
          f"(final loss {_final_loss(losses):.4f}, N={G * T})")
    p = delaysimm.constrain(raw)
    res = generic.LoopResult(raw=raw, params=p, history=hist,
                             grad_norms=torch.tensor(norms, dtype=f64), opt_state=opt_state)
    d_true = data.params_true["decay"].detach().cpu().numpy()
    del_true = data.params_true["delay"].detach().cpu().numpy()
    del_fit = p.delay.detach().cpu().numpy()
    corr_d = float(np.corrcoef(p.decay.detach().cpu().numpy(), d_true)[0, 1])
    corr_del = float(np.corrcoef(del_fit, del_true)[0, 1])
    mae_del = float(np.abs(del_fit - del_true).mean())
    print(f"Ground-truth recovery: corr(decay)={corr_d:.3f} corr(delay)={corr_del:.3f} "
          f"delay MAE={mae_del:.3f}")
    post = None
    if config.posterior_samples > 0:
        post = dense_delay_posterior(config, p, tgrid, y, data, del_true)
    if config.metrics_path:
        write_dense_metrics(config.metrics_path, hist)
    model = delaysimm.ExactDelaySIMM(num_genes=G, jitter=config.exact_jitter)
    return DenseRun(res, model, data, X, y, var, step_seconds, final_loss=_final_loss(losses),
                    ss_stats=ss_stats, posterior=post)


def dense_delay_posterior(config: cfg.RunConfig, params, tgrid, y, data, del_true):
    """``--preset dense10k --model delaysimm --mll-engine ss
    --posterior-samples``: full-Bayes (kinetics, delays) through the O(T G)
    warped-event likelihood (``training.hmc.delay_posterior_ss``, 10
    leapfrog steps, ``--force-kernel``), the kinetics report capped at 10
    genes and the posterior delays against the generating ones. Returns the
    HMC result."""
    from dis_project_tpu_torch.training import hmc

    n_draws, N = config.posterior_samples, config.synth_genes * config.synth_timepoints
    print(f"Sampling (kinetics, delay) posterior at N={N} "
          f"via the O(T G) warped-event likelihood: {n_draws} HMC "
          f"draws ({n_draws} warmup)...")
    t0 = time.perf_counter()
    post = hmc.delay_posterior_ss(
        params, tgrid, y, posterior_generator(config, y.device), jitter=config.exact_jitter,
        num_warmup=n_draws, num_samples=n_draws, num_chains=config.posterior_chains,
        force_kernel=config.force_kernel)
    pooled = _finish_posterior(post, t0, config, data, "dense_delay_ss", max_report_genes=10)
    dvals = _host(pooled.delay)
    n_rep = min(10, dvals.shape[1])
    extra = (f" (reporting the first {n_rep} of {dvals.shape[1]} genes)"
             if dvals.shape[1] > n_rep else "")
    print(f"\nPosterior delays vs generating truth{extra}:")
    for g_i in range(n_rep):
        lo, hi = np.percentile(dvals[:, g_i], [5, 95])
        print(f"  delay g{g_i:03d} {dvals[:, g_i].mean():.4f} "
              f"+/- {dvals[:, g_i].std():.4f} [{lo:.4f}, {hi:.4f}] "
              f"(true {del_true[g_i]:.4f})")
    return post


@dataclasses.dataclass
class NonlinearRun(FamilyRun):
    """The nonlinear family's p53 route: ``latent`` is the Laplace force
    posterior on the quadrature grid ``t_grid``; ``bands`` the delta-method
    Gaussian over the gene curves there, (G*Q,); ``laplace_s`` the wall
    seconds of the one-Hessian ``laplace_posteriors``."""

    bands: Any = None
    laplace_s: float = 0.0


def run_nonlinear(config: cfg.RunConfig) -> NonlinearRun:
    """The nonlinear-response LFM on the p53 data, the ``--model nlfm``
    route: Lawrence et al. (2006) §5's dx/dt = B + S g(f) - D x
    (``--response``, default exp) by MAP over (kinetics, whitened force on
    a ``--num-quad``-point grid), ``nlfm.fit`` with the p21 pin when p21 is
    present (``fit_checkpointed`` under ``--checkpoint-dir``), the metrics
    JSONL, the hyperparameter table and ``hyperparams.csv`` (in the working
    directory), then both Laplace posteriors from one Hessian; with
    matplotlib, the parameter trace and the force and gene-curve plots;
    with ``--posterior-samples``, :func:`nonlinear_posterior`."""
    from dis_project_tpu_torch.data.dataset import P53Data
    from dis_project_tpu_torch.models import nlfm
    from dis_project_tpu_torch.ops.precision import default_device, dtype_for
    from dis_project_tpu_torch.reporting import tables

    _check_route_flags(config, "nlfm", ((config.shared_kinetics, "--shared-kinetics"),))
    if config.num_quad < 3:
        raise SystemExit("--num-quad must be >= 3")
    dev = default_device(config.device)
    dtype = dtype_for(config.x64)
    data = P53Data(replicate=config.replicate, data_dir=config.data_dir,
                   selected_genes=config.selected_genes, source=config.data_source,
                   seed=config.seed)
    t_obs, Y, V = (torch.as_tensor(a, dtype=dtype, device=dev) for a in (
        data.timepoints, data.gene_expressions, data.gene_variances))
    model = nlfm.NonlinearLFM(num_genes=data.num_genes, response=config.response,
                              t_max=float(data.timepoints[-1]), num_quad=config.num_quad,
                              jitter=config.sparse_jitter)
    # The pin targets p21 by name; for the exp response the S <-> force
    # shift degeneracy g(f + c) = e^c g(f) makes it matter more than in the
    # linear family.
    has_p21 = "p21" in data.gene_names
    print(f"Training nonlinear-response LFM (g={config.response}, Q={config.num_quad}) by MAP "
          f"on {dev} ({dtype})...")
    t0 = time.perf_counter()
    result = nlfm.fit(
        model, nlfm.init_params(data.num_genes, config.num_quad, dtype, dev), t_obs, Y, V,
        num_iters=config.num_iters, learning_rate=config.learning_rate,
        fix_params=config.fix_params and has_p21,
        clamp_gene=data.gene_names.index("p21") if has_p21 else 0,
        optimizer=config.optimizer, track_parameters=config.track_parameters,
        checkpoint_dir=config.checkpoint_dir, resume=config.resume, full_result=True)
    wall = time.perf_counter() - t0
    print(f"Trained {config.num_iters} iters in {wall:.2f}s "
          f"(final negative log-joint {_final_loss(result.history):.6f})")
    if config.metrics_path:
        write_metrics(config.metrics_path, result)
        print(f"Metrics written to {config.metrics_path}")
    plots = _have_matplotlib()
    tr = result.param_trace
    if config.track_parameters and tr is not None and plots:
        _plot_trace(config, {"basal": tr.kinetics.basal, "sensitivity": tr.kinetics.sensitivity,
                             "decay": tr.kinetics.decay}, data.gene_names, "nlfm")
    if config.response == "exp":
        print("NOTE: the exp response has an exact (f+c, S*e^-c) shift "
              "degeneracy; the force is identified up to an additive "
              "constant (resolved in practice by the p21 sensitivity pin).")
    params = result.params
    tables.print_hyperparams(params.kinetics, data, csv_path="hyperparams.csv")

    print("Making predictions and plotting...")
    grid = model.quad_grid(dtype, dev)
    t1 = time.perf_counter()
    lap, bands = model.laplace_posteriors(params, t_obs, Y, V)
    laplace_s = time.perf_counter() - t1
    if plots:
        from dis_project_tpu_torch.reporting import plotter

        # The Barenco activity profile lives in the response's domain: it
        # is comparable to the force f only for g = identity.
        identity = config.response == "identity"
        name = config.save_name or "nlfm"
        plotter.plot_lf(grid[:, None], lap, y_scatter=data.f_observed if identity else None,
                        scatter_times=data.timepoints if identity else None,
                        title=f"nonlinear ({config.response})", save_name=name,
                        out_dir=config.out_dir)
        plotter.plot_gene_predictions(grid.repeat(data.num_genes)[:, None], bands, data,
                                      save_name=name, out_dir=config.out_dir,
                                      points_per_gene=config.num_quad)
        print(f"Plots saved under {config.out_dir}/")
    else:
        print("matplotlib is not installed: the force and gene-curve plots are not drawn")
    out = NonlinearRun(result, lap, data, grid, wall, bands=bands, laplace_s=laplace_s)
    if config.posterior_samples > 0:
        nonlinear_posterior(config, out, model, t_obs, Y, V)
    return out


def nonlinear_posterior(config: cfg.RunConfig, out: NonlinearRun, model, t_obs, Y, V) -> None:
    """``--model nlfm --posterior-samples``: joint HMC over (kinetics,
    whitened force) (``models.nlfm.force_posterior_hmc``), the kinetics
    report, and the full-Bayes force band: the moments of the draws' forces
    f_s = L(l_s) w_s, beside the Laplace band (``lf_<save-name or
    nlfm>_hmc.png``). Sets ``out.posterior`` and ``out.bma`` (the band, or
    None when every draw's force is non-finite)."""
    from dis_project_tpu_torch.models import nlfm
    from dis_project_tpu_torch.models.base import Gaussian
    from dis_project_tpu_torch.training import checkpoint as ckpt

    n_draws = config.posterior_samples
    print(f"Sampling (kinetics, force) posterior: {n_draws} HMC draws "
          f"({n_draws} warmup)...")
    t0 = time.perf_counter()
    out.posterior = nlfm.force_posterior_hmc(
        model, out.result.params, t_obs, Y, V, posterior_generator(config, t_obs.device),
        num_warmup=n_draws, num_samples=n_draws, num_chains=config.posterior_chains)
    name = config.save_name or "nlfm"
    pooled = _finish_posterior(out.posterior, t0, config, out.data, name,
                               kin_from=lambda s: s.kinetics)
    # The state holds the force itself (whitened w), so the full-Bayes band
    # is the empirical moment over f_s = L(l_s) w_s: kinetics, lengthscale
    # and force uncertainty marginalised jointly.
    leaves = ckpt.tree_leaves(pooled)
    with torch.no_grad():
        forces = _host(torch.stack([
            model.force(ckpt.tree_unflatten(pooled, [a[i] for a in leaves]))
            for i in range(leaves[0].shape[0])]))
    forces = forces[np.isfinite(forces).all(axis=1)]
    if forces.shape[0] == 0:
        print("HMC force band: every draw's force values were non-finite "
              "— skipping the full-Bayes force band")
        return
    fvar = forces.var(axis=0)
    hmc_widen = float(np.mean(np.sqrt(fvar) / _host(out.latent.stddev())))
    print(f"HMC force band ({forces.shape[0]} draws): mean stddev "
          f"{hmc_widen:.2f}x the Laplace band")
    dev = out.t_grid.device
    out.bma = Gaussian(mean=torch.as_tensor(forces.mean(axis=0), device=dev),
                       cov=torch.diag(torch.as_tensor(fvar, device=dev)))
    if _have_matplotlib():
        from dis_project_tpu_torch.reporting import plotter

        identity = config.response == "identity"
        plotter.plot_lf(out.t_grid[:, None], out.bma,
                        y_scatter=out.data.f_observed if identity else None,
                        scatter_times=out.data.timepoints if identity else None,
                        title=f"nonlinear ({config.response}), full-Bayes force",
                        save_name=f"{name}_hmc", out_dir=config.out_dir)
    else:
        print("matplotlib is not installed: the full-Bayes force band is not drawn")


def synthetic_nlfm_data(genes: int, timepoints: int, seed: int, response: str, dtype, device):
    """The dense nonlinear route's dataset: ``generate_ode_nonlinear`` at
    genes x timepoints, one replicate, noise std 0.1, oversample 4, from
    ``seed``."""
    from dis_project_tpu_torch.data import synthetic

    scfg = synthetic.SyntheticConfig(
        num_genes=genes, num_timepoints=timepoints, num_replicates=1, noise_std=0.1
    )
    return synthetic.generate_ode_nonlinear(torch.Generator().manual_seed(seed), scfg,
                                            response=response, oversample=4, dtype=dtype,
                                            device=device)


def run_dense_nlfm(config: cfg.RunConfig) -> DenseRun:
    """Dense nonlinear-response run, ``--preset dense10k --model nlfm
    --mll-engine ss``: ``generate_ode_nonlinear`` data (``--response``,
    oversample 4) at N = genes x timepoints, full-batch plain Adam (no
    clipping, no guard, as the JAX package's optax loop) on the
    extended-Kalman approximate marginal
    ``ops.statespace.nlfm_mll_ekf`` (the force integrated out, the gene
    drift linearized around the filtered mean; ``--force-kernel``), the
    decay and sensitivity recovery, the dense metrics file. One loop: the
    JAX package's 25-step segments serve its compiler only."""
    from dis_project_tpu_torch.data.dataset import train_arrays
    from dis_project_tpu_torch.models import simm
    from dis_project_tpu_torch.ops import statespace as ss_ops
    from dis_project_tpu_torch.ops.precision import default_device, dtype_for
    from dis_project_tpu_torch.training import generic

    dev = default_device(config.device)
    dtype = dtype_for(config.x64)
    G, T, resp = config.synth_genes, config.synth_timepoints, config.response
    print(f"Sampling synthetic {resp}-response ODE dataset via quadrature: {G} x {T} "
          f"(N={G * T}) on {dev}...")
    data = synthetic_nlfm_data(G, T, config.seed, resp, dtype, dev)
    X, y, var = train_arrays(data, dev, dtype)
    tgrid = torch.as_tensor(data.timepoints, dtype=dtype, device=dev)
    raw = simm.unconstrain(simm.init_params(G, dtype=dtype, device=dev))
    ss_stats, forward_s = [], []
    objective = _ss_objective(lambda r: -ss_ops.nlfm_mll_ekf(
        simm.constrain(r), tgrid, y, response=resp, jitter=config.exact_jitter,
        force_kernel=config.force_kernel), forward_s)
    prior = ("order-10 SDE" if config.force_kernel == "rbf"
             else f"EXACT {config.force_kernel} prior")
    print(f"Training (approximate marginal {resp}-response likelihood, extended Kalman engine "
          f"(O(T), {prior}))...")
    t0 = time.perf_counter()
    raw, opt_state, losses, norms, step_seconds = fit_dense_adam(
        objective, raw, config.num_iters, config.learning_rate, ss_stats, forward_s)
    print_ss_step(ss_stats, step_seconds, T)
    f64 = torch.float64
    hist = torch.tensor(losses, dtype=f64)
    print(f"Trained {config.num_iters} iters in {time.perf_counter() - t0:.2f}s "
          f"(final loss {_final_loss(losses):.4f}, N={G * T})")
    p = simm.constrain(raw)
    res = generic.LoopResult(raw=raw, params=p, history=hist,
                             grad_norms=torch.tensor(norms, dtype=f64), opt_state=opt_state)
    corr_d = float(np.corrcoef(p.decay.detach().cpu().numpy(),
                               data.params_true["decay"].detach().cpu().numpy())[0, 1])
    corr_s = float(np.corrcoef(p.sensitivity.detach().cpu().numpy(),
                               data.params_true["sensitivity"].detach().cpu().numpy())[0, 1])
    print(f"Ground-truth recovery: corr(decay)={corr_d:.3f} corr(sensitivity)={corr_s:.3f}")
    if config.metrics_path:
        write_dense_metrics(config.metrics_path, hist)
    return DenseRun(res, None, data, X, y, var, step_seconds, final_loss=_final_loss(losses),
                    ss_stats=ss_stats)


PORTED_FLAGS = (
    "--preset p53|p53-replicates|alfi-parity|dense10k|sparse100k, "
    "--num-inducing, --batch-size, --num-epochs, "
    "--model simm|simm2|multisimm|delaysimm|nlfm, --num-forces, --response, --num-quad, "
    "--mll-engine cholesky|cg|ss, "
    "--force-kernel, --stationary-after, "
    "--replicate, --genes, --data-dir, --data-source, --seed, --synth-genes, "
    "--synth-timepoints, --jitter, --num-iters, --learning-rate, --optimizer, "
    "--no-fix-params, --shared-kinetics, --steps-per-epoch, --track-parameters, "
    "--no-x64, --device, --out-dir, --save-name, --checkpoint-dir, --resume, "
    "--metrics-path, --posterior-samples, --posterior-chains"
)


def check_ss_flags(config: cfg.RunConfig) -> None:
    """The state-space flags' guards, with the JAX package's messages
    (dis_project_tpu/main.py:2163-2193, the first-order route's)."""
    if config.ss_shard and config.mll_engine != "ss":
        raise SystemExit(
            "--ss-shard requires --mll-engine ss (it shards the Kalman "
            "filter's time axis)"
        )
    if config.stationary_after is not None:
        if config.mll_engine != "ss":
            raise SystemExit(
                "--stationary-after requires --mll-engine ss (it freezes "
                "the Kalman gain at the covariance fixed point)"
            )
        if config.ss_shard:
            raise SystemExit(
                "--stationary-after is incompatible with --ss-shard "
                "(the sharded filter keeps per-chunk exact covariances)"
            )
        if config.model in ("delaysimm", "nlfm"):
            raise SystemExit(
                "--stationary-after requires a UNIFORM-grid family "
                "(simm/simm2/multisimm): the delay family's warped event "
                "chain and the EKF's state-dependent prediction have no "
                "shared-step gain fixed point"
            )
        if config.stationary_after < 1:
            raise SystemExit("--stationary-after must be >= 1")
    if config.force_kernel != "rbf" and config.mll_engine != "ss":
        raise SystemExit(
            "--force-kernel requires --mll-engine ss (the Matern priors "
            "are exactly Markovian but have NO closed-form dense Gram; "
            "every state-space route supports them — multisimm applies "
            "the kernel to every force)"
        )
    if config.ss_shard and config.model == "nlfm":
        raise SystemExit(
            "--ss-shard is not supported on the nlfm EKF route (the "
            "extended prediction step is state-dependent, so the "
            "filtering-semigroup factorisation does not apply)"
        )


def check_model_flags(config: cfg.RunConfig) -> None:
    """The JAX package's guards of the model families, engines and the
    posterior flags, with its messages (dis_project_tpu/main.py:2095-2226),
    for the families the port runs; then :func:`check_ss_flags`."""
    if config.model == "simm2" and config.preset in ("alfi-parity", "p53-replicates"):
        raise SystemExit(
            f"--model simm2 is not supported with --preset {config.preset} "
            "(second-order routes: the default preset, dense10k, sparse100k)"
        )
    if config.model == "multisimm" and config.preset not in ("p53", "sparse100k", "dense10k"):
        raise SystemExit(
            f"--model multisimm is not supported with --preset "
            f"{config.preset} (multi-force routes: the default preset, "
            "dense10k with --mll-engine ss, and sparse100k)"
        )
    if config.model == "nlfm" and config.preset not in ("p53", "dense10k"):
        raise SystemExit(
            f"--model nlfm is not supported with --preset {config.preset} "
            "(nonlinear-response routes: the default p53 preset, and "
            "dense10k with --mll-engine ss)"
        )
    if config.model == "delaysimm" and config.preset not in ("p53", "dense10k"):
        raise SystemExit(
            f"--model delaysimm is not supported with --preset "
            f"{config.preset} (delayed-response routes: the default p53 "
            "preset, and dense10k with --mll-engine ss)"
        )
    if config.mll_engine != "cholesky":
        # The first-order dense route takes every engine; the other
        # families' dense routes the state-space engine only.
        engine_ok = config.preset == "dense10k" and (
            config.model == "simm" or config.mll_engine == "ss"
        )
        if not engine_ok:
            raise SystemExit(
                f"--mll-engine {config.mll_engine} is only supported by "
                "the dense10k routes (--model simm: any engine; simm2/"
                "multisimm/delaysimm: --mll-engine ss only)"
            )
    elif config.model == "multisimm" and config.preset == "dense10k":
        raise SystemExit(
            "--preset dense10k --model multisimm requires --mll-engine ss "
            "(the R-force family has no dense table Gram; the O(T) "
            "state-space engine is the dense-scale route)"
        )
    elif config.model == "delaysimm" and config.preset == "dense10k":
        raise SystemExit(
            "--preset dense10k --model delaysimm requires --mll-engine ss "
            "(the per-gene warp breaks the shared-grid table Gram; the "
            "O(T G) warped-event state-space engine is the dense-scale "
            "route)"
        )
    elif config.model == "nlfm" and config.preset == "dense10k":
        raise SystemExit(
            "--preset dense10k --model nlfm requires --mll-engine ss "
            "(no closed-form Gram exists for the nonlinear family; the "
            "extended Kalman engine is the dense-scale marginal route)"
        )
    if config.posterior_chains < 1:
        raise SystemExit("--posterior-chains must be >= 1")
    if config.posterior_chains > 1 and not config.posterior_samples:
        raise SystemExit("--posterior-chains requires --posterior-samples")
    check_ss_flags(config)
    if config.dp_shard and config.preset != "sparse100k":
        raise SystemExit(
            "--dp-shard requires --preset sparse100k (it shards the SVI "
            "minibatch's row axis over the device mesh)"
        )
    dense_ss_posterior = (config.preset == "dense10k" and config.mll_engine == "ss"
                          and config.model in ("simm", "delaysimm"))
    if config.posterior_samples and (
        (config.preset in ("alfi-parity", "dense10k", "sparse100k") and not dense_ss_posterior)
        or config.model in ("simm2", "multisimm")
    ):
        raise SystemExit(
            "--posterior-samples is only supported on the exact "
            "first-order p53 routes (the default preset, and "
            "--preset p53-replicates without --ensemble), the "
            "nlfm route, and --preset dense10k --mll-engine ss "
            "(the O(T) state-space likelihood)"
        )


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__, allow_abbrev=False)
    cfg.add_cli_args(parser)
    args, unknown = parser.parse_known_args(argv)
    if unknown:
        raise SystemExit(f"{' '.join(unknown)}: not yet ported to dis_project_tpu_torch "
                         f"(ported flags: {PORTED_FLAGS})")
    config = cfg.config_from_args(args)
    check_model_flags(config)
    if config.mll_engine in cfg.NOT_PORTED_ENGINES:
        raise SystemExit(f"--mll-engine {config.mll_engine} is not yet ported")
    if config.resume and not config.checkpoint_dir:
        raise SystemExit("--resume requires --checkpoint-dir")
    if config.ss_shard:
        raise SystemExit("--ss-shard (the temporally-sharded filter) is not yet ported")
    if config.dp_shard:
        raise SystemExit("--dp-shard (data-parallel SVI) is not yet ported "
                         "(ROADMAP Queue 1 item 17)")
    if config.preset == "alfi-parity":
        return run_alfi_parity(config)
    if config.preset == "dense10k":
        out = run_dense(config)
        if config.mll_engine == "ss" and config.model == "simm":
            dense_ss_report(config, out)
        return out
    if config.preset == "sparse100k":
        return run_sparse(config)
    if config.model == "simm2":
        return run_second_order(config)
    if config.model == "multisimm":
        return run_multiforce(config)
    if config.model == "delaysimm":
        return run_delay(config)
    if config.model == "nlfm":
        return run_nonlinear(config)
    if config.preset == "p53-replicates":
        config.replicate = None
    return run(config)


if __name__ == "__main__":
    main()
