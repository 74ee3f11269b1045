"""End-to-end pipelines of the port (``python -m dis_project_tpu_torch.main``).

Two routes of ``dis_project_tpu/main.py``, on the card unless ``--device``
says otherwise:

- ``--preset p53`` (:func:`run`): Barenco data (synthetic seed 0 unless the
  CSVs are present), ExactSIMM(jitter=1e-4), negative conjugate MLL + Adam
  (0.01) with the p21 clamp through the Kronecker/table fast path,
  hyperparameter table + ``hyperparams.csv``, the latent-force posterior on
  a 100-point grid and the per-gene expression posterior. Plots are not
  ported yet.
- ``--preset dense10k`` (:func:`run_dense`): a synthetic draw at
  N = genes x timepoints (50 x 200 = 1e4 by default), full-batch exact MLL
  and Adam, with ground-truth recovery metrics. The Gram route is the JAX
  package's, with the card in the TPU's place (:func:`dense_gram`): on the
  card in float32 the row Gram — the kernel K2 and its backward, the custom
  MLL backward with the SYRK kernel K3 — and elsewhere the table Gram of
  ``ExactSIMM.mll_gridded``.

Every other preset, engine, model family and flag of the JAX CLI fails with
"not yet ported".
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Any, List

import numpy as np
import torch

from dis_project_tpu_torch import config as cfg


@dataclasses.dataclass
class CanonicalRun:
    result: Any  # training.trainer.TrainResult
    latent: Any  # models.base.Gaussian over the 100-point latent grid
    expression: Any  # models.base.Gaussian over the expression grid


@dataclasses.dataclass
class DenseRun:
    result: Any  # training.trainer.TrainResult
    model: Any
    data: Any  # data.synthetic.SyntheticLFMData
    X: torch.Tensor
    y: torch.Tensor
    var: torch.Tensor
    step_seconds: List[float]


def _final_loss(hist) -> float:
    return float(hist[-1]) if len(hist) else float("nan")


def run(config: cfg.RunConfig) -> CanonicalRun:
    from dis_project_tpu_torch.data.dataset import P53Data, dataset_3d
    from dis_project_tpu_torch.models import simm
    from dis_project_tpu_torch.ops.precision import default_device, dtype_for
    from dis_project_tpu_torch.reporting import tables
    from dis_project_tpu_torch.training import trainer as tr
    from dis_project_tpu_torch.utils.test_grids import expression_grid, latent_grid

    dev = default_device(config.device)
    dtype = dtype_for(config.x64)
    data = P53Data(replicate=0, source="auto", seed=config.seed)
    X, y, var = dataset_3d(data, dev, dtype)
    model = simm.ExactSIMM(num_genes=data.num_genes, jitter=cfg.EXACT_JITTER)
    params0 = simm.init_params(data.num_genes, dtype=dtype, device=dev)
    train_cfg = tr.TrainConfig(num_iters=config.num_iters,
                               clamp_gene=data.gene_names.index("p21"))

    print(f"Training model on {dev} ({dtype})...")
    t0 = time.perf_counter()
    # dataset_3d rows are canonical gene-major grid blocks -> the
    # Kronecker/table fast path applies exactly.
    result = tr.fit(model, params0, X, y, train_cfg,
                    gridded=(data.timepoints, data.num_replicates))
    final = _final_loss(result.history)
    print(f"Trained {config.num_iters} iters in {time.perf_counter() - t0:.2f}s "
          f"(final loss {final:.6f})")

    tables.print_hyperparams(result.params, data, csv_path="hyperparams.csv")

    print("Making predictions...")
    t_grid = latent_grid(100, dtype=dtype, device=dev)
    latent = model.latent_predict(result.params, t_grid, X, y, var)
    x_grid = expression_grid(data.num_genes, t=100, dtype=dtype, device=dev)
    expression = model.multi_gene_predict(result.params, x_grid, X, y, var)
    print(f"Latent force posterior on {t_grid.shape[0]} points, expression "
          f"posterior on {x_grid.shape[0]} points (plots are not yet ported)")
    return CanonicalRun(result, latent, expression)


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


def run_dense(config: cfg.RunConfig) -> DenseRun:
    """Dense exact-GP stress run: synthetic first-order data at
    N = genes x timepoints, full-batch exact MLL through the Gram that
    :func:`dense_gram` picks, Adam, and ground-truth kinetics recovery."""
    from dis_project_tpu_torch.data.dataset import train_arrays
    from dis_project_tpu_torch.models import simm
    from dis_project_tpu_torch.ops.precision import default_device, dtype_for
    from dis_project_tpu_torch.training import generic
    from dis_project_tpu_torch.training import trainer as tr

    dev = default_device(config.device)
    dtype = dtype_for(config.x64)
    G, T = config.synth_genes, config.synth_timepoints
    print(f"Sampling synthetic LFM dataset: {G} genes x {T} timepoints "
          f"(N={G * T}) on {dev}...")
    data = synthetic_dense_data(G, T, config.seed, dtype, dev)
    X, y, var = train_arrays(data, dev, dtype)

    model = simm.ExactSIMM(num_genes=G, jitter=cfg.EXACT_JITTER, canonical_rows=True)
    route = dense_gram(dev, dtype)
    print(f"Training (full-batch exact MLL, {route} Gram, Cholesky engine, {dtype})...")
    timepoints = torch.as_tensor(data.timepoints, dtype=dtype, device=dev)

    def objective(r):
        if route == "row":
            return -model.mll(simm.constrain(r), X, y)
        return -model.mll_gridded(simm.constrain(r), timepoints, y)

    optimizer = generic.Adam(0.01)
    raw = simm.unconstrain(simm.init_params(G, dtype=dtype, device=dev))
    opt_state = optimizer.init(raw)
    losses, norms, step_seconds = [], [], []
    t0 = time.perf_counter()
    for _ in range(config.num_iters):
        ts = time.perf_counter()
        loss, grads = generic.value_and_grad(objective, raw)
        updates, opt_state = optimizer.update(grads, opt_state)
        raw = generic.apply_updates(raw, updates)
        losses.append(float(loss))  # host fetch: the step has finished
        norms.append(float(generic.global_norm(grads)))
        step_seconds.append(time.perf_counter() - ts)
    wall = time.perf_counter() - t0
    res = tr.TrainResult(
        params=simm.constrain(raw),
        history=torch.tensor(losses, dtype=torch.float64),
        grad_norms=torch.tensor(norms, dtype=torch.float64),
        raw_params=raw,
        opt_state=opt_state,
    )
    print(f"Trained {config.num_iters} iters in {wall:.2f}s "
          f"(final loss {_final_loss(res.history):.4f}, N={G * T})")

    b, s, d = data.params_ground_truth()
    trained_d = res.params.decay.detach().cpu().numpy()
    trained_s = res.params.sensitivity.detach().cpu().numpy()
    corr_d = float(np.corrcoef(trained_d, d)[0, 1])
    corr_s = float(np.corrcoef(trained_s, s)[0, 1])
    print(f"Ground-truth recovery: corr(decay)={corr_d:.3f} "
          f"corr(sensitivity)={corr_s:.3f}")
    return DenseRun(res, model, data, X, y, var, step_seconds)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__, allow_abbrev=False)
    cfg.add_cli_args(parser)
    args, unknown = parser.parse_known_args(argv)
    if unknown:
        raise SystemExit(
            f"{' '.join(unknown)}: not yet ported to dis_project_tpu_torch "
            "(ported flags: --preset p53|dense10k, --num-iters, --no-x64, "
            "--synth-genes, --synth-timepoints, --seed, --device)"
        )
    config = cfg.config_from_args(args)
    if config.preset in cfg.NOT_PORTED_PRESETS:
        raise SystemExit(f"--preset {config.preset} is not yet ported")
    if config.preset == "dense10k":
        return run_dense(config)
    return run(config)


if __name__ == "__main__":
    main()
