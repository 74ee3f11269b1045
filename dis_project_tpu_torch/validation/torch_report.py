"""Torch-side reporting for the cross-framework validation stack.

The port's own copy of ``dis_project_tpu/validation/torch_report.py``,
drawing through the port's ``reporting.plotter``.

The reference's torch stack has its own full plotter set
(``src/gpytorch_alfi/plotter_alfi.py``): a latent-force band plot (``:33-112``),
per-gene expression panels (``:115-198``), and a kinetics-comparison chart
that reads the learned B/S/D out of the trainer's *parameter trace* +
constraint transforms (``:201-316``, trace plumbing ``trainer_alfi.py:79-84``).
This module provides the same surface for :class:`~.torch_lfm.TorchSIMM`,
reusing the framework's house plotters where the figure is identical so the
two stacks' artifacts are visually comparable, and adds the train/valid/test
DataLoader split scaffolding of the reference torch trainer
(``trainer_alfi.py:68-99``).
"""

from __future__ import annotations

import numpy as np

from dis_project_tpu_torch.reporting import plotter


class _Dist:
    """Minimal (mean, stddev) adapter for the house plotters."""

    def __init__(self, mean, var):
        self.mean = np.asarray(mean)
        self._std = np.sqrt(np.clip(np.asarray(var), 0.0, None))

    def stddev(self):
        return self._std


def plot_lf_torch(t_test, mean, var, data=None, save_name="torch",
                  out_dir="plots"):
    """Latent-force band plot from torch ``predict_f`` output (reference
    ``plotter_alfi.py:33-112``)."""
    grid = np.stack([np.asarray(t_test), -np.ones(len(t_test)),
                     np.zeros(len(t_test))], axis=-1)
    y_scatter = None if data is None else data.f_observed
    return plotter.plot_lf(
        grid, _Dist(mean, var), y_scatter=y_scatter, save_name=save_name,
        out_dir=out_dir, title="torch validation stack",
    )


def plot_gxpred_torch(t_test, means, variances, data, save_name="torch",
                      out_dir="plots"):
    """Per-gene expression panels from torch ``predict_m`` output
    (reference ``plotter_alfi.py:115-198``). ``means``/``variances`` are the
    (G, T) arrays ``predict_m`` returns."""
    G, T = np.asarray(means).shape
    t = np.asarray(t_test)
    grid = np.stack(
        [np.tile(t, G), np.repeat(np.arange(G), T), np.ones(G * T)], axis=-1
    )
    dist = _Dist(np.asarray(means).reshape(-1), np.asarray(variances).reshape(-1))
    return plotter.plot_gene_predictions(
        grid, dist, data, save_name=save_name, out_dir=out_dir
    )


class _TraceParams:
    """Adapter exposing the last trace entry as a params-like object."""

    def __init__(self, entry):
        self.basal = np.asarray(entry["basal"])
        self.sensitivity = np.asarray(entry["sensitivity"])
        self.decay = np.asarray(entry["decay"])


def plot_comparison_torch(param_trace, data, save_name="torch",
                          out_dir="plots"):
    """Kinetics-comparison bar chart read out of the PARAMETER TRACE — the
    reference reads the learned B/S/D from the trainer's by-name trace
    rather than the model (``plotter_alfi.py:226-241``)."""
    if not param_trace:
        raise ValueError(
            "empty parameter trace — fit with track_parameters=True"
        )
    return plotter.plot_comparison(
        _TraceParams(param_trace[-1]), data, save_name=save_name,
        out_dir=out_dir,
    )


def plot_param_trace_torch(param_trace, data, save_name="torch",
                           out_dir="plots"):
    """Per-epoch trajectories of the constrained kinetics (the trace the
    reference records at ``trainer_alfi.py:186-190``)."""
    if not param_trace:
        raise ValueError(
            "empty parameter trace — fit with track_parameters=True"
        )
    trace = {
        key: np.stack([np.asarray(e[key]) for e in param_trace])
        for key in ("basal", "sensitivity", "decay")
    }
    return plotter.plot_param_trace(
        trace, data.gene_names, save_name=save_name, out_dir=out_dir
    )


def make_loaders(
    dataset,
    batch_size: int = 1,
    valid_split: float = 0.0,
    test_split: float = 0.0,
    seed: int = 0,
):
    """Train/valid/test DataLoader split scaffolding (reference
    ``trainer_alfi.py:68-99``; both splits default to 0 there too — the
    p53 problem trains full-batch, but the surface exists for subclassing).

    Returns ``(train_loader, valid_loader_or_None, test_loader_or_None)``.
    """
    import torch

    n = len(dataset)
    n_valid = int(round(valid_split * n))
    n_test = int(round(test_split * n))
    n_train = n - n_valid - n_test
    if n_train <= 0:
        raise ValueError(
            f"splits leave no training data: {n} items, "
            f"valid={n_valid}, test={n_test}"
        )
    gen = torch.Generator().manual_seed(seed)
    parts = torch.utils.data.random_split(
        dataset, [n_train, n_valid, n_test], generator=gen
    )

    def loader(part):
        return torch.utils.data.DataLoader(part, batch_size=batch_size)

    train, valid, test = parts
    return (
        loader(train),
        loader(valid) if n_valid else None,
        loader(test) if n_test else None,
    )
