"""Reporting: latent-force / gene-expression / kinetics-comparison plots.

The port's own copy of ``dis_project_tpu/reporting/plotter.py``: the same
figures from the port's tensors (``.detach().cpu().numpy()``) or numpy
arrays. Mirrors the reference artifact matrix (``src/plotter.py``,
``src/utils.py``, SURVEY.md §2 #17-#18, #35): latent-force plot with a +/- k-sigma band against
the published Barenco profile, per-gene expression prediction panels, and the
3-panel learned-vs-measured kinetics bar chart. Plots are saved under
``plots/`` relative to the configured output directory.

matplotlib is imported lazily so the numerics core never pays for it.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from dis_project_tpu_torch.models.base import Gaussian


def _host(a) -> np.ndarray:
    """A tensor (on any device) or array-like as a host numpy array."""
    if hasattr(a, "detach"):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    # House style (the reference's dissertation.mplstyle role); never fatal.
    style = os.path.join(os.path.dirname(__file__), "house.mplstyle")
    try:
        plt.style.use(style)
    except OSError:
        pass
    return plt


def save_plot(fig, plot_name: str, out_dir: str = "plots") -> str:
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, plot_name)
    fig.savefig(path, format="png", facecolor="white", bbox_inches="tight")
    return path


def plot_lf(
    testing_times,
    predictive_dist: Gaussian,
    stddev: int = 2,
    y_scatter=None,
    scatter_times=None,
    title: Optional[str] = None,
    save: bool = True,
    save_name: Optional[str] = None,
    out_dir: str = "plots",
):
    """Latent-force posterior with +/- stddev band (reference
    ``src/plotter.py:33-115``; fig. 1a of Lawrence et al.).

    ``scatter_times`` places the ``y_scatter`` ground-truth markers; when
    omitted it falls back to the reference's hard-coded Barenco span
    ``linspace(0, 12)`` — correct for the p53 pipeline only, so any
    synthetic caller with a different time span must pass its own grid.
    """
    plt = _plt()
    mean = _host(predictive_dist.mean)
    std = _host(predictive_dist.stddev())
    t = _host(testing_times)[:, 0]

    fig, ax = plt.subplots(figsize=(7.5, 2.5), dpi=150)
    ax.fill_between(
        t, mean - stddev * std, mean + stddev * std, alpha=0.2, label=f"{stddev} sigma"
    )
    ax.plot(t, mean - stddev * std, linestyle="--", linewidth=1)
    ax.plot(t, mean + stddev * std, linestyle="--", linewidth=1)
    ax.plot(t, mean, label="Predictive mean")
    if y_scatter is not None:
        y_scatter = _host(y_scatter).ravel()
        ts = (
            _host(scatter_times).ravel()
            if scatter_times is not None
            else np.linspace(0, 12, len(y_scatter))
        )
        ax.plot(ts, y_scatter, "x", label="True values")
    ax.set_xlabel("Time")
    ax.set_ylabel("mRNA Expression")
    ax.set_title(f"Latent Force Model{' - ' + title if title else ''}")
    _dedupe_legend(ax)
    if save:
        name = f"lf_{save_name}.png" if save_name else "lf.png"
        path = save_plot(fig, name, out_dir)
        plt.close(fig)
        return path
    return fig


def plot_gene_predictions(
    grid,
    dist: Gaussian,
    data,
    stddev: int = 2,
    save: bool = True,
    save_name: Optional[str] = None,
    out_dir: str = "plots",
    points_per_gene: Optional[int] = None,
):
    """Per-gene expression posterior panels (reference
    ``src/utils.py:144-234``). ``grid`` must be gene-major blocks."""
    plt = _plt()
    G = data.num_genes
    n = points_per_gene or (_host(grid).shape[0] // G)
    t = _host(grid)[:n, 0]
    mean = _host(dist.mean)
    std = _host(dist.stddev())

    fig = plt.figure(figsize=(7.5, 2.2 * G), dpi=150)
    for i in range(G):
        ax = fig.add_subplot(G, 1, i + 1)
        m = mean[i * n : (i + 1) * n]
        s = std[i * n : (i + 1) * n]
        ax.fill_between(t, m - stddev * s, m + stddev * s, alpha=0.2,
                        label=f"{stddev} sigma")
        ax.plot(t, m, label="Predictive mean")
        for r in range(data.num_replicates):
            ax.scatter(
                _host(data.timepoints),
                _host(data.gene_expressions[r, i]).ravel(),
                s=12,
                label="True values" if r == 0 else None,
            )
        ax.set_title(f"{data.gene_names[i]} Expression Over Time")
        ax.set_xlabel("Time")
        ax.set_ylabel("Expression Level")
        _dedupe_legend(ax)
    fig.tight_layout()
    if save:
        name = f"gxpr_{save_name}.png" if save_name else "gxpr.png"
        path = save_plot(fig, name, out_dir)
        plt.close(fig)
        return path
    return fig


def plot_comparison(
    params, data, save: bool = True, save_name: Optional[str] = None,
    out_dir: str = "plots"
):
    """3-panel learned-vs-measured B/S/D bar chart (reference
    ``src/plotter.py:118-193``)."""
    plt = _plt()
    basal_true, sens_true, decay_true = data.params_ground_truth()
    learned = [
        _host(params.basal),
        _host(params.sensitivity),
        _host(params.decay),
    ]
    true = [basal_true, sens_true, decay_true]
    titles = ["Basal rates", "Sensitivities", "Decay rates"]

    fig, axes = plt.subplots(1, 3, figsize=(7.5, 2.5), dpi=150)
    x = np.arange(len(basal_true))
    for ax, lv, tv, title in zip(axes, learned, true, titles):
        ax.bar(x + 0.2, lv, width=0.4, label="Learned")
        ax.bar(x - 0.2, tv, width=0.4, label="Measured")
        ax.set_title(title)
        ax.set_xticks(x)
        ax.set_xticklabels(data.gene_names, rotation=45, ha="right")
    axes[0].legend(fontsize="small")
    fig.tight_layout()
    if save:
        name = f"comparison_{save_name}.png" if save_name else "comparison.png"
        path = save_plot(fig, name, out_dir)
        plt.close(fig)
        return path
    return fig


def plot_param_trace(
    trace,
    gene_names,
    save: bool = True,
    save_name: Optional[str] = None,
    out_dir: str = "plots",
):
    """Per-step trajectories of the constrained kinetics during training.

    ``trace``: dict of named (steps, G) arrays — what
    ``TrainConfig(track_parameters=True)`` (stacked pytree) or the torch
    trainer's by-name trace (reference ``trainer_alfi.py:79-84,186-190``)
    record. The canonical kinetics keys get their reference panel titles;
    any other keys (the non-exact families' extra parameters — delays,
    alpha/omega, per-force sensitivities) are plotted under their own
    names, one panel per key (r3: parameter traces are shared route
    infrastructure, not an exact-SIMM exclusive). The reference tracks
    this trace but only ever consumes it in the torch comparison chart
    (``plotter_alfi.py:226-241``); here it is a first-class artifact for
    both stacks.
    """
    plt = _plt()
    canonical = {
        "basal": "Basal rates",
        "sensitivity": "Sensitivities",
        "decay": "Decay rates",
    }
    keys = list(trace)
    titles = [canonical.get(k, k) for k in keys]

    fig, axes = plt.subplots(
        1, len(keys), figsize=(2.5 * len(keys), 2.5), dpi=150, sharex=True,
        squeeze=False,
    )
    axes = axes[0]
    for ax, key, title in zip(axes, keys, titles):
        values = _host(trace[key])
        if values.ndim == 1:
            values = values[:, None]
        for g in range(values.shape[1]):
            label = gene_names[g] if g < len(gene_names) else f"g{g}"
            ax.plot(values[:, g], label=label, linewidth=1)
        ax.set_title(title)
        ax.set_xlabel("Step")
    axes[0].legend(fontsize="x-small")
    fig.tight_layout()
    if save:
        name = f"param_trace_{save_name}.png" if save_name else "param_trace.png"
        path = save_plot(fig, name, out_dir)
        plt.close(fig)
        return path
    return fig


def plot_posterior_kinetics(
    samples,
    data,
    save: bool = True,
    save_name: Optional[str] = None,
    out_dir: str = "plots",
):
    """Posterior histograms of the kinetic parameters (HMC draws) with the
    Barenco measured values overlaid — the full-Bayes counterpart of the
    point-estimate kinetics comparison chart.

    ``samples``: dict with keys ``basal`` / ``sensitivity`` / ``decay``,
    each (draws, G).
    """
    plt = _plt()
    b_true, s_true, d_true = data.params_ground_truth()
    truths = {"basal": b_true, "sensitivity": s_true, "decay": d_true}
    titles = ["Basal rates", "Sensitivities", "Decay rates"]
    keys = ["basal", "sensitivity", "decay"]
    G = len(data.gene_names)

    fig, axes = plt.subplots(
        3, G, figsize=(1.8 * G, 5.2), dpi=150, squeeze=False
    )
    for row, (key, title) in enumerate(zip(keys, titles)):
        vals = _host(samples[key])
        if vals.ndim == 1:
            vals = vals[:, None]
        for g in range(G):
            ax = axes[row][g]
            ax.hist(vals[:, g], bins=30, density=True, alpha=0.75)
            t = _host(truths[key]).ravel()
            if g < t.shape[0]:
                ax.axvline(t[g], color="k", linestyle="--", linewidth=1,
                           label="measured")
            if row == 0:
                ax.set_title(data.gene_names[g], fontsize="small")
            if g == 0:
                ax.set_ylabel(title, fontsize="small")
            ax.set_yticks([])
            ax.tick_params(labelsize="x-small")
    axes[0][0].legend(fontsize="x-small")
    fig.tight_layout()
    if save:
        name = (
            f"posterior_kinetics_{save_name}.png"
            if save_name
            else "posterior_kinetics.png"
        )
        path = save_plot(fig, name, out_dir)
        plt.close(fig)
        return path
    return fig


def _dedupe_legend(ax):
    handles, labels = ax.get_legend_handles_labels()
    by_label = dict(zip(labels, handles))
    ax.legend(by_label.values(), by_label.keys(), fontsize="small")
