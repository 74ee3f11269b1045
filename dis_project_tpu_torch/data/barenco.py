"""Barenco et al. (2006) p53 microarray data: loader + synthetic fallback.

The port's own copy of ``dis_project_tpu/data/barenco.py`` (pure numpy), so
the synthetic stand-in reproduces the JAX package's data bit for bit.

The reference loads two CSVs (``barencoPUMA_exprs.csv``/``_se.csv``) that are
*not* redistributed with it (downloaded separately, see reference
``data/README.md``), selects 6 probes, renames them to
DDB2/p21/SESN1/BIK/DR5/p53, log-normal-transforms means and variances, and
rescales per gene (reference ``src/dataset.py:213-321``). :func:`load_csv`
reproduces that pipeline exactly when the CSVs are present.

Because the CSVs are typically absent, :func:`synthetic` generates a
deterministic stand-in with identical shapes and realistic dynamics: the
published Barenco latent-force profile is smoothly interpolated and pushed
through the actual SIMM ODE ``dx/dt = B + S f(t) - D x`` with the published
ground-truth kinetics (reference ``src/dataset.py:201-203``), integrated with
RK4, plus fixed-seed replicate noise. :func:`load` dispatches between them.
"""

from __future__ import annotations

import os
import warnings

import numpy as np

GENE_NAMES = ["DDB2", "BIK", "DR5", "p21", "SESN1"]

# Published Barenco kinetics (reference src/dataset.py:201-203), ordered as
# GENE_NAMES above.
B_EXACT = np.array([0.0649, 0.0069, 0.0181, 0.0033, 0.0869])
D_EXACT = np.array([0.2829, 0.3720, 0.3617, 0.8000, 0.3573])
S_EXACT = np.array([0.9075, 0.9748, 0.9785, 1.0000, 0.9680])

# Published latent p53 activity at the 7 measurement times
# (reference src/dataset.py:111-113).
F_BARENCO = np.array([0.1845, 1.1785, 1.6160, 0.8156, 0.6862, -0.1828, 0.5131])

TIMEPOINTS = np.linspace(0.0, 12.0, 7)

_PROBE_TO_GENE = {
    "203409_at": "DDB2",
    "202284_s_at": "p21",
    "218346_s_at": "SESN1",
    "205780_at": "BIK",
    "209295_at": "DR5",
    "211300_s_at": "p53",
}


# Canonical row order after probe renaming: the five targets then the p53
# transcription factor (reference src/dataset.py:275-281).
_CANONICAL_ORDER = ["DDB2", "BIK", "DR5", "p21", "SESN1", "p53"]


def load_csv(dir_path: str) -> dict:
    """Barenco PUMA CSV pipeline with reference-identical numerics
    (behavioral contract: ``src/dataset.py:213-321``); all six genes are
    transformed uniformly with plain broadcasting and split at the end.

    Steps: select the six probes by replicate-major column order, rename to
    gene symbols, log-normal-transform the log-domain means/variances, and
    rescale each gene by the sample std-dev of its first replicate.
    Outputs are bit-identical to the reference transform (pinned by
    ``tests/test_data.py::TestCsvPipeline`` against an in-repo fixture).
    """
    import pandas as pd

    # Replicate-major column layout of the PUMA files: three cARP replicate
    # arrays, seven 2-hour timepoints each.
    columns = [f"cARP{r}-{t}hrs.CEL" for r in (1, 2, 3) for t in range(0, 14, 2)]

    def read(name):
        frame = pd.read_csv(os.path.join(dir_path, name), index_col=0)
        frame = frame.loc[frame.index.isin(_PROBE_TO_GENE), columns]
        return frame.rename(index=_PROBE_TO_GENE).reindex(_CANONICAL_ORDER)

    log_mean = read("barencoPUMA_exprs.csv").to_numpy()  # (6, 21)
    log_var = read("barencoPUMA_se.csv").to_numpy() ** 2

    # Log-normal moments from the log-domain mean/variance. (Written with
    # exp(v) - 1, not expm1, to stay bit-identical to the reference.)
    mean = np.exp(log_mean + log_var / 2)
    var = (np.exp(log_var) - 1) * np.exp(2 * log_mean + log_var)

    # Per-gene rescale by the first replicate's sample std-dev (ddof=1).
    scale = np.sqrt(np.var(mean[:, :7], axis=1, ddof=1))  # (6,)
    mean = mean / scale[:, None]
    var = var / scale[:, None] ** 2

    def split(values):
        # (6, 21) replicate-major rows -> (3 replicates, 6 genes, 7 times),
        # then targets (first 5) / p53 (last).
        stacked = np.float64(values).reshape(6, 3, 7).swapaxes(0, 1)
        return stacked[:, :5], stacked[:, 5:]

    gene_expr, p53_expr = split(mean)
    gene_vars, p53_vars = split(var)

    return {
        "gene_names": list(GENE_NAMES),
        "gene_expressions": gene_expr,
        "gene_variances": gene_vars,
        "p53_expressions": p53_expr,
        "p53_variances": p53_vars,
    }


def interpolate_force(t, anchors_t=TIMEPOINTS, anchors_f=F_BARENCO, width=1.6):
    """Smooth RBF interpolant through the published latent-force profile.

    Solves the tiny (7x7) RBF system once so f(t) passes through the
    published points and stays C-infinity — the latent force a SIMM GP with
    the published kinetics would plausibly have produced.
    """
    gram_a = np.exp(-((anchors_t[:, None] - anchors_t[None, :]) ** 2) / (2 * width**2))
    weights = np.linalg.solve(gram_a + 1e-10 * np.eye(len(anchors_t)), anchors_f)
    basis = np.exp(-((np.asarray(t)[:, None] - anchors_t[None, :]) ** 2) / (2 * width**2))
    return basis @ weights


def simulate_expression(t_grid, basal, sens, decay, dt=0.005):
    """RK4-integrate dx/dt = B + S f(t) - D x from x(0) = B/D, sample t_grid."""
    t_fine = np.arange(0.0, float(t_grid[-1]) + dt, dt)
    f_fine = interpolate_force(t_fine)

    def f_at(time):
        idx = min(int(round(time / dt)), len(f_fine) - 1)
        return f_fine[idx]

    x = basal / decay
    out = np.empty((len(t_grid), len(basal)))
    next_sample = 0
    for i, time in enumerate(t_fine):
        if next_sample < len(t_grid) and time >= t_grid[next_sample] - 1e-9:
            out[next_sample] = x
            next_sample += 1
        if i + 1 >= len(t_fine):
            break

        def deriv(xv, tv):
            return basal + sens * f_at(tv) - decay * xv

        k1 = deriv(x, time)
        k2 = deriv(x + 0.5 * dt * k1, time + 0.5 * dt)
        k3 = deriv(x + 0.5 * dt * k2, time + 0.5 * dt)
        k4 = deriv(x + dt * k3, time + dt)
        x = x + (dt / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)
    while next_sample < len(t_grid):
        out[next_sample] = x
        next_sample += 1
    return out  # (T, G)


def synthetic(seed: int = 0, noise_frac: float = 0.08) -> dict:
    """Deterministic Barenco-shaped dataset from the real SIMM dynamics."""
    rng = np.random.default_rng(seed)
    clean = simulate_expression(TIMEPOINTS, B_EXACT, S_EXACT, D_EXACT).T  # (G, T)

    reps = []
    var_reps = []
    for _ in range(3):
        std = np.maximum(noise_frac * np.abs(clean), 0.02)
        noisy = clean + rng.normal(size=clean.shape) * std
        reps.append(noisy)
        var_reps.append(std**2)
    gene_expr = np.stack(reps)  # (3, G, T)
    gene_vars = np.stack(var_reps)

    f_clean = interpolate_force(TIMEPOINTS)
    p53_reps, p53_vars = [], []
    for _ in range(3):
        std = np.maximum(noise_frac * np.abs(f_clean), 0.02)
        p53_reps.append(f_clean + rng.normal(size=f_clean.shape) * std)
        p53_vars.append(std**2)
    p53_expr = np.stack(p53_reps)[:, None, :]  # (3, 1, T)
    p53_var = np.stack(p53_vars)[:, None, :]

    return {
        "gene_names": list(GENE_NAMES),
        "gene_expressions": gene_expr,
        "gene_variances": gene_vars,
        "p53_expressions": p53_expr,
        "p53_variances": p53_var,
    }


def load(data_dir: str = "data", source: str = "auto", seed: int = 0) -> dict:
    """Load Barenco data: ``csv``, ``synthetic``, or ``auto`` (csv if found)."""
    if source not in ("auto", "csv", "synthetic"):
        raise ValueError(f"unknown source {source!r}")
    if source in ("auto", "csv"):
        path = os.path.join(data_dir, "barencoPUMA_exprs.csv")
        if os.path.exists(path):
            return load_csv(data_dir)
        if source == "csv":
            raise FileNotFoundError(f"Barenco CSVs not found under {data_dir!r}")
        warnings.warn(
            "Barenco CSVs not found; using the deterministic synthetic "
            "stand-in (dis_project_tpu_torch.data.barenco.synthetic).",
            stacklevel=2,
        )
    return synthetic(seed=seed)
