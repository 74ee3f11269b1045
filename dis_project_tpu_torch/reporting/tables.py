"""Hyperparameter tables and CSV export (reference ``src/utils.py:237-265``)."""

from __future__ import annotations

import csv
import os

import numpy as np


def _host(a):
    return a.detach().cpu().numpy() if hasattr(a, "detach") else np.asarray(a)


def hyperparam_rows(params, data):
    G = len(data.gene_names)
    # Shared-kinetics params hold shape-(1,) values; show them per gene.
    basal = np.broadcast_to(_host(params.basal), (G,))
    sens = np.broadcast_to(_host(params.sensitivity), (G,))
    decay = np.broadcast_to(_host(params.decay), (G,))
    return list(zip(data.gene_names, basal, sens, decay))


HEADERS = ["Gene Name", "Basal", "Sensitivity", "Decay"]


def format_hyperparams(params, data) -> str:
    rows = hyperparam_rows(params, data)
    try:
        from tabulate import tabulate

        return tabulate(rows, headers=HEADERS, tablefmt="fancy_grid")
    except ImportError:
        lines = ["\t".join(HEADERS)]
        lines += ["\t".join(f"{v}" for v in row) for row in rows]
        return "\n".join(lines)


def print_hyperparams(params, data, csv_path: str | None = "hyperparams.csv"):
    """Print the learned-kinetics table; optionally write it as CSV."""
    print("\n" + format_hyperparams(params, data) + "\n")
    if csv_path:
        write_hyperparams_csv(params, data, csv_path)


def write_hyperparams_csv(params, data, path: str = "hyperparams.csv") -> str:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(HEADERS)
        writer.writerows(hyperparam_rows(params, data))
    return path
