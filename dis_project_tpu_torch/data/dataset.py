"""Dataset container and the 3-column input encoding for the p53 SIMM LFM.

Port of ``dis_project_tpu/data/dataset.py``. :class:`P53Data` keeps its
arrays in host numpy (float64); :func:`dataset_3d` / :func:`train_arrays`
move the encoded rows onto a device at the dtype the caller chooses, and
default to the card like every entry point of the port.

Rows are ``(t, gene_index, flag)`` with flag 1 = gene expression, 0 = latent
force; replicate-major, then gene-major blocks of T (reference
``src/dataset.py:358-399``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from dis_project_tpu_torch.data import barenco
from dis_project_tpu_torch.ops.precision import PARITY_DTYPE, default_device


class P53Data:
    """Gene-expression container with replicate / gene-subset selection."""

    def __init__(
        self,
        replicate: Optional[int] = None,
        data_dir: str = "data",
        selected_genes: Optional[Sequence[str]] = None,
        source: str = "auto",
        seed: int = 0,
    ):
        gene_data = barenco.load(data_dir=data_dir, source=source, seed=seed)
        all_genes = gene_data["gene_names"]

        if not (replicate is None or 0 <= replicate < 3):
            raise AssertionError("Invalid replicate number")

        if selected_genes is not None:
            selected_genes = list(selected_genes)
            valid = set(all_genes)
            chosen = set(selected_genes)
            if not chosen.issubset(valid):
                missing = chosen - valid
                raise ValueError(
                    f"Invalid gene names provided: {', '.join(sorted(missing))}"
                )
            if len(selected_genes) != len(chosen):
                dupes = {g for g in selected_genes if selected_genes.count(g) > 1}
                raise ValueError(f"Duplicate genes provided: {', '.join(sorted(dupes))}")
            if len(selected_genes) == 0:
                raise ValueError(
                    "Empty list of genes selected, set 'selected_genes' to None"
                )
            # Keep the dataset's gene order (the reference filters by
            # membership: src/dataset.py:90-94).
            indices = [i for i, g in enumerate(all_genes) if g in chosen]
            self.selected_indices = indices
            self.gene_names = [all_genes[i] for i in indices]
        else:
            self.selected_indices = list(range(len(all_genes)))
            self.gene_names = list(all_genes)

        idx = np.asarray(self.selected_indices)
        expressions = np.asarray(gene_data["gene_expressions"])[:, idx]
        variances = np.asarray(gene_data["gene_variances"])[:, idx]

        self.num_genes = len(self.gene_names)
        self.timepoints = np.asarray(barenco.TIMEPOINTS)
        self.f_observed = np.asarray(barenco.F_BARENCO).reshape(1, 1, 7)
        self.replicate = replicate

        if replicate is None:
            self.gene_expressions = expressions  # (3, G, T)
            self.gene_variances = variances
        else:
            self.gene_expressions = expressions[replicate : replicate + 1]
            self.gene_variances = variances[replicate : replicate + 1]

        self.num_replicates = int(self.gene_expressions.shape[0])

    def __len__(self) -> int:
        return self.num_replicates * self.num_genes

    def __getitem__(self, index: int):
        """(timepoints, expression) for flat index replicate-major over genes,
        matching the reference's list ordering (``src/dataset.py:121-125``)."""
        if index < 0 or index >= len(self):
            raise IndexError("Index out of range")
        r, g = divmod(index, self.num_genes)
        return self.timepoints, self.gene_expressions[r, g]

    @property
    def shape(self):
        return (len(self), 2, int(self.timepoints.shape[0]))

    def params_ground_truth(self):
        """Published Barenco kinetics (B, S, D), filtered to selected genes."""
        idx = np.asarray(self.selected_indices)
        return barenco.B_EXACT[idx], barenco.S_EXACT[idx], barenco.D_EXACT[idx]


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _encode_3d_host(data):
    """3-column encoding assembled in host numpy (``data`` is a
    :class:`P53Data` or a ``SyntheticLFMData``)."""
    t_host = _host(data.timepoints)
    T = int(t_host.shape[0])
    G, R = data.num_genes, data.num_replicates

    times = np.tile(t_host, G * R)
    gene_idx = np.tile(np.repeat(np.arange(G), T), R).astype(t_host.dtype)
    flags = np.ones(R * G * T, dtype=t_host.dtype)
    X = np.stack([times, gene_idx, flags], axis=-1)

    y = _host(data.gene_expressions).reshape(-1, 1)
    variances = _host(data.gene_variances).reshape(-1, 1)
    return X, y, variances


def dataset_3d(data, device=None, dtype: torch.dtype = PARITY_DTYPE):
    """``(X, y, variances)``: X (R*G*T, 3) rows ``(t, gene_index, 1)``,
    y / variances (R*G*T, 1), on ``device`` (default: the card)."""
    dev = default_device(device)
    return tuple(
        torch.as_tensor(a, dtype=dtype, device=dev) for a in _encode_3d_host(data)
    )


def flatten_blocked(data, device=None, dtype: torch.dtype = PARITY_DTYPE):
    """Reference ALFI 1-D blocked encoding
    (``src/gpytorch_alfi/model_alfi.py:545-569``): ``(train_t, train_y)``,
    times tiled per (replicate, gene) block, gene identity implied by the
    block's position."""
    dev = default_device(device)
    n_blocks = data.num_replicates * data.num_genes
    train_t = np.tile(_host(data.timepoints), n_blocks)
    train_y = _host(data.gene_expressions).reshape(-1)
    return (torch.as_tensor(train_t, dtype=dtype, device=dev),
            torch.as_tensor(train_y, dtype=dtype, device=dev))


def train_arrays(data, device=None, dtype: torch.dtype = PARITY_DTYPE):
    """The ``(X, y, variances)`` triple with y / variances flattened to 1-D —
    the shape the trainer consumes."""
    X, y, var = dataset_3d(data, device, dtype)
    return X, y.reshape(-1), var.reshape(-1)
