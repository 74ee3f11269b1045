"""Test-grid builders for posterior prediction (reference
``src/utils.py:81-98, 268-314``).

- :func:`latent_grid` — rows ``(linspace(0, 13, t), -1, 0)``: latent-force
  queries; the gene index is irrelevant and flagged out.
- :func:`expression_grid` — times tiled per gene, flag 1, 0-based gene
  indices by default (``one_based=True`` is the reference's convention,
  which the clamped gather turns into gene i+1's kinetics for block i).
"""

from __future__ import annotations

import torch

from dis_project_tpu_torch.ops.precision import PARITY_DTYPE, default_device


def latent_grid(t: int = 100, t_max: float = 13.0, dtype=PARITY_DTYPE,
                device=None) -> torch.Tensor:
    kw = dict(dtype=dtype, device=default_device(device))
    times = torch.linspace(0.0, t_max, t, **kw)
    return torch.stack(
        [times, torch.full((t,), -1.0, **kw), torch.zeros(t, **kw)], dim=-1
    )


def expression_grid(num_genes: int, t: int = 100, t_max: float = 13.0,
                    one_based: bool = False, dtype=PARITY_DTYPE,
                    device=None) -> torch.Tensor:
    kw = dict(dtype=dtype, device=default_device(device))
    times = torch.linspace(0.0, t_max, t, **kw).repeat(num_genes)
    start = 1 if one_based else 0
    gene_idx = torch.arange(start, num_genes + start, **kw).repeat_interleave(t)
    return torch.stack([times, gene_idx, torch.ones_like(times)], dim=-1)
