"""Shared model-layer types: Gaussian predictive distributions."""

from __future__ import annotations

from typing import NamedTuple

import torch


class Gaussian(NamedTuple):
    """A multivariate normal predictive distribution: ``mean`` (N,),
    ``cov`` (N, N)."""

    mean: torch.Tensor
    cov: torch.Tensor

    def stddev(self) -> torch.Tensor:
        return torch.sqrt(torch.diagonal(self.cov))

    def variance(self) -> torch.Tensor:
        return torch.diagonal(self.cov)
