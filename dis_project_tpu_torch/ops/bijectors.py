"""Parameter bijectors (constrained <-> unconstrained transforms).

Port of ``dis_project_tpu/ops/bijectors.py``: Softplus for positivity and a
sigmoid bounded to [low, high] for the lengthscale, with TFP's numerics
(stable softplus inverse ``y + log(-expm1(-y))``) so unconstrained-space
trajectories — and the reference's raw-space p21 clamp — match the JAX
package in f64.

A parameter NamedTuple is paired with a NamedTuple of bijectors of the same
type and transformed field by field with :func:`constrain` /
:func:`unconstrain`.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Softplus:
    """y = log(1 + exp(x)); x = y + log(-expm1(-y))."""

    def forward(self, x):
        # logaddexp(x, 0), as jnp.logaddexp computes it.
        return torch.logaddexp(x, torch.zeros_like(x))

    def inverse(self, y):
        return y + torch.log(-torch.expm1(-y))


@dataclasses.dataclass(frozen=True)
class SigmoidBounded:
    """y = low + (high - low) * sigmoid(x); inverse is a logit."""

    low: float = 0.0
    high: float = 1.0

    def forward(self, x):
        return self.low + (self.high - self.low) * torch.sigmoid(x)

    def inverse(self, y):
        z = (y - self.low) / (self.high - self.low)
        return torch.log(z) - torch.log1p(-z)


def constrain(raw, bijectors):
    """Map a NamedTuple of unconstrained tensors to constrained space."""
    return type(raw)(*(b.forward(x) for b, x in zip(bijectors, raw)))


def unconstrain(params, bijectors):
    """Inverse of :func:`constrain`."""
    return type(params)(*(b.inverse(y) for b, y in zip(bijectors, params)))
