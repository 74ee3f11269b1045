"""Parameter bijectors (constrained <-> unconstrained transforms).

Port of ``dis_project_tpu/ops/bijectors.py``: Softplus for positivity and a
sigmoid bounded to [low, high] for the lengthscale, with TFP's numerics
(stable softplus inverse ``y + log(-expm1(-y))``) so unconstrained-space
trajectories — and the reference's raw-space p21 clamp — match the JAX
package in f64.

A parameter NamedTuple is paired with a NamedTuple of bijectors of the same
type and transformed field by field with :func:`constrain` /
:func:`unconstrain`. :func:`constrain_log_det` is the change-of-variables
term the HMC log-densities add (``training.hmc``).
"""

from __future__ import annotations

import dataclasses
import math

import torch


def _logaddexp0(x):
    """logaddexp(x, 0), as jnp.logaddexp computes it."""
    return torch.logaddexp(x, torch.zeros_like(x))


@dataclasses.dataclass(frozen=True)
class Bijector:
    """Base transform. ``forward`` maps unconstrained -> constrained."""

    def forward(self, x):
        raise NotImplementedError

    def inverse(self, y):
        raise NotImplementedError

    def log_det_grad(self, x):
        """Elementwise ``log |d forward / dx|``."""
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class Identity(Bijector):
    def forward(self, x):
        return x

    def inverse(self, y):
        return y

    def log_det_grad(self, x):
        return torch.zeros_like(x)


@dataclasses.dataclass(frozen=True)
class Softplus(Bijector):
    """y = log(1 + exp(x)); x = y + log(-expm1(-y))."""

    def forward(self, x):
        return _logaddexp0(x)

    def inverse(self, y):
        return y + torch.log(-torch.expm1(-y))

    def log_det_grad(self, x):
        # d softplus / dx = sigmoid(x); log sigmoid(x) = -softplus(-x).
        return -_logaddexp0(-x)


@dataclasses.dataclass(frozen=True)
class SigmoidBounded(Bijector):
    """y = low + (high - low) * sigmoid(x); inverse is a logit."""

    low: float = 0.0
    high: float = 1.0

    def forward(self, x):
        return self.low + (self.high - self.low) * torch.sigmoid(x)

    def inverse(self, y):
        z = (y - self.low) / (self.high - self.low)
        return torch.log(z) - torch.log1p(-z)

    def log_det_grad(self, x):
        # d/dx = (high - low) * sigmoid(x) * sigmoid(-x).
        return math.log(self.high - self.low) - _logaddexp0(x) - _logaddexp0(-x)


def constrain(raw, bijectors):
    """Map a NamedTuple of unconstrained tensors to constrained space."""
    return type(raw)(*(b.forward(x) for b, x in zip(bijectors, raw)))


def unconstrain(params, bijectors):
    """Inverse of :func:`constrain`."""
    return type(params)(*(b.inverse(y) for b, y in zip(bijectors, params)))


def constrain_log_det(raw, bijectors):
    """``log |d constrain(raw) / d raw|`` summed over every element of every
    field — the Jacobian term that makes a flat prior in CONSTRAINED space
    into the matching unconstrained-space density (``training.hmc``)."""
    total = None
    for b, x in zip(bijectors, raw):
        s = torch.sum(b.log_det_grad(x))
        total = s if total is None else total + s
    return total
