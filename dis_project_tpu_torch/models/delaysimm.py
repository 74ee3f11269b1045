r"""Delayed-response exact SIMM: per-gene transcriptional delays.

Port of ``dis_project_tpu/models/delaysimm.py``. Parameters are a
:class:`DelaySIMMParams` NamedTuple of tensors; :class:`ExactDelaySIMM`
holds only static configuration.

.. math:: \dot x_j(t) = B_j + S_j f(t - \delta_j) - D_j x_j(t)

With the switch-on convention f(u) = 0 for u < 0 and x_j(0) = B_j / D_j,
the delayed solution is the zero-delay one read at warped time,
:math:`x_j(t) = \tilde x_j(\max(t - \delta_j, 0))` (the JAX module's notes
give the proof). Every covariance is therefore the first-order closed form
at time-warped rows (:func:`warp_rows`), and every method of
:class:`ExactDelaySIMM` hands over to the port's ``ExactSIMM`` at those
rows: on the card its Grams are the kernels K2 (training Gram, with K2's
backward for decay, sensitivity and lengthscale) and K1 (cross-covariances).
The gradient with respect to the delays flows through the rows of the Gram;
on a CUDA tensor ``ops.cuda_gram`` takes it by the plain VJP and counts it
in ``PLAIN_X_GRADS``, as the JAX package takes its rows' gradient by an
XLA VJP. With every delay 0 each method equals ``ExactSIMM``'s bitwise.

``fit(fix_params=True)`` pins the p21 kinetics (S = 1.0, D = 0.8 in raw
space) and that gene's delay to raw -20 (softplus ~2e-9) on every step: the
family's identifiability anchor, the other delays read relative to it.
:func:`kinetics_posterior` samples (kinetics, delays) by HMC
(``training.hmc``) over the unclamped model.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from dis_project_tpu_torch.models.base import Gaussian
from dis_project_tpu_torch.models.simm import ExactSIMM, SIMMParams
from dis_project_tpu_torch.ops import bijectors as bij
from dis_project_tpu_torch.ops.precision import PARITY_DTYPE


class DelaySIMMParams(NamedTuple):
    """SIMM kinetics and per-gene delays (constrained space): basal,
    sensitivity, decay (G,); lengthscale (); obs_stddev (); delay (G,),
    nonnegative, in the observations' time units."""

    basal: torch.Tensor
    sensitivity: torch.Tensor
    decay: torch.Tensor
    lengthscale: torch.Tensor
    obs_stddev: torch.Tensor
    delay: torch.Tensor


DELAY_BIJECTORS = DelaySIMMParams(
    basal=bij.Softplus(),
    sensitivity=bij.Softplus(),
    decay=bij.Softplus(),
    lengthscale=bij.SigmoidBounded(0.5, 3.5),
    obs_stddev=bij.Softplus(),
    delay=bij.Softplus(),
)

# The delay anchor's raw value: softplus(-20) ~ 2e-9, below any observation
# spacing (a softplus never reaches 0).
ZERO_DELAY_RAW = -20.0


def init_params(num_genes: int, dtype=PARITY_DTYPE, device="cpu",
                delay0: float = 0.2) -> DelaySIMMParams:
    """Reference kinetic inits (B=0.05, S=1.0, D=0.4, l=2.5, obs=1.0) and
    small positive delays ``delay0`` (0 is out of the softplus's reach, and
    the offset keeps the warp's kink away from the t=0 observation)."""
    kw = dict(dtype=dtype, device=device)
    return DelaySIMMParams(
        basal=torch.full((num_genes,), 0.05, **kw),
        sensitivity=torch.full((num_genes,), 1.0, **kw),
        decay=torch.full((num_genes,), 0.4, **kw),
        lengthscale=torch.tensor(2.5, **kw),
        obs_stddev=torch.tensor(1.0, **kw),
        delay=torch.full((num_genes,), delay0, **kw),
    )


def constrain(raw: DelaySIMMParams) -> DelaySIMMParams:
    return bij.constrain(raw, DELAY_BIJECTORS)


def unconstrain(params: DelaySIMMParams) -> DelaySIMMParams:
    return bij.unconstrain(params, DELAY_BIJECTORS)


def warp_rows(x: torch.Tensor, delay: torch.Tensor, num_genes: int) -> torch.Tensor:
    """The delay warp ``t -> max(t - delta_gene, 0)`` on the expression rows
    (flag 1) of a ``(t, gene, flag)`` row matrix; force rows pass through.
    ``torch.maximum`` splits the gradient of a tie at t = delta evenly, as
    ``jnp.maximum`` does (``clamp_min`` would pass all of it)."""
    g = torch.clamp(x[:, 1].to(torch.int32), 0, num_genes - 1).long()
    t_w = torch.maximum(x[:, 0] - delay[g], torch.zeros_like(x[:, 0]))
    t = torch.where(x[:, 2] == 1, t_w, x[:, 0])
    return torch.cat([t[:, None], x[:, 1:]], dim=1)


def pin_raw(raw: DelaySIMMParams, gene: int) -> DelaySIMMParams:
    """The raw-space anchor of ``fit(fix_params=True)``: gene ``gene``'s
    S = 1.0, D = 0.8 and delay raw -20."""
    sp = bij.Softplus()
    kw = dict(dtype=raw.delay.dtype, device=raw.delay.device)
    s, d, dl = raw.sensitivity.clone(), raw.decay.clone(), raw.delay.clone()
    s[gene] = sp.inverse(torch.tensor(1.0, **kw))
    d[gene] = sp.inverse(torch.tensor(0.8, **kw))
    dl[gene] = ZERO_DELAY_RAW
    return raw._replace(sensitivity=s, decay=d, delay=dl)


def fit(model: "ExactDelaySIMM", params: DelaySIMMParams, x, y, num_iters: int = 150,
        learning_rate: float = 0.01, fix_params: bool = False, clamp_gene: int = 3,
        optimizer=None, track_parameters: bool = False, full_result: bool = False,
        checkpoint_dir=None, checkpoint_every: int = 50, resume: bool = True):
    """Minimise the negative exact MLL with ``training.generic.fit_loop``
    (``fit_checkpointed`` under ``checkpoint_dir``); ``fix_params`` applies
    :func:`pin_raw` at ``clamp_gene`` before the optimizer starts and after
    every step. Returns ``(constrained params, (num_iters,) history)``, or
    the ``LoopResult`` with ``full_result=True``."""
    from dis_project_tpu_torch.training import generic

    y = y.reshape(-1)

    def loss_fn(raw):
        return -model.mll(constrain(raw), x, y)

    kw = dict(num_iters=num_iters, learning_rate=learning_rate, optimizer=optimizer or "adam",
              constrain_fn=constrain, track_parameters=track_parameters,
              clamp_raw=(lambda r: pin_raw(r, clamp_gene)) if fix_params else None)
    if checkpoint_dir:
        result = generic.fit_checkpointed(loss_fn, unconstrain(params), directory=checkpoint_dir,
                                          checkpoint_every=checkpoint_every, resume=resume, **kw)
    else:
        result = generic.fit_loop(loss_fn, unconstrain(params), **kw)
    if full_result:
        return result
    return result.params, result.history


@dataclasses.dataclass(frozen=True)
class ExactDelaySIMM:
    """Static configuration + pure methods for the delayed exact SIMM:
    every method is ``ExactSIMM``'s at warped rows. ``kernels`` and
    ``chol_impl`` pass through (``kernels=False``: the plain Grams)."""

    num_genes: int = 5
    jitter: float = 1e-4
    kernels: bool = True
    chol_impl: str = "auto"

    @property
    def _inner(self) -> ExactSIMM:
        return ExactSIMM(num_genes=self.num_genes, jitter=self.jitter, kernels=self.kernels,
                         chol_impl=self.chol_impl)

    @staticmethod
    def _kin(params: DelaySIMMParams) -> SIMMParams:
        """The instantaneous family's view of the parameters."""
        return SIMMParams(params.basal, params.sensitivity, params.decay, params.lengthscale,
                          params.obs_stddev)

    def _warp(self, params: DelaySIMMParams, x: torch.Tensor) -> torch.Tensor:
        return warp_rows(x, params.delay, self.num_genes)

    def mean_function(self, params: DelaySIMMParams, x: torch.Tensor) -> torch.Tensor:
        """B_j / D_j on expression rows, 0 on force rows (the warp moves
        times only)."""
        return self._inner.mean_function(self._kin(params), x)

    def cross_covariance(self, params: DelaySIMMParams, x1: torch.Tensor,
                         x2: torch.Tensor) -> torch.Tensor:
        return self._inner.cross_covariance(self._kin(params), self._warp(params, x1),
                                            self._warp(params, x2))

    def gram(self, params: DelaySIMMParams, x: torch.Tensor) -> torch.Tensor:
        return self._inner.gram(self._kin(params), self._warp(params, x))

    def mll(self, params: DelaySIMMParams, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """Exact conjugate MLL, Sigma = K + (jitter + obs^2) I at the warped
        rows (no per-point variances)."""
        return self._inner.mll(self._kin(params), self._warp(params, x), y)

    def latent_predict(self, params: DelaySIMMParams, test_rows: torch.Tensor, x: torch.Tensor,
                       y: torch.Tensor, variances: torch.Tensor) -> Gaussian:
        """Posterior over the force at ``test_rows`` (flag 0), the
        instantaneous family's conventions."""
        return self._inner.latent_predict(self._kin(params), self._warp(params, test_rows),
                                          self._warp(params, x), y, variances)

    def multi_gene_predict(self, params: DelaySIMMParams, test_rows: torch.Tensor,
                           x: torch.Tensor, y: torch.Tensor,
                           variances: torch.Tensor) -> Gaussian:
        """Posterior over expression at ``test_rows``, the flag forced to 1
        before the warp, so each test row is delayed by its gene's delta."""
        t2 = test_rows.clone()
        t2[:, 2] = 1
        return self._inner.multi_gene_predict(self._kin(params), self._warp(params, t2),
                                              self._warp(params, x), y, variances)


def kinetics_posterior(model: ExactDelaySIMM, params: DelaySIMMParams, x, y, generator,
                       num_warmup: int = 400, num_samples: int = 400, num_leapfrog: int = 24,
                       num_chains: int = 1, mesh=None, draws=None, init_noise=None):
    """Full-Bayes posterior over (kinetics, delays): ``training.hmc`` on the
    delayed exact MLL (on the card K2 and K2's backward at the warped rows,
    the rows' gradient by the counted plain VJP), flat prior on the
    CONSTRAINED parameters through the bijector Jacobian. Seed at the
    trained point; samples come back constrained. Over the UNCLAMPED model:
    the delay anchor is a point constraint the posterior does not impose,
    so the delays show the common-shift spread the anchor resolves.
    ``num_chains > 1`` returns (C, S)-leading samples; ``draws`` /
    ``init_noise`` take the random numbers ready-made."""
    from dis_project_tpu_torch.training import hmc

    y = y.reshape(-1)

    def logdensity(raw):
        return model.mll(constrain(raw), x, y) + bij.constrain_log_det(raw, DELAY_BIJECTORS)

    return hmc.sample_constrained(
        logdensity, unconstrain(params), generator, num_chains, mesh, constrain,
        dict(num_warmup=num_warmup, num_samples=num_samples, num_leapfrog=num_leapfrog),
        draws, init_noise)
