r"""Nonlinear-response latent force model: MAP and Laplace inference.

Port of ``dis_project_tpu/models/nlfm.py``. Lawrence, Sanguinetti & Rattray (2006) §5's
nonlinear response

.. math:: \dot x_j(t) = B_j + S_j\,g(f(t)) - D_j x_j(t)

has no closed-form covariance, so:

- the force is its values on a dense uniform quadrature grid, whitened as
  ``f = L_ff w`` (``L_ff`` the Cholesky factor of the consistent RBF prior
  ``exp(-r^2/l^2)`` on the grid), so the prior on the trainable ``w`` is
  N(0, I);
- the gene curves come from the log-depth trapezoid scan of
  ``ops.odeint``;
- inference is MAP over ``(kinetics, w)`` (:func:`fit`, the generic
  training loop), with a Laplace Gaussian over the force at the MAP point
  from one Q x Q Hessian (``torch.func.hessian``) and delta-method bands
  over the gene curves (``torch.func.jacfwd``);
- :func:`force_posterior_hmc` samples (kinetics, w) jointly by HMC
  (``training.hmc``) on the same log-joint.

Every factorisation on the path fails to NaN rather than raising
(``cholesky_ex``, ``inv_ex``): a raising call would read its status on the
host, one synchronisation a training step on the card.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from dis_project_tpu_torch.models import simm
from dis_project_tpu_torch.models.base import Gaussian
from dis_project_tpu_torch.models.simm import SIMM_BIJECTORS, SIMMParams
from dis_project_tpu_torch.ops import bijectors as bij
from dis_project_tpu_torch.ops.cuda_cholesky import cholesky_nan
from dis_project_tpu_torch.ops.odeint import gene_curves, response_fn
from dis_project_tpu_torch.ops.precision import PARITY_DTYPE

LOG_2PI = 1.8378770664093453


class NLFMParams(NamedTuple):
    """Kinetics (constrained space) and the whitened force values:
    ``kinetics`` a ``SIMMParams``; ``w`` (Q,) the whitened force on the
    quadrature grid, unconstrained (its prior is N(0, I))."""

    kinetics: SIMMParams
    w: torch.Tensor


def init_params(num_genes: int, num_quad: int = 97, dtype=PARITY_DTYPE,
                device="cpu") -> NLFMParams:
    """Reference kinetic inits and the zero force (the prior mean)."""
    return NLFMParams(kinetics=simm.init_params(num_genes, dtype=dtype, device=device),
                      w=torch.zeros((num_quad,), dtype=dtype, device=device))


def constrain(raw: NLFMParams) -> NLFMParams:
    return NLFMParams(kinetics=bij.constrain(raw.kinetics, SIMM_BIJECTORS), w=raw.w)


def unconstrain(params: NLFMParams) -> NLFMParams:
    return NLFMParams(kinetics=bij.unconstrain(params.kinetics, SIMM_BIJECTORS), w=params.w)


def _interp(x, xp, fp):
    """``jnp.interp(x, xp, row)`` for every row of ``fp`` (..., len(xp)):
    linear between the bracketing grid points, ``fp``'s first and last
    values beyond the grid's ends. The brackets depend on ``x`` and ``xp``
    only, so a transform over ``fp`` sees a gather and a blend."""
    n = xp.shape[0]
    i = torch.clamp(torch.searchsorted(xp, x, right=True), 1, n - 1)
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    dx0 = dx.abs() <= float(np.spacing(torch.finfo(xp.dtype).eps))
    frac = delta / torch.where(dx0, torch.ones_like(dx), dx)
    lo, hi = fp[..., i - 1], fp[..., i]
    f = torch.where(dx0, lo, lo + frac * (hi - lo))
    f = torch.where(x < xp[0], fp[..., :1], f)
    return torch.where(x > xp[-1], fp[..., -1:], f)


@dataclasses.dataclass(frozen=True)
class NonlinearLFM:
    """Static configuration + pure methods of the nonlinear-response LFM.

    ``num_quad`` is the quadrature grid size Q over ``[0, t_max]``; the
    default 97 = (7 - 1) * 16 + 1 refines the p53 timepoints 16x.
    Observation times need not lie on the grid: the curves are linearly
    interpolated to them."""

    num_genes: int = 5
    response: str = "exp"
    t_max: float = 12.0
    num_quad: int = 97
    jitter: float = 1e-6

    # -- force representation ------------------------------------------------

    def quad_grid(self, dtype=PARITY_DTYPE, device="cpu") -> torch.Tensor:
        return torch.linspace(0.0, self.t_max, self.num_quad, dtype=dtype, device=device)

    def force_chol(self, lengthscale, dtype=None) -> torch.Tensor:
        """Cholesky factor of the consistent RBF prior on the grid (NaN
        where the jittered prior is not positive definite)."""
        t = self.quad_grid(dtype or lengthscale.dtype, lengthscale.device)
        K = torch.exp(-((t[:, None] - t[None, :]) ** 2) / lengthscale**2)
        eye = torch.eye(self.num_quad, dtype=K.dtype, device=K.device)
        return cholesky_nan(K + self.jitter * eye)

    def force(self, params: NLFMParams) -> torch.Tensor:
        """f(t_grid) = L_ff @ w."""
        return self.force_chol(params.kinetics.lengthscale, params.w.dtype) @ params.w

    # -- forward map ----------------------------------------------------------

    def curves(self, params: NLFMParams, f_grid=None) -> torch.Tensor:
        """Gene expression curves on the quadrature grid, (G, Q), with
        x_j(0) = B_j / D_j."""
        k = params.kinetics
        if f_grid is None:
            f_grid = self.force(params)
        g_vals = response_fn(self.response)(f_grid)
        dt = self.t_max / (self.num_quad - 1)
        return gene_curves(g_vals, k.basal, k.sensitivity, k.decay, dt)

    def curves_at(self, params: NLFMParams, t_obs) -> torch.Tensor:
        """The curves interpolated to the observation times, (G, T_obs)."""
        x = self.curves(params)
        grid = self.quad_grid(x.dtype, x.device)
        return _interp(torch.as_tensor(t_obs, dtype=x.dtype, device=x.device), grid, x)

    # -- objective -------------------------------------------------------------

    def log_joint(self, params: NLFMParams, t_obs, Y, var) -> torch.Tensor:
        """log p(Y | kinetics, w) + log N(w | 0, I). ``Y`` / ``var``
        (..., G, T_obs): observations and fixed measurement variances
        (leading replicate axes broadcast); the likelihood variance is
        ``obs_stddev^2 + var``."""
        k = params.kinetics
        x = self.curves_at(params, t_obs)
        v = k.obs_stddev**2 + var
        resid = Y - x
        loglik = -0.5 * torch.sum(resid**2 / v + torch.log(v) + LOG_2PI)
        logprior = -0.5 * torch.sum(params.w**2) - 0.5 * params.w.numel() * LOG_2PI
        return loglik + logprior

    # -- posterior -------------------------------------------------------------

    def _laplace_w_cov(self, params: NLFMParams, t_obs, Y, var):
        """H^{-1}, H = -d^2/dw^2 log_joint at ``params.w`` (the dense Q x Q
        Hessian by ``torch.func.hessian``; the inverse by ``inv_ex``, NaN
        where singular)."""

        def obj(w):
            return self.log_joint(params._replace(w=w), t_obs, Y, var)

        H = -torch.func.hessian(obj)(params.w)
        eye = torch.eye(H.shape[0], dtype=H.dtype, device=H.device)
        inv, info = torch.linalg.inv_ex(H + self.jitter * eye)
        return torch.where(info != 0, torch.nan, inv)

    def laplace_force_posterior(self, params: NLFMParams, t_obs, Y, var,
                                cov_w=None) -> Gaussian:
        """Gaussian over f(t_grid) by Laplace at the (MAP) point:
        cov_f = L H^{-1} L^T + jitter I. ``cov_w`` skips the Hessian."""
        L = self.force_chol(params.kinetics.lengthscale, params.w.dtype)
        if cov_w is None:
            cov_w = self._laplace_w_cov(params, t_obs, Y, var)
        cov = L @ cov_w @ L.T
        cov = cov + self.jitter * torch.eye(cov.shape[0], dtype=cov.dtype, device=cov.device)
        return Gaussian(mean=L @ params.w, cov=cov)

    def laplace_curve_bands(self, params: NLFMParams, t_obs, Y, var,
                            cov_w=None) -> Gaussian:
        """Delta-method Gaussian over the gene curves on the grid:
        cov_x = J H^{-1} J^T + jitter I, J = dx/dw (``torch.func.jacfwd``);
        the mean is the stacked gene-major curves, (G*Q,)."""

        def flat_curves(w):
            return self.curves(params._replace(w=w)).reshape(-1)

        J = torch.func.jacfwd(flat_curves)(params.w)  # (G*Q, Q)
        if cov_w is None:
            cov_w = self._laplace_w_cov(params, t_obs, Y, var)
        cov = J @ cov_w @ J.T
        cov = cov + self.jitter * torch.eye(cov.shape[0], dtype=cov.dtype, device=cov.device)
        return Gaussian(mean=flat_curves(params.w), cov=cov)

    def laplace_posteriors(self, params: NLFMParams, t_obs, Y, var):
        """Both Laplace Gaussians (force, curves) from one Hessian."""
        cov_w = self._laplace_w_cov(params, t_obs, Y, var)
        return (self.laplace_force_posterior(params, t_obs, Y, var, cov_w),
                self.laplace_curve_bands(params, t_obs, Y, var, cov_w))


def pin_raw(raw: NLFMParams, gene: int) -> NLFMParams:
    """The raw-space anchor of ``fit(fix_params=True)``: gene ``gene``'s
    S = 1.0 and D = 0.8. The raw values are computed on the host in the
    parameters' dtype and selected in as numbers (an indexed write of a
    number is a host-to-device copy, a synchronisation a step on the
    card)."""
    sp = bij.Softplus()
    k = raw.kinetics
    at = torch.arange(k.decay.shape[0], device=k.decay.device) == gene
    s_raw, d_raw = (float(sp.inverse(torch.tensor(v, dtype=raw.w.dtype))) for v in (1.0, 0.8))
    return raw._replace(kinetics=k._replace(sensitivity=torch.where(at, s_raw, k.sensitivity),
                                            decay=torch.where(at, d_raw, k.decay)))


def fit(model: NonlinearLFM, params: NLFMParams, t_obs, Y, var, num_iters: int = 2000,
        learning_rate: float = 0.01, fix_params: bool = False, clamp_gene: int = 3,
        optimizer=None, track_parameters: bool = False, full_result: bool = False,
        checkpoint_dir=None, checkpoint_every: int = 50, resume: bool = True):
    """MAP over (kinetics, w) with ``training.generic.fit_loop``
    (``fit_checkpointed`` under ``checkpoint_dir``). ``fix_params`` applies
    :func:`pin_raw` at ``clamp_gene`` before the optimizer starts and after
    every step: for the exp response the S <-> force-shift degeneracy
    (g(f + c) = e^c g(f)) makes the pin matter more than in the linear
    family. Returns ``(constrained params, (num_iters,) negative-log-joint
    history)``, or the ``LoopResult`` with ``full_result=True``."""
    from dis_project_tpu_torch.training import generic

    def loss_fn(raw):
        return -model.log_joint(constrain(raw), t_obs, Y, var)

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


def force_posterior_hmc(model: NonlinearLFM, params: NLFMParams, t_obs, Y, var, generator,
                        num_warmup: int = 400, num_samples: int = 400, num_leapfrog: int = 24,
                        num_chains: int = 1, mesh=None, draws=None, init_noise=None):
    """Full-Bayes posterior over (kinetics, w): ``training.hmc`` on the
    log-joint the MAP fit optimises, with a flat prior on the CONSTRAINED
    kinetics through the bijector Jacobian of ``raw.kinetics`` (``w`` is
    unconstrained). Seed the chain at the MAP point; samples come back
    constrained. ``num_chains > 1`` returns (C, S)-leading samples for the
    R-hat/ESS diagnostics; ``draws`` / ``init_noise`` take the random
    numbers ready-made (``training.hmc.sample``)."""
    from dis_project_tpu_torch.training import hmc

    def logdensity(raw):
        return model.log_joint(constrain(raw), t_obs, Y, var) + bij.constrain_log_det(
            raw.kinetics, SIMM_BIJECTORS)

    return hmc.sample_constrained(
        logdensity, unconstrain(params), generator, num_chains, mesh, constrain,
        dict(num_warmup=num_warmup, num_samples=num_samples, num_leapfrog=num_leapfrog),
        draws, init_noise)
