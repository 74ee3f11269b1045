r"""Exact second-order (spring-damper) LFM.

Port of ``dis_project_tpu/models/simm2.py``. Parameters are a
:class:`SIMM2Params` NamedTuple of tensors; :class:`SecondOrderSIMM` holds
only static configuration, and every method is a pure function of
``(params, tensors)`` on the device its tensors live on.

Dynamics per output j (mass normalised):

    x_j'' + 2 alpha_j x_j' + (alpha_j^2 + omega_j^2) x_j = B_j + S_j f(t)

with the decay rate alpha_j > 0 and the damped frequency omega_j > 0 (always
underdamped). The steady-state mean is B_j / (alpha_j^2 + omega_j^2); the
covariances come from ``ops.lfm_kernels2`` (complex-exponential closed
forms). The MLL goes through ``ops.mll.mvn_logpdf``: on the card in float32
above N = 2048 its backward forms tril(Σ⁻¹) through the SYRK kernel K3
(``kernels=False``: the plain version, the yardstick it is held against).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from dis_project_tpu_torch.models.base import Gaussian
from dis_project_tpu_torch.ops import bijectors as bij
from dis_project_tpu_torch.ops import lfm_kernels2 as lfk2
from dis_project_tpu_torch.ops import mll as mll_ops
from dis_project_tpu_torch.ops.precision import PARITY_DTYPE


class SIMM2Params(NamedTuple):
    """Constrained-space parameters of the second-order LFM: basal,
    sensitivity, alpha (decay rates = damping / 2), omega (damped
    frequencies) (G,); lengthscale (); obs_stddev ()."""

    basal: torch.Tensor
    sensitivity: torch.Tensor
    alpha: torch.Tensor
    omega: torch.Tensor
    lengthscale: torch.Tensor
    obs_stddev: torch.Tensor


SIMM2_BIJECTORS = SIMM2Params(
    basal=bij.Softplus(),
    sensitivity=bij.Softplus(),
    alpha=bij.Softplus(),
    omega=bij.Softplus(),
    lengthscale=bij.SigmoidBounded(0.5, 3.5),
    obs_stddev=bij.Softplus(),
)


def init_params(num_genes: int, dtype=PARITY_DTYPE, device="cpu") -> SIMM2Params:
    """Defaults in the closed forms' safe region (omega * l = 2 < 5)."""
    kw = dict(dtype=dtype, device=device)
    return SIMM2Params(
        basal=torch.full((num_genes,), 0.05, **kw),
        sensitivity=torch.full((num_genes,), 1.0, **kw),
        alpha=torch.full((num_genes,), 0.4, **kw),
        omega=torch.full((num_genes,), 1.0, **kw),
        lengthscale=torch.tensor(2.0, **kw),
        obs_stddev=torch.tensor(1.0, **kw),
    )


def constrain(raw: SIMM2Params) -> SIMM2Params:
    return bij.constrain(raw, SIMM2_BIJECTORS)


def unconstrain(params: SIMM2Params) -> SIMM2Params:
    return bij.unconstrain(params, SIMM2_BIJECTORS)


def damping(params: SIMM2Params) -> torch.Tensor:
    """Physical damping coefficient c = 2 alpha."""
    return 2.0 * params.alpha


def spring(params: SIMM2Params) -> torch.Tensor:
    """Physical spring constant k = alpha^2 + omega^2."""
    return params.alpha**2 + params.omega**2


@dataclasses.dataclass(frozen=True)
class SecondOrderSIMM:
    """Static configuration + pure methods for the exact second-order LFM.
    ``kernels``: let the MLL's backward take K3 on the card (``False``: the
    plain versions everywhere)."""

    num_genes: int = 5
    jitter: float = 1e-6
    kernels: bool = True

    # From this row count the square Gram build is row-chunked and
    # recomputed in the backward (cross_covariance2_chunked): the
    # complex-erf closed forms otherwise keep ~20 (N, N) temporaries.
    CHUNKED_GRAM_MIN_N = 4096

    def mean_function(self, params: SIMM2Params, x: torch.Tensor) -> torch.Tensor:
        """Steady-state mean B_j / (alpha_j^2 + omega_j^2) on output rows."""
        ratio = params.basal / spring(params)
        g = torch.clamp(x[:, 1].to(torch.int32), 0, self.num_genes - 1).long()
        return ratio[g] * x[:, 2]

    def gram(self, params: SIMM2Params, x: torch.Tensor) -> torch.Tensor:
        if x.shape[0] >= self.CHUNKED_GRAM_MIN_N:
            return lfk2.cross_covariance2_chunked(
                x, x, params.alpha, params.omega, params.sensitivity, params.lengthscale)
        return self.cross_covariance(params, x, x)

    def cross_covariance(self, params: SIMM2Params, x1: torch.Tensor,
                         x2: torch.Tensor) -> torch.Tensor:
        return lfk2.cross_covariance2(
            x1, x2, params.alpha, params.omega, params.sensitivity, params.lengthscale)

    def _chol_impl(self, y: torch.Tensor) -> str:
        return mll_ops.resolve_chol_impl(y.shape[0], y.dtype, y.device)

    def mll(self, params: SIMM2Params, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """Exact conjugate MLL with Sigma = K + (jitter + obs^2) I."""
        y = y.reshape(-1)
        mx = self.mean_function(params, x)
        K = self.gram(params, x)
        sigma = mll_ops.add_diagonal(K, self.jitter + params.obs_stddev**2)
        return mll_ops.mvn_logpdf(y, mx, sigma, impl=self._chol_impl(y), kernels=self.kernels)

    def mll_gridded(self, params: SIMM2Params, timepoints: torch.Tensor,
                    y: torch.Tensor) -> torch.Tensor:
        """Exact MLL for gene-major gridded outputs through the table Gram
        (``lfm_kernels2.gram_xx2_blocked_fast``): the value of :meth:`mll`
        on the corresponding rows, with O(T G) complex-erf evaluations."""
        y = y.reshape(-1)
        T = timepoints.shape[0]
        mx = (params.basal / spring(params)).repeat_interleave(T)
        K = lfk2.gram_xx2_blocked_fast(
            timepoints, params.alpha, params.omega, params.sensitivity, params.lengthscale)
        sigma = mll_ops.add_diagonal(K, self.jitter + params.obs_stddev**2)
        return mll_ops.mvn_logpdf(y, mx, sigma, impl=self._chol_impl(y), kernels=self.kernels)

    def latent_predict(self, params: SIMM2Params, test_rows: torch.Tensor, x: torch.Tensor,
                       y: torch.Tensor, variances: torch.Tensor) -> Gaussian:
        """Exact posterior over the latent force at force rows (flag 0);
        the train covariance adds the per-point variances and jitter."""
        y = y.reshape(-1)
        variances = variances.reshape(-1)
        mean_x = self.mean_function(params, x)
        mean_t = self.mean_function(params, test_rows)

        Kxx = mll_ops.add_diagonal(self.gram(params, x), variances + self.jitter)
        L = mll_ops.cholesky(Kxx)
        Kxf = self.cross_covariance(params, x, test_rows)
        solved = mll_ops.chol_solve(L, Kxf)
        mean = mean_t + solved.T @ (y - mean_x)

        var = self.gram(params, test_rows) - solved.T @ Kxf
        return Gaussian(mean=mean, cov=mll_ops.add_diagonal(var, self.jitter))

    def output_predict(self, params: SIMM2Params, test_rows: torch.Tensor, x: torch.Tensor,
                       y: torch.Tensor, variances: torch.Tensor) -> Gaussian:
        """Exact posterior over outputs at test rows (flag forced to 1)."""
        y = y.reshape(-1)
        variances = variances.reshape(-1)
        t2 = test_rows.clone()
        t2[:, 2] = 1
        mean_x = self.mean_function(params, x)
        mean_t = self.mean_function(params, t2)

        sigma = mll_ops.add_diagonal(self.gram(params, x), variances + params.obs_stddev**2)
        L = mll_ops.cholesky(sigma)
        Ktt = self.gram(params, t2)
        Kxt = self.cross_covariance(params, x, t2)
        solved = mll_ops.chol_solve(L, Kxt)
        mean = mean_t + solved.T @ (y - mean_x)
        cov = Ktt - Kxt.T @ solved
        return Gaussian(mean=mean, cov=mll_ops.add_diagonal(cov, self.jitter))
