r"""Sparse variational SIMM LFM: the N ~ 1e5 route.

Port of ``dis_project_tpu/models/svlfm.py``. Inducing points live in the
latent-force domain, u = f(z) at M inducing times z: every output is a
linear functional of f, so the closed-form cross-covariance k_xf
(``ops.lfm_kernels``) gives exact inter-domain projections,

    Kuu[a,b] = k_ff*(z_a, z_b)       Kuf[a,i] = k_xf(t_i, z_a; D_j, S_j)

Every force-domain covariance here is the Lawrence-consistent RBF
``k_ff* = exp(-r^2/l^2)`` (``ops.lfm_kernels.k_ff_consistent``), the prior
the closed forms integrate. The reference's ``k_ff`` (``2*l`` denominator,
the kind 'ff' of the exact path and of the kernel K1) would make the joint
(u, x) covariance non-PSD here and break the bound, so ``K_{u,x}`` is built
from the closed forms in PyTorch, as the JAX package builds it in XLA; no
hand-written kernel is on this path.

Two objectives:

- :meth:`SparseSIMM.elbo`: the uncollapsed, whitened Hensman bound
  (q(v) = N(m, L_s L_sᵀ), u = Luu v), O(M^3 + B M^2) per minibatch of B
  rows, unbiased with the N/B scale factor.
- :meth:`SparseSIMM.collapsed_elbo`: the Titsias bound with q(u) optimal,
  O(N M^2); :meth:`SparseSIMM.optimal_q` gives that optimum as explicit
  (m, L_s) so that the predictions are shared.

Both use the heteroscedastic likelihood variance ``obs_stddev^2 +
measurement_variance_i``. A Cholesky factor of a matrix that is not PD is
NaN (``ops.cuda_cholesky.cholesky_nan``), as ``jnp.linalg.cholesky``
returns it, so a failed factorisation shows up in the bound and does not
raise.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from dis_project_tpu_torch.models.base import Gaussian
from dis_project_tpu_torch.models.multisimm import MULTISIMM_BIJECTORS, MultiSIMMParams
from dis_project_tpu_torch.models.simm import SIMM_BIJECTORS, SIMMParams
from dis_project_tpu_torch.models.simm2 import SIMM2_BIJECTORS, SIMM2Params
from dis_project_tpu_torch.ops import bijectors as bij
from dis_project_tpu_torch.ops import lfm_kernels as lfk
from dis_project_tpu_torch.ops import lfm_kernels2 as lfk2
from dis_project_tpu_torch.ops.cuda_cholesky import cholesky_nan
from dis_project_tpu_torch.ops.precision import PARITY_DTYPE

LOG_2PI = 1.8378770664093453


class SVLFMParams(NamedTuple):
    """Kinetics and GP hyperparameters (constrained space) and the
    variational state.

    ``kinetics``: ``SIMMParams`` (first order), ``SIMM2Params`` (second
    order) or ``MultiSIMMParams`` (R forces). ``z``: (M,) inducing times
    (unconstrained). ``q_mu``: (R*M,) whitened variational mean.
    ``q_sqrt``: (R*M, R*M) whitened variational square root; only its lower
    triangle is used, its diagonal passed through softplus.
    """

    kinetics: SIMMParams
    z: torch.Tensor
    q_mu: torch.Tensor
    q_sqrt: torch.Tensor


def _kinetics_bijectors(kinetics):
    if isinstance(kinetics, SIMM2Params):
        return SIMM2_BIJECTORS
    if isinstance(kinetics, MultiSIMMParams):
        return MULTISIMM_BIJECTORS
    return SIMM_BIJECTORS


def init_params(num_genes: int, num_inducing: int, t_max: float = 12.0,
                dtype=PARITY_DTYPE, order: int = 1, num_forces: int = 1,
                device="cpu") -> SVLFMParams:
    """Reference kinetic inits and the identity whitened posterior, inducing
    times uniform over [0, t_max]. ``order=2`` selects spring-damper
    kinetics; ``num_forces > 1`` the multi-force first-order family, whose
    inducing variables are the R stacked force values on one shared z grid
    (an (R*M)-dimensional whitened posterior)."""
    if num_forces > 1:
        if order != 1:
            raise ValueError("num_forces > 1 requires order=1")
        from dis_project_tpu_torch.models import multisimm

        kinetics = multisimm.init_params(num_genes, num_forces, dtype, device)
    elif order == 2:
        from dis_project_tpu_torch.models import simm2

        kinetics = simm2.init_params(num_genes, dtype, device)
    else:
        from dis_project_tpu_torch.models import simm

        kinetics = simm.init_params(num_genes, dtype, device)
    m_total = num_inducing * num_forces
    kw = dict(dtype=dtype, device=device)
    return SVLFMParams(
        kinetics=kinetics,
        z=torch.linspace(0.0, t_max, num_inducing, **kw),
        q_mu=torch.zeros((m_total,), **kw),
        q_sqrt=torch.eye(m_total, **kw),
    )


def constrain(raw: SVLFMParams) -> SVLFMParams:
    return SVLFMParams(
        kinetics=bij.constrain(raw.kinetics, _kinetics_bijectors(raw.kinetics)),
        z=raw.z,
        q_mu=raw.q_mu,
        q_sqrt=_tri_constrain(raw.q_sqrt),
    )


def unconstrain(params: SVLFMParams) -> SVLFMParams:
    return SVLFMParams(
        kinetics=bij.unconstrain(params.kinetics, _kinetics_bijectors(params.kinetics)),
        z=params.z,
        q_mu=params.q_mu,
        q_sqrt=_tri_unconstrain(params.q_sqrt),
    )


def _tri_constrain(raw):
    return torch.tril(raw, -1) + torch.diag(bij.Softplus().forward(torch.diagonal(raw)))


def _tri_unconstrain(L):
    return torch.tril(L, -1) + torch.diag(bij.Softplus().inverse(torch.diagonal(L)))


def _gene_index(x, num_genes: int):
    """The rows' gene column as indices clipped to [0, num_genes - 1]; the
    float-to-integer cast truncates (a force row's -1 stays -1, then clips
    to 0), as ``astype(int32)`` does."""
    return torch.clamp(x[:, 1].to(torch.long), 0, num_genes - 1)


@dataclasses.dataclass(frozen=True)
class SparseSIMM:
    """Static configuration and pure methods of the sparse variational LFM.

    ``order``: 1 = first-order SIMM kinetics, 2 = spring-damper; only the
    cross and auto covariances and the steady-state mean change.
    ``num_forces > 1`` (order 1): R independent latent forces on a shared z
    grid; ``Kuu`` is block-diagonal over forces, each inducing block
    projects through its own force's ``S[:, r] k_xf(l_r)``, and the prior
    variance of an expression row sums the forces' contributions. Latent
    rows carry the force index in the gene column.
    """

    num_genes: int = 5
    num_inducing: int = 64
    jitter: float = 1e-6
    order: int = 1
    num_forces: int = 1

    # -- shared pieces ------------------------------------------------------

    def mean_function(self, params: SVLFMParams, x: torch.Tensor) -> torch.Tensor:
        k = params.kinetics
        g = _gene_index(x, self.num_genes)
        if self.order == 2:
            ratio = k.basal / (k.alpha**2 + k.omega**2)
        else:
            ratio = k.basal / k.decay
        return ratio[g] * x[:, 2]

    def _luu(self, params: SVLFMParams):
        z = params.z
        ell = params.kinetics.lengthscale
        if self.num_forces > 1:
            Kuu = torch.block_diag(*[lfk.k_ff_consistent_block(z, z, ell[r])
                                     for r in range(self.num_forces)])
        else:
            Kuu = lfk.k_ff_consistent_block(z, z, ell)
        # The RBF Kuu is near-low-rank; in float32 its build error alone
        # pushes the smallest eigenvalues negative once z leaves a uniform
        # grid, so the jitter has a floor at that precision.
        floor = 1e-4 if z.dtype == torch.float32 else self.jitter
        eye = torch.eye(Kuu.shape[0], dtype=z.dtype, device=z.device)
        return cholesky_nan(Kuu + max(self.jitter, floor) * eye)

    def _proj(self, params: SVLFMParams, luu, x: torch.Tensor):
        """A = Luu^{-1} K_{u,x} for mixed (t, gene, flag) rows x: expression
        rows through k_xf, force rows through k_ff*."""
        k = params.kinetics
        t = x[:, 0]
        raw_g = x[:, 1].to(torch.long)
        g = torch.clamp(raw_g, 0, self.num_genes - 1)
        flag = x[:, 2][:, None]
        s = k.sensitivity[g]
        z = params.z[None, :]
        tc = t[:, None]
        if self.num_forces > 1:
            fidx = torch.clamp(raw_g, 0, self.num_forces - 1)
            blocks = []
            for r in range(self.num_forces):
                kxu_r = lfk.k_xf(tc, z, k.decay[g][:, None], s[:, r][:, None],
                                 k.lengthscale[r])
                kfu_r = (fidx == r).to(t.dtype)[:, None] * lfk.k_ff_consistent(
                    tc, z, k.lengthscale[r])
                blocks.append(flag * kxu_r + (1.0 - flag) * kfu_r)
            Kxu = torch.cat(blocks, dim=1)  # (B, R*M)
            return torch.linalg.solve_triangular(luu, Kxu.T, upper=False)  # (R*M, B)
        if self.order == 2:
            kxu = lfk2.k_xf2(tc, z, k.alpha[g][:, None], k.omega[g][:, None], s[:, None],
                             k.lengthscale)
        else:
            kxu = lfk.k_xf(tc, z, k.decay[g][:, None], s[:, None], k.lengthscale)
        kfu = lfk.k_ff_consistent(tc, z, k.lengthscale)
        Kxu = flag * kxu + (1.0 - flag) * kfu
        return torch.linalg.solve_triangular(luu, Kxu.T, upper=False)  # (M, B)

    def _prior_var(self, params: SVLFMParams, x: torch.Tensor):
        """Diagonal of the prior covariance at rows x (k_xx or k_ff*)."""
        k = params.kinetics
        t = x[:, 0]
        g = _gene_index(x, self.num_genes)
        flag = x[:, 2]
        s = k.sensitivity[g]
        if self.num_forces > 1:
            d = k.decay[g]
            one = torch.ones((), dtype=t.dtype, device=t.device)
            vxx = sum(s[:, r] ** 2 * lfk.k_xx(t, t, d, d, one, one, k.lengthscale[r])
                      for r in range(self.num_forces))
        elif self.order == 2:
            a, w = k.alpha[g], k.omega[g]
            vxx = lfk2.k_xx2(t, t, a, w, a, w, s, s, k.lengthscale)
        else:
            d = k.decay[g]
            vxx = lfk.k_xx(t, t, d, d, s, s, k.lengthscale)
        vff = torch.ones_like(t)  # k_ff*(t, t) = 1
        return flag * vxx + (1.0 - flag) * vff

    def _marginals(self, params: SVLFMParams, x: torch.Tensor):
        """Whitened SVGP marginals q(g_i) = N(mu_i, var_i) at rows x."""
        luu = self._luu(params)
        A = self._proj(params, luu, x)  # (M, B)
        mean = self.mean_function(params, x) + A.T @ params.q_mu
        SA = params.q_sqrt.T @ A  # (M, B)
        var = self._prior_var(params, x) - torch.sum(A * A, dim=0) + torch.sum(SA * SA, dim=0)
        # maximum, not clamp_min: at a tie the gradient splits, as jnp.maximum's does.
        return mean, torch.maximum(var, var.new_full((), self.jitter))

    # -- objectives ---------------------------------------------------------

    def kl(self, params: SVLFMParams) -> torch.Tensor:
        """KL(q(v) || N(0, I)) in the whitened space."""
        Ls = params.q_sqrt
        m = params.q_mu
        M = m.shape[0]
        logdet = 2.0 * torch.sum(torch.log(torch.diagonal(Ls)))
        return 0.5 * (torch.sum(m * m) + torch.sum(Ls * Ls) - logdet - M)

    def elbo(self, params: SVLFMParams, x, y, variances, n_total: int) -> torch.Tensor:
        """Uncollapsed whitened ELBO on a minibatch of rows; ``n_total``
        scales the likelihood term to the full dataset."""
        y = y.reshape(-1)
        variances = variances.reshape(-1)
        mean, var = self._marginals(params, x)
        noise = params.kinetics.obs_stddev ** 2 + variances
        quad = (y - mean) ** 2 + var
        ll = -0.5 * torch.sum(torch.log(2 * math.pi * noise) + quad / noise)
        scale = n_total / x.shape[0]
        return scale * ll - self.kl(params)

    def _woodbury(self, params: SVLFMParams, x, y, variances):
        """The pieces both collapsed quantities share: the noise diagonal,
        A, the centred targets, A Λ^{-1} and B = I + A Λ^{-1} Aᵀ's factor."""
        y = y.reshape(-1)
        variances = variances.reshape(-1)
        noise = params.kinetics.obs_stddev ** 2 + variances  # (N,)
        luu = self._luu(params)
        A = self._proj(params, luu, x)  # (M, N)
        yc = y - self.mean_function(params, x)
        An = A / noise[None, :]
        eye = torch.eye(A.shape[0], dtype=A.dtype, device=A.device)
        Lb = cholesky_nan(eye + An @ A.T)
        return noise, A, yc, An, Lb, eye

    def collapsed_elbo(self, params: SVLFMParams, x, y, variances) -> torch.Tensor:
        r"""Titsias (2009) collapsed bound, q(u) analytically optimal:

        .. math:: \log N(y \mid \mu, Q_{ff} + \Lambda)
                  - \tfrac12 \mathrm{tr}(\Lambda^{-1}(K_{ff} - Q_{ff}))

        with :math:`Q_{ff} = A^\top A` and :math:`\Lambda` the noise
        diagonal, in O(N M^2) through the Woodbury identity. ``q_mu`` and
        ``q_sqrt`` are unused."""
        noise, A, yc, An, Lb, _ = self._woodbury(params, x, y, variances)
        n = yc.shape[0]
        c = torch.linalg.solve_triangular(Lb, (An @ yc)[:, None], upper=False)[:, 0]
        logdet = 2.0 * torch.sum(torch.log(torch.diagonal(Lb))) + torch.sum(torch.log(noise))
        quad = torch.sum(yc * yc / noise) - torch.sum(c * c)
        logp = -0.5 * (logdet + quad + n * LOG_2PI)
        trace = torch.sum((self._prior_var(params, x) - torch.sum(A * A, dim=0)) / noise)
        return logp - 0.5 * trace

    def optimal_q(self, params: SVLFMParams, x, y, variances) -> SVLFMParams:
        """Closed-form optimal whitened (q_mu, q_sqrt) for fixed hypers,
        S* = B^{-1} and m* = B^{-1} A Λ^{-1} (y - μ): B's factor Lb, Lb^{-T}
        by a triangular solve against I, S = Lb^{-T} Lb^{-1} and its lower
        Cholesky factor, in that order."""
        _, _, yc, An, Lb, eye = self._woodbury(params, x, y, variances)
        m = torch.cholesky_solve((An @ yc)[:, None], Lb, upper=False)[:, 0]
        Ls = torch.linalg.solve_triangular(Lb.mT, eye, upper=True)
        S = Ls @ Ls.T
        return params._replace(q_mu=m, q_sqrt=cholesky_nan(S))

    # -- prediction ---------------------------------------------------------

    def latent_predict(self, params: SVLFMParams, t_grid: torch.Tensor,
                       force: int = 0) -> Gaussian:
        """q(f*) on force rows at ``t_grid`` (diagonal covariance);
        ``force`` selects the latent force when ``num_forces > 1`` (with one
        force it clips to 0 and changes nothing)."""
        rows = torch.stack([t_grid, torch.full_like(t_grid, force), torch.zeros_like(t_grid)],
                           dim=-1)
        mean, var = self._marginals(params, rows)
        return Gaussian(mean=mean, cov=torch.diag(var))

    def gene_predict(self, params: SVLFMParams, rows: torch.Tensor) -> Gaussian:
        """q(x*) marginals at expression rows (flag forced to 1)."""
        rows = rows.clone()
        rows[:, 2] = 1.0
        mean, var = self._marginals(params, rows)
        return Gaussian(mean=mean, cov=torch.diag(var))
