r"""Exact multi-force SIMM latent force model (R independent latent forces).

Port of ``dis_project_tpu/models/multisimm.py``. Parameters are a
:class:`MultiSIMMParams` NamedTuple of tensors; :class:`ExactMultiSIMM`
holds only static configuration, and every method is a pure function of
``(params, tensors)`` on the device its tensors live on.

.. math::
    \frac{dx_j}{dt} = B_j + \sum_{r=1}^R S_{jr}\, f_r(t) - D_j x_j(t),
    \qquad f_r \sim \mathrm{GP}(0,\ k_{ff}(\cdot,\cdot; \ell_r))
    \ \text{independent}

The forces are independent and enter linearly, so every covariance is a
static sum over the R forces of the single-force closed forms
(``ops.lfm_kernels``): ``K_xx[j, k] = sum_r S_jr S_kr k_xx(d_j, d_k, 1, 1,
l_r)``, ``K_xf[j, r] = S_jr k_xf(d_j, 1, l_r)`` and a block-diagonal
``K_ff``. With R = 1 every quantity reduces to the first-order
``ExactSIMM``.

Rows follow the ``(t, gene, flag)`` convention; force rows (flag 0) carry
the FORCE index in the gene column (:func:`force_rows`). The force prior is
``k_ff_consistent`` (the Lawrence convention the closed forms integrate),
not the reference's ``2l`` ``k_ff``: the family conditions on a joint
(x, f) covariance, which must be positive semi-definite.

There is no hand-written kernel here: the JAX package builds this Gram as a
plain XLA sum, with no Pallas. The MLL goes through ``ops.mll.mvn_logpdf``
(on the card in float32 above N = 2048 its backward takes K3).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from dis_project_tpu_torch.models.base import Gaussian
from dis_project_tpu_torch.ops import bijectors as bij
from dis_project_tpu_torch.ops import lfm_kernels as lfk
from dis_project_tpu_torch.ops import mll as mll_ops
from dis_project_tpu_torch.ops.precision import PARITY_DTYPE


class MultiSIMMParams(NamedTuple):
    """Constrained-space parameters of the R-force SIMM: basal, decay (G,);
    sensitivity (G, R); lengthscale (R,), bounded to [0.5, 3.5];
    obs_stddev ()."""

    basal: torch.Tensor
    sensitivity: torch.Tensor
    decay: torch.Tensor
    lengthscale: torch.Tensor
    obs_stddev: torch.Tensor


MULTISIMM_BIJECTORS = MultiSIMMParams(
    basal=bij.Softplus(),
    sensitivity=bij.Softplus(),
    decay=bij.Softplus(),
    lengthscale=bij.SigmoidBounded(0.5, 3.5),
    obs_stddev=bij.Softplus(),
)


def init_params(num_genes: int, num_forces: int = 2, dtype=PARITY_DTYPE,
                device="cpu") -> MultiSIMMParams:
    """B=0.05, S=1.0, D=0.4, obs=1.0, and lengthscales spread around 2.5
    (``2.5 + s (r - (R-1)/2)``, s = min(0.5, 1.8 / (R - 1))) so that the
    forces start distinguishable, every one strictly inside the
    ``SigmoidBounded(0.5, 3.5)`` support (on the bound the unconstrain is
    inf, beyond it NaN)."""
    kw = dict(dtype=dtype, device=device)
    r = torch.arange(num_forces, **kw)
    spread = min(0.5, 1.8 / max(num_forces - 1, 1))
    return MultiSIMMParams(
        basal=torch.full((num_genes,), 0.05, **kw),
        sensitivity=torch.full((num_genes, num_forces), 1.0, **kw),
        decay=torch.full((num_genes,), 0.4, **kw),
        lengthscale=2.5 + spread * (r - (num_forces - 1) / 2.0),
        obs_stddev=torch.tensor(1.0, **kw),
    )


def constrain(raw: MultiSIMMParams) -> MultiSIMMParams:
    return bij.constrain(raw, MULTISIMM_BIJECTORS)


def unconstrain(params: MultiSIMMParams) -> MultiSIMMParams:
    return bij.unconstrain(params, MULTISIMM_BIJECTORS)


def cross_covariance(x1, x2, decay, sens, lengthscales):
    """Dense (N, M) multi-force covariance from (t, gene-or-force, flag)
    rows: a static sum over the forces of the single-force closed forms,
    weighted by the four flag branches."""
    G, R = sens.shape

    def split(x):
        g = torch.clamp(x[:, 1].to(torch.int32), 0, max(G, R) - 1).long()
        return x[:, 0], g, torch.clamp(g, 0, G - 1), x[:, 2]

    t1, g1, gg1, f1 = split(x1)
    t2, g2, gg2, f2 = split(x2)
    T1, T2 = t1[:, None], t2[None, :]
    D1, D2 = decay[gg1][:, None], decay[gg2][None, :]
    F1, F2 = f1[:, None], f2[None, :]

    one = torch.ones((), dtype=x1.dtype, device=x1.device)
    kxx = torch.zeros((x1.shape[0], x2.shape[0]), dtype=x1.dtype, device=x1.device)
    kff, kxf, kfx = kxx, kxx, kxx
    for r in range(R):
        ell = lengthscales[r]
        s1r = sens[gg1, r][:, None]
        s2r = sens[gg2, r][None, :]
        # Force-index selectors of the latent rows (gene column = force id).
        m1 = (g1 == r).to(x1.dtype)[:, None]
        m2 = (g2 == r).to(x2.dtype)[None, :]
        kxx = kxx + s1r * s2r * lfk.k_xx(T1, T2, D1, D2, one, one, ell)
        kff = kff + m1 * m2 * lfk.k_ff_consistent(T1, T2, ell)
        kxf = kxf + m2 * s1r * lfk.k_xf(T1, T2, D1, one, ell)
        kfx = kfx + m1 * s2r * lfk.k_xf(T2, T1, D2, one, ell)

    w_xx = F1 * F2
    w_ff = (1.0 - F1) * (1.0 - F2)
    w_xf = F1 * (1.0 - F2)
    w_fx = (1.0 - F1) * F2
    return w_xx * kxx + w_ff * kff + w_xf * kxf + w_fx * kfx


def force_rows(timepoints, force: int, dtype=PARITY_DTYPE, device=None) -> torch.Tensor:
    """Latent-grid rows of one force: ``(t, force_index, 0)``."""
    t = torch.as_tensor(timepoints, dtype=dtype, device=device)
    return torch.stack([t, torch.full_like(t, force), torch.zeros_like(t)], dim=-1)


# The JAX package's ``fit(checkpoint_dir=...)`` passes ``raw0`` to
# ``generic.fit_checkpointed``, and nothing in that ``fit`` defines it: the
# branch raises ``NameError``. The port adds no feature the reference lacks.
CHECKPOINT_REFUSAL = (
    "multisimm.fit(checkpoint_dir=...) is not supported: the JAX package's "
    "branch raises NameError (name 'raw0' is not defined), so the port does "
    "not implement it"
)


def fit(model: "ExactMultiSIMM", params: MultiSIMMParams, x, y, num_iters: int = 150,
        learning_rate: float = 0.01, optimizer=None, track_parameters: bool = False,
        full_result: bool = False, checkpoint_dir=None, checkpoint_every: int = 50,
        resume: bool = True):
    """Minimise the negative exact MLL with ``training.generic.fit_loop``;
    no clamp (the distinct per-force lengthscale inits identify the
    forces). Returns ``(constrained params, (num_iters,) history)``, or the
    ``LoopResult`` with ``full_result=True``. ``checkpoint_dir`` raises
    ``NotImplementedError`` (:data:`CHECKPOINT_REFUSAL`)."""
    from dis_project_tpu_torch.training import generic

    if checkpoint_dir:
        raise NotImplementedError(CHECKPOINT_REFUSAL)
    y = y.reshape(-1)

    def loss_fn(raw):
        return -model.mll(constrain(raw), x, y)

    result = generic.fit_loop(loss_fn, unconstrain(params), num_iters=num_iters,
                              learning_rate=learning_rate, optimizer=optimizer or "adam",
                              constrain_fn=constrain, track_parameters=track_parameters)
    if full_result:
        return result
    return result.params, result.history


@dataclasses.dataclass(frozen=True)
class ExactMultiSIMM:
    """Static configuration + pure methods for the R-force exact SIMM."""

    num_genes: int = 5
    num_forces: int = 2
    jitter: float = 1e-6

    def mean_function(self, params: MultiSIMMParams, x: torch.Tensor) -> torch.Tensor:
        """B_j / D_j on expression rows, 0 on force rows."""
        ratio = params.basal / params.decay
        g = torch.clamp(x[:, 1].to(torch.int32), 0, self.num_genes - 1).long()
        return ratio[g] * x[:, 2]

    def cross_covariance(self, params: MultiSIMMParams, x1: torch.Tensor,
                         x2: torch.Tensor) -> torch.Tensor:
        return cross_covariance(x1, x2, params.decay, params.sensitivity, params.lengthscale)

    def gram(self, params: MultiSIMMParams, x: torch.Tensor) -> torch.Tensor:
        return self.cross_covariance(params, x, x)

    def _chol_impl(self, x: torch.Tensor) -> str:
        return mll_ops.resolve_chol_impl(x.shape[0], x.dtype, x.device)

    def mll(self, params: MultiSIMMParams, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """Exact conjugate MLL with Sigma = K + (jitter + obs^2) I (no
        per-point variances, the single-force convention)."""
        y = y.reshape(-1)
        mx = self.mean_function(params, x)
        sigma = mll_ops.add_diagonal(self.gram(params, x), self.jitter + params.obs_stddev**2)
        return mll_ops.mvn_logpdf(y, mx, sigma, impl=self._chol_impl(x))

    def latent_predict(self, params: MultiSIMMParams, test_rows: torch.Tensor, x: torch.Tensor,
                       y: torch.Tensor, variances: torch.Tensor) -> Gaussian:
        """Posterior over the latent forces at ``test_rows`` (flag 0, gene
        column = force index; :func:`force_rows`): per-point variances and
        jitter in the train covariance, a diagonalised, twice-jittered
        posterior covariance."""
        y = y.reshape(-1)
        variances = variances.reshape(-1)
        mean_x = self.mean_function(params, x)
        Kxx = mll_ops.add_diagonal(self.gram(params, x), variances + self.jitter)
        L = mll_ops.cholesky(Kxx, self._chol_impl(x))
        Kxf = self.cross_covariance(params, x, test_rows)  # (N, M)
        solved = mll_ops.chol_solve(L, Kxf)
        mean = solved.T @ (y - mean_x)
        kff_diag = torch.diagonal(self.gram(params, test_rows))
        corr = torch.einsum("nm,nm->m", solved, Kxf)
        var = torch.diag(kff_diag + self.jitter - corr)
        return Gaussian(mean=mean, cov=mll_ops.add_diagonal(var, self.jitter))

    def multi_gene_predict(self, params: MultiSIMMParams, test_rows: torch.Tensor,
                           x: torch.Tensor, y: torch.Tensor,
                           variances: torch.Tensor) -> Gaussian:
        """Posterior over gene expression at ``test_rows`` (flag forced 1):
        per-point variances and the learned noise, the full covariance."""
        y = y.reshape(-1)
        variances = variances.reshape(-1)
        t2 = test_rows.clone()
        t2[:, 2] = 1
        mean_x = self.mean_function(params, x)
        mean_t = self.mean_function(params, t2)
        sigma = mll_ops.add_diagonal(self.gram(params, x), variances + params.obs_stddev**2)
        L = mll_ops.cholesky(sigma, self._chol_impl(x))
        Ktt = self.gram(params, t2)
        Kxt = self.cross_covariance(params, x, t2)
        solved = mll_ops.chol_solve(L, Kxt)
        mean = mean_t + solved.T @ (y - mean_x)
        cov = Ktt - Kxt.T @ solved
        return Gaussian(mean=mean, cov=mll_ops.add_diagonal(cov, self.jitter))
