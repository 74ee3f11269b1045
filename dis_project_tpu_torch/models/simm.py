"""Exact SIMM latent force model — the flagship model family.

Port of ``dis_project_tpu/models/simm.py``. Parameters are a
:class:`SIMMParams` NamedTuple of tensors; :class:`ExactSIMM` holds only
static configuration, and every method is a pure function of
``(params, tensors)`` that runs on the device its tensors live on.

Kernel dispatch: with ``kernels=True`` (the default), ``gram`` goes through
``ops.cuda_gram.gram_sym`` (K2 on a CUDA tensor), ``cross_covariance``
through ``ops.cuda_gram.cross_covariance`` (K1), the float32 MLL backward
above N = 2048 through the SYRK kernel K3, and the ``'blocked'`` engine's
float32 diagonal steps through K4. There are no size thresholds on the
card for the Grams: the JAX package's ``PALLAS_GRAM_MIN_N``/``MAX_N`` were
measured on a TPU. ``kernels=False`` takes the plain PyTorch versions on
any device — the reference the kernels are held against on the card.

``chol_impl``: ``'auto' | 'xla' | 'blocked'``, the O(N³) engine of the
MLL (``ops.mll``). ``'auto'`` resolves through
``ops.mll.resolve_chol_impl``, which is ``'xla'`` in the port.

Behavioral parity notes (each deliberate, from the reference):

- The conjugate MLL adds ``jitter`` and ``obs_stddev**2`` to the Gram but
  NOT the fixed per-point measurement variances, while both predict paths
  DO add them (``src/objectives.py:70-73`` vs ``src/model.py:446-449,
  489-499``).
- ``latent_predict`` diagonalises its posterior covariance and adds jitter
  twice, and does NOT add learned observation noise.
- ``multi_gene_predict`` forces the flag column of the test rows to 1 and
  keeps the full covariance.
- ``mean_function`` defaults to index-based B_g/D_g; ``legacy_block_mean``
  reproduces the reference's block-repeat indexing (a parity oracle).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from dis_project_tpu_torch.models.base import Gaussian
from dis_project_tpu_torch.ops import bijectors as bij
from dis_project_tpu_torch.ops import cuda_gram
from dis_project_tpu_torch.ops import gram as gram_ops
from dis_project_tpu_torch.ops import mll as mll_ops
from dis_project_tpu_torch.ops.precision import PARITY_DTYPE


class SIMMParams(NamedTuple):
    """Trainable kinetic and GP hyperparameters (constrained space):
    basal, sensitivity, decay (G,); lengthscale (); obs_stddev ()."""

    basal: torch.Tensor
    sensitivity: torch.Tensor
    decay: torch.Tensor
    lengthscale: torch.Tensor
    obs_stddev: torch.Tensor


SIMM_BIJECTORS = SIMMParams(
    basal=bij.Softplus(),
    sensitivity=bij.Softplus(),
    decay=bij.Softplus(),
    lengthscale=bij.SigmoidBounded(0.5, 3.5),
    obs_stddev=bij.Softplus(),
)


def init_params(num_genes: int, dtype=PARITY_DTYPE, device="cpu",
                shared_kinetics: bool = False) -> SIMMParams:
    """Reference inits: B=0.05, S=1.0, D=0.4, l=2.5, obs_stddev=1.0."""
    g = 1 if shared_kinetics else num_genes
    kw = dict(dtype=dtype, device=device)
    return SIMMParams(
        basal=torch.full((g,), 0.05, **kw),
        sensitivity=torch.full((g,), 1.0, **kw),
        decay=torch.full((g,), 0.4, **kw),
        lengthscale=torch.tensor(2.5, **kw),
        obs_stddev=torch.tensor(1.0, **kw),
    )


def constrain(raw: SIMMParams) -> SIMMParams:
    return bij.constrain(raw, SIMM_BIJECTORS)


def unconstrain(params: SIMMParams) -> SIMMParams:
    return bij.unconstrain(params, SIMM_BIJECTORS)


@dataclasses.dataclass(frozen=True)
class ExactSIMM:
    """Static configuration + pure methods for the exact SIMM LFM.

    ``canonical_rows``: promise that training rows are all gene-expression
    and latent grids all force rows, letting the Gram builds specialise
    their branch ``kind`` instead of evaluating all four flag branches.
    """

    num_genes: int = 5
    jitter: float = 1e-6
    legacy_block_mean: bool = False
    canonical_rows: bool = False
    shared_kinetics: bool = False
    kernels: bool = True
    chol_impl: str = "auto"

    def _resolve_chol(self, n: int, dtype, device) -> str:
        if self.chol_impl != "auto":
            return self.chol_impl
        return mll_ops.resolve_chol_impl(n, dtype, device)

    def _kind(self, default: str) -> str:
        return default if self.canonical_rows else "mixed"

    def _expand(self, params: SIMMParams) -> SIMMParams:
        """Broadcast shared (1,) kinetics to per-gene (G,) for the gathers."""
        if not self.shared_kinetics:
            return params
        G = self.num_genes
        return params._replace(
            basal=params.basal.expand(G),
            sensitivity=params.sensitivity.expand(G),
            decay=params.decay.expand(G),
        )

    # -- model pieces -----------------------------------------------------

    def mean_function(self, params: SIMMParams, x: torch.Tensor) -> torch.Tensor:
        """SIMM mean: B_j / D_j on expression rows, 0 on force rows."""
        params = self._expand(params)
        ratio = params.basal / params.decay  # (G,)
        flags = x[:, 2]
        if self.legacy_block_mean:
            # Reference block-repeat (src/model.py:143-149): each B_g/D_g over
            # N//G contiguous rows regardless of the gene column.
            block = x.shape[0] // self.num_genes
            mean = ratio.repeat_interleave(block)
            mean = torch.cat([mean, mean.new_zeros(x.shape[0] - mean.shape[0])])
        else:
            g = torch.clamp(x[:, 1].to(torch.long), 0, self.num_genes - 1)
            mean = ratio[g]
        return mean * flags

    def gram(self, params: SIMMParams, x: torch.Tensor, kind: str = "mixed") -> torch.Tensor:
        """Square Gram over one row set (K2 on the card)."""
        p = self._expand(params)
        if self.kernels:
            return cuda_gram.gram_sym(x, p.decay, p.sensitivity, p.lengthscale, kind)
        return gram_ops.cross_covariance_kind(
            x, x, p.decay, p.sensitivity, p.lengthscale, kind
        )

    def cross_covariance(
        self, params: SIMMParams, x1: torch.Tensor, x2: torch.Tensor, kind: str = "mixed"
    ) -> torch.Tensor:
        """Rectangular covariance between two row sets (K1 on the card)."""
        p = self._expand(params)
        if self.kernels:
            return cuda_gram.cross_covariance(
                x1, x2, p.decay, p.sensitivity, p.lengthscale, kind
            )
        return gram_ops.cross_covariance_kind(
            x1, x2, p.decay, p.sensitivity, p.lengthscale, kind
        )

    # -- objective ---------------------------------------------------------

    def mll(self, params: SIMMParams, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """Exact conjugate marginal log-likelihood with
        Sigma = Kxx + jitter*I + obs_stddev^2*I (per-point measurement
        variances deliberately excluded, reference src/objectives.py:70-73)."""
        y = y.reshape(-1)
        mx = self.mean_function(params, x)
        K = self.gram(params, x, self._kind("xx"))
        sigma = mll_ops.add_diagonal(K, self.jitter + params.obs_stddev**2)
        impl = self._resolve_chol(x.shape[0], x.dtype, x.device)
        return mll_ops.mvn_logpdf(y, mx, sigma, impl=impl, kernels=self.kernels)

    def mll_iterative(
        self,
        params: SIMMParams,
        x: torch.Tensor,
        y: torch.Tensor,
        probes: torch.Tensor,
        lanczos_iters: int = 32,
        cg_iters: int = 256,
        stats=None,
    ) -> torch.Tensor:
        """Matmul-only MLL via batched CG and stochastic Lanczos quadrature
        (``ops.iterative``), same Sigma convention as :meth:`mll`; the value
        is a randomised estimate, the gradient unbiased. ``probes``: (P, N)
        ±1 (``iterative.rademacher``). On a CUDA float32 input the Gram and
        its gradient are K2 and K2's backward kernel."""
        from dis_project_tpu_torch.ops import iterative

        y = y.reshape(-1)
        mx = self.mean_function(params, x)
        K = self.gram(params, x, self._kind("xx"))
        sigma = mll_ops.add_diagonal(K, self.jitter + params.obs_stddev**2)
        return iterative.mvn_logpdf_cg(y - mx, sigma, probes, lanczos_iters, cg_iters, stats)

    def mll_gridded(
        self,
        params: SIMMParams,
        timepoints: torch.Tensor,
        y: torch.Tensor,
        replicates: int = 1,
    ) -> torch.Tensor:
        """Exact conjugate MLL for canonical GRIDDED data (gene-major
        blocks of one shared time grid, optionally replicate-tiled — the
        layout ``dataset_3d`` produces). Uses the table-based Gram
        (``ops.gram.gram_xx_blocked_fast``): O(T G^2) transcendentals
        instead of O((GT)^2). Same Sigma convention as :meth:`mll`.
        """
        params = self._expand(params)
        y = y.reshape(-1)
        T = timepoints.shape[0]
        K = gram_ops.gram_xx_blocked_fast(
            timepoints, params.decay, params.sensitivity, params.lengthscale
        )
        if replicates > 1:
            K = K.repeat(replicates, replicates)
        mean = (params.basal / params.decay).repeat_interleave(T).repeat(replicates)
        sigma = mll_ops.add_diagonal(K, self.jitter + params.obs_stddev**2)
        impl = self._resolve_chol(y.shape[0], y.dtype, y.device)
        return mll_ops.mvn_logpdf(y, mean, sigma, impl=impl, kernels=self.kernels)

    def mll_replicated(
        self,
        params: SIMMParams,
        timepoints: torch.Tensor,
        y: torch.Tensor,
        replicates: int,
    ) -> torch.Tensor:
        r"""Exact conjugate MLL for R replicates of gene-major grid blocks,
        R^3-fold cheaper.

        The covariance over replicate-tiled rows is exactly
        :math:`\Sigma = J_R \otimes B + c I` (the kernel ignores the
        replicate index). Diagonalising the all-ones :math:`J_R`
        block-diagonalises it into one dense system :math:`R B + cI` for the
        scaled replicate mean plus :math:`(R-1)` pure-noise copies whose
        likelihood needs only :math:`\sum_r \lVert y_r - \mu \rVert^2`.
        """
        params = self._expand(params)
        T = timepoints.shape[0]
        n_block = self.num_genes * T
        R = replicates
        Y = y.reshape(R, n_block)
        c = self.jitter + params.obs_stddev**2

        B = gram_ops.gram_xx_blocked_fast(
            timepoints, params.decay, params.sensitivity, params.lengthscale
        )
        mu = (params.basal / params.decay).repeat_interleave(T)

        ybar = torch.mean(Y, dim=0)
        sigma1 = mll_ops.add_diagonal(R * B, c)
        w = torch.sqrt(torch.tensor(float(R), dtype=y.dtype, device=y.device)) * (ybar - mu)
        impl = self._resolve_chol(n_block, y.dtype, y.device)
        logp_dense = mll_ops.mvn_logpdf(w, torch.zeros_like(w), sigma1, impl=impl,
                                        kernels=self.kernels)

        resid = Y - mu[None, :]
        ss_total = torch.sum(resid * resid)
        ss_mean = R * torch.sum((ybar - mu) ** 2)
        ss_perp = ss_total - ss_mean
        n_perp = (R - 1) * n_block
        logp_perp = -0.5 * (
            ss_perp / c + n_perp * torch.log(c) + n_perp * mll_ops.LOG_2PI
        )
        return logp_dense + logp_perp

    # -- posteriors ---------------------------------------------------------

    def latent_predict(
        self,
        params: SIMMParams,
        test_rows: torch.Tensor,
        x: torch.Tensor,
        y: torch.Tensor,
        variances: torch.Tensor,
    ) -> Gaussian:
        """Posterior over the latent force f at ``test_rows`` (flag 0).

        Reference ``src/model.py:420-463``: the train covariance uses the
        fixed per-point variances + jitter (no learned noise); the posterior
        variance is diagonalised and re-jittered. Solves use the Cholesky
        factor; only diag(Kff) and the correction diagonal are formed.
        """
        y = y.reshape(-1)
        variances = variances.reshape(-1)

        mean_x = self.mean_function(params, x)
        mean_t = self.mean_function(params, test_rows)

        Kxx = self.gram(params, x, self._kind("xx"))
        Kxx = mll_ops.add_diagonal(Kxx, variances + self.jitter)
        L = mll_ops.cholesky(Kxx, self._resolve_chol(x.shape[0], x.dtype, x.device))

        Kxf = self.cross_covariance(params, x, test_rows, self._kind("xf"))  # (N, M)
        solved = mll_ops.chol_solve(L, Kxf)  # (N, M)
        mean = mean_t + solved.T @ (y - mean_x)

        kff_diag = torch.diagonal(self.gram(params, test_rows, self._kind("ff")))
        corr = torch.einsum("nm,nm->m", solved, Kxf)
        var = torch.diag(kff_diag + self.jitter - corr)
        var = mll_ops.add_diagonal(var, self.jitter)
        return Gaussian(mean=mean, cov=var)

    def multi_gene_predict(
        self,
        params: SIMMParams,
        test_rows: torch.Tensor,
        x: torch.Tensor,
        y: torch.Tensor,
        variances: torch.Tensor,
    ) -> Gaussian:
        """Posterior over gene expression at ``test_rows`` (flag forced 1).

        Reference ``src/model.py:465-514``: Sigma adds the per-point
        variances AND the learned noise; the full covariance is kept.
        """
        y = y.reshape(-1)
        variances = variances.reshape(-1)
        t2 = test_rows.clone()
        t2[:, 2] = 1

        mean_x = self.mean_function(params, x)
        mean_t = self.mean_function(params, t2)

        Kxx = self.gram(params, x, self._kind("xx"))
        sigma = mll_ops.add_diagonal(Kxx, variances + params.obs_stddev**2)
        L = mll_ops.cholesky(sigma, self._resolve_chol(x.shape[0], x.dtype, x.device))

        Ktt = self.gram(params, t2, self._kind("xx"))
        Kxt = self.cross_covariance(params, x, t2, self._kind("xx"))
        solved = mll_ops.chol_solve(L, Kxt)

        mean = mean_t + solved.T @ (y - mean_x)
        cov = Ktt - Kxt.T @ solved
        cov = mll_ops.add_diagonal(cov, self.jitter)
        return Gaussian(mean=mean, cov=cov)


def clamp_params(
    params: SIMMParams,
    gene_index: int = 3,
    sensitivity: float = 1.0,
    decay: float = 0.8,
) -> SIMMParams:
    """Identifiability clamp: fix one gene's S and D (reference p21 clamp,
    ``src/trainer.py:151-158``; index 3 = p21 in the canonical order).

    Applied to whatever space ``params`` is in — raw during training,
    constrained after, as the reference does. Raises when ``gene_index``
    is out of bounds (shared-kinetics (1,) params or a small gene subset)
    so the clamp can never silently not apply.
    """
    if gene_index >= params.sensitivity.shape[0]:
        raise ValueError(
            f"clamp_params: gene_index {gene_index} is out of bounds for "
            f"{params.sensitivity.shape[0]} gene parameter(s) (shared "
            "kinetics or a small gene subset?) — pass the in-subset index "
            "or disable fix_params."
        )
    s = params.sensitivity.clone()
    d = params.decay.clone()
    s[gene_index] = sensitivity
    d[gene_index] = decay
    return params._replace(sensitivity=s, decay=d)
