r"""Multivariate-normal log-density with a factorisation-reusing backward.

Port of ``dis_project_tpu/ops/mll.py``. The forward pass computes one
Cholesky factor and two triangular solves; the backward reuses that factor
through the closed form

.. math::
    \partial \log p / \partial \mu   &= \alpha \\
    \partial \log p / \partial \Sigma &= \tfrac12(\alpha\alpha^\top - \Sigma^{-1}),
    \qquad \alpha = \Sigma^{-1}(y - \mu)

so autograd never runs through ``cholesky``/``solve_triangular``; the
gradient reaches the kernel hyperparameters through the Gram build only.

Cotangent forms (both kept, as in the JAX package):

- N < ``_TRI_INV_MIN_N``: the dense symmetric form above.
- N >= ``_TRI_INV_MIN_N``: a symmetric-equivalent form built from
  ``T = tril(Σ⁻¹)`` only — ``dΣ = g/2 ααᵀ - g (T - diag(T)/2)``, whose
  symmetrisation is the textbook cotangent (Σ is a symmetric function of
  everything upstream, so only sym(dΣ) contributes). For float32 factors
  on the card ``T`` comes from the SYRK kernel K3
  (``ops.cuda_cholesky``).

Non-PD Σ: ``torch.linalg.cholesky`` raises where ``jnp.linalg.cholesky``
returns NaN; :func:`cholesky` fills the factor with NaN instead (no host
sync), so the trainer's finite guard sees a NaN loss as it does in JAX.
"""

from __future__ import annotations

import math

import torch

from dis_project_tpu_torch.ops import cuda_cholesky

LOG_2PI = math.log(2.0 * math.pi)

_TRI_INV_MIN_N = 2048


def add_diagonal(mat, diag):
    """mat + diag(diag) — ``diag`` a scalar or (N,). Adds in place on a
    copy of ``mat`` (one N x N buffer, not two)."""
    out = mat.clone()
    out.diagonal().add_(diag)
    return out


def cholesky(sigma):
    """Lower Cholesky factor; NaN-filled when ``sigma`` is not PD."""
    L, info = torch.linalg.cholesky_ex(sigma)
    return L.masked_fill(info != 0, float("nan"))


def _solve_tri(L, b, upper=False):
    """Triangular solve; ``b`` may be a vector."""
    vec = b.dim() == 1
    x = torch.linalg.solve_triangular(L, b[:, None] if vec else b, upper=upper)
    return x[:, 0] if vec else x


def chol_solve(L, b):
    """Solve Σ x = b given the lower Cholesky factor ``L`` of Σ."""
    z = _solve_tri(L, b)
    return _solve_tri(L.T, z, upper=True)


class _MvnLogpdfCentered(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y_centered, sigma, kernels):
        L = cholesky(sigma)
        alpha = chol_solve(L, y_centered)
        n = y_centered.shape[0]
        logp = (
            -0.5 * torch.dot(y_centered, alpha)
            - torch.sum(torch.log(torch.diagonal(L)))
            - 0.5 * n * LOG_2PI
        )
        ctx.save_for_backward(L, alpha)
        ctx.kernels = kernels
        return logp

    @staticmethod
    def backward(ctx, g):
        L, alpha = ctx.saved_tensors
        n = L.shape[0]
        d_y = -g * alpha
        if n >= _TRI_INV_MIN_N:
            t = cuda_cholesky.inv_from_factor_tril(L, kernels=ctx.kernels)
            d_sigma = (0.5 * g) * torch.outer(alpha, alpha) - g * t
            d_sigma.diagonal().add_((0.5 * g) * torch.diagonal(t))
        else:
            eye = torch.eye(n, dtype=L.dtype, device=L.device)
            sigma_inv = chol_solve(L, eye)
            d_sigma = (0.5 * g) * (torch.outer(alpha, alpha) - sigma_inv)
        return d_y, d_sigma, None


def mvn_logpdf_centered(y_centered, sigma, kernels: bool = True):
    """log N(y_centered | 0, sigma) for a 1-D centered observation vector.
    ``kernels`` lets the backward take K3 on the card (see module doc)."""
    return _MvnLogpdfCentered.apply(y_centered, sigma, kernels)


def mvn_logpdf(y, mean, sigma, kernels: bool = True):
    """log N(y | mean, sigma); gradients flow to all three arguments."""
    return mvn_logpdf_centered(y - mean, sigma, kernels)
