r"""Multivariate-normal log-density with a factorisation-reusing backward.

Port of ``dis_project_tpu/ops/mll.py``. The forward pass computes one
Cholesky factor and two triangular solves; the backward reuses that factor
through the closed form

.. math::
    \partial \log p / \partial \mu   &= \alpha \\
    \partial \log p / \partial \Sigma &= \tfrac12(\alpha\alpha^\top - \Sigma^{-1}),
    \qquad \alpha = \Sigma^{-1}(y - \mu)

so autograd never runs through the factorisation; the gradient reaches the
kernel hyperparameters through the Gram build only.

``impl`` selects the O(N³) engine:

- ``'xla'`` — ``torch.linalg.cholesky_ex`` (cuSOLVER on the card) and
  triangular solves (the name stays the JAX package's);
- ``'blocked'`` — the blocked factorisers of ``ops.cuda_cholesky``: in
  float32 the transposed two-level ``blocked_cholesky_t``, whose 128-wide
  diagonal steps are K4 on the card; in float64 the left-looking
  ``blocked_cholesky``. The forward keeps the factor's diagonal-block
  inverses, and the backward builds ``tril(Σ⁻¹)`` from them
  (``tri_inv_from_diag``) without re-inverting the diagonal.

Cotangent forms (both kept, as in the JAX package):

- ``'xla'`` below ``_TRI_INV_MIN_N``: the dense symmetric form above, Σ⁻¹
  from ``chol_solve(L, I)``.
- ``'xla'`` in float64 from ``_TRI_INV_MIN_N``: the same dense symmetric
  form, Σ⁻¹ from ``cuda_cholesky.sigma_inv_panels`` (one block-column
  recurrence, 2N³/3 flops in large GEMMs, in one N x N buffer), with the
  cotangent assembled in that buffer. The JAX package emits the tril form
  below at these sizes; the two agree in their symmetric parts.
- ``'blocked'``, or float32 from ``_TRI_INV_MIN_N``: a symmetric-equivalent
  form built from ``T = tril(Σ⁻¹)`` only — ``dΣ = g/2 ααᵀ - g (T - diag(T)/2)``,
  whose symmetrisation is the textbook cotangent (Σ is a symmetric
  function of everything upstream, so only sym(dΣ) contributes). For
  float32 factors above N=2048 ``T`` comes through the SYRK kernel K3.

Non-PD Σ: both engines return a NaN factor instead of raising (no host
sync), so the trainer's finite guard sees a NaN loss as it does in JAX.
"""

from __future__ import annotations

import math

import torch

from dis_project_tpu_torch.ops import cuda_cholesky
from dis_project_tpu_torch.utils.profiling import annotate

LOG_2PI = math.log(2.0 * math.pi)

CHOL_IMPLS = ("xla", "blocked")

# Above this size Σ⁻¹ comes from a blocked route (the panel recurrence in
# float64, the triangular inverse + SYRK in float32) instead of a dense
# solve against the identity.
_TRI_INV_MIN_N = 2048


def resolve_chol_impl(n: int, dtype, device) -> str:
    """The O(N³) engine for ``'auto'``: ``'xla'`` at every size, dtype and
    device. The JAX package picks ``'blocked'`` for float32 N >= 2048 on
    its chip; the port takes that rule back on the card only once a run of
    ``chip_smoke.py`` shows the blocked dense10k step faster than the xla
    step by more than the step-to-step spread. Since K4's redesign the two
    steps are within that spread of each other on an H100 (PERF.md)."""
    return "xla"


def add_diagonal(mat, diag):
    """mat + diag(diag) — ``diag`` a scalar or (N,). Adds in place on a
    copy of ``mat`` (one N x N buffer, not two)."""
    out = mat.clone()
    out.diagonal().add_(diag)
    return out


def cholesky(sigma, impl: str = "xla"):
    """Lower Cholesky factor via the selected engine; NaN-filled when
    ``sigma`` is not PD."""
    with annotate("lfm.mll.factor"):
        if impl == "blocked":
            if sigma.dtype == torch.float32:
                return cuda_cholesky.blocked_cholesky_t(sigma).mT.contiguous()
            return cuda_cholesky.blocked_cholesky(sigma)
        return cuda_cholesky.cholesky_nan(sigma)


def _solve_tri(L, b, upper=False):
    """Triangular solve; ``b`` may be a vector."""
    vec = b.dim() == 1
    x = torch.linalg.solve_triangular(L, b[:, None] if vec else b, upper=upper)
    return x[:, 0] if vec else x


def chol_solve(L, b):
    """Solve Σ x = b given the lower Cholesky factor ``L`` of Σ."""
    with annotate("lfm.mll.solve"):
        z = _solve_tri(L, b)
        return _solve_tri(L.T, z, upper=True)


def _use_panel_inv(L, impl: str) -> bool:
    """The float64 ``'xla'`` Σ⁻¹ route from ``_TRI_INV_MIN_N`` (see module doc)."""
    return impl == "xla" and L.dtype == torch.float64 and L.shape[0] >= _TRI_INV_MIN_N


def _use_blocked_inv(L, impl: str) -> bool:
    """The tril Σ⁻¹ route of the backward pass (see module doc)."""
    return impl == "blocked" or L.shape[0] >= _TRI_INV_MIN_N


class _MvnLogpdfCentered(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y_centered, sigma, impl, kernels):
        n = y_centered.shape[0]
        dinvs = None
        transposed = impl == "blocked" and sigma.dtype == torch.float32
        if transposed:
            # The factor stays Lt = Lᵀ: solve against it directly and take
            # the logdet from its diagonal.
            with annotate("lfm.mll.factor"):
                factor, dinvs = cuda_cholesky.blocked_cholesky_t(
                    sigma, return_diag_inv=True, kernels=kernels)
            with annotate("lfm.mll.solve"):
                alpha = _solve_tri(factor, _solve_tri(factor.mT, y_centered), upper=True)
        else:
            if impl == "blocked":
                with annotate("lfm.mll.factor"):
                    factor, dinvs = cuda_cholesky.blocked_cholesky(sigma, return_diag_inv=True)
            else:
                factor = cholesky(sigma)
            alpha = chol_solve(factor, y_centered)
        logp = (
            -0.5 * torch.dot(y_centered, alpha)
            - torch.sum(torch.log(torch.diagonal(factor)))
            - 0.5 * n * LOG_2PI
        )
        ctx.save_for_backward(factor, alpha, dinvs)
        ctx.impl, ctx.kernels, ctx.transposed = impl, kernels, transposed
        return logp

    @staticmethod
    def backward(ctx, g):
        with annotate("lfm.mll.backward"):
            factor, alpha, dinvs = ctx.saved_tensors
            L = factor.mT if ctx.transposed else factor  # transpose back once
            n = L.shape[0]
            d_y = -g * alpha
            if _use_panel_inv(L, ctx.impl):
                with annotate("lfm.mll.sigma_inv"):
                    d_sigma = cuda_cholesky.sigma_inv_panels(L)
                # (0.5 g)(ααᵀ - Σ⁻¹) in Σ⁻¹'s buffer: no N x N temporary.
                d_sigma.addr_(alpha, alpha, beta=-1.0).mul_(0.5 * g)
            elif _use_blocked_inv(L, ctx.impl):
                with annotate("lfm.mll.sigma_inv"):
                    t = cuda_cholesky.inv_from_factor_tril(L, diag_inv=dinvs,
                                                           kernels=ctx.kernels)
                d_sigma = (0.5 * g) * torch.outer(alpha, alpha) - g * t
                d_sigma.diagonal().add_((0.5 * g) * torch.diagonal(t))
            else:
                with annotate("lfm.mll.sigma_inv"):
                    eye = torch.eye(n, dtype=L.dtype, device=L.device)
                    sigma_inv = chol_solve(L, eye)
                d_sigma = (0.5 * g) * (torch.outer(alpha, alpha) - sigma_inv)
            return d_y, d_sigma, None, None


def mvn_logpdf_centered(y_centered, sigma, impl: str = "xla", kernels: bool = True):
    """log N(y_centered | 0, sigma) for a 1-D centered observation vector.
    ``impl`` picks the engine; ``kernels`` lets the engine take K3/K4 on the
    card (``False``: the plain versions everywhere)."""
    if impl not in CHOL_IMPLS:
        raise ValueError(f"impl must be one of {CHOL_IMPLS}, not {impl!r}")
    return _MvnLogpdfCentered.apply(y_centered, sigma, impl, kernels)


def mvn_logpdf(y, mean, sigma, impl: str = "xla", kernels: bool = True):
    """log N(y | mean, sigma); gradients flow to all three arguments."""
    return mvn_logpdf_centered(y - mean, sigma, impl, kernels)
