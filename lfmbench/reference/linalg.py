"""The reference's dense linear algebra, in plain torch.

A right-looking blocked Cholesky whose trailing updates are matrix
products, triangular solves, the Gaussian log-density and its derivative
with respect to the covariance. The O(N^3) products take ``tf32``: full
precision for the reference (float64), or, for the control, float32
products of operands rounded to TF32's 10-bit mantissa, as the tensor
cores' TF32 mode takes them (the precision a later change could be
tempted to take for the factor's products). The rounding is explicit, so
the control computes the same on any device.
"""

from __future__ import annotations

import math

import torch

BLOCK = 256
LOG_2PI = math.log(2.0 * math.pi)


def control_precision(dtype: str):
    """``(dtype, tf32)`` of the control: the nearest precision below the
    configuration's ``dtype``: float32 for float64; for float32 (whose
    products the port keeps f32-faithful, TF32 off) TF32 products."""
    return torch.float32, dtype == "float32"


def to_tf32(x):
    """float32 ``x`` rounded (to nearest) to a 10-bit mantissa."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _operands(tf32: bool, *xs):
    return tuple(to_tf32(x) for x in xs) if tf32 else xs


def col_dots(a, b, tf32: bool = False):
    """The column-wise dot products of ``a`` and ``b``: diag(a^T b)."""
    a, b = _operands(tf32, a, b)
    return (a * b).sum(0)


def matvec_t(a, v, tf32: bool = False):
    """a^T v."""
    a, v = _operands(tf32, a, v)
    return a.mT @ v


def cholesky_(a, tf32: bool = False, block: int = BLOCK):
    """Lower Cholesky factor of the symmetric ``a``, overwriting ``a``'s
    lower triangle (its upper triangle is zeroed). NaN where a diagonal
    block is not positive definite."""
    n = a.shape[0]
    for k in range(0, n, block):
        e = min(k + block, n)
        l11, info = torch.linalg.cholesky_ex(a[k:e, k:e])
        l11 = l11.masked_fill(info != 0, float("nan"))
        a[k:e, k:e] = l11
        if e < n:
            # A21 L11^-T, then the trailing update A22 -= L21 L21^T.
            l21 = torch.linalg.solve_triangular(l11.mT, a[e:, k:e], upper=True, left=False)
            a[e:, k:e] = l21
            p, q = _operands(tf32, l21, l21.mT)
            a[e:, e:].addmm_(p, q, alpha=-1.0)
    return a.tril_()


def solve_lower(l, b):
    return torch.linalg.solve_triangular(l, b, upper=False)


def solve_upper_t(l, b):
    """L^-T b."""
    return torch.linalg.solve_triangular(l.mT, b, upper=True)


def chol_solve(l, b):
    """Sigma^-1 b from the lower factor of Sigma."""
    return solve_upper_t(l, solve_lower(l, b))


def logpdf_and_grad_(sigma, resid, tf32: bool = False):
    """``(log N(resid | 0, Sigma), dlogp/dSigma, alpha)`` with
    ``alpha = Sigma^-1 resid``; ``sigma`` is overwritten by its factor.
    ``dlogp/dSigma = (alpha alpha^T - Sigma^-1) / 2``, with
    ``Sigma^-1 = L^-T L^-1`` as one product."""
    n = sigma.shape[0]
    l = cholesky_(sigma, tf32)
    alpha = chol_solve(l, resid[:, None])[:, 0]
    logp = -0.5 * torch.dot(resid, alpha) - torch.log(torch.diagonal(l)).sum() - 0.5 * n * LOG_2PI
    eye = torch.eye(n, dtype=l.dtype, device=l.device)
    li = solve_lower(l, eye)
    del eye, l, sigma
    p, q = _operands(tf32, li.mT, li)
    dsigma = p @ q
    del li
    dsigma.mul_(-0.5).addr_(alpha, alpha, alpha=0.5)
    return logp, dsigma, alpha
