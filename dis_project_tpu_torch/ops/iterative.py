r"""Iterative (matmul-only) exact-GP inference: batched CG and stochastic
Lanczos quadrature, GPyTorch's BBMM pattern (Gardner et al. 2018).

Port of ``dis_project_tpu/ops/iterative.py``. Every step is a product with
Sigma and small vector work, so the cost per training step is a few dozen
reads of Sigma instead of an O(N^3) factorisation.

- :func:`batched_cg` — conjugate gradients on (N, R) right-hand sides, the
  columns' recurrences vectorised; the loop ends when every column's
  residual is small or at ``max_iters``. The stopping test reads the
  residual norms on the host each iteration, so the iteration count is
  the JAX ``while_loop``'s.
- :func:`lanczos` — m-step Lanczos with full reorthogonalisation, batched
  over probe vectors (the JAX module ``vmap``\ s one start vector).
- :func:`slq_logdet` — stochastic Lanczos quadrature estimate of
  ``log det Sigma`` from given Rademacher probes.
- :func:`mvn_logpdf_cg` — the MLL as an autograd function: one batched
  solve against ``[y - mu, Z]`` serves the quadratic term, the logdet
  probes and the backward, ``d Sigma = g/2 (alpha alpha^T - sym(E[Sigma^-1
  z z^T]))``; the residuals are O(N P), the N x N estimate exists only in
  the backward.

The logdet (hence the value) is a randomised estimate; the gradient
estimator is unbiased. The probes are an argument: callers draw them from
a ``torch.Generator`` on the CPU, so one seed gives the same probes on
every device.

Float32 products here must be full FP32: with reduced-precision products
the JAX package measured an SLQ logdet of -4722 (it must be >= 0) at
N = 1e4. Every entry point asserts that TF32 is off.
"""

from __future__ import annotations

import time
from typing import Optional

import torch

from dis_project_tpu_torch.ops.precision import assert_full_fp32

LOG_2PI = 1.8378770664093453


def batched_cg(sigma, b, *, tol: Optional[float] = None, max_iters: int = 256,
               stats: Optional[dict] = None):
    """Solve ``sigma @ X = b`` for SPD ``sigma`` and ``b`` of shape (N, R).

    Iterates while any column's residual norm exceeds
    ``tol * max(||b_col||, 1e-30)`` and fewer than ``max_iters`` iterations
    ran; ``tol=None`` is ``100 * eps`` of the dtype (2.2e-14 in f64, ~1.2e-5
    in f32). Returns ``(X, iterations)``. ``stats``, when given, receives
    the iteration count, the number of converged columns and the loop's
    host seconds.
    """
    assert_full_fp32("ops.iterative")
    if tol is None:
        tol = 100 * float(torch.finfo(b.dtype).eps)
    thresh = tol * torch.clamp(torch.linalg.vector_norm(b, dim=0), min=1e-30)
    x = torch.zeros_like(b)
    r = b.clone()
    p = b.clone()
    rs = torch.sum(r * r, dim=0)
    it = 0
    t0 = time.perf_counter()
    while it < max_iters and bool(torch.any(torch.linalg.vector_norm(r, dim=0) > thresh)):
        ap = sigma @ p
        denom = torch.sum(p * ap, dim=0)
        alpha = rs / torch.where(denom > 0, denom, torch.ones_like(denom))
        x = x + alpha[None, :] * p
        r = r - alpha[None, :] * ap
        rs_new = torch.sum(r * r, dim=0)
        beta = rs_new / torch.where(rs > 0, rs, torch.ones_like(rs))
        p = r + beta[None, :] * p
        rs = rs_new
        it += 1
    if stats is not None:
        stats["cg_iters"] = it
        stats["cg_host_s"] = time.perf_counter() - t0
        stats["columns"] = b.shape[1]
        stats["converged"] = int(torch.sum(torch.linalg.vector_norm(r, dim=0) <= thresh))
    return x, it


def lanczos(sigma, v0, m: int):
    """m-step Lanczos with full reorthogonalisation for the P start vectors
    in the columns of ``v0`` (N, P); each need not be normalised.

    Returns ``(alphas, betas)``, (P, m) and (P, m - 1): the tridiagonals
    T_m, one per probe.
    """
    assert_full_fp32("ops.iterative")
    n, n_probes = v0.shape
    V = v0.new_zeros((m, n, n_probes))
    V[0] = v0 / torch.linalg.vector_norm(v0, dim=0)
    alphas = v0.new_zeros((m, n_probes))
    betas = v0.new_zeros((m, n_probes))  # betas[j] links rows j and j + 1
    for j in range(m):
        v = V[j]
        w = sigma @ v
        a = torch.sum(v * w, dim=0)
        w = w - a * v
        if j > 0:
            w = w - betas[j - 1] * V[j - 1]
        # Full reorthogonalisation against the rows filled so far.
        filled = V[: j + 1]
        proj = torch.einsum("knp,np->kp", filled, w)
        w = w - torch.einsum("knp,kp->np", filled, proj)
        b = torch.linalg.vector_norm(w, dim=0)
        if j + 1 < m:
            V[j + 1] = torch.where(b > 1e-30, w / b, torch.zeros_like(w))
        alphas[j] = a
        betas[j] = b
    return alphas.T, betas[: m - 1].T


def _tridiag_logquad(alphas, betas):
    """``e1^T log(T_m) e1`` for each of a batch of tridiagonals, from a
    batched eigendecomposition; eigenvalues clamped at 1e-30."""
    T = torch.diag_embed(alphas) + torch.diag_embed(betas, 1) + torch.diag_embed(betas, -1)
    evals, evecs = torch.linalg.eigh(T)
    evals = torch.clamp(evals, min=1e-30)
    w = evecs[:, 0, :] ** 2
    return torch.sum(w * torch.log(evals), dim=-1)


def slq_logdet(sigma, probes, m: int = 32):
    """Stochastic Lanczos quadrature estimate of ``log det sigma`` from the
    (P, N) ±1 ``probes``: each contributes ``N e1^T log(T_m) e1``."""
    n = probes.shape[1]
    a, b = lanczos(sigma, probes.T, m)
    return n * torch.mean(_tridiag_logquad(a, b))


def rademacher(generator: torch.Generator, n_probes: int, n: int, dtype, device):
    """(n_probes, n) ±1 probes drawn on the CPU from ``generator``, then
    moved to ``device``: the same probes from one seed on every device."""
    z = torch.randint(0, 2, (n_probes, n), generator=generator, dtype=torch.int64)
    return (2 * z - 1).to(dtype).to(device)


class _MvnLogpdfCG(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y_centered, sigma, probes, lanczos_iters, cg_iters, stats):
        n = y_centered.shape[0]
        logdet = slq_logdet(sigma, probes, lanczos_iters)
        # One batched solve serves the quadratic term (column 0) and the
        # probes (the rest).
        rhs = torch.cat([y_centered[:, None], probes.T], dim=1)
        sols, _ = batched_cg(sigma, rhs, max_iters=cg_iters, stats=stats)
        alpha = sols[:, 0].contiguous()
        zsols = sols[:, 1:].contiguous()  # Sigma^-1 z_i
        ctx.save_for_backward(alpha, probes, zsols)
        return -0.5 * torch.dot(y_centered, alpha) - 0.5 * logdet - 0.5 * n * LOG_2PI

    @staticmethod
    def backward(ctx, g):
        alpha, z, zsols = ctx.saved_tensors
        gf = float(g)
        # Hutchinson: E[Sigma^-1 z z^T] = Sigma^-1; the estimate symmetrised.
        # Two N x N buffers: the estimate, then d_sigma built in place.
        est = zsols @ z
        d_sigma = est + est.T
        del est
        d_sigma.mul_(-0.25 * gf / z.shape[0])
        d_sigma.addr_(alpha, alpha, alpha=0.5 * gf)
        return -gf * alpha, d_sigma, None, None, None, None


def mvn_logpdf_cg(y_centered, sigma, probes, lanczos_iters: int = 32, cg_iters: int = 256,
                  stats: Optional[dict] = None):
    """Stochastic-but-unbiased MVN log-density, matmul-only (BBMM).

    ``probes``: (P, N) ±1 tensor (:func:`rademacher`). Differentiable in
    ``y_centered`` and ``sigma``; the backward saves alpha, the probes and
    their solves (O(N P)). ``stats`` as in :func:`batched_cg`.
    """
    return _MvnLogpdfCG.apply(y_centered, sigma, probes, lanczos_iters, cg_iters, stats)
