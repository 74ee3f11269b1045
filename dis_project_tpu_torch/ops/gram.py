"""Dense Gram / cross-covariance assembly from (t, gene, flag) row metadata —
the plain PyTorch closed forms.

Port of ``dis_project_tpu/ops/gram.py``. The reference dispatches a scalar
kernel per pair through flag-product switches; here the four branch values
are evaluated elementwise over the full (N, M) pair grid and combined with
the same multiplicative flag switches. These functions are also the plain
versions the CUDA kernels of :mod:`dis_project_tpu_torch.ops.cuda_gram` are
held against, and the route their backward differentiates.

Gather semantics: gene indices are clamped to [0, G-1] before the gather.
JAX gathers clamp on their own; torch indexing wraps ``-1`` to ``G-1`` and
raises on ``G``, so the clamp is explicit. Force rows carry gene ``-1``
(``utils.test_grids.latent_grid``), and the reference's 1-based expression
grids rely on the positive overflow clamping to ``G-1``.
"""

from __future__ import annotations

import numpy as np
import torch

from dis_project_tpu_torch.ops import lfm_kernels as lfk


def split_rows(x):
    """Split an (N, 3) row-metadata tensor into (t, gene_idx, flag)."""
    return x[:, 0], x[:, 1].to(torch.long), x[:, 2]


def _gather(param, g):
    return param[torch.clamp(g, 0, param.shape[0] - 1)]


def cross_covariance(x1, x2, decay, sens, lengthscale):
    """Dense (N, M) covariance between two sets of (t, gene, flag) rows,
    flag-weighted over all four branches (reference
    ``src/model.py:183-193, 372-394``)."""
    t1, g1, f1 = split_rows(x1)
    t2, g2, f2 = split_rows(x2)
    d1, s1 = _gather(decay, g1), _gather(sens, g1)
    d2, s2 = _gather(decay, g2), _gather(sens, g2)

    T1, T2 = t1[:, None], t2[None, :]
    D1, D2 = d1[:, None], d2[None, :]
    S1, S2 = s1[:, None], s2[None, :]
    F1, F2 = f1[:, None], f2[None, :]

    kxx = lfk.k_xx(T1, T2, D1, D2, S1, S2, lengthscale)
    kff = lfk.k_ff(T1, T2, lengthscale)
    kxf = lfk.k_xf(T1, T2, D1, S1, lengthscale)
    kfx = lfk.k_xf(T2, T1, D2, S2, lengthscale)

    w_xx = F1 * F2
    w_ff = (1.0 - F1) * (1.0 - F2)
    w_xf = F1 * (1.0 - F2)
    w_fx = (1.0 - F1) * F2

    return w_xx * kxx + w_ff * kff + w_xf * kxf + w_fx * kfx


def gram(x, decay, sens, lengthscale):
    """Symmetric (N, N) Gram matrix over one set of rows."""
    return cross_covariance(x, x, decay, sens, lengthscale)


def cross_covariance_kind(x1, x2, decay, sens, lengthscale, kind="mixed"):
    """Branch-specialised dense covariance.

    When the row population is known (``kind`` in ``{'xx','ff','xf','fx'}``)
    only that branch's closed form is evaluated; the flag columns are then
    static labels and carry no gradient. Identical values to
    :func:`cross_covariance` whenever the flags match the declared kind.
    """
    if kind == "mixed":
        return cross_covariance(x1, x2, decay, sens, lengthscale)
    t1, g1, _ = split_rows(x1)
    t2, g2, _ = split_rows(x2)
    T1, T2 = t1[:, None], t2[None, :]
    if kind == "ff":
        return lfk.k_ff(T1, T2, lengthscale)
    d1, s1 = _gather(decay, g1)[:, None], _gather(sens, g1)[:, None]
    d2, s2 = _gather(decay, g2)[None, :], _gather(sens, g2)[None, :]
    if kind == "xx":
        return lfk.k_xx(T1, T2, d1, d2, s1, s2, lengthscale)
    if kind == "xf":
        return lfk.k_xf(T1, T2, d1, s1, lengthscale)
    if kind == "fx":
        return lfk.k_xf(T2, T1, d2, s2, lengthscale)
    raise ValueError(f"unknown kind {kind!r}")


def is_uniform_grid(t) -> bool:
    """True when a time grid is uniformly spaced, to a tolerance that
    scales with its dtype (an f32 linspace is uniform only to ~|t|*eps per
    difference). The single spacing predicate shared by the table-Gram
    guard and the trainer's choice between the gridded and row paths."""
    t_host = t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    diffs = np.diff(t_host)
    if not diffs.size:
        return True
    if not np.issubdtype(t_host.dtype, np.inexact):
        return bool(np.all(diffs == diffs[0]))
    tol = 32 * np.finfo(t_host.dtype).eps * max(1.0, float(np.abs(t_host).max()))
    return bool(np.allclose(diffs, diffs[0], rtol=0.0, atol=tol))


def _check_uniform_grid(t):
    """Raise ``ValueError`` on an irregular grid (the table Gram indexes
    its delta table by row - col index difference)."""
    if not is_uniform_grid(t):
        raise ValueError(
            "the table Gram requires a UNIFORM time grid (its "
            "delta table is indexed by row-col index difference); got "
            "irregular spacing. Use ops.lfm_kernels.k_xx_block / "
            "ops.gram.gram for shared-but-irregular grids."
        )


def gram_xx_blocked_fast(timepoints, decay, sens, lengthscale):
    r"""Table-based (G*T, G*T) gene-gene Gram for a UNIFORM time grid.

    Every transcendental argument of the k_xx closed form lives on a small
    index set on a shared uniform grid — time differences take 2T-1
    values, the other erf/exp factors depend on (time, gene) or (gene,) —
    so the build needs O(T*G + T*G^2) transcendentals; the N^2 remainder
    is gathers and multiply-adds. Same layout and values as
    :func:`dis_project_tpu_torch.ops.lfm_kernels.k_xx_block`.
    """
    t = timepoints
    _check_uniform_grid(t)
    T = t.shape[0]
    G = decay.shape[0]
    l = lengthscale
    g = lfk.gamma(decay, l)  # (G,)

    dt = t[1] - t[0]
    ar = torch.arange(2 * T - 1, device=t.device)
    deltas = (ar - (T - 1)).to(t.dtype) * dt  # (2T-1,)

    # E1[d, j] = exp(-D_j delta_d)      F1[d, j] = erf(delta_d/l - g_j)
    # F2[b, j] = erf(t_b/l + g_j)       F3[a, j] = erf(t_a/l - g_j)
    # e_row[a, j] = exp(-D_j t_a)       F4[j]    = erf(g_j)
    E1 = torch.exp(-deltas[:, None] * decay[None, :])
    F1 = torch.erf(deltas[:, None] / l - g[None, :])
    F2 = torch.erf(t[:, None] / l + g[None, :])
    F3 = torch.erf(t[:, None] / l - g[None, :])
    F4 = torch.erf(g)
    e_row = torch.exp(-t[:, None] * decay[None, :])  # (T, G)

    iT = torch.arange(T, device=t.device)
    didx = iT[:, None] - iT[None, :] + (T - 1)  # (T, T)

    expg2 = torch.exp(g * g)  # (G,)
    inv_sum = 1.0 / (decay[:, None] + decay[None, :])  # (G, G)

    E1g = E1[didx]  # [a, b, gene]
    F1g = F1[didx]

    h1 = E1g * (F1g + F2[None, :, :])
    h2 = E1g.permute(1, 0, 2) * (F1g.permute(1, 0, 2) + F2[:, None, :])
    r_row = e_row * (F3 + F4[None, :])  # (T, G)

    c = 0.5 * lfk.SQRT_PI * l
    s_jk = sens[:, None] * sens[None, :] * c * inv_sum  # (G, G)
    w1 = s_jk * expg2[:, None]
    w2 = s_jk * expg2[None, :]

    # K4[j, a, k, b]; gene-major collapse matches k_xx_block's layout.
    K4 = w1[:, None, :, None] * (
        h1.permute(2, 0, 1)[:, :, None, :]
        - r_row.T[:, :, None, None] * e_row.T[None, None, :, :]
    ) + w2[:, None, :, None] * (
        h2.permute(0, 2, 1)[None, :, :, :]
        - e_row.T[:, :, None, None] * r_row.T[None, None, :, :]
    )
    return K4.reshape(G * T, G * T)


class _GramHybrid(torch.autograd.Function):
    """Table forward, row-algebra backward (see :func:`gram_xx_blocked_hybrid`)."""

    @staticmethod
    def forward(ctx, timepoints, decay, sens, lengthscale):
        ctx.save_for_backward(timepoints, decay, sens, lengthscale)
        return gram_xx_blocked_fast(timepoints, decay, sens, lengthscale)

    @staticmethod
    def backward(ctx, kbar):
        inputs = [a.detach().requires_grad_(need)
                  for a, need in zip(ctx.saved_tensors, ctx.needs_input_grad)]
        wanted = [a for a in inputs if a.requires_grad]
        if not wanted:
            return (None,) * 4
        with torch.enable_grad():
            out = lfk.k_xx_block(inputs[0], inputs[0], *inputs[1:])
            grads = iter(torch.autograd.grad(out, wanted, kbar, allow_unused=True))
        return tuple(next(grads) if a.requires_grad else None for a in inputs)


def gram_xx_blocked_hybrid(timepoints, decay, sens, lengthscale):
    """Table-Gram forward, row-algebra backward: the values of
    :func:`gram_xx_blocked_fast` bit for bit; the gradient is the VJP of
    the row closed form ``lfm_kernels.k_xx_block`` (elementwise algebra,
    no scatter into the delta tables). The JAX package measured it slower
    than differentiating the table on its chip and keeps it as library
    API; so does the port. The ``timepoints`` gradient follows the row
    algebra (the kernel's true derivative)."""
    return _GramHybrid.apply(timepoints, decay, sens, lengthscale)


def gram_xx_blocked(timepoints, decay, sens, lengthscale, replicates: int = 1):
    """Training-path Gram when every row is a gene-expression row on one
    shared grid: the (G*T, G*T) block ``k_xx_block``, tiled ``replicates``
    x ``replicates`` (k_xx does not depend on the replicate)."""
    block = lfk.k_xx_block(timepoints, timepoints, decay, sens, lengthscale)
    if replicates == 1:
        return block
    return block.repeat(replicates, replicates)
