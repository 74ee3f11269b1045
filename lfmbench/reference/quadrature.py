r"""Expression data drawn by quadrature, for a configuration whose N is beyond
an exact draw from the prior (``"data": "quadrature"``, ``"oversample": k``).

The force is drawn exactly from the RBF prior :math:`e^{-(s - s')^2 / l^2}`
of the closed forms on a uniform grid of :math:`K = k (T - 1) + 1` points
over :math:`[0, t_{max}]`, spacing :math:`h = t_{max} / (K - 1)`, so that
every observation time :math:`t_i = k i h` is a grid point; ``JITTER`` is
added to the grid covariance's diagonal before its factor. Gene j's
expression is its steady-state mean plus the force pushed through the
family's response :math:`g_j(\tau)` (``family.green``: the sensitivity times
the Green's function) from the closed forms' time origin, the ODE at rest
at its steady state at t = 0, by the trapezoid rule on the grid points in
:math:`[0, t_i]`:

.. math::
    x_j(t_i) = \mathrm{mean}_j + h \sum_{m=0}^{k i} w_{im}\, g_j(t_i - s_m) f(s_m),
    \qquad w_{i0} = w_{i,ki} = \tfrac12,\ \text{else } 1,

with :math:`x_j(0) = \mathrm{mean}_j`. Observation noise is added last. The
rule's error is :math:`O(h^2)`; with W the rule's matrix (``response``), the
data's covariance is :math:`W K_{ff} W^T`, which the closed forms give
exactly as h goes to 0.

At 100 genes x 1000 times with k = 4 this is one 3997-point factor and
~4e8 multiply-adds, where the exact draw's covariance alone is 80 GB.
"""

from __future__ import annotations

import torch

F64 = torch.float64
# The grid covariance is numerically singular (h is a small share of l). At
# 3997 points and l = 2.5 over [0, 12], with its entries off by ~3e-9 (one
# exp over the whole matrix on a CPU), float64's factor failed with 1e-8 on
# its unit diagonal, and with 1e-6 the draw moved by ~1e-3. ``force_cov``
# takes one exp per lag, the same matrix on every call, which factors
# with 1e-8 up to 7993 points. 1e-6 keeps a hundredfold margin: white force
# noise of std 1e-3 at each grid point, which the quadrature averages over
# ~l / h points, a variance of ~h * 1e-6 in the data against the observation
# noise's 1e-2.
JITTER = 1e-6
# Bytes of one block of the response matrix.
BLOCK_BYTES = 64 * 2**20


def grid(t_max: float, timepoints: int, oversample: int, device=None):
    """The force's grid (K,) and its spacing h."""
    K = oversample * (timepoints - 1) + 1
    h = t_max / (K - 1)
    return torch.arange(K, dtype=F64, device=device) * h, h


def _toeplitz(K: int, device=None):
    """|i - j| for the K x K grid."""
    i = torch.arange(K, device=device)
    return (i[:, None] - i[None, :]).abs()


def force_cov(s, ell):
    """The force's prior covariance on the uniform grid ``s``, without
    jitter: one exp per lag, so the matrix is Toeplitz and symmetric to the
    bit, and its factor sees the same matrix on every call."""
    return torch.exp(-((s - s[0]) / ell) ** 2)[_toeplitz(s.shape[0], s.device)]


def _gene_blocks(genes: int, timepoints: int, K: int):
    step = max(1, BLOCK_BYTES // (8 * timepoints * K))
    return [slice(a, min(a + step, genes)) for a in range(0, genes, step)]


def response(family, p, genes: slice, timepoints: int, oversample: int, h: float, device=None):
    """The trapezoid rule's weights times each gene's response: (g, T, K),
    row i of gene j holding h w_im g_j(t_i - s_m)."""
    K = oversample * (timepoints - 1) + 1
    lag = oversample * torch.arange(timepoints, device=device)[:, None] \
        - torch.arange(K, device=device)[None, :]  # k i - m, exact in integers
    w = torch.where(lag > 0, 1.0, 0.5) * (lag >= 0)
    w[:, 0] *= 0.5  # the rule's first point
    w[0] = 0.0  # t = 0: an empty integral
    pb = {k: v[genes, None] if v.ndim else v for k, v in p.items()}
    green = family.green(pb, torch.arange(K, dtype=F64, device=device) * h)  # (g, K) by lag
    return h * w.to(F64) * green[:, lag.clamp(min=0)]


def draw(family, p, inp, gen, t_max: float, oversample: int, noise_std: float):
    """The training rows' expression (gene-major, N,) at the parameters
    ``p`` (float64), its force and noise from ``gen`` in one call."""
    G, T = inp["genes"], inp["t"].shape[0]
    dev = inp["t"].device
    s, h = grid(t_max, T, oversample, dev)
    K, n = s.shape[0], G * T
    kff = force_cov(s, p["lengthscale"])
    kff.diagonal().add_(JITTER)
    z = torch.randn(K + n, generator=gen, dtype=F64, device=dev)
    f = torch.linalg.cholesky(kff) @ z[:K]
    del kff
    x = torch.empty(G, T, dtype=F64, device=dev)
    for genes in _gene_blocks(G, T, K):
        x[genes] = response(family, p, genes, T, oversample, h, dev) @ f
    return family.prior_mean(p, inp) + x.reshape(n) + noise_std * z[K:]

