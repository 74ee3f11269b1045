r"""Closed-form SIMM latent-force-model kernel family, elementwise in torch.

Port of ``dis_project_tpu/ops/lfm_kernels.py``. Target-gene mRNA x_j obeys
``dx_j/dt = B_j + S_j f(t) - D_j x_j(t)`` with an RBF GP prior on the latent
force f(t); the joint covariances integrate out as erf/exp expressions
(Lawrence, Sanguinetti & Rattray 2006).

Behavioral contract, kept from the reference:

- ``k_ff`` divides the squared distance by ``2*l`` — NOT ``2*l**2``
  (reference ``src/model.py:307-310``): a quirk to match, not a typo.
- ``k_xx`` is eq. 5, ``S_j S_k (sqrt(pi) l / 2) [h(k,j,t',t) + h(j,k,t,t')]``.
- ``k_xf`` is eq. 6.

``erf`` is ``torch.erf`` (the true erf) unless ``erf_fn=`` names another:
the second-order family (``ops.lfm_kernels2``) evaluates these same forms
at complex decay rates with ``ops.special.erf_complex``. The JAX package's
Pallas path used an Abramowitz & Stegun approximation only because erf does
not lower in Mosaic; the CUDA kernels of this port call CUDA's own
``erf``/``erff``. Every function broadcasts.
"""

from __future__ import annotations

import torch

SQRT_PI = 1.7724538509055159  # sqrt(pi), f64-exact to the ulp


def gamma(decay, lengthscale):
    """gamma_k = D_k * l / 2."""
    return decay * lengthscale * 0.5


def h_term(d_a, d_b, t1, t2, lengthscale, erf_fn=torch.erf):
    r"""The analytic double-integral term h(a, b, t1, t2), with
    :math:`\gamma_b = D_b l / 2`:

    .. math::
        h = \frac{e^{\gamma_b^2}}{D_a + D_b}\Big[
            e^{-D_b (t_2 - t_1)}\big(\mathrm{erf}(\tfrac{t_2-t_1}{l}-\gamma_b)
                + \mathrm{erf}(\tfrac{t_1}{l}+\gamma_b)\big)
          - e^{-(D_b t_2 + D_a t_1)}\big(\mathrm{erf}(\tfrac{t_2}{l}-\gamma_b)
                + \mathrm{erf}(\gamma_b)\big)\Big]
    """
    g_b = gamma(d_b, lengthscale)
    t_dist = t2 - t1
    mult = torch.exp(g_b * g_b) / (d_a + d_b)
    first = torch.exp(-d_b * t_dist) * (
        erf_fn(t_dist / lengthscale - g_b) + erf_fn(t1 / lengthscale + g_b)
    )
    second = torch.exp(-(d_b * t2 + d_a * t1)) * (
        erf_fn(t2 / lengthscale - g_b) + erf_fn(g_b)
    )
    return mult * (first - second)


def k_xx(t, t_prime, d_j, d_k, s_j, s_k, lengthscale, erf_fn=torch.erf):
    """Gene-gene covariance k_{x_j x_k}(t, t') — eq. 5."""
    mult = s_j * s_k * lengthscale * (0.5 * SQRT_PI)
    return mult * (
        h_term(d_k, d_j, t_prime, t, lengthscale, erf_fn)
        + h_term(d_j, d_k, t, t_prime, lengthscale, erf_fn)
    )


def k_xf(t_x, t_f, d_j, s_j, lengthscale, erf_fn=torch.erf):
    """Gene-force cross-covariance k_{x_j f}(t_x, t_f) — eq. 6."""
    g_j = gamma(d_j, lengthscale)
    t_dist = t_x - t_f
    first = (0.5 * SQRT_PI) * lengthscale * s_j
    return (
        first
        * torch.exp(g_j * g_j)
        * torch.exp(-d_j * t_dist)
        * (erf_fn(t_dist / lengthscale - g_j) + erf_fn(t_f / lengthscale + g_j))
    )


def k_ff(t, t_prime, lengthscale):
    """RBF prior over f(t) with the reference's ``2*l`` denominator."""
    sq = torch.square(t - t_prime)
    return torch.exp(-sq / (2.0 * lengthscale))


def k_ff_consistent(t, t_prime, lengthscale):
    """RBF force prior in the Lawrence convention, ``exp(-(t-t')^2 / l^2)``:
    the prior that the closed forms of ``k_xx``/``k_xf`` integrate (their erf
    arguments are t/l). The reference's ``k_ff`` above divides by ``2*l``
    instead; families that need a jointly consistent (f, x) covariance (the
    second-order family) use this one."""
    sq = torch.square(t - t_prime)
    return torch.exp(-sq / (lengthscale * lengthscale))


# ---------------------------------------------------------------------------
# Block builders — gene-major dense blocks on one shared time grid.
# ---------------------------------------------------------------------------


def k_xx_block(t1, t2, decay, sens, lengthscale):
    """Dense (G*T1, G*T2) gene-gene covariance, gene-major rows and cols."""
    G = decay.shape[0]
    T1, T2 = t1.shape[0], t2.shape[0]
    tt1 = t1[None, :, None, None]
    tt2 = t2[None, None, None, :]
    d_j = decay[:, None, None, None]
    d_k = decay[None, None, :, None]
    s_j = sens[:, None, None, None]
    s_k = sens[None, None, :, None]
    K = k_xx(tt1, tt2, d_j, d_k, s_j, s_k, lengthscale)
    return K.reshape(G * T1, G * T2)


def k_xf_block(t_x, t_f, decay, sens, lengthscale):
    """Dense (G*T1, T2) gene-force cross-covariance, gene-major rows."""
    G = decay.shape[0]
    T1, T2 = t_x.shape[0], t_f.shape[0]
    K = k_xf(
        t_x[None, :, None],
        t_f[None, None, :],
        decay[:, None, None],
        sens[:, None, None],
        lengthscale,
    )
    return K.reshape(G * T1, T2)


def k_ff_block(t1, t2, lengthscale):
    """Dense (T1, T2) latent-force prior covariance (reference convention)."""
    return k_ff(t1[:, None], t2[None, :], lengthscale)


def k_ff_consistent_block(t1, t2, lengthscale):
    """Dense (T1, T2) latent-force prior covariance (Lawrence convention)."""
    return k_ff_consistent(t1[:, None], t2[None, :], lengthscale)
