r"""Second-order (spring-damper) LFM kernel family, elementwise in torch.

Port of ``dis_project_tpu/ops/lfm_kernels2.py``. Each output obeys a damped
driven oscillator (mass normalised to 1)

.. math:: \ddot x_j + 2\alpha_j \dot x_j + (\alpha_j^2 + \omega_j^2) x_j
          = B_j + S_j f(t)

with the Lawrence-convention RBF prior ``exp(-r^2/l^2)`` on f
(``lfm_kernels.k_ff_consistent``). With the decay rate :math:`\alpha_j > 0`
and the damped frequency :math:`\omega_j > 0` the system is always
underdamped and its Green's function is a signed pair of complex
exponentials,

.. math:: g_j(\tau) = e^{-\alpha_j \tau} \sin(\omega_j \tau)/\omega_j
        = \frac{e^{-p_j\tau} - e^{-q_j\tau}}{2i\,\omega_j},
        \qquad p_j = \alpha_j - i\omega_j,\; q_j = \alpha_j + i\omega_j,

so every covariance is the first-order closed form of ``ops.lfm_kernels``
at complex decay rates, its erf terms through ``ops.special.erf_complex``;
the imaginary parts cancel and the real part is taken.

Safe parameter region: the h-term multiplies ``exp(gamma^2)`` by erf
differences, and for complex ``gamma = d l / 2`` the intermediates grow like
``exp((omega l / 2)^2)``; keep ``omega * l < ~12`` in float64 (``< ~5`` in
float32).

:func:`gram_xx2_blocked_fast` is the uniform-grid table Gram of the dense
route; see its docstring for how its (G, T, G, T) sums are arranged.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from dis_project_tpu_torch.ops import lfm_kernels as lfk
from dis_project_tpu_torch.ops.gram import _check_uniform_grid
from dis_project_tpu_torch.ops.special import erf_complex


def _complex_rates(alpha, omega):
    p = alpha - 1j * omega
    q = alpha + 1j * omega
    return p, q


def k_xx2(t, t_prime, a_j, w_j, a_k, w_k, s_j, s_k, lengthscale):
    """Output-output covariance of the second-order LFM (broadcasts)."""
    p_j, q_j = _complex_rates(a_j, w_j)
    p_k, q_k = _complex_rates(a_k, w_k)
    acc = 0.0
    for d_a, sign_a in ((p_j, 1.0), (q_j, -1.0)):
        for d_b, sign_b in ((p_k, 1.0), (q_k, -1.0)):
            acc = acc + sign_a * sign_b * lfk.k_xx(
                t, t_prime, d_a, d_b, 1.0, 1.0, lengthscale, erf_fn=erf_complex
            )
    # (2i w_j)(2i w_k) = -4 w_j w_k
    return torch.real(acc) * s_j * s_k / (-4.0 * w_j * w_k)


def k_xf2(t_x, t_f, a_j, w_j, s_j, lengthscale):
    """Output-force cross-covariance of the second-order LFM (broadcasts)."""
    p_j, q_j = _complex_rates(a_j, w_j)
    ep = lfk.k_xf(t_x, t_f, p_j, 1.0, lengthscale, erf_fn=erf_complex)
    eq = lfk.k_xf(t_x, t_f, q_j, 1.0, lengthscale, erf_fn=erf_complex)
    # z / (2i) = Im(z) / 2 for the purely imaginary difference ep - eq
    return s_j * torch.imag(ep - eq) / (2.0 * w_j)


def k_ff2(t, t_prime, lengthscale):
    """Force prior: the Lawrence-consistent RBF (the convention every closed
    form here integrates)."""
    return lfk.k_ff_consistent(t, t_prime, lengthscale)


# ---------------------------------------------------------------------------
# Block builders (gene-major layout, as the first-order block builders).
# ---------------------------------------------------------------------------


def k_xx2_block(t1, t2, alpha, omega, sens, lengthscale):
    """(G*T1, G*T2) dense output-output covariance for all gene pairs."""
    G = alpha.shape[0]
    T1, T2 = t1.shape[0], t2.shape[0]
    K = k_xx2(
        t1[None, :, None, None], t2[None, None, None, :],
        alpha[:, None, None, None], omega[:, None, None, None],
        alpha[None, None, :, None], omega[None, None, :, None],
        sens[:, None, None, None], sens[None, None, :, None], lengthscale,
    )
    return K.reshape(G * T1, G * T2)


def k_xf2_block(t_x, t_f, alpha, omega, sens, lengthscale):
    """(G*T1, T2) dense output-force cross-covariance."""
    G = alpha.shape[0]
    T1, T2 = t_x.shape[0], t_f.shape[0]
    K = k_xf2(
        t_x[None, :, None], t_f[None, None, :],
        alpha[:, None, None], omega[:, None, None], sens[:, None, None], lengthscale,
    )
    return K.reshape(G * T1, T2)


def cross_covariance2(x1, x2, alpha, omega, sens, lengthscale):
    """Dense (N, M) covariance between (t, gene, flag) row sets, the
    second-order analogue of ``ops.gram.cross_covariance`` (flag 1 = output,
    flag 0 = latent force; genes clamped to [0, G-1])."""
    G = alpha.shape[0]
    t1, f1 = x1[:, 0], x1[:, 2]
    t2, f2 = x2[:, 0], x2[:, 2]
    g1 = torch.clamp(x1[:, 1].to(torch.int32), 0, G - 1).long()
    g2 = torch.clamp(x2[:, 1].to(torch.int32), 0, G - 1).long()

    T1, T2 = t1[:, None], t2[None, :]
    A1, A2 = alpha[g1][:, None], alpha[g2][None, :]
    W1, W2 = omega[g1][:, None], omega[g2][None, :]
    S1, S2 = sens[g1][:, None], sens[g2][None, :]
    F1, F2 = f1[:, None], f2[None, :]

    kxx = k_xx2(T1, T2, A1, W1, A2, W2, S1, S2, lengthscale)
    kff = k_ff2(T1, T2, lengthscale)
    kxf = k_xf2(T1, T2, A1, W1, S1, lengthscale)
    kfx = k_xf2(T2, T1, A2, W2, S2, lengthscale)

    return (
        F1 * F2 * kxx
        + (1.0 - F1) * (1.0 - F2) * kff
        + F1 * (1.0 - F2) * kxf
        + (1.0 - F1) * F2 * kfx
    )


def _split(z):
    """Real and imaginary parts along a new last axis."""
    return torch.stack([z.real, z.imag], dim=-1)


def gram_xx2_blocked_fast(timepoints, alpha, omega, sens, lengthscale):
    r"""Table-based (G*T, G*T) second-order output Gram on a UNIFORM grid.

    The order-2 closed form is the order-1 h-term algebra over the complex
    rate pair :math:`p_g = a_g - i w_g,\ q_g = a_g + i w_g`, so on a shared
    uniform grid every transcendental argument lives on a small index set,
    as in ``ops.gram.gram_xx_blocked_fast`` with 2G complex rates: the exp
    tables and ONE ``erf_complex`` call over the concatenated arguments of
    the four erf tables and ``erf(gamma)``. Matches :func:`k_xx2_block` to
    float tolerance; gene-major rows ``(g, t)``.

    The N^2 assembly. The JAX package writes it as broadcasts over
    (G, T, G, T), one complex term per (p/q, p/q) sign pair, which XLA
    fuses; eager PyTorch would materialise every temporary (one complex64
    (G, T, G, T) tensor is 800 MB at 50 x 200) and autograd would keep
    several per pair. Here the four sign pairs, the real part and the
    normalisation ``S_j S_k / (-4 w_j w_k)`` are first summed into small
    factors, so that the Gram is three real contractions:

    - the ``h(a, b; j)`` terms, ``sum_c U[a, b, j, c] V1[j, k, c]`` (batched
      over the row gene j), with ``U`` the (T, T, G, 4) real and imaginary
      parts of the h-table at both rates of a gene;
    - the ``h(b, a; k)`` terms, ``sum_c U[b, a, k, c] V2[j, k, c]``;
    - the separable terms, ``sum_d Z[j, a, k, d] Y[b, k, d]``, ``Z`` and
      ``Y`` (..., 8) real.

    Autograd keeps the small factors only. The sums are reassociated from
    the JAX package's order; the value moves by rounding.
    """
    t = timepoints
    _check_uniform_grid(t)
    T = t.shape[0]
    G = alpha.shape[0]
    l = lengthscale
    cdtype = torch.complex128 if t.dtype == torch.float64 else torch.complex64

    p, q = _complex_rates(alpha, omega)
    rates = torch.cat([p, q]).to(cdtype)  # (2G,): [p_1..p_G, q_1..q_G]
    g_c = (rates * l * 0.5).to(cdtype)  # complex gamma per rate

    dt = t[1] - t[0]
    deltas = (torch.arange(2 * T - 1, device=t.device) - (T - 1)).to(t.dtype) * dt

    # Tables over the 2G complex rates; the four erf tables in one call.
    E1 = torch.exp(-deltas[:, None].to(cdtype) * rates[None, :])  # (2T-1, 2G)
    erf_args = torch.cat([
        (deltas[:, None] / l - g_c[None, :]).reshape(-1),
        (t[:, None] / l + g_c[None, :]).reshape(-1),
        (t[:, None] / l - g_c[None, :]).reshape(-1),
        g_c,
    ])
    n1, n2 = (2 * T - 1) * 2 * G, T * 2 * G
    F1, F2, F3, F4 = torch.split(erf_complex(erf_args), [n1, n2, n2, 2 * G])
    F1, F2, F3 = F1.reshape(2 * T - 1, 2 * G), F2.reshape(T, 2 * G), F3.reshape(T, 2 * G)
    e_row = torch.exp(-t[:, None].to(cdtype) * rates[None, :])  # (T, 2G)
    expg2 = torch.exp(g_c * g_c)  # (2G,)

    ar = torch.arange(T, device=t.device)
    didx = ar[:, None] - ar[None, :] + (T - 1)
    # h1[a, b, r] = exp(-c_r (t_a - t_b)) (erf((t_a - t_b)/l - gamma_r) + F2[b, r])
    h1 = E1[didx] * (F1[didx] + F2[None, :, :])  # (T, T, 2G)
    r_row = e_row * (F3 + F4[None, :])  # (T, 2G)

    c = 0.5 * lfk.SQRT_PI * l
    sign = torch.tensor([1.0, -1.0], dtype=t.dtype, device=t.device)  # p -> +, q -> -
    rate2 = rates.reshape(2, G)  # [rate choice, gene]
    inv_sum = 1.0 / (rate2[:, None, :, None] + rate2[None, :, None, :])  # (ia, ib, j, k)
    ss = (sign[:, None] * sign[None, :]).to(cdtype)[:, :, None, None]
    eg = expg2.reshape(2, G)
    w1 = ss * c * inv_sum * eg[:, None, :, None]  # sa sb w1 per pair: (ia, ib, j, k)
    w2 = ss * c * inv_sum * eg[None, :, None, :]
    norm = (sens[:, None] * sens[None, :]) / (-4.0 * omega[:, None] * omega[None, :])

    # h-terms: Re(A h) = Re A Re h - Im A Im h, with A the pair weight
    # summed over the other gene's rate choice.
    a1 = w1.sum(dim=1)  # (ia, j, k)
    a2 = w2.sum(dim=0)  # (ib, j, k)
    u = _split(h1.reshape(T, T, 2, G)).permute(0, 1, 3, 2, 4).reshape(T, T, G, 4)

    def weights(a):  # (rate, j, k) complex -> (j, k, 4) real, U's (rate, re/im) order
        return torch.stack([a.real, -a.imag], dim=-1).permute(1, 2, 0, 3).reshape(G, G, 4) \
            * norm[:, :, None]

    v1, v2 = weights(a1), weights(a2)
    k_a = torch.einsum("abjc,jkc->jakb", u, v1)
    k_c = torch.einsum("bakc,jkc->jakb", u, v2)

    # Separable terms: -Re(sum_{c,d} X[a, j, c] M[j, k, c, d] Y[b, k, d]),
    # c, d over (term, rate choice): r_row e_row with w1, e_row r_row with w2.
    e2, r2 = e_row.reshape(T, 2, G), r_row.reshape(T, 2, G)
    x = torch.cat([r2, e2], dim=1).permute(2, 0, 1)  # (j, a, 4)
    y = torch.cat([e2, r2], dim=1).permute(2, 0, 1)  # (k, b, 4)
    zero = torch.zeros_like(w1)
    m = torch.cat([torch.cat([w1, zero], dim=1), torch.cat([zero, w2], dim=1)], dim=0)
    m = m.permute(2, 3, 0, 1) * (-norm).to(cdtype)[:, :, None, None]  # (j, k, 4, 4)
    z = torch.einsum("jac,jkcd->jakd", x, m)  # (G, T, G, 4) complex
    zr = torch.cat([z.real, -z.imag], dim=-1)
    yr = torch.cat([y.real, y.imag], dim=-1)
    k_bd = torch.einsum("jakd,kbd->jakb", zr, yr)

    return (k_a + k_c + k_bd).reshape(G * T, G * T)


def cross_covariance2_chunked(x1, x2, alpha, omega, sens, lengthscale, *, chunk: int = 1024):
    """Row-chunked, rematerialised :func:`cross_covariance2`: each chunk of
    ``chunk`` rows is built under ``torch.utils.checkpoint`` (the JAX
    package's ``jax.checkpoint`` under ``lax.map``), so the forward keeps
    only the (N, M) output and the backward recomputes each chunk's
    complex-erf intermediates (~20 (chunk, M) temporaries a chunk)."""
    n = x1.shape[0]
    blocks = [
        checkpoint(cross_covariance2, x1[i:i + chunk], x2, alpha, omega, sens, lengthscale,
                   use_reentrant=False)
        for i in range(0, n, chunk)
    ]
    return torch.cat(blocks, dim=0)
