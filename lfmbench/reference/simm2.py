r"""The second-order (spring-damper) SIMM (Alvarez, Luengo & Lawrence 2009),
in plain torch.

Output j obeys :math:`\ddot x_j + 2\alpha_j \dot x_j + (\alpha_j^2 + \omega_j^2)
x_j = B_j + S_j f(t)` under the RBF prior :math:`e^{-(t - t')^2 / l^2}` on f.
Its Green's function :math:`e^{-\alpha\tau}\sin(\omega\tau)/\omega` is the
signed pair :math:`(e^{-p\tau} - e^{-q\tau}) / 2i\omega` with
:math:`p = \alpha - i\omega,\ q = \alpha + i\omega`, so the covariance is
the first-order closed form at complex rates,

.. math::
    k_{jk}(t, t') = \frac{S_j S_k}{-4\omega_j\omega_k}\,\mathrm{Re}
      \sum_{a \in \{p_j, q_j\}} \sum_{b \in \{p_k, q_k\}} s_a s_b\, k^{(1)}_{ab}(t, t'),

.. math::
    k^{(1)}_{ab}(t, t') = \frac{\sqrt\pi\,l}{2(a + b)}\Big(
      e^{\gamma_a^2}[P_a(t, t') - Q_a(t) e^{-b t'}]
      + e^{\gamma_b^2}[P_b(t', t) - Q_b(t') e^{-a t}]\Big),

with :math:`s_p = 1, s_q = -1`, :math:`\gamma_r = r l / 2`,
:math:`P_r(t, t') = e^{-r (t - t')}(\mathrm{erf}(\tfrac{t - t'}{l} - \gamma_r)
+ \mathrm{erf}(\tfrac{t'}{l} + \gamma_r))` and
:math:`Q_r(t) = e^{-r t}(\mathrm{erf}(\tfrac{t}{l} - \gamma_r) + \mathrm{erf}(\gamma_r))`.
The mean is :math:`B_j / (\alpha_j^2 + \omega_j^2)`. Rows are gene-major on
one time grid; P is evaluated on every pair of grid times, so nothing
assumes the grid is uniform. The erf of a complex argument is
``reference.erf``.
"""

from __future__ import annotations

import math

import torch

from lfmbench.reference.erf import erf

LEAVES = ("basal", "sensitivity", "alpha", "omega", "lengthscale", "obs_stddev")
BIJECTORS = {"basal": ("softplus",), "sensitivity": ("softplus",), "alpha": ("softplus",),
             "omega": ("softplus",), "lengthscale": ("sigmoid", 0.5, 3.5),
             "obs_stddev": ("softplus",)}
PER_GENE = ("basal", "sensitivity", "alpha", "omega")


def tables(p, t):
    """Everything a row gene's block is built from: the rates (2, G) (p
    then q), exp(gamma^2) (2, G), P (2, G, T, T), Q and exp(-r t) (2, G, T),
    the sensitivities and frequencies (G,), and the lengthscale."""
    cdt = torch.complex128 if t.dtype == torch.float64 else torch.complex64
    alpha, omega, ell = p["alpha"], p["omega"], p["lengthscale"]
    r = torch.stack([alpha - 1j * omega, alpha + 1j * omega]).to(cdt)  # (2, G)
    gam = 0.5 * ell * r
    tc = t.to(cdt)
    lag = (tc[:, None] - tc[None, :])[None, None]  # (1, 1, T, T): t_x - t_y
    rr, gg = r[:, :, None, None], gam[:, :, None, None]
    P = torch.exp(-rr * lag) * (erf(lag / ell - gg) + erf(tc[None, None, None, :] / ell + gg))
    E = torch.exp(-r[:, :, None] * tc[None, None, :])
    Q = E * (erf(tc[None, None, :] / ell - gam[:, :, None]) + erf(gam)[:, :, None])
    return {"r": r, "expg": torch.exp(gam * gam), "P": P, "Q": Q, "E": E,
            "s": p["sensitivity"], "w": omega, "l": ell}


def block(tab, j):
    """Rows of gene j against every row: (T, G*T)."""
    G, T = tab["E"].shape[1], tab["E"].shape[2]
    acc = 0.0
    for ca in (0, 1):
        a, ea = tab["r"][ca, j], tab["expg"][ca, j]
        Pa, Qa, Ea = tab["P"][ca, j], tab["Q"][ca, j], tab["E"][ca, j]
        for cb in (0, 1):
            b, eb = tab["r"][cb], tab["expg"][cb]
            Pb, Qb, Eb = tab["P"][cb], tab["Q"][cb], tab["E"][cb]
            term = ea * (Pa[:, None, :] - Qa[:, None, None] * Eb[None]) \
                + eb[None, :, None] * (Pb.permute(2, 0, 1) - Qb[None] * Ea[:, None, None])
            sign = 1.0 if ca == cb else -1.0
            acc = acc + (sign / (a + b))[None, :, None] * term
    w = tab["s"][j] * tab["s"] / (-4.0 * tab["w"][j] * tab["w"])
    k = (0.5 * math.sqrt(math.pi)) * tab["l"] * acc.real * w[None, :, None]
    return k.reshape(T, G * T)


def mean(p, T):
    return (p["basal"] / (p["alpha"] ** 2 + p["omega"] ** 2)).repeat_interleave(T)


def covariance(p, inp):
    """The prior covariance of every gridded output, without a graph."""
    G, T = inp["genes"], inp["t"].shape[0]
    with torch.no_grad():
        tab = tables(p, inp["t"])
        out = torch.empty(G * T, G * T, dtype=inp["t"].dtype, device=inp["t"].device)
        for j in range(G):
            out[j * T:(j + 1) * T] = block(tab, j)
    return out


def prior_mean(p, inp):
    return mean(p, inp["t"].shape[0])


def green(p, tau):
    """Each output's response at lag ``tau`` >= 0 to a unit impulse of the
    force, S_j e^{-alpha_j tau} sin(omega_j tau) / omega_j
    (``reference.quadrature``)."""
    w = p["omega"]
    return p["sensitivity"] * torch.exp(-p["alpha"] * tau) * torch.sin(w * tau) / w


class Train:
    """The MLL's pieces over the gridded outputs, for ``reference.common``."""

    def __init__(self, inp):
        self.t, self.genes = inp["t"], inp["genes"]

    def tables(self, p):
        return tables(p, self.t)

    def mean(self, p):
        return mean(p, self.t.shape[0])

    def blocks(self):
        T = self.t.shape[0]
        return [(slice(j * T, (j + 1) * T), (lambda tab, j=j: block(tab, j)))
                for j in range(self.genes)]
