r"""The first-order SIMM (Lawrence, Sanguinetti & Rattray 2006), in plain torch.

Gene j's mRNA obeys :math:`\dot x_j = B_j + S_j f(t) - D_j x_j` with an RBF
prior on the force f. The expression covariance is the paper's eq. 5,

.. math::
    k_{jk}(t, t') = S_j S_k \tfrac{\sqrt\pi\,l}{2}\,[h_{kj}(t', t) + h_{jk}(t, t')],

.. math::
    h_{ab}(t_1, t_2) = \frac{e^{\gamma_b^2}}{D_a + D_b}\Big[
        e^{-D_b (t_2 - t_1)}\big(\mathrm{erf}(\tfrac{t_2 - t_1}{l} - \gamma_b)
        + \mathrm{erf}(\tfrac{t_1}{l} + \gamma_b)\big)
      - e^{-(D_b t_2 + D_a t_1)}\big(\mathrm{erf}(\tfrac{t_2}{l} - \gamma_b)
        + \mathrm{erf}(\gamma_b)\big)\Big],\quad \gamma_b = \tfrac{D_b l}{2},

and the mean is :math:`B_j / D_j`. Rows are ``(t, gene, 1)``: every row is
an expression row. Built in blocks of rows, so that the graph of one block
is all that autograd holds.
"""

from __future__ import annotations

import math

import torch

from lfmbench.reference import linalg

ROW_BLOCK = 512
LEAVES = ("basal", "sensitivity", "decay", "lengthscale", "obs_stddev")
PER_GENE = ("basal", "sensitivity", "decay")
BIJECTORS = {"basal": ("softplus",), "sensitivity": ("softplus",), "decay": ("softplus",),
             "lengthscale": ("sigmoid", 0.5, 3.5), "obs_stddev": ("softplus",)}


def _h(d_a, d_b, t1, t2, ell):
    g_b = 0.5 * d_b * ell
    return torch.exp(g_b * g_b) / (d_a + d_b) * (
        torch.exp(-d_b * (t2 - t1)) * (torch.erf((t2 - t1) / ell - g_b) + torch.erf(t1 / ell + g_b))
        - torch.exp(-(d_b * t2 + d_a * t1)) * (torch.erf(t2 / ell - g_b) + torch.erf(g_b)))


def kxx(t1, t2, d1, d2, s1, s2, ell):
    """Eq. 5, broadcasting."""
    return s1 * s2 * (0.5 * math.sqrt(math.pi)) * ell * (
        _h(d2, d1, t2, t1, ell) + _h(d1, d2, t1, t2, ell))


def row_tables(p, rows):
    """Per-row decay and sensitivity, the times, and the lengthscale: what
    a block of the Gram is built from."""
    g = rows[:, 1].round().long()
    return {"t": rows[:, 0], "d": p["decay"][g], "s": p["sensitivity"][g],
            "l": p["lengthscale"]}


def cross(ta, tb, a, b):
    """The covariance between row sets ``ta[a]`` and ``tb[b]`` (slices)."""
    return kxx(ta["t"][a, None], tb["t"][None, b], ta["d"][a, None], tb["d"][None, b],
               ta["s"][a, None], tb["s"][None, b], ta["l"])


def diag(tab):
    """k(t, t) of every row."""
    return kxx(tab["t"], tab["t"], tab["d"], tab["d"], tab["s"], tab["s"], tab["l"])


def blocks(n):
    return [slice(a, min(a + ROW_BLOCK, n)) for a in range(0, n, ROW_BLOCK)]


def mean(p, rows):
    g = rows[:, 1].round().long()
    return (p["basal"] / p["decay"])[g]


class Train:
    """The MLL's pieces over the training rows, for ``reference.common``."""

    def __init__(self, inp):
        self.rows = inp["X"]

    def tables(self, p):
        return row_tables(p, self.rows)

    def mean(self, p):
        return mean(p, self.rows)

    def blocks(self):
        n = self.rows.shape[0]
        full = slice(0, n)
        return [(b, (lambda tab, b=b: cross(tab, tab, b, full))) for b in blocks(n)]


def gram(tab_a, tab_b):
    """The whole (n_a, n_b) covariance, block by block, without a graph."""
    na, nb = tab_a["t"].shape[0], tab_b["t"].shape[0]
    out = torch.empty(na, nb, dtype=tab_a["t"].dtype, device=tab_a["t"].device)
    with torch.no_grad():
        for b in blocks(na):
            out[b] = cross(tab_a, tab_b, b, slice(0, nb))
    return out


def covariance(p, inp):
    """The prior covariance of every training row, without a graph."""
    tab = row_tables(p, inp["X"])
    return gram(tab, tab)


def prior_mean(p, inp):
    return mean(p, inp["X"])


def green(p, tau):
    """Each gene's response at lag ``tau`` >= 0 to a unit impulse of the
    force, S_j e^{-D_j tau} (``reference.quadrature``)."""
    return p["sensitivity"] * torch.exp(-p["decay"] * tau)


def predict(p, rows, y, variances, test, jitter, tf32: bool = False):
    """The posterior over expression at the ``test`` rows (flag 1): its
    mean and the diagonal of its covariance, with
    Sigma = K + diag(variances) + obs^2 I and jitter on the covariance."""
    with torch.no_grad():
        tx, tt = row_tables(p, rows), row_tables(p, test)
        sigma = gram(tx, tx)
        sigma.diagonal().add_(variances + p["obs_stddev"] ** 2)
        l = linalg.cholesky_(sigma, tf32)
        kxt = gram(tx, tt)
        solved = linalg.chol_solve(l, kxt)
        del l, sigma
        mu = mean(p, test) + linalg.matvec_t(solved, y - mean(p, rows), tf32)
        var = diag(tt) - linalg.col_dots(kxt, solved, tf32) + jitter
    return mu, var
