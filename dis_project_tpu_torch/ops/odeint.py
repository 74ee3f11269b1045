r"""Log-depth integration of the first-order LFM response ODE.

Port of ``dis_project_tpu/ops/odeint.py``. The nonlinear-response family
(``models.nlfm``) has no closed-form covariance: its gene curves come from
quadrature against the force values on a dense uniform grid. The
integrating-factor solution

.. math:: x_j(t) = \frac{B_j}{D_j} + S_j\, e^{-D_j t} \int_0^t e^{D_j u}
    g(f(u))\,du

is evaluated through the decay-propagated trapezoid recurrence (spacing
``dt``)

.. math:: J_0 = 0,\qquad J_{k+1} = e^{-D_j\,dt} J_k +
    \tfrac{dt}{2}\left(e^{-D_j\,dt} g_k + g_{k+1}\right),

so that ``x_j(t_k) = B_j/D_j + S_j J_k``. Every factor is
:math:`e^{-D\,dt} \le 1`: no large intermediate exponential exists at any
``D t`` (the ``cumsum(e^{D u} g)`` form overflows float32 at
``D t \gtrsim 80``).

The recurrence is a first-order linear one, so it is associative: the whole
grid is one odd/even prefix scan (the state-space engine's
``_associative_scan``, about ``2 log2 Q`` batched combines) instead of
Q - 1 dependent steps. Every operation on it (slices, ``cat``, ``stack``)
supports ``torch.func``'s forward mode and ``vmap``, so the Hessian and
Jacobians of the model's Laplace posteriors run through it.
"""

from __future__ import annotations

import numpy as np
import torch

from dis_project_tpu_torch.ops.statespace import _associative_scan

#: Supported response nonlinearities g(f). ``exp`` is the
#: positivity-constrained response of Lawrence et al. (2006) §5;
#: ``softplus`` and ``sigmoid`` saturate; ``identity`` recovers the linear
#: SIMM.
RESPONSE_NAMES = ("identity", "exp", "softplus", "sigmoid")


def response_fn(name: str, xp=torch):
    """g as a function of the force values; ``xp`` is the array module
    (``torch`` for the model, ``numpy`` for the host-float64 generator)."""
    if name == "identity":
        return lambda f: f
    if name == "exp":
        return xp.exp
    if name == "softplus":
        if xp is np:
            return lambda f: np.logaddexp(0.0, f)
        return lambda f: torch.logaddexp(torch.zeros_like(f), f)
    if name == "sigmoid":
        return lambda f: 1.0 / (1.0 + xp.exp(-f))
    raise ValueError(
        f"unknown response {name!r}; expected one of {RESPONSE_NAMES}"
    )


def _combine(lhs, rhs):
    a1, b1 = lhs
    a2, b2 = rhs
    return a1 * a2, a2 * b1 + b2


def decay_propagated_trapezoid(g_vals, decay, dt):
    r"""``J[..., j, k]`` of the recurrence above for every gene j and grid
    step k.

    ``g_vals`` (..., Q): the response values on the uniform grid (leading
    axes broadcast); ``decay`` (G,); ``dt`` the grid spacing (a number or
    a 0-d tensor). Returns (..., G, Q) with ``J[..., j, 0] = 0``."""
    decay = torch.as_tensor(decay, dtype=g_vals.dtype, device=g_vals.device)
    a = torch.exp(-decay * dt)  # (G,)
    # b[j, k] covers the step ending at grid point k + 1.
    b = 0.5 * dt * (a[..., :, None] * g_vals[..., None, :-1] + g_vals[..., None, 1:])
    af = torch.broadcast_to(a[..., :, None], b.shape)
    # The scan runs over the leading axis: the grid axis moves there and back.
    _, J = _associative_scan(_combine, (torch.movedim(af, -1, 0), torch.movedim(b, -1, 0)))
    J = torch.movedim(J, 0, -1)
    zero = torch.zeros(J.shape[:-1] + (1,), dtype=J.dtype, device=J.device)
    return torch.cat([zero, J], dim=-1)


def gene_curves(g_vals, basal, sensitivity, decay, dt):
    """Gene expression curves ``x_j(t_k) = B_j / D_j + S_j J_j`` from the
    response values on the grid, with ``x_j(0) = B_j / D_j``. Shapes:
    ``g_vals (..., Q)``, kinetics ``(G,)`` -> ``(..., G, Q)``."""
    J = decay_propagated_trapezoid(g_vals, decay, dt)
    return (basal / decay)[:, None] + sensitivity[:, None] * J
