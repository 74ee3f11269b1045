"""What the reference families share: bijectors, Adam, the exact MLL's
value and gradient, and the first Adam steps of a fit.

The gradient is taken without differentiating through the factor:
d loss / d Sigma = (Sigma^-1 - alpha alpha^T) / 2 (``reference.linalg``),
pushed back through the family's Gram one block of rows at a time, against
detached copies of the small tables the blocks are built from, and from the
tables to the raw parameters in one last backward pass.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from lfmbench.reference import linalg

B1, B2, EPS = 0.9, 0.999, 1e-8


def constrain(raw, bijectors):
    """Raw (unconstrained) leaves to the model's parameters."""
    out = {}
    for k, x in raw.items():
        kind = bijectors[k]
        if kind[0] == "softplus":
            out[k] = F.softplus(x)
        else:
            lo, hi = kind[1], kind[2]
            out[k] = lo + (hi - lo) * torch.sigmoid(x)
    return out


def unconstrain(params, bijectors):
    out = {}
    for k, y in params.items():
        kind = bijectors[k]
        if kind[0] == "softplus":
            out[k] = y + torch.log(-torch.expm1(-y))
        else:
            lo, hi = kind[1], kind[2]
            u = (y - lo) / (hi - lo)
            out[k] = torch.log(u) - torch.log1p(-u)
    return out


def loss_and_grad(family, train, raw, y, jitter, tf32: bool = False):
    """``(loss, grads)`` of the negative exact MLL at the raw leaves ``raw``
    (a dict), Sigma = K + (jitter + obs_stddev^2) I."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in raw.items()}
    p = constrain(leaves, family.BIJECTORS)
    tabs = train.tables(p)
    mu = train.mean(p)
    c = jitter + p["obs_stddev"] ** 2
    tabs_d = {k: v.detach().requires_grad_(v.requires_grad) for k, v in tabs.items()}
    n = y.shape[0]
    with torch.no_grad():
        sigma = torch.empty(n, n, dtype=y.dtype, device=y.device)
        for rows, fn in train.blocks():
            sigma[rows] = fn(tabs_d)
        sigma.diagonal().add_(c.detach())
        logp, dsigma, alpha = linalg.logpdf_and_grad_(sigma, y - mu.detach(), tf32)
        del sigma
    want = [k for k, v in tabs_d.items() if v.requires_grad]
    acc = {k: torch.zeros_like(tabs_d[k]) for k in want}
    for rows, fn in train.blocks():
        with torch.enable_grad():
            kb = fn(tabs_d)
            gs = torch.autograd.grad((kb * dsigma[rows]).sum(), [tabs_d[k] for k in want],
                                     allow_unused=True)
        for k, g in zip(want, gs):
            if g is not None:
                acc[k] -= g
    trace = torch.diagonal(dsigma).sum()
    del dsigma
    torch.autograd.backward([tabs[k] for k in want] + [mu, c],
                            [acc[k] for k in want] + [-alpha, -trace])
    return -logp, {k: v.grad for k, v in leaves.items()}


def first_steps(family, train, raw0, y, jitter, lr, steps, tf32: bool = False):
    """Adam (Kingma & Ba, with optax's conventions) from ``raw0`` for
    ``steps`` steps: each step's loss, the first gradient, and each leaf's
    change over the steps."""
    raw = {k: v.clone() for k, v in raw0.items()}
    m = {k: torch.zeros_like(v) for k, v in raw.items()}
    v2 = {k: torch.zeros_like(v) for k, v in raw.items()}
    losses, first = [], None
    for i in range(1, steps + 1):
        loss, g = loss_and_grad(family, train, raw, y, jitter, tf32)
        losses.append(float(loss))
        first = first or {k: t.clone() for k, t in g.items()}
        for k in raw:
            m[k] = B1 * m[k] + (1 - B1) * g[k]
            v2[k] = B2 * v2[k] + (1 - B2) * g[k] ** 2
            raw[k] = raw[k] - lr * (m[k] / (1 - B1**i)) / (torch.sqrt(v2[k] / (1 - B2**i)) + EPS)
    return {"losses": losses, "grad": first, "change": {k: raw[k] - raw0[k] for k in raw}}
