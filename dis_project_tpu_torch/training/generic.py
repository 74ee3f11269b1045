"""Optimizer rule and the finite-guarded training transition.

Port of the parts of ``dis_project_tpu/training/generic.py`` the exact-SIMM
trainer uses. The JAX loop is one compiled ``lax.scan``; here it is a
Python loop, and the guard's ``lax.cond`` becomes a host-side ``if``.

Adam is the explicit optax update rule (``optax.adam``: bias-corrected
moments, ``eps`` outside the square root, ``-lr`` scaling) written as pure
functions of a state tuple, because the guard must keep a known-good
``(params, state)`` pair and replay a scaled update from it —
``torch.optim.Adam`` mutates its state in place and applies the update
itself.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch


class AdamState(NamedTuple):
    count: int
    mu: Tuple[torch.Tensor, ...]
    nu: Tuple[torch.Tensor, ...]


class Adam:
    """optax.adam(learning_rate) as pure functions over tuples of tensors."""

    def __init__(self, learning_rate: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        self.lr, self.b1, self.b2, self.eps = learning_rate, b1, b2, eps

    def init(self, params) -> AdamState:
        zeros = tuple(torch.zeros_like(p) for p in params)
        return AdamState(0, zeros, tuple(torch.zeros_like(p) for p in params))

    def update(self, grads, state: AdamState):
        """Returns ``(updates, new_state)``; ``updates`` has the type of
        ``grads``."""
        b1, b2 = self.b1, self.b2
        mu = tuple((1 - b1) * g + b1 * m for g, m in zip(grads, state.mu))
        nu = tuple((1 - b2) * (g**2) + b2 * v for g, v in zip(grads, state.nu))
        count = state.count + 1
        bc1 = 1 - b1**count
        bc2 = 1 - b2**count
        updates = type(grads)(*(
            -self.lr * ((m / bc1) / (torch.sqrt(v / bc2) + self.eps))
            for m, v in zip(mu, nu)
        ))
        return updates, AdamState(count, mu, nu)


def apply_updates(params, updates):
    return type(params)(*(p + u for p, u in zip(params, updates)))


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(g * g) for g in tree))


def tree_isfinite(tree) -> bool:
    """Every tensor of ``tree`` is entirely finite (a host sync)."""
    return all(bool(torch.isfinite(a).all()) for a in tree)


def value_and_grad(loss_fn, raw):
    """``(loss, grads)`` of a scalar ``loss_fn`` at the tuple ``raw``;
    both detached, ``grads`` of the type of ``raw``."""
    leaves = type(raw)(*(p.detach().requires_grad_(True) for p in raw))
    loss = loss_fn(leaves)
    grads = torch.autograd.grad(loss, tuple(leaves))
    return loss.detach(), type(raw)(*grads)


def guarded_transition(value_and_grad_fn, do_update, raw, opt_state, good,
                       streak: int, count: int):
    """One finite-guarded optimizer transition.

    The failure it protects against: the reference's ``2l`` kernel family
    is indefinite in reachable parameter regions, so one step can land on a
    non-PSD Sigma, NaN the Cholesky and poison the optimizer moments. On a
    non-finite loss or gradient the guard backtracks to the last good
    ``(raw, opt_state)`` and retries the same update scaled by the ladder
    ``1/2, 2, 1/4, 4, ...`` (streak ``s`` -> ``0.5^k`` for odd ``s``,
    ``2^k`` for even, ``k = min((s+1)//2, 8)``). A non-finite good point
    (only the initial point can be one) freezes the run there.

    ``do_update(grads, opt_state) -> (updates, new_state)``. Returns
    ``(raw, opt_state, good, streak, count, loss, grads, guard_fired)``.
    """
    loss, grads = value_and_grad_fn(raw)
    if tree_isfinite((loss, *grads)):
        updates, opt2 = do_update(grads, opt_state)
        return (apply_updates(raw, updates), opt2, (raw, opt_state), 0, count,
                loss, grads, False)
    g_raw, g_opt = good
    loss_g, grads_g = value_and_grad_fn(g_raw)
    s = streak + 1
    if not tree_isfinite((loss_g, *grads_g)):
        return g_raw, g_opt, (g_raw, g_opt), s, count + 1, loss_g, grads_g, True
    updates, opt2 = do_update(grads_g, g_opt)
    k = min((s + 1) // 2, 8)
    scale = 0.5**k if s % 2 == 1 else 2.0**k
    scaled = type(updates)(*(u * scale for u in updates))
    return (apply_updates(g_raw, scaled), opt2, (g_raw, g_opt), s, count + 1,
            loss_g, grads_g, True)
