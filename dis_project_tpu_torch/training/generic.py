"""Optimizer rules, the finite-guarded training transition and the
model-agnostic training loops.

Port of ``dis_project_tpu/training/generic.py`` and of the optax rules it
calls. The JAX loop is one compiled ``lax.scan``; here it is a Python loop,
and the guard's ``lax.cond`` becomes a host-side ``if``. :func:`fit_loop`
and :func:`fit_checkpointed` train any ``loss_fn(raw) -> scalar`` over a
NamedTuple of raw parameters (the model families other than the exact
SIMM, whose trainer is ``training.trainer``), with the same step semantics.

Every optimizer is a pair of pure functions over a state tuple, as optax's
are: ``init(params) -> state`` and ``update(grads, state, params=None,
value=None, *, grad=None, value_fn=None) -> (updates, state)``. The guard
must keep a known-good ``(params, state)`` pair and replay a scaled update
from it, so no update mutates a state it was given (``torch.optim``
optimizers mutate theirs and apply the update themselves).

- :class:`Adam` — ``optax.adam``: bias-corrected moments, ``eps`` outside
  the square root, ``-lr`` scaling.
- :class:`ClipByGlobalNorm` and :class:`Chain` — ``optax.clip_by_global_norm``
  and ``optax.chain``.
- :class:`LBFGS` — ``optax.lbfgs()`` with optax 0.2.6's defaults: memory
  10, the scaled initial preconditioner, and the zoom line search (strong
  Wolfe, ``max_linesearch_steps=20``, initial step 1, cubic and quadratic
  interpolation with their safeguards). The line search's scalars are
  host floats: its branches are host decisions, as the JAX
  ``while_loop``'s are device ones.

Parameter trees are NamedTuples (or tuples) of tensors, nested to any
depth (the nonlinear family's ``NLFMParams`` holds a ``SIMMParams``): every
helper reads a tree through ``training.checkpoint.tree_leaves`` and rebuilds
it through ``tree_unflatten``, in ``jax.tree.leaves``' order (fields in
order, depth first). Optimizer states hold the flat tuple of a tree's
leaves.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from dis_project_tpu_torch.training.checkpoint import tree_leaves, tree_unflatten


def _map(fn, *trees):
    return tree_unflatten(trees[0], [fn(*leaves)
                                     for leaves in zip(*(tree_leaves(t) for t in trees))])


def _vdot(a, b) -> float:
    """Sum over leaves of each leaf's inner product (``optax.tree.vdot``)."""
    total = 0.0
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        total = total + float(torch.dot(x.reshape(-1), y.reshape(-1)))
    return total


def _sqnorm(tree) -> float:
    total = 0.0
    for x in tree_leaves(tree):
        total = total + float(torch.sum(x * x))
    return total


def _add_scale(x, s, y):
    return _map(lambda a, b: a + s * b, x, y)


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
        leaves = tree_leaves(params)
        zeros = tuple(torch.zeros_like(p) for p in leaves)
        return AdamState(0, zeros, tuple(torch.zeros_like(p) for p in leaves))

    def update(self, grads, state: AdamState, params=None, value=None, **_):
        """Returns ``(updates, new_state)``; ``updates`` has the structure
        of ``grads``."""
        b1, b2 = self.b1, self.b2
        g_leaves = tree_leaves(grads)
        mu = tuple((1 - b1) * g + b1 * m for g, m in zip(g_leaves, tree_leaves(state.mu)))
        nu = tuple((1 - b2) * (g**2) + b2 * v for g, v in zip(g_leaves, tree_leaves(state.nu)))
        count = state.count + 1
        bc1 = 1 - b1**count
        bc2 = 1 - b2**count
        updates = tree_unflatten(grads, [
            -self.lr * ((m / bc1) / (torch.sqrt(v / bc2) + self.eps))
            for m, v in zip(mu, nu)
        ])
        return updates, AdamState(count, mu, nu)


class ClipByGlobalNorm:
    """optax.clip_by_global_norm: scale the updates by ``max_norm / norm``
    when their global norm is ``max_norm`` or more."""

    def __init__(self, max_norm: float):
        self.max_norm = max_norm

    def init(self, params):
        return ()

    def update(self, grads, state, params=None, value=None, **_):
        g_norm = global_norm(grads)
        if bool(g_norm < self.max_norm):
            return grads, state
        return _map(lambda t: (t / g_norm.to(t.dtype)) * self.max_norm, grads), state


class Chain:
    """optax.chain: the transformations applied in order; the state is the
    tuple of their states."""

    def __init__(self, *transforms):
        self.transforms = transforms

    def init(self, params):
        return tuple(t.init(params) for t in self.transforms)

    def update(self, grads, state, params=None, value=None, **extra):
        states = []
        for t, s in zip(self.transforms, state):
            grads, s = t.update(grads, s, params, value, **extra)
            states.append(s)
        return grads, tuple(states)


class LBFGSState(NamedTuple):
    count: int
    params: tuple  # the parameters of the previous update
    updates: tuple  # the gradients of the previous update
    diff_params_memory: tuple  # per leaf (memory, *leaf.shape)
    diff_updates_memory: tuple
    weights_memory: Tuple[float, ...]  # rho_i = 1 / <dw_i, du_i>, 0 where undefined
    learning_rate: float  # the line search's last step size
    linesearch_steps: int  # the line search's steps in the last update


def _nanmax(a, b):
    return a if math.isnan(a) else (b if math.isnan(b) else max(a, b))


def _nanmin(a, b):
    return a if math.isnan(a) else (b if math.isnan(b) else min(a, b))


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    """Critical point of the cubic through (a, fa), (b, fb), (c, fc) with
    slope fpa at a; NaN or inf where it has none (IEEE arithmetic, as in
    optax, so the caller's validity test rejects it)."""
    a, fa, fpa, b, fb, c, fc = (np.float64(v) for v in (a, fa, fpa, b, fb, c, fc))
    with np.errstate(all="ignore"):
        C = fpa
        db = b - a
        dc = c - a
        denom = (db * dc) ** 2 * (db - dc)
        v0 = fb - fa - C * db
        v1 = fc - fa - C * dc
        A = (dc**2 * v0 + -(db**2) * v1) / denom
        B = (-(dc * dc * dc) * v0 + (db * db * db) * v1) / denom
        radical = B * B - 3.0 * A * C
        return float(a + (-B + np.sqrt(radical)) / (3.0 * A))


def _quadmin(a, fa, fpa, b, fb):
    """Critical point of the quadratic through (a, fa), (b, fb) with slope
    fpa at a."""
    a, fa, fpa, b, fb = (np.float64(v) for v in (a, fa, fpa, b, fb))
    with np.errstate(all="ignore"):
        db = b - a
        B = (fb - fa - fpa * db) / (db**2)
        return float(a - fpa / (2.0 * B))


class _Zoom:
    """optax's zoom line search (``linesearch.zoom_linesearch``) with its
    defaults: no maximal step, ``tol=0``, ``increase_factor=2``,
    ``slope_rtol=1e-4``, ``curv_rtol=0.9``, ``approx_dec_rtol=1e-6``,
    ``interval_threshold=1e-5``. One instance per line search."""

    tol, increase_factor, slope_rtol, curv_rtol = 0.0, 2.0, 1e-4, 0.9
    approx_dec_rtol, interval_threshold = 1e-6, 1e-5

    def __init__(self, value_and_grad_fn, params, updates, value, grad, max_steps):
        self.vg, self.params, self.updates, self.max_steps = (
            value_and_grad_fn, params, updates, max_steps)
        slope = _vdot(updates, grad)
        self.value_init, self.slope_init = value, slope
        self.count = 0
        self.stepsize, self.value, self.grad, self.slope = 0.0, value, grad, slope
        self.decrease_error = self.curvature_error = math.inf
        self.interval_found = self.done = self.failed = False
        self.low, self.value_low, self.slope_low = 0.0, value, slope
        self.high, self.value_high, self.slope_high = 0.0, value, slope
        self.cubic_ref, self.value_cubic_ref = 0.0, value
        self.safe_stepsize, self.safe_value, self.safe_grad = 0.0, value, grad

    def _on_line(self, stepsize):
        value, grad = self.vg(_add_scale(self.params, stepsize, self.updates))
        return float(value), grad, _vdot(grad, self.updates)

    def _decrease_error(self, stepsize, value, slope):
        err = value - self.value_init - self.slope_rtol * stepsize * self.slope_init
        approx = slope - (2 * self.slope_rtol - 1.0) * self.slope_init
        delta = value - self.value_init - self.approx_dec_rtol * abs(self.value_init)
        err = _nanmin(_nanmax(approx, delta), err)
        err = _nanmax(err, 0.0)
        return math.inf if math.isnan(err) else err

    def _curvature_error(self, slope):
        err = _nanmax(abs(slope) - self.curv_rtol * abs(self.slope_init), 0.0)
        return math.inf if math.isnan(err) else err

    def _search_interval(self):
        """Algorithm 3.5 of Nocedal and Wright."""
        it = self.count
        prev = (self.stepsize, self.value, self.slope)
        new = 1.0 if it == 0 else self.increase_factor * self.stepsize
        value, grad, slope = self._on_line(new)
        dec = self._decrease_error(new, value, slope)
        curv = self._curvature_error(slope)
        error = max(dec, curv)
        if dec <= self.tol:
            self.safe_stepsize, self.safe_value, self.safe_grad = new, value, grad
        set_high_to_new = dec > 0.0 or (value >= prev[1] and it > 0)
        set_low_to_new = slope >= 0.0 and not set_high_to_new
        if set_low_to_new:
            (self.low, self.value_low, self.slope_low), (
                self.high, self.value_high, self.slope_high) = (new, value, slope), prev
        else:
            (self.low, self.value_low, self.slope_low), (
                self.high, self.value_high, self.slope_high) = prev, (new, value, slope)
        self.interval_found = set_high_to_new or set_low_to_new or error <= self.tol
        self.done = error <= self.tol
        self.failed = it + 1 >= self.max_steps and not self.done
        self.count = it + 1
        self.stepsize, self.value, self.grad, self.slope = new, value, grad, slope
        self.decrease_error, self.curvature_error = dec, curv
        self.cubic_ref, self.value_cubic_ref = self.low, self.value_low

    def _zoom_into_interval(self):
        """Algorithm 3.6 of Nocedal and Wright."""
        low, vlow, slow = self.low, self.value_low, self.slope_low
        high, vhigh, shigh = self.high, self.value_high, self.slope_high
        delta = abs(high - low)
        left, right = min(high, low), max(high, low)
        too_small_int = delta <= self.interval_threshold
        cubic = _cubicmin(low, vlow, slow, high, vhigh, self.cubic_ref, self.value_cubic_ref)
        quad = _quadmin(low, vlow, slow, high, vhigh)
        if left + 0.2 * delta < cubic < right - 0.2 * delta:
            middle = cubic
        elif left + 0.1 * delta < quad < right - 0.1 * delta:
            middle = quad
        else:
            middle = (low + high) / 2.0
        value, grad, slope = self._on_line(middle)
        dec = self._decrease_error(middle, value, slope)
        curv = self._curvature_error(slope)
        if dec <= self.tol and value < self.safe_value:
            self.safe_stepsize, self.safe_value, self.safe_grad = middle, value, grad
        self.done = max(dec, curv) <= self.tol
        set_high_to_middle = dec > 0.0 or value >= vlow
        set_high_to_low = slope * (high - low) >= 0.0 and not set_high_to_middle
        if set_high_to_middle or set_high_to_low:
            self.cubic_ref, self.value_cubic_ref = high, vhigh
        else:
            self.cubic_ref, self.value_cubic_ref = low, vlow
        if set_high_to_middle:
            self.high, self.value_high, self.slope_high = middle, value, slope
        if set_high_to_low:
            self.high, self.value_high, self.slope_high = low, vlow, slow
        if not set_high_to_middle:
            self.low, self.value_low, self.slope_low = middle, value, slope
        presumably_failed = (self.count + 1 >= self.max_steps
                             or (too_small_int and self.safe_stepsize > 0.0))
        self.failed = presumably_failed and not self.done
        self.count += 1
        self.stepsize, self.value, self.grad, self.slope = middle, value, grad, slope
        self.decrease_error, self.curvature_error = dec, curv

    def run(self) -> float:
        """Step until done or failed; on failure fall back to the safe step
        (sufficient decrease), as optax's ``_try_safe_step``. Returns the
        step size."""
        while not (self.done or self.failed):
            if self.interval_found:
                self._zoom_into_interval()
            else:
                self._search_interval()
            if self.failed and (self.safe_stepsize > 0.0 or math.isinf(self.decrease_error)):
                self.stepsize, self.value, self.grad = (
                    self.safe_stepsize, self.safe_value, self.safe_grad)
        return self.stepsize


class LBFGS:
    """optax.lbfgs() (optax 0.2.6 defaults): the two-loop recursion over a
    ring buffer of (s, y) pairs, a scaled identity as the initial inverse
    Hessian (the capped reciprocal of the gradient norm at the first step),
    the direction negated, and the step size from the zoom line search.
    ``update`` needs ``value``, ``grad`` and ``value_fn`` as optax's does."""

    def __init__(self, memory_size: int = 10, max_linesearch_steps: int = 20):
        self.memory_size, self.max_linesearch_steps = memory_size, max_linesearch_steps

    def init(self, params) -> LBFGSState:
        m = self.memory_size
        stacked = tuple(p.new_zeros((m,) + tuple(p.shape)) for p in tree_leaves(params))
        zeros = _map(torch.zeros_like, params)
        return LBFGSState(0, zeros, zeros, stacked, stacked, (0.0,) * m, 1.0, 0)

    def _precondition(self, updates, dw_mem, du_mem, rhos, identity_scale, memory_idx):
        """Algorithm 7.4 of Nocedal and Wright (optax's
        ``_precondition_by_lbfgs``)."""
        m = self.memory_size
        indices = [(memory_idx + k) % m for k in range(m)]

        def pair(idx):
            return (tree_unflatten(updates, [x[idx] for x in dw_mem]),
                    tree_unflatten(updates, [x[idx] for x in du_mem]))

        vec, alphas = updates, [0.0] * m
        for k in reversed(range(m)):
            dwi, dui = pair(indices[k])
            alphas[k] = rhos[indices[k]] * _vdot(dwi, vec)
            vec = _add_scale(vec, -alphas[k], dui)
        vec = _map(lambda v: identity_scale * v, vec)
        for k in range(m):
            dwi, dui = pair(indices[k])
            beta = rhos[indices[k]] * _vdot(dui, vec)
            vec = _add_scale(vec, alphas[k] - beta, dwi)
        return vec

    def update(self, grads, state: LBFGSState, params=None, value=None, *, grad=None,
               value_fn=None):
        m = self.memory_size
        memory_idx = state.count % m
        prev_idx = (state.count - 1) % m
        # 1. The memory: the newest (s, y) pair goes where the oldest was.
        if state.count > 0:
            diff_params = _map(lambda a, b: a - b, params, state.params)
            diff_updates = _map(lambda a, b: a - b, grads, state.updates)
            vdot = _vdot(diff_updates, diff_params)
            weight = 0.0 if vdot == 0.0 else 1.0 / vdot
        else:
            diff_params = diff_updates = _map(torch.zeros_like, params)
            weight = 0.0

        def put(mem, leaves):
            out = []
            for buf, leaf in zip(mem, tree_leaves(leaves)):
                buf = buf.clone()
                buf[prev_idx] = leaf
                out.append(buf)
            return tuple(out)

        dw_mem = put(state.diff_params_memory, diff_params)
        du_mem = put(state.diff_updates_memory, diff_updates)
        rhos = tuple(weight if i == prev_idx else w for i, w in enumerate(state.weights_memory))
        # 2. The scale of the initial inverse Hessian.
        if state.count > 0:
            denominator = _sqnorm(diff_updates)
            identity_scale = (_vdot(diff_updates, diff_params) / denominator
                              if denominator > 0.0 else 1.0)
        else:
            identity_scale = min(1.0, 1.0 / math.sqrt(_sqnorm(grads)))
        # 3. The direction, negated, and its step from the line search.
        direction = _map(lambda u: -u, self._precondition(
            grads, dw_mem, du_mem, rhos, identity_scale, memory_idx))

        def value_and_grad_fn(p):
            return value_and_grad(value_fn, p)

        zoom = _Zoom(value_and_grad_fn, params, direction, float(value), grad,
                     self.max_linesearch_steps)
        lr = zoom.run()
        new_state = LBFGSState(state.count + 1, params, grads, dw_mem, du_mem, rhos, lr,
                               zoom.count)
        return _map(lambda u: lr * u, direction), new_state


def make_optimizer(name: str, learning_rate: float):
    """``'adam'`` (optax.adam(learning_rate)) or ``'lbfgs'`` (optax.lbfgs(),
    whose line search sets the step: the learning rate is unused)."""
    if name == "adam":
        return Adam(learning_rate)
    if name == "lbfgs":
        return LBFGS()
    raise ValueError(f"unknown optimizer {name!r}")


def apply_updates(params, updates):
    return _map(lambda p, u: p + u, params, updates)


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(g * g) for g in tree_leaves(tree)))


def tree_isfinite(tree) -> bool:
    """Every tensor of ``tree`` is entirely finite (a host sync a leaf)."""
    return all(bool(torch.isfinite(a).all()) for a in tree_leaves(tree))


def value_and_grad(loss_fn, raw):
    """``(loss, grads)`` of a scalar ``loss_fn`` at the tree ``raw``;
    both detached, ``grads`` of the structure of ``raw``."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(raw)]
    loss = loss_fn(tree_unflatten(raw, leaves))
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), tree_unflatten(raw, grads)


def guarded_transition(value_and_grad_fn, do_update, raw, opt_state, good,
                       streak: int, count: int):
    """One finite-guarded optimizer transition.

    The failure it protects against: the reference's ``2l`` kernel family
    is indefinite in reachable parameter regions, so one step can land on a
    non-PSD Sigma, NaN the Cholesky and poison the optimizer state. On a
    non-finite loss or gradient the guard backtracks to the last good
    ``(raw, opt_state)`` and retries the same update scaled by the ladder
    ``1/2, 2, 1/4, 4, ...`` (streak ``s`` -> ``0.5^k`` for odd ``s``,
    ``2^k`` for even, ``k = min((s+1)//2, 8)``). A non-finite good point
    (only the initial point can be one) freezes the run there. The optimizer
    state is any optimizer's (Adam moments, the L-BFGS memory): updates
    never mutate it.

    ``do_update(grads, opt_state, raw, loss) -> (updates, new_state)``.
    Returns ``(raw, opt_state, good, streak, count, loss, grads,
    guard_fired)``.
    """
    loss, grads = value_and_grad_fn(raw)
    if tree_isfinite((loss, *grads)):
        updates, opt2 = do_update(grads, opt_state, raw, loss)
        return (apply_updates(raw, updates), opt2, (raw, opt_state), 0, count,
                loss, grads, False)
    g_raw, g_opt = good
    loss_g, grads_g = value_and_grad_fn(g_raw)
    s = streak + 1
    if not tree_isfinite((loss_g, *grads_g)):
        return g_raw, g_opt, (g_raw, g_opt), s, count + 1, loss_g, grads_g, True
    updates, opt2 = do_update(grads_g, g_opt, g_raw, loss_g)
    k = min((s + 1) // 2, 8)
    scale = 0.5**k if s % 2 == 1 else 2.0**k
    scaled = _map(lambda u: u * scale, updates)
    return (apply_updates(g_raw, scaled), opt2, (g_raw, g_opt), s, count + 1,
            loss_g, grads_g, True)


@dataclasses.dataclass
class LoopResult:
    """Outcome of :func:`fit_loop`."""

    raw: Any  # final unconstrained params
    params: Any  # constrain_fn(raw)
    history: torch.Tensor  # (num_iters,) per-step loss
    grad_norms: torch.Tensor  # (num_iters,)
    param_trace: Optional[Any] = None  # stacked constrained params
    opt_state: Optional[Any] = None
    guard_flags: Optional[torch.Tensor] = None  # (num_iters,) bool: the guard fired
    # Final (good, streak, count) guard carry: fit_loop's init_guard for the
    # next segment, so segmented runs reproduce the unsegmented one.
    guard_state: Optional[Tuple] = None

    @property
    def guard_count(self) -> int:
        """Number of finite-guard events (non-finite loss/grad recoveries)."""
        if self.guard_flags is None:
            return 0
        return int(self.guard_flags.sum())


def _stack(values, like):
    if values:
        return torch.stack(values)
    return torch.zeros(0, dtype=like.dtype, device=like.device)


def fit_loop(
    loss_fn: Callable[[Any], torch.Tensor],
    raw0: Any,
    *,
    num_iters: int,
    learning_rate: float = 0.01,
    optimizer: Any = "adam",
    constrain_fn: Optional[Callable[[Any], Any]] = None,
    clamp_raw: Optional[Callable[[Any], Any]] = None,
    track_parameters: bool = False,
    init_state: Optional[Tuple[Any, Any]] = None,
    finite_guard: bool = True,
    init_guard: Optional[Tuple] = None,
) -> LoopResult:
    """Minimise ``loss_fn`` over the raw NamedTuple ``raw0``.

    ``optimizer``: ``'adam'``, ``'lbfgs'`` (its updates take the value, the
    gradient and ``loss_fn``) or an optimizer object. ``clamp_raw``: the
    family's raw-space projection, applied before the optimizer is
    initialised and after every update. ``constrain_fn`` maps raw to
    constrained parameters for the returned ``params`` and the per-step
    trace. ``init_state`` ``(raw, opt_state)`` and ``init_guard`` continue an
    earlier run exactly. ``finite_guard`` backtracks on a non-finite loss or
    gradient (:func:`guarded_transition`)."""
    is_lbfgs = optimizer == "lbfgs"
    if isinstance(optimizer, str):
        optimizer = make_optimizer(optimizer, learning_rate)
    constrain_fn = constrain_fn or (lambda r: r)

    def vg(r):
        return value_and_grad(loss_fn, r)

    def do_update(grads, state, r, loss):
        if is_lbfgs:
            return optimizer.update(grads, state, r, loss, grad=grads, value_fn=loss_fn)
        return optimizer.update(grads, state, r, loss)

    if init_state is not None:
        raw, opt_state = init_state
    else:
        raw = clamp_raw(raw0) if clamp_raw is not None else raw0
        opt_state = optimizer.init(raw)
    good, streak, count = init_guard if init_guard is not None else ((raw, opt_state), 0, 0)

    losses, norms, flags, trace = [], [], [], []
    for _ in range(num_iters):
        if finite_guard:
            (raw, opt_state, good, streak, count, loss, grads,
             fired) = guarded_transition(vg, do_update, raw, opt_state, good, streak, count)
            flags.append(fired)
        else:
            loss, grads = vg(raw)
            updates, opt_state = do_update(grads, opt_state, raw, loss)
            raw = apply_updates(raw, updates)
        if clamp_raw is not None:
            raw = clamp_raw(raw)
        losses.append(loss)
        norms.append(global_norm(grads))
        if track_parameters:
            trace.append(constrain_fn(raw))

    like = tree_leaves(raw)[0]
    return LoopResult(
        raw=raw,
        params=constrain_fn(raw),
        history=_stack(losses, like),
        grad_norms=_stack(norms, like),
        param_trace=_map(lambda *steps: torch.stack(steps), *trace) if trace else None,
        opt_state=opt_state,
        guard_flags=torch.tensor(flags, dtype=torch.bool) if finite_guard else None,
        guard_state=(good, streak, count) if finite_guard else None,
    )


def guard_payload(guard):
    """The checkpoint entries of a ``(good, streak, count)`` guard carry."""
    good, streak, count = guard
    return {"guard_raw": good[0], "guard_opt": good[1],
            "guard_streak": streak, "guard_count": count}


def fit_checkpointed(
    loss_fn: Callable[[Any], torch.Tensor],
    raw0: Any,
    *,
    num_iters: int,
    directory: str,
    checkpoint_every: int = 50,
    learning_rate: float = 0.01,
    optimizer: Any = "adam",
    constrain_fn: Optional[Callable[[Any], Any]] = None,
    clamp_raw: Optional[Callable[[Any], Any]] = None,
    track_parameters: bool = False,
    resume: bool = True,
) -> LoopResult:
    """Fault-tolerant :func:`fit_loop`: ``checkpoint_every``-step segments,
    with (raw, optimizer state, step, guard carry) saved by
    ``training.checkpoint`` after each; with ``resume`` a rerun continues
    exactly from the latest checkpoint in ``directory`` (a checkpoint
    without the guard carry resumes with the guard re-anchored at the
    restored point). The result's histories, traces and guard flags cover
    the steps this call ran."""
    from dis_project_tpu_torch.training import checkpoint as ckpt

    opt = make_optimizer(optimizer, learning_rate) if isinstance(optimizer, str) else optimizer
    opt_arg = optimizer if isinstance(optimizer, str) else opt  # 'lbfgs' takes its extras
    constrain_fn = constrain_fn or (lambda r: r)
    raw = clamp_raw(raw0) if clamp_raw is not None else raw0
    opt_state = opt.init(raw)
    step = 0
    guard = None

    if resume:
        latest = ckpt.latest_step(directory)
        if latest is not None and latest > 0:
            template = {"raw": raw, "opt_state": opt_state, "step": 0}
            try:
                restored = ckpt.restore(directory, latest, template={
                    **template, **guard_payload(((raw, opt_state), 0, 0))})
                guard = ((restored["guard_raw"], restored["guard_opt"]),
                         restored["guard_streak"], restored["guard_count"])
            except ValueError:
                restored = ckpt.restore(directory, latest, template=template)
            raw, opt_state = restored["raw"], restored["opt_state"]
            step = int(restored["step"])

    results = []
    while step < num_iters:
        seg = min(checkpoint_every, num_iters - step)
        result = fit_loop(
            loss_fn, raw, num_iters=seg, learning_rate=learning_rate, optimizer=opt_arg,
            constrain_fn=constrain_fn, clamp_raw=clamp_raw, track_parameters=track_parameters,
            init_state=(raw, opt_state), init_guard=guard,
        )
        raw, opt_state, guard = result.raw, result.opt_state, result.guard_state
        step += seg
        results.append(result)
        ckpt.save(directory, {"raw": raw, "opt_state": opt_state, "step": step,
                              **guard_payload(guard)}, step=step)

    if not results:  # already complete on entry
        like = tree_leaves(raw)[0]
        empty = torch.zeros(0, dtype=like.dtype, device=like.device)
        return LoopResult(raw=raw, params=constrain_fn(raw), history=empty, grad_norms=empty,
                          opt_state=opt_state)
    traces = [r.param_trace for r in results if r.param_trace is not None]
    return dataclasses.replace(
        results[-1],
        history=torch.cat([r.history for r in results]),
        grad_norms=torch.cat([r.grad_norms for r in results]),
        guard_flags=torch.cat([r.guard_flags for r in results]),
        param_trace=_map(lambda *segs: torch.cat(segs), *traces) if traces else None,
    )
