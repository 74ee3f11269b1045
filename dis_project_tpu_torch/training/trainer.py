"""Training loop for the exact SIMM LFM.

Port of ``dis_project_tpu/training/trainer.py`` (reference ``JaxTrainer``,
``src/trainer.py:36-228``):

- parameters live in *unconstrained* space during optimisation; the loss
  constrains them on the fly;
- every ``num_steps_per_epoch`` steps the p21 sensitivity/decay are re-fixed
  on the RAW values (with the default 1000 steps/epoch and 150 iterations
  this fires only at step 0), exactly like the reference;
- after the loop, parameters are constrained and clamped once more in
  *constrained* space;
- a finite guard backtracks on non-finite loss/gradients
  (``generic.guarded_transition``); per-step loss and gradient-norm
  histories, and optionally the constrained parameters of every step, are
  recorded;
- Adam or L-BFGS (``TrainConfig.optimizer``);
- :func:`fit` continues an earlier run exactly from ``init_state``,
  ``step_offset`` and ``init_guard``; :func:`fit_checkpointed` runs in
  segments, saves ``training.checkpoint`` files between them and resumes
  from the latest.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from dis_project_tpu_torch.models import simm
from dis_project_tpu_torch.models.simm import ExactSIMM, SIMMParams
from dis_project_tpu_torch.ops.gram import is_uniform_grid
from dis_project_tpu_torch.training import generic


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Canonical values mirror reference ``src/main.py:41-59``."""

    num_iters: int = 150
    learning_rate: float = 0.01
    fix_params: bool = True
    num_steps_per_epoch: int = 1000
    clamp_gene: int = 3  # p21 in the canonical DDB2,BIK,DR5,p21,SESN1 order
    clamp_sensitivity: float = 1.0
    clamp_decay: float = 0.8
    track_parameters: bool = False
    optimizer: str = "adam"  # or "lbfgs"
    # Backtrack-and-retry on non-finite loss/grad instead of poisoning the
    # optimizer state; the same update rule on clean trajectories.
    finite_guard: bool = True


@dataclasses.dataclass
class TrainResult:
    params: SIMMParams
    history: torch.Tensor  # (num_iters,) per-step loss
    grad_norms: torch.Tensor  # (num_iters,)
    param_trace: Optional[SIMMParams] = None  # stacked constrained params
    raw_params: Optional[SIMMParams] = None  # final unconstrained params
    opt_state: Optional[object] = None  # final optimizer state (resume)
    guard_flags: Optional[torch.Tensor] = None  # (num_iters,) bool
    # Final (good, streak, count) guard carry: fit()'s init_guard for the
    # next segment, so segmented runs equal the unsegmented one.
    guard_state: Optional[tuple] = None

    @property
    def guard_count(self) -> int:
        """Number of finite-guard recovery events during the fit."""
        if self.guard_flags is None:
            return 0
        return int(self.guard_flags.sum())


def make_optimizer(config: TrainConfig):
    return generic.make_optimizer(config.optimizer, config.learning_rate)


def _clamp(params, config: TrainConfig):
    return simm.clamp_params(params, gene_index=config.clamp_gene,
                             sensitivity=config.clamp_sensitivity,
                             decay=config.clamp_decay)


def fit(
    model: ExactSIMM,
    params: SIMMParams,
    x: torch.Tensor,
    y: torch.Tensor,
    config: TrainConfig = TrainConfig(),
    gridded: Optional[Tuple] = None,
    optimizer=None,
    init_state: Optional[Tuple] = None,
    step_offset: int = 0,
    init_guard: Optional[Tuple] = None,
) -> TrainResult:
    """Train to the negative exact MLL.

    ``gridded``: optional ``(timepoints, replicates)`` promise that the rows
    are canonical gene-major grid blocks (what ``dataset_3d`` produces) —
    routes the loss through ``model.mll_replicated`` (table Gram plus the
    Kronecker replicate diagonalisation). An irregular grid falls back to
    the always-correct row path, by the table Gram's own spacing predicate.

    ``init_state``: ``(raw_params, opt_state)`` of an earlier run to
    continue exactly; ``step_offset`` keeps the epoch-clamp schedule across
    segments; ``init_guard`` the earlier run's ``guard_state``.
    """
    optimizer = optimizer or make_optimizer(config)
    y = y.reshape(-1)
    if gridded is not None:
        timepoints, replicates = gridded
        if is_uniform_grid(timepoints):
            timepoints = torch.as_tensor(timepoints, dtype=y.dtype, device=y.device)

            def loss_fn(raw):
                return -model.mll_replicated(simm.constrain(raw), timepoints, y, replicates)
        else:
            gridded = None
    if gridded is None:

        def loss_fn(raw):
            return -model.mll(simm.constrain(raw), x, y)

    if init_state is not None:
        raw, opt_state = init_state
    else:
        raw = simm.unconstrain(params)
        opt_state = optimizer.init(raw)
    if init_guard is not None:
        good, streak, count = init_guard
    else:
        good, streak, count = (raw, opt_state), 0, 0

    def vg(r):
        return generic.value_and_grad(loss_fn, r)

    def do_update(grads, state, r, loss):
        if config.optimizer == "lbfgs":
            return optimizer.update(grads, state, r, loss, grad=grads, value_fn=loss_fn)
        return optimizer.update(grads, state, r, loss)

    losses, norms, flags, trace = [], [], [], []
    for step in range(step_offset, step_offset + config.num_iters):
        if config.finite_guard:
            (raw, opt_state, good, streak, count, loss, grads,
             fired) = generic.guarded_transition(
                vg, do_update, raw, opt_state, good, streak, count
            )
            flags.append(fired)
        else:
            loss, grads = vg(raw)
            updates, opt_state = do_update(grads, opt_state, raw, loss)
            raw = generic.apply_updates(raw, updates)
        if config.fix_params and step % config.num_steps_per_epoch == 0:
            raw = _clamp(raw, config)
        losses.append(loss)
        norms.append(generic.global_norm(grads))
        if config.track_parameters:
            trace.append(simm.constrain(raw))

    trained = simm.constrain(raw)
    if config.fix_params:
        trained = _clamp(trained, config)
    empty = torch.zeros(0, dtype=y.dtype, device=y.device)
    return TrainResult(
        params=trained,
        history=torch.stack(losses) if losses else empty,
        grad_norms=torch.stack(norms) if norms else empty,
        param_trace=(SIMMParams(*(torch.stack(leaves) for leaves in zip(*trace)))
                     if trace else None),
        raw_params=raw,
        opt_state=opt_state,
        guard_flags=torch.tensor(flags, dtype=torch.bool) if config.finite_guard else None,
        guard_state=(good, streak, count) if config.finite_guard else None,
    )


def fit_checkpointed(
    model: ExactSIMM,
    params: SIMMParams,
    x: torch.Tensor,
    y: torch.Tensor,
    config: TrainConfig,
    directory: str,
    checkpoint_every: int = 50,
    gridded: Optional[Tuple] = None,
) -> TrainResult:
    """Fault-tolerant training: run in ``checkpoint_every``-step segments,
    saving (raw params, optimizer state, step, guard carry) between them,
    and resume exactly from the latest checkpoint in ``directory`` if one
    exists — kill the process at any point and rerunning continues where it
    left off. A checkpoint without the guard carry (the older layout)
    resumes the trajectory with the guard re-anchored at the restored
    point."""
    from dis_project_tpu_torch.training import checkpoint as ckpt

    optimizer = make_optimizer(config)
    raw = simm.unconstrain(params)
    opt_state = optimizer.init(raw)
    step = 0
    guard = None

    latest = ckpt.latest_step(directory)
    if latest is not None and latest > 0:
        template = {"raw": raw, "opt_state": opt_state, "step": 0}
        try:
            restored = ckpt.restore(directory, latest, template={
                **template, **generic.guard_payload(((raw, opt_state), 0, 0))})
            guard = ((restored["guard_raw"], restored["guard_opt"]),
                     restored["guard_streak"], restored["guard_count"])
        except ValueError:
            restored = ckpt.restore(directory, latest, template=template)
        raw, opt_state = restored["raw"], restored["opt_state"]
        step = int(restored["step"])

    histories, grad_norms, guard_flags, traces = [], [], [], []
    result = None
    while step < config.num_iters:
        seg = min(checkpoint_every, config.num_iters - step)
        result = fit(model, params, x, y, dataclasses.replace(config, num_iters=seg),
                     gridded=gridded, optimizer=optimizer, init_state=(raw, opt_state),
                     step_offset=step, init_guard=guard)
        raw, opt_state = result.raw_params, result.opt_state
        guard = result.guard_state
        step += seg
        histories.append(result.history)
        grad_norms.append(result.grad_norms)
        if result.guard_flags is not None:
            guard_flags.append(result.guard_flags)
        if result.param_trace is not None:
            traces.append(result.param_trace)
        payload = {"raw": raw, "opt_state": opt_state, "step": step}
        if guard is not None:
            payload.update(generic.guard_payload(guard))
        ckpt.save(directory, payload, step=step)

    if result is None:  # already complete on entry
        trained = simm.constrain(raw)
        if config.fix_params:
            trained = _clamp(trained, config)
        empty = torch.zeros(0, dtype=y.dtype, device=y.device)
        return TrainResult(params=trained, history=empty, grad_norms=empty,
                           raw_params=raw, opt_state=opt_state)
    return dataclasses.replace(
        result,
        history=torch.cat(histories),
        grad_norms=torch.cat(grad_norms),
        guard_flags=torch.cat(guard_flags) if guard_flags else None,
        param_trace=(SIMMParams(*(torch.cat(leaves) for leaves in zip(*traces)))
                     if traces else None),
    )
