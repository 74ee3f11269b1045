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
  histories are recorded.

L-BFGS, parameter traces and checkpointed/resumable fits are not ported yet.
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


@dataclasses.dataclass
class TrainResult:
    params: SIMMParams
    history: torch.Tensor  # (num_iters,) per-step loss
    grad_norms: torch.Tensor  # (num_iters,)
    raw_params: Optional[SIMMParams] = None  # final unconstrained params
    opt_state: Optional[generic.AdamState] = None
    guard_flags: Optional[torch.Tensor] = None  # (num_iters,) bool

    @property
    def guard_count(self) -> int:
        """Number of finite-guard recovery events during the fit."""
        if self.guard_flags is None:
            return 0
        return int(self.guard_flags.sum())


def fit(
    model: ExactSIMM,
    params: SIMMParams,
    x: torch.Tensor,
    y: torch.Tensor,
    config: TrainConfig = TrainConfig(),
    gridded: Optional[Tuple] = None,
) -> TrainResult:
    """Train to the negative exact MLL with Adam.

    ``gridded``: optional ``(timepoints, replicates)`` promise that the rows
    are canonical gene-major grid blocks (what ``dataset_3d`` produces) —
    routes the loss through ``model.mll_replicated`` (table Gram plus the
    Kronecker replicate diagonalisation). An irregular grid falls back to
    the always-correct row path, by the table Gram's own spacing predicate.
    """
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

    def clamp(p):
        return simm.clamp_params(
            p,
            gene_index=config.clamp_gene,
            sensitivity=config.clamp_sensitivity,
            decay=config.clamp_decay,
        )

    optimizer = generic.Adam(config.learning_rate)
    raw = simm.unconstrain(params)
    opt_state = optimizer.init(raw)
    good, streak, count = (raw, opt_state), 0, 0

    def vg(r):
        return generic.value_and_grad(loss_fn, r)

    losses, norms, flags = [], [], []
    for step in range(config.num_iters):
        (raw, opt_state, good, streak, count, loss, grads,
         fired) = generic.guarded_transition(
            vg, optimizer.update, raw, opt_state, good, streak, count
        )
        flags.append(fired)
        if config.fix_params and step % config.num_steps_per_epoch == 0:
            raw = clamp(raw)
        losses.append(loss)
        norms.append(generic.global_norm(grads))

    trained = simm.constrain(raw)
    if config.fix_params:
        trained = clamp(trained)
    empty = torch.zeros(0, dtype=y.dtype, device=y.device)
    return TrainResult(
        params=trained,
        history=torch.stack(losses) if losses else empty,
        grad_norms=torch.stack(norms) if norms else empty,
        raw_params=raw,
        opt_state=opt_state,
        guard_flags=torch.tensor(flags, dtype=torch.bool),
    )
