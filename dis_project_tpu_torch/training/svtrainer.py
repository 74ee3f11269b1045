"""Minibatch SVI training loop of the sparse variational SIMM.

Port of ``dis_project_tpu/training/svtrainer.py``. The JAX loop is one
compiled program (an epoch scan over a minibatch scan); here it is a Python
loop of eager steps that never waits for the card: each epoch's (batches,
bs) index table is made on the host (:func:`epoch_indices`) and copied to
the device once, each batch is gathered there by index, and the per-step
negative ELBO is written into a (num_epochs, batches) history on the
device, read by the caller once at the end.

The optimizer is ``training.generic.Adam`` over the flat tuple of the raw
parameters' leaves (:func:`flatten`: the kinetics fields, then z, q_mu and
q_sqrt). With ``train_z=False`` z's update is zero and z carries no
moments, as under ``optax.multi_transform`` with ``set_to_zero``
(:class:`FreezeZ`).

The shuffle stream cannot be ``jax.random``'s: :func:`epoch_indices` draws
each epoch's permutation from a CPU ``torch.Generator`` seeded from (seed,
absolute epoch), so segmented and resumed runs see the shuffles of an
unsegmented run, and the card and the CPU see the same tables. Parity tests
replace it with the JAX package's tables.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from dis_project_tpu_torch.models import svlfm
from dis_project_tpu_torch.models.svlfm import SparseSIMM, SVLFMParams
from dis_project_tpu_torch.training import generic

_TAIL = ("z", "q_mu", "q_sqrt")


@dataclasses.dataclass(frozen=True)
class SVTrainConfig:
    num_epochs: int = 50
    batch_size: int = 1024
    learning_rate: float = 0.01
    seed: int = 0
    # Freeze the inducing locations (often preferable when z is a dense grid).
    train_z: bool = True


@dataclasses.dataclass
class SVTrainResult:
    params: SVLFMParams
    history: torch.Tensor  # (num_epochs, batches_per_epoch) negative ELBO
    raw_params: Optional[SVLFMParams] = None
    opt_state: Optional[object] = None


@functools.lru_cache(maxsize=None)
def _leaves_type(fields):
    return collections.namedtuple("SVLeaves", fields)


def flatten(raw: SVLFMParams, train_z: bool = True):
    """The leaves of ``raw`` as one flat NamedTuple: the kinetics fields,
    then z (left out when ``train_z`` is False), q_mu and q_sqrt."""
    tail = _TAIL if train_z else _TAIL[1:]
    leaves = tuple(raw.kinetics) + tuple(getattr(raw, f) for f in tail)
    return _leaves_type(raw.kinetics._fields + tail)(*leaves)


def unflatten(leaves, like: SVLFMParams) -> SVLFMParams:
    """The inverse of :func:`flatten` (with z), in ``like``'s kinetics type."""
    n = len(like.kinetics)
    return SVLFMParams(type(like.kinetics)(*leaves[:n]), *leaves[n:])


class FreezeZ:
    """``optax.multi_transform({'opt': base, 'frozen': set_to_zero()})``
    with z frozen, over :func:`flatten`'s leaves: ``base`` and its state
    see every leaf but z, and z's update is zero."""

    def __init__(self, base, z_index: int):
        self.base, self.i = base, z_index

    def _drop(self, leaves):
        kept = tuple(leaves[:self.i]) + tuple(leaves[self.i + 1:])
        fields = leaves._fields[:self.i] + leaves._fields[self.i + 1:]
        return _leaves_type(fields)(*kept)

    def init(self, params):
        return self.base.init(self._drop(params))

    def update(self, grads, state, params=None, value=None, **extra):
        updates, state = self.base.update(
            self._drop(grads), state, None if params is None else self._drop(params), value,
            **extra)
        out = list(updates)
        out.insert(self.i, torch.zeros_like(grads[self.i]))
        return type(grads)(*out), state


def make_optimizer(config: SVTrainConfig, params: SVLFMParams, base=None):
    """The SVI optimizer for ``config``: Adam(lr), with z frozen
    (:class:`FreezeZ`) when ``config.train_z`` is False. :func:`fit` (when
    no optimizer is passed) and :func:`fit_checkpointed` build it here, so
    their optimizer states always match."""
    base = base if base is not None else generic.Adam(config.learning_rate)
    if config.train_z:
        return base
    return FreezeZ(base, len(params.kinetics))


def epoch_indices(seed: int, epoch: int, n: int, bs: int) -> torch.Tensor:
    """The (batches, bs) int64 row indices of absolute epoch ``epoch``, on
    the CPU (bs is capped at n; batches = ceil(n / bs)): a permutation of
    range(n) from a generator seeded from (seed, epoch), padded to
    batches * bs by wrapping its first entries, so that every batch has bs
    rows (the tail batch oversamples early rows slightly)."""
    bs = min(bs, n)
    batches = -(-n // bs)
    state = np.random.SeedSequence((seed % 2**64, epoch)).generate_state(1, np.uint64)[0]
    perm = torch.randperm(n, generator=torch.Generator().manual_seed(int(state)))
    return torch.cat([perm, perm[: batches * bs - n]]).reshape(batches, bs)


def _to_device(idx: torch.Tensor, device) -> torch.Tensor:
    """``idx`` on ``device`` without the host waiting for the card (a
    pinned, non-blocking copy on CUDA)."""
    if device.type == "cuda":
        return idx.pin_memory().to(device, non_blocking=True)
    return idx.to(device)


def svi_step(model: SparseSIMM, optimizer, like: SVLFMParams, n_total: int, leaves, opt_state,
             xb, yb, vb):
    """One SVI step on the minibatch ``(xb, yb, vb)``: the negative ELBO
    (likelihood scaled to ``n_total`` rows) and its gradient at the raw
    leaves, the optimizer's update, applied. Returns ``(leaves, opt_state,
    loss)``; nothing in it waits for the card."""
    def loss_fn(lv):
        return -model.elbo(svlfm.constrain(unflatten(lv, like)), xb, yb, vb, n_total=n_total)

    loss, grads = generic.value_and_grad(loss_fn, leaves)
    updates, opt_state = optimizer.update(grads, opt_state, leaves)
    return type(leaves)(*(p + u for p, u in zip(leaves, updates))), opt_state, loss


def fit(model: SparseSIMM, params: SVLFMParams, x, y, variances,
        config: SVTrainConfig = SVTrainConfig(), optimizer=None,
        init_state: Optional[tuple] = None, epoch_offset: int = 0,
        mesh=None) -> SVTrainResult:
    """Stochastic ELBO maximisation over row minibatches of
    bs = min(batch_size, N) rows, ceil(N / bs) steps an epoch.

    ``init_state``: ``(raw_params, opt_state)`` to continue an earlier run
    exactly; ``epoch_offset`` shifts the per-epoch shuffle stream so that
    resumed runs see the shuffles of an unsegmented run. ``optimizer``,
    when given, is final (built by :func:`make_optimizer`, so that its state
    matches ``init_state``). ``mesh`` (data-parallel SVI) is not yet
    ported."""
    if mesh is not None:
        raise NotImplementedError(
            "mesh=: data-parallel SVI is not yet ported (ROADMAP Queue 1 item 17)")
    n = x.shape[0]
    bs = min(config.batch_size, n)
    batches = -(-n // bs)
    if optimizer is None:
        optimizer = make_optimizer(config, params)
    y = y.reshape(-1)
    variances = variances.reshape(-1)

    if init_state is not None:
        raw, opt_state = init_state
    else:
        raw = svlfm.unconstrain(params)
        opt_state = optimizer.init(flatten(raw))
    leaves = flatten(raw)

    history = torch.empty((config.num_epochs, batches), dtype=x.dtype, device=x.device)
    for e in range(config.num_epochs):
        idx = _to_device(epoch_indices(config.seed, epoch_offset + e, n, bs), x.device)
        for b in range(batches):
            bidx = idx[b]
            leaves, opt_state, history[e, b] = svi_step(
                model, optimizer, raw, n, leaves, opt_state, x[bidx], y[bidx], variances[bidx])
    raw_final = unflatten(leaves, raw)
    return SVTrainResult(params=svlfm.constrain(raw_final), history=history,
                         raw_params=raw_final, opt_state=opt_state)


def fit_checkpointed(model: SparseSIMM, params: SVLFMParams, x, y, variances,
                     config: SVTrainConfig, directory: str, checkpoint_every: int = 10,
                     mesh=None) -> SVTrainResult:
    """Fault-tolerant SVI: :func:`fit` in ``checkpoint_every``-epoch
    segments, each followed by a checkpoint of (raw parameters, optimizer
    state, epoch) through ``training.checkpoint``; a rerun resumes exactly
    from the latest one (the epoch-keyed shuffle stream keeps the sequence
    of an unsegmented run)."""
    from dis_project_tpu_torch.training import checkpoint as ckpt

    optimizer = make_optimizer(config, params)
    raw = svlfm.unconstrain(params)
    opt_state = optimizer.init(flatten(raw))
    epoch = 0

    latest = ckpt.latest_step(directory)
    if latest is not None and latest > 0:
        restored = ckpt.restore(directory, latest,
                                template={"raw": raw, "opt_state": opt_state, "epoch": 0})
        raw, opt_state = restored["raw"], restored["opt_state"]
        epoch = int(restored["epoch"])

    histories = []
    while epoch < config.num_epochs:
        seg = min(checkpoint_every, config.num_epochs - epoch)
        result = fit(model, params, x, y, variances,
                     dataclasses.replace(config, num_epochs=seg), optimizer=optimizer,
                     init_state=(raw, opt_state), epoch_offset=epoch, mesh=mesh)
        raw, opt_state = result.raw_params, result.opt_state
        epoch += seg
        histories.append(result.history)
        ckpt.save(directory, {"raw": raw, "opt_state": opt_state, "epoch": epoch}, step=epoch)

    history = (torch.cat(histories, dim=0) if histories
               else torch.zeros((0, 1), dtype=x.dtype, device=x.device))
    return SVTrainResult(params=svlfm.constrain(raw), history=history, raw_params=raw,
                         opt_state=opt_state)
