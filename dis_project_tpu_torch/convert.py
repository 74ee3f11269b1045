"""Carry parameters, data and training state, as numpy, into the port.

The JAX package's arrays leave it as numpy (``np.asarray``); these helpers
turn them into the port's tensors on a device, so one set of inputs can be
run through both packages, and a JAX run (its raw parameters, optax's Adam
state, its guard carry) can be continued by the port.
"""

from __future__ import annotations

import numpy as np
import torch

from dis_project_tpu_torch.models.delaysimm import DelaySIMMParams
from dis_project_tpu_torch.models.multisimm import MultiSIMMParams
from dis_project_tpu_torch.models.simm import SIMMParams
from dis_project_tpu_torch.models.simm2 import SIMM2Params
from dis_project_tpu_torch.ops.precision import PARITY_DTYPE, default_device


def _named(cls, mapping, device, dtype):
    dev = default_device(device)
    return cls(**{
        name: torch.as_tensor(np.array(mapping[name]), dtype=dtype, device=dev)
        for name in cls._fields
    })


def params_from_numpy(mapping, device=None, dtype=PARITY_DTYPE) -> SIMMParams:
    """:class:`SIMMParams` from a mapping with the five field names
    (e.g. ``jax_params._asdict()``); values are array-likes."""
    return _named(SIMMParams, mapping, device, dtype)


def simm2_params_from_numpy(mapping, device=None, dtype=PARITY_DTYPE) -> SIMM2Params:
    """:class:`SIMM2Params` (the second-order family) from a mapping with its
    six field names (e.g. ``jax_params._asdict()``); values are array-likes."""
    return _named(SIMM2Params, mapping, device, dtype)


def multisimm_params_from_numpy(mapping, device=None, dtype=PARITY_DTYPE) -> MultiSIMMParams:
    """:class:`MultiSIMMParams` (the R-force family) from a mapping with its
    five field names; values are array-likes (sensitivity (G, R),
    lengthscale (R,))."""
    return _named(MultiSIMMParams, mapping, device, dtype)


def delaysimm_params_from_numpy(mapping, device=None, dtype=PARITY_DTYPE) -> DelaySIMMParams:
    """:class:`DelaySIMMParams` (the delayed-response family) from a mapping
    with its six field names; values are array-likes."""
    return _named(DelaySIMMParams, mapping, device, dtype)


def arrays_from_numpy(X, y, var, device=None, dtype=PARITY_DTYPE):
    """``(X, y, variances)`` tensors from array-likes; y and variances
    flattened to 1-D, as ``train_arrays`` returns them."""
    dev = default_device(device)

    def t(a):
        return torch.as_tensor(np.array(a), dtype=dtype, device=dev)

    return t(X), t(y).reshape(-1), t(var).reshape(-1)


def adam_state_from_numpy(count, mu, nu, device=None, dtype=PARITY_DTYPE):
    """The port's ``generic.AdamState`` from optax's Adam state
    (``ScaleByAdamState``: ``count``, ``mu``, ``nu``): ``mu`` and ``nu``
    are mappings with the five :class:`SIMMParams` field names (e.g.
    ``state.mu._asdict()``), values array-likes."""
    from dis_project_tpu_torch.training.generic import AdamState

    return AdamState(int(np.asarray(count)), params_from_numpy(mu, device, dtype),
                     params_from_numpy(nu, device, dtype))


def guard_from_numpy(good_raw, good_adam, streak, count, device=None, dtype=PARITY_DTYPE):
    """The port's ``(good, streak, count)`` guard carry from the JAX
    package's: ``good_raw`` a mapping of raw parameters by field name,
    ``good_adam`` a ``(count, mu, nu)`` triple as for
    :func:`adam_state_from_numpy`."""
    good = (params_from_numpy(good_raw, device, dtype),
            adam_state_from_numpy(*good_adam, device=device, dtype=dtype))
    return good, int(np.asarray(streak)), int(np.asarray(count))


def nlfm_params_from_numpy(mapping, device=None, dtype=PARITY_DTYPE):
    """The nonlinear family's ``NLFMParams`` from a mapping with
    ``kinetics`` (a mapping of the five :class:`SIMMParams` field names,
    e.g. ``jax_params.kinetics._asdict()``) and ``w`` (the (Q,) whitened
    force); values are array-likes."""
    from dis_project_tpu_torch.models.nlfm import NLFMParams

    return NLFMParams(params_from_numpy(mapping["kinetics"], device, dtype),
                      torch.as_tensor(np.array(mapping["w"]), dtype=dtype,
                                      device=default_device(device)))


def svlfm_params_from_numpy(mapping, device=None, dtype=PARITY_DTYPE):
    """The sparse family's ``SVLFMParams`` from a mapping with ``kinetics``
    (a mapping of the kinetics' field names, e.g.
    ``jax_params.kinetics._asdict()``), ``z``, ``q_mu`` and ``q_sqrt``;
    values are array-likes. The kinetics' type follows their fields:
    ``alpha`` makes ``SIMM2Params``, a 2-D sensitivity ``MultiSIMMParams``,
    anything else ``SIMMParams``."""
    from dis_project_tpu_torch.models.svlfm import SVLFMParams

    kin = mapping["kinetics"]
    if "alpha" in kin:
        kinetics = simm2_params_from_numpy(kin, device, dtype)
    elif np.ndim(kin["sensitivity"]) == 2:
        kinetics = multisimm_params_from_numpy(kin, device, dtype)
    else:
        kinetics = params_from_numpy(kin, device, dtype)
    dev = default_device(device)
    return SVLFMParams(kinetics, *(
        torch.as_tensor(np.array(mapping[f]), dtype=dtype, device=dev)
        for f in ("z", "q_mu", "q_sqrt")))


def sv_adam_state_from_numpy(count, mu, nu, train_z: bool = True, device=None,
                             dtype=PARITY_DTYPE):
    """The port's SVI Adam state (``training.svtrainer.make_optimizer``'s)
    from optax's ``ScaleByAdamState`` over ``SVLFMParams``: ``mu`` and
    ``nu`` are mappings as for :func:`svlfm_params_from_numpy`. With
    ``train_z=False`` (z frozen by ``optax.multi_transform``) they hold no
    ``z``, and neither does the port's state."""
    from dis_project_tpu_torch.training import svtrainer
    from dis_project_tpu_torch.training.generic import AdamState

    def leaves(m):
        m = {**m, "z": m.get("z", np.zeros(0))}
        return svtrainer.flatten(svlfm_params_from_numpy(m, device, dtype), train_z)

    return AdamState(int(np.asarray(count)), leaves(mu), leaves(nu))


def hmc_draws_from_numpy(momenta, jitter, accept, device=None, dtype=PARITY_DTYPE):
    """One HMC phase's ``training.hmc.HMCDraws`` from array-likes: momenta
    (n, C, d) standard normals, jitter (n, C) step-size factors, accept (n,
    C) uniforms (e.g. the JAX package's draws of ``sample``'s keys). Tables
    of one chain may come without the chain axis: (n, d), (n,), (n,)."""
    from dis_project_tpu_torch.training.hmc import HMCDraws

    dev = default_device(device)
    momenta, jitter, accept = (np.array(a) for a in (momenta, jitter, accept))
    if momenta.ndim == 2:
        momenta, jitter, accept = momenta[:, None], jitter[:, None], accept[:, None]
    return HMCDraws(*(torch.as_tensor(a, dtype=dtype, device=dev)
                      for a in (momenta, jitter, accept)))
