"""Carry parameters and data, as numpy, into the port.

The JAX package's arrays leave it as numpy (``np.asarray``); these helpers
turn them into the port's tensors on a device, so one set of inputs can be
run through both packages.
"""

from __future__ import annotations

import numpy as np
import torch

from dis_project_tpu_torch.models.simm import SIMMParams
from dis_project_tpu_torch.ops.precision import PARITY_DTYPE, default_device


def params_from_numpy(mapping, device=None, dtype=PARITY_DTYPE) -> SIMMParams:
    """:class:`SIMMParams` from a mapping with the five field names
    (e.g. ``jax_params._asdict()``); values are array-likes."""
    dev = default_device(device)
    return SIMMParams(**{
        name: torch.as_tensor(np.array(mapping[name]), dtype=dtype, device=dev)
        for name in SIMMParams._fields
    })


def arrays_from_numpy(X, y, var, device=None, dtype=PARITY_DTYPE):
    """``(X, y, variances)`` tensors from array-likes; y and variances
    flattened to 1-D, as ``train_arrays`` returns them."""
    dev = default_device(device)

    def t(a):
        return torch.as_tensor(np.array(a), dtype=dtype, device=dev)

    return t(X), t(y).reshape(-1), t(var).reshape(-1)
