"""The second-order family's entry in ``dis_project_tpu_torch``.

The fit's objective is ``main.run_dense_second_order``'s Cholesky route:
``-SecondOrderSIMM(num_genes, jitter).mll_gridded`` at
``simm2.constrain(raw)`` on the time grid: the table Gram over
``erf_complex``, cuSOLVER's factor and the MLL's custom backward, in the
configuration's dtype.
"""

from __future__ import annotations

import functools

from torch.profiler import record_function

from lfmbench import faults

FAULTS = {kind: functools.partial(faults.dense, kind) for kind in faults.KINDS}


def _simm2():
    from dis_project_tpu_torch.models import simm2

    return simm2


def raw_params(raw: dict):
    return _simm2().SIMM2Params(**raw)


def leaves(tree) -> dict:
    return dict(tree._asdict())


def objective(cfg, inp):
    simm2 = _simm2()
    model = simm2.SecondOrderSIMM(num_genes=cfg["genes"], jitter=cfg["jitter"])
    t, y = inp["t"], inp["y"]

    def negative_mll(raw):
        with record_function("lfmbench.objective"):
            return -model.mll_gridded(simm2.constrain(raw), t, y)

    return negative_mll
