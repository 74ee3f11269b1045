"""The first-order family's entries in ``dis_project_tpu_torch``.

The fit's objective is the one ``main.run_dense`` builds for
``--preset dense10k`` on the Cholesky engine in float64:
``-ExactSIMM(num_genes, jitter, canonical_rows=True).mll_gridded`` at
``simm.constrain(raw)`` on the time grid (the table Gram, which
``main.dense_gram`` picks everywhere but on the card in float32), then
cuSOLVER's factor and the MLL's custom backward. A prediction is
``ExactSIMM.multi_gene_predict`` (K2 twice, K1, the factor, the solves).
"""

from __future__ import annotations

import functools

import torch
from torch.profiler import record_function

from lfmbench import faults

FAULTS = {kind: functools.partial(faults.dense, kind) for kind in faults.KINDS}


def _simm():
    from dis_project_tpu_torch.models import simm

    return simm


def _model(cfg):
    return _simm().ExactSIMM(num_genes=cfg["genes"], jitter=cfg["jitter"], canonical_rows=True)


def raw_params(raw: dict):
    return _simm().SIMMParams(**raw)


def leaves(tree) -> dict:
    return dict(tree._asdict())


def objective(cfg, inp):
    simm, model = _simm(), _model(cfg)
    t, y = inp["t"], inp["y"]

    def negative_mll(raw):
        with record_function("lfmbench.objective"):
            return -model.mll_gridded(simm.constrain(raw), t, y)

    return negative_mll


def predictor(cfg, inp):
    """``request(k)``: the posterior at the test rows under the k-th draw of
    hyperparameters, its mean and covariance diagonal stacked (2, M)."""
    simm, model = _simm(), _model(cfg)
    draws, test, X, y, var = inp["draws"], inp["test"], inp["X"], inp["y"], inp["var"]

    def request(k: int):
        p = simm.SIMMParams(**{name: v[k] for name, v in draws.items()})
        post = model.multi_gene_predict(p, test, X, y, var)
        return torch.stack([post.mean, torch.diagonal(post.cov)])

    return request
