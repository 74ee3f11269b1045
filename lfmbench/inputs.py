"""The benchmark's inputs, made on the device from ``--seed``.

One ``torch.Generator`` on the device, in a few large calls: the ground
truth's kinetics (uniform in the configuration's ranges), the expression
data at that truth, the fit's starting parameters (the configuration's
start, each entry scaled by ``exp(spread * U(-1, 1))``) and whatever the
traffic kind draws for itself (``traffic/<kind>.py``'s ``draw_inputs``, if
it has one: a prediction mix's test rows and the hyperparameters of every
request). Every seed gives the same sizes; only the values change.

The data's route is the configuration's ``data``:

- none (the default): one exact draw from the family's prior at the truth
  (the reference's covariance, float64, N x N) plus observation noise;
- ``"quadrature"``, with ``oversample``: the reference family's force
  drawn exactly on a grid and pushed through each gene's Green's function
  by quadrature (``reference.quadrature``), plus observation noise, for an
  N whose covariance would not fit.

The program gets tensors in the configuration's ``dtype``; the reference
gets the same values widened to float64, so both start from identical
inputs.
"""

from __future__ import annotations

import importlib

import torch

from lfmbench.reference import common, quadrature

F64 = torch.float64


def rows(times, genes, device):
    t = times.repeat(genes)
    g = torch.arange(genes, dtype=times.dtype, device=device).repeat_interleave(times.shape[0])
    return torch.stack([t, g, torch.ones_like(t)], dim=-1)


def make(cfg, mix, family, seed: int, device):
    """A dict of the cell's inputs: ``X``, ``y``, ``t``, ``var`` and ``raw0``
    (a dict of raw leaves) in the configuration's dtype for the program, and
    what the traffic kind draws (a prediction mix: ``test`` and ``draws``, a
    dict of leaves, one row a request); each floating tensor, alone or in a
    dict, also as float64 under ``<name>64`` for the reference."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    G, T = cfg["genes"], cfg["timepoints"]
    n = G * T
    dt = getattr(torch, cfg["dtype"])
    t = torch.linspace(0.0, cfg["t_max"], T, dtype=dt, device=device)
    X = rows(t, G, device)
    inp = {"genes": G, "t": t, "X": X}

    truth = {}
    for k, v in cfg["truth"].items():
        if isinstance(v, list):
            truth[k] = v[0] + (v[1] - v[0]) * torch.rand(G, generator=gen, dtype=F64, device=device)
        else:
            truth[k] = torch.tensor(float(v), dtype=F64, device=device)
    ref64 = {"genes": G, "t": t.to(F64), "X": X.to(F64)}
    with torch.no_grad():
        if cfg.get("data") == "quadrature":
            y = quadrature.draw(family, truth, ref64, gen, cfg["t_max"], cfg["oversample"],
                                cfg["noise_std"])
        elif "data" in cfg:
            raise ValueError(f"unknown data route {cfg['data']!r}")
        else:
            cov = family.covariance(truth, ref64)
            cov.diagonal().add_(1e-9 * float(cov.diagonal().max()))
            chol = torch.linalg.cholesky(cov)
            del cov
            draws = torch.randn(2, n, generator=gen, dtype=F64, device=device)
            y = family.prior_mean(truth, ref64) + chol @ draws[0] + cfg["noise_std"] * draws[1]
            del chol
    inp["y"] = y.to(dt)
    inp["var"] = torch.full((n,), cfg["noise_std"] ** 2, dtype=dt, device=device)

    start = {}
    for k in family.LEAVES:
        v = torch.full(torch.Size([G]) if k in family.PER_GENE else torch.Size(),
                       float(cfg["start"][k]), dtype=F64, device=device)
        u = 2.0 * torch.rand(v.shape, generator=gen, dtype=F64, device=device) - 1.0
        start[k] = v * torch.exp(cfg["start_spread"] * u)
    inp["raw0"] = {k: v.to(dt) for k, v in common.unconstrain(start, family.BIJECTORS).items()}

    kind = importlib.import_module(f"lfmbench.traffic.{mix['kind']}")
    if hasattr(kind, "draw_inputs"):
        inp.update(kind.draw_inputs(cfg, mix, family, truth, gen, dt, device))
    for name, v in list(inp.items()):
        if isinstance(v, torch.Tensor) and v.is_floating_point():
            inp[name + "64"] = v.to(F64)
        elif isinstance(v, dict):
            inp[name + "64"] = {k: x.to(F64) for k, x in v.items() if x.is_floating_point()}
    return inp


def reference_view(inp, dtype=F64):
    """The reference's copy of the inputs, in ``dtype``, under the names
    the reference families read."""
    return {"genes": inp["genes"], "t": inp["t64"].to(dtype), "X": inp["X64"].to(dtype)}
