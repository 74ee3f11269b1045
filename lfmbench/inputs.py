"""The benchmark's inputs, made on the device from ``--seed``.

One ``torch.Generator`` on the device, in a few large calls: the ground
truth's kinetics (uniform in the configuration's ranges), one exact draw
from the family's prior at that truth (the reference's covariance, float64)
plus observation noise, the fit's starting parameters (the configuration's
start, each entry scaled by ``exp(spread * U(-1, 1))``) and, for a
prediction mix, the hyperparameters of every request (the truth with the
mix's ``base_obs_stddev``, each entry scaled by ``exp(spread * N(0, 1))``).
Every seed gives the same sizes; only the values change.

The program gets tensors in the configuration's ``dtype``; the reference
gets the same values widened to float64, so both start from identical
inputs.
"""

from __future__ import annotations

import torch

from lfmbench.reference import common

F64 = torch.float64


def _rows(times, genes, device):
    t = times.repeat(genes)
    g = torch.arange(genes, dtype=times.dtype, device=device).repeat_interleave(times.shape[0])
    return torch.stack([t, g, torch.ones_like(t)], dim=-1)


def make(cfg, mix, family, seed: int, device):
    """A dict of the cell's inputs: ``X``, ``y``, ``t``, ``var`` and ``raw0``
    (a dict of raw leaves) in the configuration's dtype for the program,
    each also as float64 under ``<name>64`` for the reference; with a prediction mix also
    ``test``/``test64`` and ``draws``/``draws64`` (a dict of leaves, one row
    a request)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    G, T = cfg["genes"], cfg["timepoints"]
    n = G * T
    dt = getattr(torch, cfg["dtype"])
    t = torch.linspace(0.0, cfg["t_max"], T, dtype=dt, device=device)
    X = _rows(t, G, device)
    inp = {"genes": G, "t": t, "X": X}

    truth = {}
    for k, v in cfg["truth"].items():
        if isinstance(v, list):
            truth[k] = v[0] + (v[1] - v[0]) * torch.rand(G, generator=gen, dtype=F64, device=device)
        else:
            truth[k] = torch.tensor(float(v), dtype=F64, device=device)
    ref64 = {"genes": G, "t": t.to(F64), "X": X.to(F64)}
    with torch.no_grad():
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

    if mix["kind"] == "predict":
        tt = torch.linspace(0.0, mix["test_t_max"], mix["test_times"], dtype=dt, device=device)
        inp["test"] = _rows(tt, G, device)
        base = dict(truth, obs_stddev=torch.tensor(mix["base_obs_stddev"], dtype=F64,
                                                   device=device))
        k = mix["draws"]
        inp["draws"] = {
            name: (base[name] * torch.exp(mix["spread"] * torch.randn(
                (k,) + tuple(base[name].shape), generator=gen, dtype=F64, device=device))).to(dt)
            for name in family.LEAVES}
    for name in ("t", "X", "y", "var", "test"):
        if name in inp:
            inp[name + "64"] = inp[name].to(F64)
    inp["raw064"] = {k: v.to(F64) for k, v in inp["raw0"].items()}
    if "draws" in inp:
        inp["draws64"] = {k: v.to(F64) for k, v in inp["draws"].items()}
    return inp


def reference_view(inp, dtype=F64):
    """The reference's copy of the inputs, in ``dtype``, under the names
    the reference families read."""
    return {"genes": inp["genes"], "t": inp["t64"].to(dtype), "X": inp["X64"].to(dtype)}
