"""The inputs: the quadrature data route against the closed forms, its cost at
100 x 1000, and the exact route's inputs equal to the bit to its draw before
the routes."""

import importlib
import json
import subprocess
import sys

import pytest
import torch

from lfmbench import harness, inputs
from lfmbench.reference import common, quadrature
from lfmbench.reference import simm as ref_simm
from lfmbench.reference import simm2 as ref_simm2
from lfmbench.tests.test_lfmbench_harness import CELLS, ROOT, tiny

F64 = torch.float64
G, T, T_MAX = 3, 8, 12.0


def _params(family):
    v = lambda *x: torch.tensor(x, dtype=F64)  # noqa: E731
    p = {"basal": v(0.05, 0.02, 0.08), "sensitivity": v(0.7, 1.2, 1.0),
         "lengthscale": torch.tensor(2.5, dtype=F64)}
    if family is ref_simm:
        return dict(p, decay=v(0.2, 0.6, 1.0))
    return dict(p, alpha=v(0.2, 0.5, 0.8), omega=v(0.6, 1.1, 1.6))


def _gap(family, p, oversample):
    """The widest gap of the quadrature data's covariance, W K_ff W^T, from
    the closed form, over the largest closed-form entry."""
    t = torch.linspace(0.0, T_MAX, T, dtype=F64)
    exact = family.covariance(p, {"genes": G, "t": t, "X": inputs.rows(t, G, "cpu")})
    s, h = quadrature.grid(T_MAX, T, oversample)
    W = quadrature.response(family, p, slice(0, G), T, oversample, h).reshape(G * T, -1)
    kff = quadrature.force_cov(s, p["lengthscale"])
    kff.diagonal().add_(quadrature.JITTER)
    implied = W @ kff @ W.T
    return float((implied - exact).abs().max() / exact.abs().max())


K = 16
H = T_MAX / (K * (T - 1))
# The trapezoid rule's error is c h^2 + O(h^4), c of order the integrand's
# second derivative over the interval: at h = 12 / 112 the rule stays under
# h^2 / 12 of the largest covariance (it reads 0.42 of that in the first
# order, 0.73 in the second), and halving h divides the gap by 4, so the gap
# is the rule's alone and not a different model's.
TOLERANCE = H * H / 12


def _matches_the_closed_form(family, p):
    coarse, fine = _gap(family, p, K), _gap(family, p, 2 * K)
    return coarse <= TOLERANCE and 3.9 <= coarse / fine <= 4.1


@pytest.mark.parametrize("family", [ref_simm, ref_simm2], ids=["simm", "simm2"])
def test_the_quadrature_route_has_the_closed_forms_covariance(family):
    assert _matches_the_closed_form(family, _params(family))


@pytest.mark.parametrize("family, leaf", [(ref_simm, "decay"), (ref_simm2, "alpha")],
                         ids=["simm", "simm2"])
def test_a_wrong_greens_function_fails(family, leaf, monkeypatch):
    p = _params(family)
    green = family.green
    monkeypatch.setattr(family, "green",
                        lambda q, tau: green(dict(q, **{leaf: 2 * q[leaf]}), tau))
    assert not _matches_the_closed_form(family, p)
    assert _gap(family, p, K) > 100 * TOLERANCE


_BIG = """
import json, resource, sys, time
import torch
sys.path.insert(0, {root!r})
from lfmbench import inputs
from lfmbench.reference import {family} as ref
cfg = json.loads({cfg!r})
t0 = time.perf_counter()
a = inputs.make(cfg, {{"kind": "fit"}}, ref, {seed}, torch.device("cpu"))
s = time.perf_counter() - t0
b = inputs.make(cfg, {{"kind": "fit"}}, ref, {seed}, torch.device("cpu"))
c = inputs.make(cfg, {{"kind": "fit"}}, ref, {seed} + 1, torch.device("cpu"))
print(json.dumps({{"s": s, "rss": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024,
                  "n": a["y"].numel(), "finite": bool(torch.isfinite(a["y"]).all()),
                  "same": all(torch.equal(a[k], b[k]) for k in ("y", "X", "var"))
                  and all(torch.equal(a["raw0"][k], b["raw0"][k]) for k in a["raw0"]),
                  "differs": not torch.equal(a["y"], c["y"])}}))
"""


@pytest.mark.parametrize("family", ["simm", "simm2"])
def test_a_quadrature_configuration_at_100_by_1000_builds_on_the_cpu(family):
    cfg = json.loads((ROOT / "lfmbench" / "configs" / f"{family}-dense10k-f64.json").read_text())
    cfg.update(genes=100, timepoints=1000, data="quadrature", oversample=4)
    code = _BIG.format(root=str(ROOT), family=family, cfg=json.dumps(cfg), seed=2**31 + 99)
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["n"] == 100_000 and out["finite"] and out["same"] and out["differs"]
    # the exact draw's covariance alone is 1e5^2 x 8 B = 80 GB; this whole
    # process, torch and three draws included, stays under 2 GiB and a minute
    assert out["rss"] < 2 * 2**30
    assert out["s"] < 60.0


def test_an_unknown_data_route_is_refused():
    cell = tiny(harness.load_cell(CELLS[0]))
    with pytest.raises(ValueError, match="data route"):
        inputs.make(dict(cell.cfg, data="exactish"), cell.mix, ref_simm, 1, torch.device("cpu"))


def _exact_draw(cfg, mix, family, seed, device):
    """The exact route's inputs as they were drawn before the quadrature route
    and the traffic kinds' own inputs existed: the same generator, the same
    calls in the same order, written out here whole."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    G, T = cfg["genes"], cfg["timepoints"]
    n = G * T
    dt = getattr(torch, cfg["dtype"])

    def rows(times):
        t = times.repeat(G)
        g = torch.arange(G, dtype=times.dtype, device=device).repeat_interleave(times.shape[0])
        return torch.stack([t, g, torch.ones_like(t)], dim=-1)

    t = torch.linspace(0.0, cfg["t_max"], T, dtype=dt, device=device)
    X = rows(t)
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
        draws = torch.randn(2, n, generator=gen, dtype=F64, device=device)
        y = family.prior_mean(truth, ref64) + chol @ draws[0] + cfg["noise_std"] * draws[1]
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
        inp["test"] = rows(tt)
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


def _same(a, b) -> bool:
    """Equal to the bit, with the same dtype and shape, tensor by tensor."""
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and a.dtype == b.dtype and torch.equal(a, b)
    return a == b


# The draw and ``inputs.make`` run in one process with the same library
# calls, so their ``y`` (a LAPACK factor and a product) agree to the bit on
# any machine; every other tensor comes from the generator alone.
@pytest.mark.parametrize("name, seed", [(n, s) for n in CELLS for s in (2**31 + 5, 7)])
def test_the_exact_routes_inputs_are_the_draw_before_the_routes(name, seed):
    cell = tiny(harness.load_cell(name))
    ref = importlib.import_module(f"lfmbench.reference.{cell.cfg['family']}")
    cpu = torch.device("cpu")
    new, old = inputs.make(cell.cfg, cell.mix, ref, seed, cpu), _exact_draw(
        cell.cfg, cell.mix, ref, seed, cpu)
    assert new.keys() == old.keys()
    for k in old:
        assert _same(new[k], old[k]), k
