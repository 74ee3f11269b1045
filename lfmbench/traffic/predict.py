"""Traffic kind ``predict``: expression posteriors, one request at a time,
in a closed loop.

Request k asks for the posterior at the mix's test rows under the k-th
hyperparameter draw of the inputs (as a BMA predictive asks for one
prediction per component), so nothing carries over between requests. A
request ends when its mean and covariance diagonal are on the host. Set-up
answers one request (draw 0, which the window does not reuse first). The
window ends at the end of the request during which its seconds pass;
``predict_ms`` is the window over all requests, ``predict_p95_ms`` the 95th
percentile of every request's latency.

The inputs (``draw_inputs``): the test rows, ``test_times`` points on
``[0, test_t_max]`` for every gene, and ``draws`` hyperparameter draws, the
truth with the mix's ``base_obs_stddev``, each entry scaled by
``exp(spread * N(0, 1))``.

The comparison (``check``): on ``checked`` requests drawn from the seed,
the widest gap of the posterior mean over the largest reference mean, and
of the covariance diagonal over the largest reference variance.
"""

from __future__ import annotations

import math
import time

import torch
from torch.profiler import record_function

from lfmbench import faults, inputs
from lfmbench.reference import linalg
from lfmbench.trace import WINDOW_SPAN

F64 = torch.float64
# The mix at the size the benchmark's CPU tests run it.
TINY = {"test_times": 10, "draws": 16, "checked": 3}


def draw_inputs(cfg, mix, family, truth, gen, dt, device):
    """``test`` (rows) and ``draws`` (a dict of leaves, one row a request)."""
    G = cfg["genes"]
    tt = torch.linspace(0.0, mix["test_t_max"], mix["test_times"], dtype=dt, device=device)
    base = dict(truth, obs_stddev=torch.tensor(mix["base_obs_stddev"], dtype=F64,
                                               device=device))
    k = mix["draws"]
    return {"test": inputs.rows(tt, G, device), "draws": {
        name: (base[name] * torch.exp(mix["spread"] * torch.randn(
            (k,) + tuple(base[name].shape), generator=gen, dtype=F64, device=device))).to(dt)
        for name in family.LEAVES}}


def setup(family, cfg, mix, inp):
    request = family.predictor(cfg, inp)
    request(0).cpu()
    return {"request": request, "draws": mix["draws"], "answers": {}}


def window(state, seconds: float, clock, sync):
    request, answers, latencies = state["request"], state["answers"], []
    k = 0
    with record_function(WINDOW_SPAN):
        t0 = clock()
        while True:
            k += 1
            ts = clock()
            with record_function("lfmbench.request"):
                answers[k] = request(k % state["draws"]).cpu()
            latencies.append(clock() - ts)
            if clock() - t0 >= seconds:
                break
        sync()
        span = clock() - t0
    failed = sum(not bool(torch.isfinite(a).all()) for a in answers.values())
    ranked = sorted(latencies)
    p95 = ranked[max(0, math.ceil(0.95 * len(ranked)) - 1)]
    return {"window_s": span, "units": k, "attempted": k, "failed": failed,
            "metrics": {"predict_ms": 1e3 * span / k, "predict_p95_ms": 1e3 * p95}}


def free(state):
    state.pop("request", None)


def sample(state, mix, seed: int):
    """The requests checked: ``checked`` of those answered, drawn from the seed."""
    done = sorted(state["answers"])
    gen = torch.Generator().manual_seed(int(seed) + 1)
    pick = torch.randperm(len(done), generator=gen)[:mix["checked"]].tolist()
    return [done[i] for i in sorted(pick)]


def reference_answer(ref_family, cfg, inp, k: int, precise: bool = True):
    """The reference's answer to request k: float64 (``precise``), or in
    the control's precision (``linalg.control_precision``)."""
    dt, tf32 = (torch.float64, False) if precise else linalg.control_precision(cfg["dtype"])
    p = {name: v[k].to(dt) for name, v in inp["draws64"].items()}
    mu, var = ref_family.predict(p, inp["X64"].to(dt), inp["y64"].to(dt), inp["var64"].to(dt),
                                 inp["test64"].to(dt), cfg["jitter"], tf32=tf32)
    return torch.stack([mu, var]).double().cpu()


def compare_one(answer, ref):
    a = answer.double()
    gaps = [float((a[i] - ref[i]).abs().max() / ref[i].abs().max()) for i in (0, 1)]
    return [g if math.isfinite(g) else math.inf for g in gaps]


def check(state, ref_family, cfg, mix, inp, seed: int):
    worst = [0.0, 0.0]
    for k in sample(state, mix, seed):
        d = k % state["draws"]
        gaps = compare_one(state["answers"][k], reference_answer(ref_family, cfg, inp, d))
        worst = [max(w, g) for w, g in zip(worst, gaps)]
    return {"mean": worst[0], "var": worst[1]}


def readings(emit, family, ref_family, cfg, mix, inp, seed: int, control: bool, fault_kinds,
             seconds: float, sync):
    """``lfmbench.calibrate``'s readings of one seed: a window of
    ``seconds`` at the cell's own load, the checked requests drawn as a run
    draws them; the worst gaps, and each over the reference's standard
    deviation (``mean_z``) and variance (``var_rel``)."""
    def run():
        state = setup(family, cfg, mix, inp)
        window(state, seconds, time.perf_counter, sync)
        return state

    refs = {}

    def ref(k, precise=True):
        if precise and k in refs:
            return refs[k]
        a = reference_answer(ref_family, cfg, inp, k % mix["draws"], precise)
        if precise:
            refs[k] = a
        return a

    def worst(answers, picks):
        gaps = [compare_one(answers[k], ref(k)) for k in picks]
        z = [float(((answers[k][0].double() - ref(k)[0]).abs() / ref(k)[1].sqrt()).max())
             for k in picks]
        rv = [float(((answers[k][1].double() - ref(k)[1]).abs() / ref(k)[1]).max())
              for k in picks]
        return {"mean": max(g[0] for g in gaps), "var": max(g[1] for g in gaps),
                "mean_z": max(z), "var_rel": max(rv)}

    state = run()
    picks = sample(state, mix, seed)
    emit("program", worst(state["answers"], picks))
    if control:
        emit("control", worst({k: ref(k, precise=False) for k in picks}, picks))
    for f in fault_kinds:
        with faults.plant(f, family):
            state = run()
        emit(f, worst(state["answers"], sample(state, mix, seed)))
