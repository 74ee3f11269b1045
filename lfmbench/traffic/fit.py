"""Traffic kind ``fit``: whole Adam fits through ``main.fit_dense_adam``.

Set-up builds the family's objective once and drives the fit's call from
the starting parameters for 1 and for ``checked_steps`` steps: the first
gradient (from Adam's state after one step), the losses and the
parameters' change, which the reference follows. The window runs whole
fits of ``steps`` steps at ``learning_rate``, back to back, each from the
same starting parameters, and ends at the end of the fit during which the
window's seconds pass. ``train_step_ms`` is the window over all its steps.

The comparison (``check``): each checked step's loss, relative to the
reference's; and, by the worst leaf, the gap between the program's and the
reference's norms of the first gradient and of the change, over the
reference's norm of that leaf or of the median leaf, whichever is larger.
Leaves whose reference gradient is under a thousandth of the median
leaf's are left out of both.
"""

from __future__ import annotations

import math
import statistics

import torch
from torch.profiler import record_function

from lfmbench import faults, inputs
from lfmbench.trace import WINDOW_SPAN
from lfmbench.reference import common, linalg

# optax.adam's first-moment decay, which main.fit_dense_adam's Adam keeps:
# its state after one step holds (1 - B1) g.
B1 = common.B1
NEGLIGIBLE = 1e-3
# The mix at the size the benchmark's CPU tests run it.
TINY = {"steps": 5}


def setup(family, cfg, mix, inp):
    from dis_project_tpu_torch.main import fit_dense_adam

    objective = family.objective(cfg, inp)
    raw0 = family.raw_params(inp["raw0"])
    steps, lr = mix["steps"], mix["learning_rate"]
    _, state1, _, _, _ = fit_dense_adam(objective, raw0, 1, lr)
    raw_n, _, losses, _, _ = fit_dense_adam(objective, raw0, mix["checked_steps"], lr)
    names = list(family.leaves(raw0))
    first = {
        "losses": [float(x) for x in losses],
        "grad": {k: (m / (1.0 - B1)).double().cpu() for k, m in zip(names, state1.mu)},
        "change": {k: (a - b).double().cpu() for (k, a), b in
                   zip(family.leaves(raw_n).items(), family.leaves(raw0).values())},
    }

    def fit():
        with record_function("lfmbench.fit"):
            return fit_dense_adam(objective, raw0, steps, lr)[2]

    return {"run": fit, "first": first, "steps": steps}


def window(state, seconds: float, clock, sync):
    fits = failed = 0
    with record_function(WINDOW_SPAN):
        t0 = clock()
        while True:
            losses = state["run"]()
            fits += 1
            failed += not all(math.isfinite(x) for x in losses)
            if clock() - t0 >= seconds:
                break
        sync()
        span = clock() - t0
    steps = fits * state["steps"]
    return {"window_s": span, "units": steps, "attempted": fits, "failed": failed,
            "metrics": {"train_step_ms": 1e3 * span / steps}}


def free(state):
    state.pop("run", None)


def leaf_gaps(prog, ref, ref_grad):
    """Each counted leaf's norm gap over max(its norm, the median leaf's)."""
    gnorm = {k: float(v.norm()) for k, v in ref_grad.items()}
    med_g = statistics.median(gnorm.values())
    keep = [k for k in ref if gnorm[k] >= NEGLIGIBLE * med_g]
    rn = {k: float(ref[k].double().norm()) for k in keep}
    med = statistics.median(rn.values())
    gaps = {k: abs(float(prog[k].double().norm()) - rn[k]) / max(rn[k], med) for k in keep}
    return {k: g if math.isfinite(g) else math.inf for k, g in gaps.items()}


def compare(prog, ref):
    """The numbers compared: ``loss``, ``grad``, ``change``."""
    loss = max(abs(p - r) / abs(r) for p, r in zip(prog["losses"], ref["losses"]))
    return {
        "loss": loss if math.isfinite(loss) else math.inf,
        "grad": max(leaf_gaps(prog["grad"], ref["grad"], ref["grad"]).values()),
        "change": max(leaf_gaps(prog["change"], ref["change"], ref["grad"]).values()),
    }


def reference_steps(ref_family, cfg, mix, inp, precise: bool = True):
    """The reference's first steps: float64 (``precise``), or in the
    control's precision (``linalg.control_precision``)."""
    dt, tf32 = (torch.float64, False) if precise else linalg.control_precision(cfg["dtype"])
    raw0 = {k: v.to(dt) for k, v in inp["raw064"].items()}
    train = ref_family.Train(inputs.reference_view(inp, dt))
    out = common.first_steps(ref_family, train, raw0, inp["y64"].to(dt),
                             cfg["jitter"], mix["learning_rate"], mix["checked_steps"],
                             tf32=tf32)
    out["grad"] = {k: v.double().cpu() for k, v in out["grad"].items()}
    out["change"] = {k: v.double().cpu() for k, v in out["change"].items()}
    return out


def check(state, ref_family, cfg, mix, inp, seed: int):
    ref = reference_steps(ref_family, cfg, mix, inp)
    return compare(state["first"], ref)


def readings(emit, family, ref_family, cfg, mix, inp, seed: int, control: bool, fault_kinds,
             seconds: float, sync):
    """``lfmbench.calibrate``'s readings of one seed: set-up through the
    fit's own call, with each leaf's gaps and norms beside the numbers."""
    ref = reference_steps(ref_family, cfg, mix, inp)

    def leaves(first):
        return {"grad": leaf_gaps(first["grad"], ref["grad"], ref["grad"]),
                "change": leaf_gaps(first["change"], ref["change"], ref["grad"]),
                "norms": {part: {k: float(v.double().norm()) for k, v in first[part].items()}
                          for part in ("grad", "change")},
                "losses": first["losses"]}

    first = setup(family, cfg, mix, inp)["first"]
    row = emit("program", compare(first, ref))
    row["leaves"] = leaves(first)
    row["reference"] = {"norms": {part: {k: float(v.double().norm()) for k, v in
                                         ref[part].items()} for part in ("grad", "change")},
                        "losses": ref["losses"]}
    if control:
        ctrl = reference_steps(ref_family, cfg, mix, inp, precise=False)
        emit("control", compare(ctrl, ref))["leaves"] = leaves(ctrl)
    for f in fault_kinds:
        with faults.plant(f, family):
            emit(f, compare(setup(family, cfg, mix, inp)["first"], ref))
