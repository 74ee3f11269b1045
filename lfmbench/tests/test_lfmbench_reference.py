"""The plain reference against the port's CPU path at a tiny size, in
float64, and the control's TF32 rounding. (The tests may import the port;
the reference itself never does.)"""

import pytest
import torch

from lfmbench import inputs
from lfmbench.reference import common, linalg
from lfmbench.reference import simm as ref_simm
from lfmbench.reference import simm2 as ref_simm2

F64 = torch.float64
CFG1 = {"family": "simm", "dtype": "float32", "genes": 3, "timepoints": 8, "t_max": 12.0,
        "jitter": 1e-4,
        "noise_std": 0.1, "start_spread": 0.1,
        "truth": {"basal": [0.01, 0.1], "sensitivity": [0.5, 1.5], "decay": [0.2, 1.0],
                  "lengthscale": 2.5},
        "start": {"basal": 0.05, "sensitivity": 1.0, "decay": 0.4, "lengthscale": 2.5,
                  "obs_stddev": 1.0}}
CFG2 = dict(CFG1, family="simm2",
            truth={"basal": [0.01, 0.1], "sensitivity": [0.5, 1.5], "alpha": [0.2, 0.8],
                   "omega": [0.6, 1.6], "lengthscale": 2.5},
            start={"basal": 0.05, "sensitivity": 1.0, "alpha": 0.4, "omega": 1.0,
                   "lengthscale": 2.0, "obs_stddev": 1.0})
FIT = {"kind": "fit"}
PREDICT = {"kind": "predict", "test_times": 5, "test_t_max": 13.0, "draws": 4, "spread": 0.05,
           "base_obs_stddev": 0.35}


def _port_loss_and_grad(objective, raw_tuple):
    leaves = [v.detach().clone().requires_grad_(True) for v in raw_tuple]
    loss = objective(type(raw_tuple)(*leaves))
    grads = torch.autograd.grad(loss, leaves)
    return float(loss.detach()), list(grads)


@pytest.mark.parametrize("seed", [3, 2**31 + 7])
def test_first_order_mll_and_gradient(seed):
    from dis_project_tpu_torch.models import simm

    inp = inputs.make(CFG1, FIT, ref_simm, seed, torch.device("cpu"))
    X, y = inp["X64"], inp["y64"]
    model = simm.ExactSIMM(num_genes=3, jitter=1e-4, canonical_rows=True, kernels=False)
    raw = simm.SIMMParams(**inp["raw064"])
    loss, grads = _port_loss_and_grad(lambda r: -model.mll(simm.constrain(r), X, y), raw)
    rloss, rgrads = common.loss_and_grad(ref_simm, ref_simm.Train(inputs.reference_view(inp)),
                                         inp["raw064"], y, 1e-4)
    assert float(rloss) == pytest.approx(loss, rel=1e-11)
    for name, g in zip(raw._fields, grads):
        torch.testing.assert_close(rgrads[name], g, rtol=1e-8, atol=1e-10)


@pytest.mark.parametrize("seed", [4, 2**31 + 9])
def test_second_order_mll_and_gradient(seed):
    from dis_project_tpu_torch.models import simm2

    inp = inputs.make(CFG2, FIT, ref_simm2, seed, torch.device("cpu"))
    # a float64 grid: the port's table Gram holds a float64 grid to float64's uniformity
    t, y = torch.linspace(0.0, 12.0, 8, dtype=F64), inp["y64"]
    inp["t64"] = t
    model = simm2.SecondOrderSIMM(num_genes=3, jitter=1e-4, kernels=False)
    raw = simm2.SIMM2Params(**inp["raw064"])
    loss, grads = _port_loss_and_grad(lambda r: -model.mll_gridded(simm2.constrain(r), t, y), raw)
    rloss, rgrads = common.loss_and_grad(ref_simm2, ref_simm2.Train(inputs.reference_view(inp)),
                                         inp["raw064"], y, 1e-4)
    assert float(rloss) == pytest.approx(loss, rel=1e-10)
    for name, g in zip(raw._fields, grads):
        torch.testing.assert_close(rgrads[name], g, rtol=1e-7, atol=1e-9)


def test_posterior_matches_multi_gene_predict():
    from dis_project_tpu_torch.models import simm

    inp = inputs.make(CFG1, PREDICT, ref_simm, 11, torch.device("cpu"))
    model = simm.ExactSIMM(num_genes=3, jitter=1e-4, canonical_rows=True, kernels=False)
    for k in range(2):
        p = {name: v[k] for name, v in inp["draws64"].items()}
        post = model.multi_gene_predict(simm.SIMMParams(**p), inp["test64"], inp["X64"],
                                        inp["y64"], inp["var64"])
        mu, var = ref_simm.predict(p, inp["X64"], inp["y64"], inp["var64"], inp["test64"],
                                   1e-4)
        torch.testing.assert_close(mu, post.mean, rtol=1e-9, atol=1e-11)
        torch.testing.assert_close(var, torch.diagonal(post.cov), rtol=1e-8, atol=1e-11)


def test_blocked_cholesky_is_the_factor():
    a = torch.randn(600, 600, dtype=F64)
    s = a @ a.T + 600 * torch.eye(600, dtype=F64)
    torch.testing.assert_close(linalg.cholesky_(s.clone()), torch.linalg.cholesky(s))


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.randn(10_000, dtype=torch.float32) * 100
    r = linalg.to_tf32(x)
    assert int((r.view(torch.int32) & 0x1FFF).abs().sum()) == 0
    assert float(((r - x).abs() / x.abs()).max()) <= 2.0**-11
    assert float(linalg.to_tf32(torch.tensor([1.0 + 2.0**-11]))) == 1.0 + 2.0**-10


def test_the_control_fails_where_the_program_holds():
    """The control of a float64 cell (the reference in float32) against the
    program (the port on the CPU in float64) on the first steps of a fit at
    N = 320: the program sits within the cell's limits, the control fails
    them by orders of magnitude."""
    import json
    from pathlib import Path

    from lfmbench.families import simm as fam
    from lfmbench.traffic import fit

    limits = json.loads((Path(__file__).resolve().parents[1] / "workloads"
                         / "simm-dense10k-f64.train.json").read_text())["limits"]
    cfg = dict(CFG1, dtype="float64", genes=8, timepoints=40)
    mix = {"kind": "fit", "steps": 3, "learning_rate": 0.01, "checked_steps": 3}
    inp = inputs.make(cfg, mix, ref_simm, 21, torch.device("cpu"))
    ref = fit.reference_steps(ref_simm, cfg, mix, inp)
    program = fit.compare(fit.setup(fam, cfg, mix, inp)["first"], ref)
    control = fit.compare(fit.reference_steps(ref_simm, cfg, mix, inp, precise=False), ref)
    assert all(program[k] <= limits[k] for k in limits), program
    assert any(control[k] > 100 * limits[k] for k in limits), control


def test_the_tf32_control_of_a_float32_cell_departs():
    """For a float32 configuration the control takes TF32 products: its
    first gradient at N = 320 is off by far more than float32's."""
    from lfmbench.traffic import fit

    cfg = dict(CFG1, genes=8, timepoints=40)
    mix = {"kind": "fit", "learning_rate": 0.01, "checked_steps": 2}
    inp = inputs.make(cfg, mix, ref_simm, 21, torch.device("cpu"))
    ref = fit.reference_steps(ref_simm, cfg, mix, inp)
    train32 = ref_simm.Train(inputs.reference_view(inp, torch.float32))
    plain = common.first_steps(ref_simm, train32, {k: v.float() for k, v in inp["raw064"].items()},
                               inp["y64"].float(), 1e-4, 0.01, 2)
    plain = {"losses": plain["losses"], "grad": {k: v.double() for k, v in plain["grad"].items()},
             "change": {k: v.double() for k, v in plain["change"].items()}}
    control = fit.reference_steps(ref_simm, cfg, mix, inp, precise=False)
    assert fit.compare(control, ref)["grad"] > 30 * fit.compare(plain, ref)["grad"]
