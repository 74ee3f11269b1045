"""The port's semigroup smoothers (``parallel_rts_smoother``,
``blocked_rts_smoother``) and ``lfm_predict_ss`` under the associative-scan
and blocked schedules, held to the JAX package's same smoothers and
schedules and to the port's sequential ones, on the CPU in float64.

Smoothed moments are held at the floor that the sequential smoother's test
uses (``tests/test_torch_port_statespace.py``): 1e-9 or the JAX package's own
distance between its union and bridge routes on the same inputs, whichever
is larger (two LAPACK builds' ``eigh`` move the pseudo-solve gains by
~1e-9–1e-8). ``lfm_predict_ss`` under a semigroup schedule is held at that
floor or 1e-7, whichever is larger: 1e-7 is JAX's own limit between its
parallel and sequential smoothers (``tests/test_statespace.py``,
``TestParallelSmoother``), and the port's associative-scan union variance
measured 3.6e-8 from JAX's where that floor is 1.4e-8 (a union grid with
duplicate times, whose dt = 0 steps the pseudo-solve cuts). The JAX
references compile at XLA's lowest CPU optimisation level.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dis_project_tpu.models import simm as jsimm
from dis_project_tpu.ops import statespace as jss
from dis_project_tpu_torch import convert
from dis_project_tpu_torch.ops import statespace as ss
from dis_project_tpu_torch.ops.precision import pin_full_fp32

F64 = torch.float64
FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


def _jit(fn):
    return jax.jit(fn, compiler_options=FAST_COMPILE)


def _t(a, dtype=F64):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def _close(got, ref, tol, what):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    err = float(np.max(np.abs(got - np.asarray(ref))))
    assert err <= tol, f"{what}: max abs error {err:.3e} > {tol:.3e}"


@pytest.fixture(autouse=True)
def _full_fp32():
    pin_full_fp32()


def _problem(G, T, seed):
    """Perturbed kinetics, the grid 0.5..12 and observations around the
    prior mean, from numpy (``tests/test_torch_port_statespace.py``'s)."""
    rng = np.random.default_rng(seed)
    p = {
        "basal": 0.05 + 0.02 * rng.uniform(size=G),
        "sensitivity": rng.uniform(0.8, 1.2, G),
        "decay": 0.4 * rng.uniform(0.7, 1.5, G),
        "lengthscale": np.asarray(1.7),
        "obs_stddev": np.asarray(0.3),
    }
    t = np.linspace(0.5, 12.0, T)
    y = np.repeat(p["basal"] / p["decay"], T) + rng.normal(size=G * T)
    return p, t, y


PREDICT_GRID = np.sort(np.concatenate([np.linspace(0.0, 13.0, 31), [0.25, 6.0, 12.0, 12.5]]))
SMOOTHERS = {"parallel": (jss.parallel_rts_smoother, ss.parallel_rts_smoother),
             "blocked": (jss.blocked_rts_smoother, ss.blocked_rts_smoother),
             "blocked-5": (functools.partial(jss.blocked_rts_smoother, block=5),
                           functools.partial(ss.blocked_rts_smoother, block=5))}


@pytest.fixture(scope="module")
def predict_case():
    """One problem (4 x 24, per-point noise), JAX's predictions under the
    sequential, associative and blocked schedules, union and bridge, and
    the floor per output: JAX's union against its bridge (sequential)."""
    p, t, y = _problem(4, 24, 21)
    nv = np.random.default_rng(4).uniform(1e-3, 1e-2, size=(24, 4))
    jp = jsimm.SIMMParams(**{k: jnp.asarray(v) for k, v in p.items()})
    ref = _jit(lambda jp: {
        (str(s), interp): jss.lfm_predict_ss(
            jp, jnp.asarray(t), jnp.asarray(y), jnp.asarray(PREDICT_GRID),
            noise_var=jnp.asarray(nv), parallel=s, interp=interp)
        for s in (False, True, "blocked") for interp in ("union", "bridge")})(jp)
    ref = {k: [np.asarray(a) for a in v] for k, v in ref.items()}
    floor = [max(1e-9, float(np.abs(u - b).max()))
             for u, b in zip(ref[("False", "union")], ref[("False", "bridge")])]
    return p, t, y, nv, ref, floor


def _projected(m_s, p_s, h_force, p):
    m_s, p_s, h_force = (np.asarray(a) for a in (m_s, p_s, h_force))
    return (m_s @ h_force, np.einsum("i,tij,j->t", h_force, p_s, h_force), m_s[:, p:],
            np.diagonal(p_s, axis1=1, axis2=2)[:, p:])


@pytest.mark.parametrize("shared_aq", [False, True], ids=["per_step", "shared"])
@pytest.mark.parametrize("which", list(SMOOTHERS))
def test_semigroup_smoothers_match_jax(predict_case, which, shared_aq):
    """On identical filtered inputs on the train grid (per-step or one
    shared (A, Q)): the smoothed force and gene moments of the port's
    parallel and blocked smoothers within the floor of JAX's same smoother
    and of the port's sequential smoother."""
    p, t, y, nv, _, floor = predict_case
    tp = convert.params_from_numpy(p, device="cpu")
    f, p_inf, p0, h_force = ss.build_lfm_ssm(tp.decay, tp.sensitivity, tp.lengthscale)
    steps = _t(t[1] - t[0]) if shared_aq else \
        torch.diff(_t(t), prepend=torch.zeros(1, dtype=F64))
    a, q = ss.discretize(f, p_inf, steps)
    ys = _t(y).reshape(4, 24).T - (tp.basal / tp.decay)[None, :]
    ms, ps, _ = ss.kalman_filter(a, q, ss.gene_observation_matrix(10, 4), _t(nv), ys, p0)
    args = [x.numpy() for x in (a, q, ms, ps)]
    jax_fn, port_fn = SMOOTHERS[which]
    ref = _jit(jax_fn)(*args)
    got = port_fn(*(_t(x) for x in args))
    seq = ss.rts_smoother(*(_t(x) for x in args))
    for name, g_, r_, s_, tol in zip(("f_mean", "f_var", "x_mean", "x_var"),
                                     _projected(*got, h_force, 10), _projected(*ref, h_force, 10),
                                     _projected(*seq, h_force, 10), floor):
        _close(g_, r_, tol, f"{which} {name} vs JAX")
        _close(g_, s_, tol, f"{which} {name} vs sequential")


@pytest.mark.parametrize("interp", ["union", "bridge"])
@pytest.mark.parametrize("sched", [True, "blocked"], ids=["True", "blocked"])
def test_lfm_predict_ss_schedules_match_jax(predict_case, sched, interp):
    """``lfm_predict_ss`` under each semigroup schedule: within max(floor,
    1e-7) of JAX's same schedule and of the port's sequential prediction."""
    p, t, y, nv, ref, floor = predict_case
    tp = convert.params_from_numpy(p, device="cpu")
    kw = dict(noise_var=_t(nv), interp=interp)
    got = ss.lfm_predict_ss(tp, _t(t), _t(y), _t(PREDICT_GRID), parallel=sched, **kw)
    seq = ss.lfm_predict_ss(tp, _t(t), _t(y), _t(PREDICT_GRID), parallel=False, **kw)
    for name, g_, r_, s_, tol in zip(("f_mean", "f_var", "x_mean", "x_var"), got,
                                     ref[(str(sched), interp)], seq, floor):
        assert not g_.requires_grad
        _close(g_, r_, max(tol, 1e-7), f"{sched} {interp} {name} vs JAX")
        _close(g_, s_, max(tol, 1e-7), f"{sched} {interp} {name} vs sequential")
    assert float(got[1].min()) > 0.0
