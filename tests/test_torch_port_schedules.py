"""The port's associative-scan and blocked schedules of the state-space
engine (``parallel=True``, ``'blocked'`` and an int block length in
``dis_project_tpu_torch/ops/statespace.py``) held to the JAX package's same
schedules and to the port's own sequential filter, on the CPU in float64.

The same numpy inputs (seeded) go through both packages. The MLL is held at
1e-9 abs and each raw gradient at 1e-9 (max|g| + 1), JAX's own limits
between its parallel and sequential filters (``tests/test_statespace.py``);
filtered moments at 1e-10. The smoothers and ``lfm_predict_ss`` under each
schedule are in ``tests/test_torch_port_smoothers.py``. The JAX references
compile at XLA's lowest CPU optimisation level.
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
from dis_project_tpu_torch.models import simm
from dis_project_tpu_torch.ops import statespace as ss
from dis_project_tpu_torch.ops.precision import pin_full_fp32
from dis_project_tpu_torch.training import generic

F64 = torch.float64
FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}
SCHEDULES = (True, "blocked", 4)


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


@functools.lru_cache(maxsize=None)
def _problem(G, T, seed, uniform=True):
    """Perturbed kinetics, a grid from 0.5 to 12 (evenly spaced or sorted
    uniform draws), observations around the prior mean; numpy."""
    rng = np.random.default_rng(seed)
    p = {
        "basal": 0.05 + 0.02 * rng.uniform(size=G),
        "sensitivity": rng.uniform(0.8, 1.2, G),
        "decay": 0.4 * rng.uniform(0.7, 1.5, G),
        "lengthscale": np.asarray(1.7),
        "obs_stddev": np.asarray(0.3),
    }
    t = np.linspace(0.5, 12.0, T) if uniform else np.sort(rng.uniform(0.1, 12.0, T))
    y = np.repeat(p["basal"] / p["decay"], T) + rng.normal(size=G * T)
    return p, t, y


# The MLL cases: (G, T, seed, uniform, obs_mask fraction kept or None,
# whether the gradient is checked, the schedules). A uniform grid filters
# T - 1 steps after the first, a non-uniform one all T: 17, 65 and 21
# steps, odd at the top of the scan tree (and at 5 for 21). The 65-step
# case holds the associative scan's value only (its deepest unbalanced
# tree; the blocked schedule's padding is held in the filter test below).
MLL_CASES = {
    "uniform_17_steps": (3, 18, 1, True, None, True, SCHEDULES),
    "uniform_65_steps": (2, 66, 2, True, None, False, (True,)),
    "nonuniform_21_steps_obs_mask_nan": (3, 21, 3, False, 0.7, True, SCHEDULES),
}
MLL_PARAMS = [(case, sched) for case, spec in MLL_CASES.items() for sched in spec[-1]]


@functools.lru_cache(maxsize=None)
def _mll_case(case):
    G, T, seed, uniform, keep, _, _ = MLL_CASES[case]
    p, t, y = _problem(G, T, seed, uniform)
    om = None
    if keep is not None:
        om = (np.random.default_rng(seed + 100).uniform(size=y.shape) < keep).astype(np.float64)
        y = np.where(om > 0, y, np.nan)
    kw = {"uniform": uniform}
    return p, t, y, om, kw


@functools.lru_cache(maxsize=None)
def _jax_mll(case):
    """JAX's MLL (and raw gradient, where the case checks it) under each
    schedule (one compile)."""
    p, t, y, om, kw = _mll_case(case)
    jom = None if om is None else jnp.asarray(om)
    with_grad, schedules = MLL_CASES[case][-2:]

    def value_and_grads(raw):
        out = {}
        for sched in schedules:
            def mll(r, s=sched):
                return jss.lfm_mll_ss(jsimm.constrain(r), jnp.asarray(t), jnp.asarray(y),
                                      jitter=1e-4, parallel=s, obs_mask=jom, **kw)
            out[str(sched)] = jax.value_and_grad(mll)(raw) if with_grad else (mll(raw), None)
        return out

    raw = jsimm.unconstrain(jsimm.SIMMParams(**{k: jnp.asarray(v) for k, v in p.items()}))
    return _jit(value_and_grads)(raw)


def _port_mll(case, sched):
    p, t, y, om, kw = _mll_case(case)
    raw = simm.unconstrain(convert.params_from_numpy(p, device="cpu"))
    return generic.value_and_grad(lambda r: ss.lfm_mll_ss(
        simm.constrain(r), _t(t), _t(y), jitter=1e-4, parallel=sched,
        obs_mask=None if om is None else _t(om), **kw), raw)


@pytest.fixture(scope="module")
def sequential_mll():
    return {case: _port_mll(case, False) for case in MLL_CASES}


@pytest.mark.parametrize("case, sched", MLL_PARAMS, ids=[f"{c}-{s}" for c, s in MLL_PARAMS])
def test_schedule_mll_and_gradient_match_jax_and_sequential(case, sched, sequential_mll):
    """The MLL within 1e-9 of JAX's same schedule and of the port's
    sequential filter; every raw gradient within 1e-9 (max|g| + 1) of both."""
    ref_v, ref_g = _jax_mll(case)[str(sched)]
    got_v, got_g = _port_mll(case, sched)
    seq_v, seq_g = sequential_mll[case]
    assert np.isfinite(float(got_v))
    assert abs(float(got_v) - float(ref_v)) <= 1e-9, "vs JAX"
    assert abs(float(got_v) - float(seq_v)) <= 1e-9, "vs sequential"
    if ref_g is None:
        return
    for name in got_g._fields:
        g = getattr(got_g, name).numpy()
        for ref, what in ((np.asarray(getattr(ref_g, name)), "JAX"),
                          (getattr(seq_g, name).numpy(), "sequential")):
            tol = 1e-9 * (np.abs(ref).max() + 1.0)
            assert np.abs(g - ref).max() <= tol, f"{name} vs {what}"


@pytest.fixture(scope="module")
def masked_filter_case():
    """Per-step (A, Q) on a non-uniform grid, a step mask and a per-entry
    mask with NaN observations (JAX's blocked-filter primitive test at
    G = 3, T = 37), and JAX's three filters on them."""
    rng = np.random.default_rng(11)
    G, T, order = 3, 37, 8
    f, p_inf, p0, _ = ss.build_lfm_ssm(_t(rng.uniform(0.3, 1.0, G)),
                                       _t(rng.uniform(0.5, 1.5, G)), _t(1.6), order)
    t = np.sort(rng.uniform(0.1, 12.0, T))
    a, q = (x.numpy() for x in ss.discretize(f, p_inf, _t(np.diff(t, prepend=0.0))))
    h = ss.gene_observation_matrix(order, G).numpy()
    ys = rng.normal(size=(T, G))
    rv = np.full((G,), 0.2)
    mask = (rng.uniform(size=T) > 0.3).astype(np.float64)
    om = (rng.uniform(size=(T, G)) > 0.2).astype(np.float64)
    ys = np.where(om > 0, ys, np.nan)
    args = (a, q, h, rv, ys, p0.numpy())
    kw = dict(mask=jnp.asarray(mask), obs_mask=jnp.asarray(om))
    ref = _jit(lambda *x: {
        "parallel": jss.parallel_filter(*x, **kw),
        **{f"blocked-{b}": jss.blocked_filter(*x, **kw, block=b) for b in (None, 4, 5)},
    })(*args)
    return args, mask, om, ref


@pytest.mark.parametrize("which", ["parallel", "blocked-None", "blocked-4", "blocked-5"])
def test_filters_match_jax_with_step_and_entry_masks(masked_filter_case, which):
    """Filtered means and covariances at 1e-10 and the MLL at 1e-9 of JAX's
    same filter and of the port's sequential filter; block 5 leaves 37 = 8 x 5
    - 3 steps of identity padding, block 4 pads 3 as well."""
    args, mask, om, ref = masked_filter_case
    targs = tuple(_t(x) for x in args)
    if which == "parallel":
        got = ss.parallel_filter(*targs, mask=_t(mask), obs_mask=_t(om))
    else:
        block = None if which == "blocked-None" else int(which.split("-")[1])
        got = ss.blocked_filter(*targs, mask=_t(mask), obs_mask=_t(om), block=block)
    seq = ss.kalman_filter(*targs, mask=mask, obs_mask=_t(om))
    for name, g_, r_, s_ in zip(("means", "covariances"), got, ref[which], seq):
        _close(g_, r_, 1e-10, f"{name} vs JAX")
        _close(g_, s_, 1e-10, f"{name} vs sequential")
    assert abs(float(got[2]) - float(ref[which][2])) <= 1e-9
    assert abs(float(got[2]) - float(seq[2])) <= 1e-9


@pytest.mark.parametrize("t_steps, block, layout", [(200, None, (16, 13, 8)), (37, None, (8, 5, 3)),
                                                    (37, 5, (5, 8, 3)), (3, 8, (3, 1, 0)),
                                                    (2000, None, (32, 63, 16))])
def test_blocked_layout_matches_jax(t_steps, block, layout):
    assert ss._blocked_layout(t_steps, block) == jss._blocked_layout(t_steps, block) == layout


def test_associative_scan_matches_a_sequential_fold():
    """The odd/even recursion is an inclusive scan for every T from 1 to
    17, forward and reverse (a non-commutative product of 2 x 2 matrices),
    in at most 2 ceil(log2 T) calls of the combine."""
    rng = np.random.default_rng(5)
    for n in range(1, 18):
        mats = _t(rng.normal(size=(n, 2, 2)))
        calls = []

        def fn(x, y):
            calls.append(1)
            return (x[0] @ y[0],)

        (got,) = ss._associative_scan(fn, (mats,))
        ref = [mats[0]]
        for i in range(1, n):
            ref.append(ref[-1] @ mats[i])
        _close(got, torch.stack(ref), 1e-12, f"forward T={n}")
        assert len(calls) <= 2 * max(1, int(np.ceil(np.log2(n)))) if n > 1 else not calls
        (got_r,) = ss._associative_scan(lambda x, y: (x[0] @ y[0],), (mats,), reverse=True)
        ref_r = [mats[-1]]
        for i in range(n - 2, -1, -1):
            ref_r.append(ref_r[-1] @ mats[i])
        _close(got_r, torch.stack(ref_r[::-1]), 1e-12, f"reverse T={n}")


def test_semigroup_identity_and_prior_elements():
    """combine(I, e) == e == combine(e, I); the prior element composed on
    the left of the elements gives the sequential filter's moments."""
    rng = np.random.default_rng(6)
    G, T, order = 2, 9, 6
    f, p_inf, p0, _ = ss.build_lfm_ssm(_t([0.5, 0.9]), _t([1.0, 0.8]), _t(2.0), order)
    a, q = ss.discretize(f, p_inf, _t(np.full(T, 0.7)))
    h = ss.gene_observation_matrix(order, G)
    ys, rv = _t(rng.normal(size=(T, G))), torch.full((T, G), 0.1, dtype=F64)
    elems = ss._filter_element(a, q, h, rv, ys, None)
    ident = ss._identity_element(order + G, F64)
    one = tuple(e[3] for e in elems)
    for got in (ss._combine(ident, one), ss._combine(one, ident)):
        for g_, e_ in zip(got, one):
            _close(g_, e_, 1e-13, "identity")
    prior = ss._prior_element(torch.zeros(order + G, dtype=F64), p0)
    elems = tuple(torch.cat([p[None], e]) for p, e in zip(prior, elems))
    _, ms, ps, _, _ = ss._associative_scan(ss._combine, elems)
    ms0, ps0, _ = ss.kalman_filter(a, q, h, rv, ys, p0)
    _close(ms[1:], ms0, 1e-11, "means")
    _close(ps[1:], ps0, 1e-11, "covariances")


# ---------------------------------------------------------------------------
# The schedule rule.
# ---------------------------------------------------------------------------


def test_select_schedule_names_each_pair():
    assert ss._select_schedule(None, 100000, "cpu") == (ss.kalman_filter, ss.rts_smoother)
    assert ss._select_schedule(False, 100) == (ss.kalman_filter, ss.rts_smoother)
    assert ss._select_schedule(True, 100) == (ss.parallel_filter, ss.parallel_rts_smoother)
    assert ss._select_schedule("blocked", 100) == (ss.blocked_filter, ss.blocked_rts_smoother)
    fil, smo = ss._select_schedule(8, 100)
    assert fil.func is ss.blocked_filter and fil.keywords == {"block": 8}
    assert smo.func is ss.blocked_rts_smoother and smo.keywords == {"block": 8}
    for bad in (0, 1, -4):
        with pytest.raises(ValueError, match="block length and must be >= 2"):
            ss._select_schedule(bad, 100)


def test_auto_schedule_rule():
    """``parallel=None``: the blocked pair on a CUDA device from
    ``_AUTO_BLOCKED_MIN_T`` = 200 steps on (measured on the card, PERF.md),
    the sequential pair below it and on the CPU at any T; never the
    associative pair."""
    assert ss._AUTO_BLOCKED_MIN_T == 200
    for dev in ("cuda", None, torch.device("cuda")):
        assert ss._select_schedule(None, 199, dev) == (ss.kalman_filter, ss.rts_smoother)
        assert ss._select_schedule(None, 200, dev) == (ss.blocked_filter, ss.blocked_rts_smoother)
        assert ss._select_schedule(None, 10**6, dev)[0] is ss.blocked_filter
    for t_steps in (2, 200, 10**6):
        assert ss._select_schedule(None, t_steps, "cpu")[0] is ss.kalman_filter
        assert ss._select_schedule(None, t_steps, torch.device("cpu"))[0] is ss.kalman_filter


def test_expm_device_matches_matrix_exp_and_refuses_past_its_squarings():
    """The sync-free scaling and squaring against ``torch.linalg.matrix_exp``
    (float64 Pade 13: rel 1e-13 at 1-norms from 1e-3 to ~200, i.e. 0 to 6
    squarings; float32 Pade 7 rel 1e-5 of the float64 result), batched, and
    NaN once the norm needs more than EXPM_MAX_SQUARINGS squarings."""
    rng = np.random.default_rng(8)
    f, _, _, _ = ss.build_lfm_ssm(_t([0.4, 0.9, 1.3]), _t([1.0, 0.8, 1.2]), _t(1.1))
    x = torch.stack([f * dt for dt in (1e-3, 0.06, 0.7, 3.0, 12.0)])
    ref = torch.linalg.matrix_exp(x)
    got = ss._expm_device(x)
    assert float((got - ref).abs().max() / ref.abs().max()) <= 1e-13
    got32 = ss._expm_device(x.float()).double()
    assert float((got32 - ref).abs().max() / ref.abs().max()) <= 1e-5
    big = _t(rng.normal(size=(4, 4))) * 0.1
    big = -torch.eye(4, dtype=F64) * 6.0 * 2.0**ss.EXPM_MAX_SQUARINGS + big
    assert bool(torch.isnan(ss._expm_device(big)).all())
    ok = -torch.eye(4, dtype=F64) * 5.0 * 2.0**ss.EXPM_MAX_SQUARINGS
    assert float(ss._expm_device(ok).abs().max()) == 0.0
