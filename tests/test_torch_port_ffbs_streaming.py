"""The port's trajectory samplers (``posterior_sample_ss``,
``sample_trajectory_ss``) and streaming API (``streaming_*``) held to the
JAX package's on the CPU in float64.

Draws cannot match JAX's element by element: ``_psd_sqrt_traced`` is
``v sqrt(w)`` from ``eigh``, whose eigenvectors MKL and OpenBLAS may flip or
rotate inside a degenerate eigenspace. So the samplers are held in three
parts:

- the draw-independent pieces against JAX's on the same filtered inputs:
  the gains through ``G_k P_pred`` (the product the recursion needs; the
  gains themselves invert eigenvalues down to 1e-12 of the largest and
  differ by eigh noise) at 1e-10 relative, and the sampling covariances
  ``sq sq^T`` at 1e-7, JAX's own limit between its parallel and sequential
  smoothers (``tests/test_statespace.py``, ``TestParallelSmoother``;
  measured 1.8e-8);
- the port's recursion fed JAX's square roots, gains and standard normals
  (recorded from JAX's own call) against JAX's trajectories, within twice
  the distance of JAX's step formula evaluated in numpy from JAX (the
  gains amplify rounding along the chain);
- the moments of seeded ``torch.Generator`` draws, as JAX's ``TestFFBS``
  and ``TestPriorSampler`` hold JAX's.

The streaming functions are held to JAX's on the same inputs and to the
port's batch filter, as JAX's ``TestStreaming`` holds JAX's.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from dis_project_tpu.models import simm as jsimm
from dis_project_tpu.ops import statespace as jss
from dis_project_tpu_torch import convert
from dis_project_tpu_torch.ops import statespace as ss
from dis_project_tpu_torch.ops.precision import pin_full_fp32

F64 = torch.float64


def _t(a, dtype=F64):
    return torch.as_tensor(np.array(a), dtype=dtype)


def _port_params(jp):
    return convert.params_from_numpy({k: np.asarray(v) for k, v in jp._asdict().items()},
                                     device="cpu")


@pytest.fixture(autouse=True)
def _full_fp32():
    pin_full_fp32()


def _ffbs_params(G=3):
    return jsimm.init_params(G)._replace(decay=jnp.asarray([0.4, 0.9, 0.6][:G]),
                                         sensitivity=jnp.asarray([1.0, 0.8, 1.2][:G]))


@pytest.fixture(scope="module")
def ffbs_jax_run():
    """JAX's ``posterior_sample_ss`` at G = 3, 9 train times, 20 test times,
    16 draws, with numpy standard normals in place of ``jax.random.normal``
    and its backward scan's inputs and outputs recorded."""
    G, T = 3, 9
    t = np.linspace(0.5, 12.0, T)
    y = np.random.default_rng(5).normal(size=(G * T,))
    tt = np.linspace(0.25, 13.25, 20)
    jp = _ffbs_params(G)
    rng = np.random.default_rng(17)
    normals, recorded = [], {}
    real_scan, real_normal = jax.lax.scan, jax.random.normal

    def fake_normal(key, shape, dtype):
        normals.append(rng.standard_normal(shape))
        return jnp.asarray(normals[-1], dtype)

    def recording_scan(f, init, xs, **kw):
        out = real_scan(f, init, xs, **kw)
        if kw.get("reverse"):
            recorded.update(z_t=np.asarray(init), xs=[np.asarray(x) for x in xs],
                            zs=np.asarray(out[1]))
        return out

    jax.random.normal, jax.lax.scan = fake_normal, recording_scan
    try:
        draws = np.asarray(jss.posterior_sample_ss(
            jp, jnp.asarray(t), jnp.asarray(y), jnp.asarray(tt), jax.random.PRNGKey(0),
            noise_var=1e-3, num_samples=16))
    finally:
        jax.random.normal, jax.lax.scan = real_normal, real_scan
    return jp, t, y, tt, draws, normals, recorded


def test_ffbs_pieces_match_jax(ffbs_jax_run):
    """The port's gains and sampling covariances on JAX's filtered union
    grid (recorded) against JAX's pieces."""
    jp, *_, recorded = ffbs_jax_run
    m_f, a_n, jgains, jsqrts, _ = recorded["xs"]
    tp = _port_params(jp)
    f_aug, p_inf, p0, _ = ss.build_lfm_ssm(tp.decay, tp.sensitivity, tp.lengthscale)
    # Rebuild the port's filtered union grid: the same inputs as JAX's.
    _, t, y, tt, *_ = ffbs_jax_run
    a, q, ys, rv, _, is_train, _ = ss._union_inputs(
        f_aug, p_inf, _t(t), _t(tt), _t(y), tp.basal / tp.decay, 1e-3, None, None)
    ms, ps, _ = ss.kalman_filter(a, q, ss.gene_observation_matrix(10, 3), rv, ys, p0,
                                 mask=is_train.astype(np.float64), obs_slice=10)
    np.testing.assert_allclose(ms[:-1].numpy(), m_f, rtol=0, atol=1e-10)
    np.testing.assert_allclose(a[1:].numpy(), a_n, rtol=0, atol=1e-13)
    gains, sqrts, sqrt_t = ss._ffbs_pieces(a, q, ms, ps, 1e-12)
    p_pred = ss._symmetrize(a[1:] @ ps[:-1] @ a[1:].mT + q[1:]).numpy()
    gp, jgp = gains.numpy() @ p_pred, jgains @ p_pred
    assert np.abs(gp - jgp).max() <= 1e-10 * np.abs(jgp).max()
    cov = (sqrts @ sqrts.mT).numpy()
    assert np.abs(cov - jsqrts @ np.swapaxes(jsqrts, -1, -2)).max() <= 1e-7
    np.testing.assert_allclose((sqrt_t @ sqrt_t.T).numpy(), ps[-1].numpy(), rtol=0, atol=1e-12)


def test_ffbs_backward_pass_on_jax_pieces_and_normals(ffbs_jax_run):
    """The port's backward pass fed JAX's filtered means, transitions,
    gains, square roots, terminal draw and normals against JAX's
    trajectories, and through ``h_force`` against JAX's draws. The recursion
    multiplies by gains of up to ~8e3, so the rounding of one step grows
    along the chain: JAX's own step formula evaluated in numpy on the same
    inputs sits ~1.9e-9 from JAX's trajectories. The port is held within
    twice that distance (plus 1e-10 of the largest entry)."""
    jp, t, y, tt, draws, normals, recorded = ffbs_jax_run
    xs = recorded["xs"]
    assert np.array_equal(xs[4], normals[1])
    ref = np.concatenate([recorded["zs"], recorded["z_t"][None]])
    z, out = recorded["z_t"], [recorded["z_t"]]
    for m_k, a_k, g_k, sq_k, e_k in zip(*(x[::-1] for x in xs)):
        z = m_k[None] + (z - (a_k @ m_k)[None]) @ g_k.T + e_k @ sq_k.T
        out.append(z)
    numpy_traj = np.stack(out[::-1])
    _, _, _, h_force = jss.build_lfm_ssm(jp.decay, jp.sensitivity, jp.lengthscale)
    hf = np.asarray(h_force)
    test_pos = np.nonzero(np.argsort(np.concatenate([t, tt]), kind="stable") >= len(t))[0]
    traj = ss._ffbs_backward(*(_t(x) for x in xs[:4]), _t(recorded["z_t"]), _t(xs[4])).numpy()
    for what, got_, ref_, floor_ in (
            ("trajectories", traj, ref, numpy_traj),
            ("draws", (traj @ hf).T[:, test_pos], draws, (numpy_traj @ hf).T[:, test_pos])):
        tol = 2.0 * np.abs(floor_ - ref_).max() + 1e-10 * np.abs(ref_).max()
        assert np.abs(got_ - ref_).max() <= tol, what


def test_ffbs_marginals_match_smoother():
    """JAX's ``TestFFBS`` marginal check with a seeded generator: 2048 draws'
    mean within 0.02 max|f| and variance within 0.05 max var of the port's
    smoothed moments; draws are time-sorted, shape (2048, 20)."""
    G, T = 3, 9
    t = _t(np.linspace(0.0, 12.0, T))
    y = _t(np.random.default_rng(5).normal(size=(G * T,)))
    tp = _port_params(_ffbs_params(G))
    tt = _t(np.linspace(0.0, 13.0, 20))
    fm, fv, _, _ = ss.lfm_predict_ss(tp, t, y, tt, noise_var=1e-3, parallel=False)
    draws = ss.posterior_sample_ss(tp, t, y, tt, torch.Generator().manual_seed(0),
                                   noise_var=1e-3, num_samples=2048).numpy()
    assert draws.shape == (2048, 20)
    scale = np.abs(fm.numpy()).max()
    assert np.abs(draws.mean(0) - fm.numpy()).max() < 0.02 * scale
    assert np.abs(draws.var(0) - fv.numpy()).max() < 0.05 * fv.numpy().max()


def test_ffbs_joint_covariance_matches_dense_conditional():
    """JAX's ``TestFFBS`` joint check: the draws' cross-time covariance (8192
    draws, exact Matern-3/2 model) against the dense joint conditional of
    the same model, within 0.06 max|cov| (Monte-Carlo error)."""
    from scipy.linalg import expm

    G, T = 2, 6
    t_grid = np.linspace(0.0, 10.0, T)
    tt = np.linspace(1.0, 11.0, 5)
    y = np.random.default_rng(7).normal(size=(G * T,))
    noise, kind = 1e-2, "matern32"
    jp = jsimm.init_params(G)._replace(decay=jnp.asarray([0.5, 1.0]),
                                       sensitivity=jnp.asarray([1.0, 0.8]), basal=jnp.zeros(G))
    tp = _port_params(jp)
    draws = ss.posterior_sample_ss(tp, _t(t_grid), _t(y), _t(tt), torch.Generator().manual_seed(1),
                                   noise_var=noise, num_samples=8192, force_kernel=kind).numpy()
    emp_cov = np.cov(draws.T)

    f_aug, p_inf, p0, hf = (x.numpy() for x in ss.build_lfm_ssm(
        tp.decay, tp.sensitivity, tp.lengthscale, force_kernel=kind))
    m = p0.shape[0]
    t_all = np.concatenate([t_grid, tt])
    idx = np.argsort(t_all, kind="stable")
    is_train = np.concatenate([np.ones(T), np.zeros(len(tt))])[idx]
    n_all = len(t_all)
    A = [expm(f_aug * dt) for dt in np.diff(t_all[idx], prepend=0.0)]
    P, prev = [], p0
    for i in range(n_all):
        prev = A[i] @ prev @ A[i].T + (p_inf - A[i] @ p_inf @ A[i].T)
        P.append(0.5 * (prev + prev.T))
    J = np.zeros((n_all * m, n_all * m))
    for i in range(n_all):
        J[i * m:(i + 1) * m, i * m:(i + 1) * m] = P[i]
        phi = np.eye(m)
        for j in range(i + 1, n_all):
            phi = A[j] @ phi
            J[i * m:(i + 1) * m, j * m:(j + 1) * m] = P[i] @ phi.T
            J[j * m:(j + 1) * m, i * m:(i + 1) * m] = (P[i] @ phi.T).T
    H = np.zeros((T * G, n_all * m))
    for k, i in enumerate(np.nonzero(is_train)[0]):
        H[k * G:(k + 1) * G, i * m + m - G:(i + 1) * m] = np.eye(G)
    Fsel = np.zeros((len(tt), n_all * m))
    for k, i in enumerate(np.nonzero(1 - is_train)[0]):
        Fsel[k, i * m:(i + 1) * m] = hf
    S = H @ J @ H.T + noise * np.eye(T * G)
    Kfy = Fsel @ J @ H.T
    cond_cov = Fsel @ J @ Fsel.T - Kfy @ np.linalg.solve(S, Kfy.T)
    assert np.abs(emp_cov - cond_cov).max() < 0.06 * np.abs(cond_cov).max()


def test_ffbs_unique_dts_is_a_checked_bound():
    tp = _port_params(_ffbs_params(2))
    t, y, tt = _t([0.5, 1.0, 1.5]), _t(np.zeros(6)), _t([0.75, 1.25])
    ss.posterior_sample_ss(tp, t, y, tt, torch.Generator().manual_seed(0), noise_var=0.01,
                           unique_dts=2)
    with pytest.raises(ValueError, match="more than max_unique=1"):
        ss.posterior_sample_ss(tp, t, y, tt, torch.Generator().manual_seed(0), noise_var=0.01,
                               unique_dts=1)


def test_prior_sampler_on_jax_pieces_and_normals(monkeypatch):
    """``sample_trajectory_ss``'s pieces (the square roots of ``Q_i`` and of
    ``P0`` reproduce them at 1e-12) and its forward recursion fed JAX's
    square roots and normals against JAX's one draw at 1e-10."""
    G = 2
    jp = jsimm.init_params(G)._replace(lengthscale=jnp.asarray(2.0))
    t = np.linspace(0.0, 12.0, 13)
    rng = np.random.default_rng(3)
    normals = []

    def fake_normal(key, shape, dtype):
        normals.append(rng.standard_normal(shape))
        return jnp.asarray(normals[-1], dtype)

    monkeypatch.setattr(jax.random, "normal", fake_normal)
    f_ref, x_ref = (np.asarray(a) for a in jss.sample_trajectory_ss(
        jp, jnp.asarray(t), jax.random.PRNGKey(0), num_samples=1, force_kernel="matern32"))
    monkeypatch.undo()
    f_aug, p_inf, p0, h_force = jss.build_lfm_ssm(jp.decay, jp.sensitivity, jp.lengthscale,
                                                  force_kernel="matern32")
    a, q = jss.discretize(f_aug, p_inf, jnp.diff(jnp.asarray(t), prepend=0.0))
    jsq = np.asarray(jax.vmap(jss._psd_sqrt_traced)(q))
    jsq0 = np.asarray(jss._psd_sqrt_traced(p0))
    tp = _port_params(jp)
    tf, tpi, tp0, _ = ss.build_lfm_ssm(tp.decay, tp.sensitivity, tp.lengthscale,
                                       force_kernel="matern32")
    ta, tq = ss.discretize(tf, tpi, torch.diff(_t(t), prepend=torch.zeros(1, dtype=F64)))
    roots = ss._psd_sqrt_traced(torch.cat([tp0[None], tq]))
    np.testing.assert_allclose((roots @ roots.mT).numpy(),
                               np.concatenate([np.asarray(p0)[None], np.asarray(q)]),
                               rtol=0, atol=1e-12)
    z0 = _t(jsq0 @ normals[0])[None]
    zs = ss._prior_forward(_t(np.asarray(a)), _t(jsq), z0, _t(normals[1])[:, None, :])
    m_dim = zs.shape[-1]
    np.testing.assert_allclose((zs[:, 0] @ _t(np.asarray(h_force))).numpy(), f_ref[0],
                               rtol=0, atol=1e-10)
    mean = (tp.basal / tp.decay).numpy()
    np.testing.assert_allclose(zs[:, 0, m_dim - G:].numpy() + mean, x_ref[0], rtol=0, atol=1e-10)


def test_prior_sampler_matern_statistics():
    """JAX's ``TestPriorSampler``: 4096 exact Matern-3/2 prior draws, the
    stationary variance ~1 (within 0.08), the cross-time covariance against
    the closed-form kernel (within 0.06), genes deterministic at t = 0."""
    tp = _port_params(jsimm.init_params(2)._replace(lengthscale=jnp.asarray(2.0)))
    t = np.linspace(0.0, 12.0, 25)
    f, x = ss.sample_trajectory_ss(tp, _t(t), torch.Generator().manual_seed(0), num_samples=4096,
                                   force_kernel="matern32")
    assert f.shape == (4096, 25) and x.shape == (4096, 25, 2)
    fc = f.numpy() - f.numpy().mean(0)
    assert abs(fc[:, 12].var() - 1.0) < 0.08
    tau = t[20] - t[12]
    k = (1 + np.sqrt(3) * tau / 2.0) * np.exp(-np.sqrt(3) * tau / 2.0)
    assert abs((fc[:, 12] * fc[:, 20]).mean() - k) < 0.06
    assert float(x.numpy()[:, 0, :].std(0).max()) == 0.0


# ---------------------------------------------------------------------------
# Streaming.
# ---------------------------------------------------------------------------


def _stream_params(G=3):
    return jsimm.init_params(G)._replace(decay=jnp.asarray([0.4, 0.9, 0.6][:G]),
                                         sensitivity=jnp.asarray([1.0, 0.8, 1.2][:G]))


def test_streaming_matches_batch_and_jax():
    """Nine arrivals: the accumulated ll within 1e-10 relative of the port's
    batch MLL and of JAX's stream, the terminal moments within 1e-12 of the
    port's batch filter and 1e-10 of JAX's stream."""
    G, T = 3, 9
    t = np.linspace(0.5, 12.0, T)
    y = np.random.default_rng(5).normal(size=(G * T,))
    jp = _stream_params(G)
    tp = _port_params(jp)
    rv = 1e-4 + float(jp.obs_stddev) ** 2
    ys = y.reshape(G, T).T
    jcarry, jaux = jss.streaming_init(jp)
    step = jax.jit(lambda c, ti, yi: jss.streaming_update(c, jaux, ti, yi, rv))
    for i in range(T):
        jcarry = step(jcarry, t[i], jnp.asarray(ys[i]))
    carry, aux = ss.streaming_init(tp)
    for i in range(T):
        carry = ss.streaming_update(carry, aux, float(t[i]), _t(ys[i]), rv)
    v_batch = float(ss.lfm_mll_ss(tp, _t(t), _t(y), jitter=1e-4, parallel=False, uniform=False))
    for ref in (v_batch, float(jcarry.ll)):
        assert abs(float(carry.ll) - ref) <= 1e-10 * max(1.0, abs(ref))
    f_aug, p_inf, p0, _ = ss.build_lfm_ssm(tp.decay, tp.sensitivity, tp.lengthscale)
    a, q = ss.discretize(f_aug, p_inf, torch.diff(_t(t), prepend=torch.zeros(1, dtype=F64)))
    ms, ps, _ = ss.kalman_filter(a, q, ss.gene_observation_matrix(10, G), torch.full((G,), rv, dtype=F64),
                                 _t(ys) - (tp.basal / tp.decay)[None, :], p0)
    assert float((carry.mean - ms[-1]).abs().max()) <= 1e-12
    assert float((carry.cov - ps[-1]).abs().max()) <= 1e-12
    np.testing.assert_allclose(carry.mean.numpy(), np.asarray(jcarry.mean), rtol=0, atol=1e-10)
    np.testing.assert_allclose(carry.cov.numpy(), np.asarray(jcarry.cov), rtol=0, atol=1e-10)
    assert float(carry.t_last) == float(jcarry.t_last) == t[-1]


def test_frozen_updates_match_batch_stationary_tail_and_jax():
    """JAX's frozen-gain serving check (G = 3, 160 arrivals, 48 exact warm-up
    steps, order 8): the ll within 1e-6 relative of the port's batch
    ``stationary_after`` MLL and within 0.05 of the exact one, within
    1e-10 relative of JAX's frozen stream; forecasting works off the frozen
    carry and matches JAX's."""
    rng = np.random.default_rng(8)
    G, T, K, dt = 3, 160, 48, 0.08
    t = 0.08 + dt * np.arange(T)
    jp = jsimm.init_params(G)
    tp = _port_params(jp)
    ys = rng.normal(size=(T, G)) + 1.0
    y_flat = ys.T.reshape(-1)
    nv = 1e-4 + float(jp.obs_stddev) ** 2
    ll_batch = float(ss.lfm_mll_ss(tp, _t(t), _t(y_flat), jitter=1e-4, order=8,
                                   stationary_after=K))
    ll_exact = float(ss.lfm_mll_ss(tp, _t(t), _t(y_flat), jitter=1e-4, order=8))

    carry, aux = ss.streaming_init(tp, order=8)
    jcarry, jaux = jss.streaming_init(jp, order=8)
    jupdate = jax.jit(lambda c, ti, yi: jss.streaming_update(c, jaux, ti, yi, nv))
    for i in range(K + 1):
        carry = ss.streaming_update(carry, aux, float(t[i]), _t(ys[i]), nv)
        jcarry = jupdate(jcarry, t[i], jnp.asarray(ys[i]))
    pack = ss.streaming_freeze(carry, aux, dt, nv)
    jpack = jss.streaming_freeze(jcarry, jaux, dt, nv)
    jfrozen = jax.jit(lambda c, yi: jss.streaming_update_frozen(c, jpack, yi))
    for i in range(K + 1, T):
        carry = ss.streaming_update_frozen(carry, pack, _t(ys[i]))
        jcarry = jfrozen(jcarry, jnp.asarray(ys[i]))
    ll = float(carry.ll)
    assert abs(ll - ll_batch) < 1e-6 * max(1.0, abs(ll_batch))
    assert abs(ll - ll_exact) < 0.05
    assert abs(ll - float(jcarry.ll)) <= 1e-10 * abs(float(jcarry.ll))
    got = ss.streaming_predict(carry, aux, tp, float(t[-1]) + 0.5)
    ref = jss.streaming_predict(jcarry, jaux, jp, float(t[-1]) + 0.5)
    assert np.isfinite(float(got[0])) and float(got[1]) > 0.0
    for g_, r_ in zip(got, ref):
        np.testing.assert_allclose(g_.numpy(), np.asarray(r_), rtol=0, atol=1e-9)


def test_streaming_out_of_order_poisons_ll_not_state():
    """``t_new < t_last``: NaN ll at this call, the moments at their pre-call
    state, ``t_last`` kept, as JAX's."""
    G = 2
    jp = jsimm.init_params(G)
    tp = _port_params(jp)
    rv = 1e-4 + float(jp.obs_stddev) ** 2
    carry, aux = ss.streaming_init(tp)
    carry = ss.streaming_update(carry, aux, 2.0, torch.ones(G, dtype=F64), rv)
    bad = ss.streaming_update(carry, aux, 1.0, torch.ones(G, dtype=F64), rv)
    assert not torch.isfinite(bad.ll)
    assert torch.equal(bad.mean, carry.mean) and torch.equal(bad.cov, carry.cov)
    assert float(bad.t_last) == 2.0
    jcarry, jaux = jss.streaming_init(jp)
    jcarry = jss.streaming_update(jcarry, jaux, 2.0, jnp.ones(G), rv)
    np.testing.assert_allclose(carry.mean.numpy(), np.asarray(jcarry.mean), rtol=0, atol=1e-12)


def test_streaming_forecast_and_masked_update_match_jax():
    """A NaN entry deleted by ``obs_mask``: a finite ll and moments equal to
    JAX's (1e-12), and the forecast at t = 3 equal to JAX's (1e-12), with
    positive variances."""
    G = 3
    jp = jsimm.init_params(G)
    tp = _port_params(jp)
    rv = 1e-4 + float(jp.obs_stddev) ** 2
    y0, om = [1.0, np.nan, 0.5], [1.0, 0.0, 1.0]
    carry, aux = ss.streaming_init(tp)
    carry = ss.streaming_update(carry, aux, 1.0, _t(y0), rv, obs_mask=_t(om))
    jcarry, jaux = jss.streaming_init(jp)
    jcarry = jss.streaming_update(jcarry, jaux, 1.0, jnp.asarray(y0), rv, obs_mask=jnp.asarray(om))
    assert torch.isfinite(carry.ll)
    assert abs(float(carry.ll) - float(jcarry.ll)) <= 1e-12 * abs(float(jcarry.ll))
    np.testing.assert_allclose(carry.cov.numpy(), np.asarray(jcarry.cov), rtol=0, atol=1e-12)
    got = ss.streaming_predict(carry, aux, tp, 3.0)
    ref = jss.streaming_predict(jcarry, jaux, jp, 3.0)
    for g_, r_ in zip(got, ref):
        np.testing.assert_allclose(g_.numpy(), np.asarray(r_), rtol=0, atol=1e-12)
    assert got[2].shape == (G,) and float(got[3].min()) > 0 and float(got[1]) > 0
