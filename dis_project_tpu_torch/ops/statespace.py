r"""State-space (Markovian) LFM engine: O(T) inference for the first-order
SIMM family, the second-order (spring-damper), multi-force and
delayed-response families by Kalman filtering and RTS smoothing.

Port of those routes of ``dis_project_tpu/ops/statespace.py`` (same
function and argument names).
The latent force's RBF prior is approximated by a balanced order-``p``
linear SDE (or replaced by an exact Matern SDE), the gene ODEs
``dx_j/dt = B_j + S_j f - D_j x_j`` are linear state evolution, so the
augmented state ``z = [f-state (p), x (G)]`` is jointly Markov-Gaussian and
the MLL of the approximated model is a Kalman filter: O(T (p+G)^3) work
instead of O((GT)^3).

- Host constants (:func:`canonical_system`, :func:`matern_canonical_system`):
  numpy/scipy, float64, cached per order and kind.
- :func:`build_lfm_ssm` and :func:`discretize`: differentiable in decay,
  sensitivity and lengthscale; ``discretize`` buckets a vector of steps on
  the host (one ``matrix_exp`` per distinct step) unless the steps carry
  a gradient, which takes one batched ``matrix_exp`` per step (JAX's
  traced branch).
- :func:`kalman_filter`: a Python loop over the steps with the JAX scan's
  per-step algebra (Joseph-form updates, one Cholesky of the innovation
  covariance for gain and log-density). Nothing in the loop syncs with the
  host: the Cholesky is ``cholesky_ex`` with a non-PD innovation
  covariance turned into a NaN factor on the device (the JAX semantics the
  finite guards rely on), and a ``mask`` is read on the host once.
- :func:`parallel_filter` and :func:`blocked_filter`: the filtering
  semigroup (:func:`_combine`, one shared LU per combine) under an eager
  odd/even associative scan (:func:`_associative_scan`, ~2 log2(T)
  batched combines) or under the blocked schedule (~L + B levels);
  :func:`parallel_rts_smoother` and :func:`blocked_rts_smoother` their
  smoothing duals. ``parallel=`` selects the pair (:func:`_select_schedule`).
- :func:`lfm_mll_ss`: the MLL (uniform grids share one (A, Q); optional
  per-entry ``obs_mask`` and the frozen-gain ``stationary_after`` tail).
- The second-order family: :func:`build_lfm2_ssm` (state ``[f-state, x,
  v]``, m = p + 2G; the stationary blocks from batched Lyapunov solves),
  :func:`lfm2_mll_ss` and :func:`lfm2_predict_ss` on the same filters,
  schedules and smoothers.
- The multi-force family: :func:`build_multiforce_ssm` (R independent force
  blocks, ragged for mixed priors), :func:`multisimm_mll_ss` and
  :func:`multisimm_predict_ss`.
- The delay family: each (timepoint, gene) pair one filter step at its
  warped time (:func:`_delay_event_grid`), :func:`delaysimm_mll_ss` (the
  masked chain, or the scalar-observation chain
  :func:`_scalar_obs_filter_ll` under the sequential filter) and
  :func:`delaysimm_predict_ss`.
- :func:`rts_smoother` and :func:`lfm_predict_ss`: smoothed posteriors on
  the union grid or by bridge interpolation, under ``torch.no_grad``.
- :func:`posterior_sample_ss` (FFBS) and :func:`sample_trajectory_ss`:
  joint posterior and prior draws from a ``torch.Generator``.
- The streaming API (:class:`FilterCarry`, :func:`streaming_init`,
  :func:`streaming_update`, :func:`streaming_freeze`,
  :func:`streaming_update_frozen`, :func:`streaming_predict`): one update a
  arrival, no host sync in it (:func:`_expm_device` discretizes the gap on
  the device).

The temporally-sharded schedule (``shard=``) is not yet ported and raises
``NotImplementedError``.

Float32 products must be full FP32: the covariance recursion
``P <- A P A^T + Q`` compounds a reduced-precision product over T steps
(the JAX package measured the MLL ~1.7 nats off and NaN within one Adam
step with single-pass products). Every entry point asserts that TF32 is
off (``ops.precision.pin_full_fp32`` turns it off).
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from dis_project_tpu_torch.ops.precision import assert_full_fp32

LOG_2PI = 1.8378770664093453
_WHO = "ops.statespace"


def _host(a) -> np.ndarray:
    """A host numpy copy of a tensor or array-like (a sync for a CUDA tensor)."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


# ---------------------------------------------------------------------------
# Canonical (unit-time-scale) force SDEs — host-side f64 constants, cached.
# ---------------------------------------------------------------------------


def _psd_sqrt(a: np.ndarray) -> np.ndarray:
    """Symmetric PSD square root via eigh, eigenvalues clipped at
    ``eps * max`` (the highest-order modes of the RBF SDE carry Hankel
    singular values near f64 eps, where a plain Cholesky fails)."""
    w, v = np.linalg.eigh(a)
    w = np.clip(w, np.finfo(np.float64).eps * w.max(), None)
    return v @ np.diag(np.sqrt(w))


@functools.lru_cache(maxsize=None)
def canonical_system(order: int):
    """Balanced LTI SDE realising ``k(tau) ~= exp(-tau^2)`` at unit
    time-scale ``l/2 = 1``: host f64 ``(F_c, h_c, q_c, p_diag)`` — the
    stable drift (p, p), the row reading f (p,), the white-noise density
    and the stationary covariance's diagonal (p,), exactly diagonal by
    construction. Roots of the truncated series ``sum_{k<=p} z^k / k!``
    give the spectral factorisation (Hartikainen & Sarkka 2010); companion
    form, then balanced with the two Gramians' square roots."""
    from scipy.linalg import solve_lyapunov, svd

    p = order
    coeffs = [1.0 / math.factorial(k) for k in range(p, -1, -1)]
    z = np.roots(coeffs)
    w = np.sqrt(-z.astype(complex))
    w = np.where(w.real > 0, -w, w)  # stable half-plane
    a = np.poly(w).real  # monic stable polynomial, length p+1

    f_comp = np.zeros((p, p))
    f_comp[: p - 1, 1:] = np.eye(p - 1)
    f_comp[p - 1, :] = -a[::-1][:p]
    lvec = np.zeros(p)
    lvec[p - 1] = 1.0
    hvec = np.zeros(p)
    hvec[0] = 1.0
    q_c = 2.0 * np.sqrt(np.pi) * math.factorial(p)

    gram_c = solve_lyapunov(f_comp, -q_c * np.outer(lvec, lvec))
    gram_o = solve_lyapunov(f_comp.T, -np.outer(hvec, hvec))
    r_c = _psd_sqrt(gram_c)
    r_o = _psd_sqrt(gram_o)
    u, s, vt = svd(r_o.T @ r_c)
    t_bal = r_c @ vt.T @ np.diag(s**-0.5)
    t_inv = np.diag(s**-0.5) @ u.T @ r_o.T
    f_bal = t_inv @ f_comp @ t_bal
    h_bal = hvec @ t_bal
    # In balanced coordinates the stationary covariance IS diag(s).
    return f_bal, h_bal, q_c, s


@functools.lru_cache(maxsize=None)
def matern_canonical_system(kind: str):
    """Exact canonical LTI SDE of a Matern force prior at unit rate, in
    coordinates with identity stationary covariance: host f64 ``(F_c, h_c,
    p_diag)``, ``p_diag = ones(p)``, p = 1/2/3 for matern12/32/52. The
    physical system at lengthscale ``l`` is ``F = F_c * sqrt(2 nu) / l``."""
    from scipy.linalg import solve_lyapunov

    if kind == "matern12":
        f = np.array([[-1.0]])
        lvec = np.array([1.0])
        q = 2.0
    elif kind == "matern32":
        f = np.array([[0.0, 1.0], [-1.0, -2.0]])
        lvec = np.array([0.0, 1.0])
        q = 4.0
    elif kind == "matern52":
        f = np.array([
            [0.0, 1.0, 0.0],
            [0.0, 0.0, 1.0],
            [-1.0, -3.0, -3.0],
        ])
        lvec = np.array([0.0, 0.0, 1.0])
        q = 16.0 / 3.0
    else:
        raise ValueError(
            f"unknown force kernel {kind!r}; expected rbf, matern12, "
            "matern32 or matern52"
        )
    p_inf = solve_lyapunov(f, -q * np.outer(lvec, lvec))
    # Whiten: identity stationary covariance (the diagonal form the
    # augmented builder assumes).
    l_chol = np.linalg.cholesky(p_inf)
    l_inv = np.linalg.inv(l_chol)
    f_bal = l_inv @ f @ l_chol
    h_bal = np.zeros(f.shape[0])
    h_bal[0] = 1.0
    h_bal = h_bal @ l_chol
    return f_bal, h_bal, np.ones(f.shape[0])


_FORCE_RATE = {
    "rbf": 2.0,            # canonical time unit is l/2
    "matern12": 1.0,       # lambda = sqrt(2 nu)/l, nu = 1/2
    "matern32": math.sqrt(3.0),
    "matern52": math.sqrt(5.0),
}


def _force_system(order: int, force_kernel: str):
    """(F_c, h_c, p_diag, rate_over_l) of the force prior; ``order``
    applies to the RBF approximation only."""
    if force_kernel == "rbf":
        f_c, h_c, _, p_diag = canonical_system(order)
    else:
        f_c, h_c, p_diag = matern_canonical_system(force_kernel)
    return f_c, h_c, p_diag, _FORCE_RATE[force_kernel]


# ---------------------------------------------------------------------------
# The augmented (force-state, genes) model — differentiable in the params.
# ---------------------------------------------------------------------------


def build_lfm_ssm(decay, sens, lengthscale, order: int = 10, force_kernel: str = "rbf"):
    """Augmented LFM state-space model of the first-order SIMM:
    ``(F, P_inf, P0, h_force)``, each (m, m) or (m,), m = p + G.

    ``F = [[F_f, 0], [S h_c^T, -diag(D)]]`` with the force block scaled by
    ``rate / l``; ``P_inf`` the stationary covariance from the constant
    force block and closed-form cross/gene blocks (one batched (p, p)
    solve over the genes, ``solve_ex`` so that nothing syncs); ``P0`` the
    reference's t=0 convention (force stationary, genes deterministic at
    ``B/D``); ``h_force`` reads f(t) out of the state."""
    dtype, dev = decay.dtype, decay.device
    f_c, h_c, p_diag, rate = _force_system(order, force_kernel)
    p = f_c.shape[0]
    g = decay.shape[0]
    kw = dict(dtype=dtype, device=dev)

    f_c = torch.as_tensor(f_c, **kw)
    h_c = torch.as_tensor(h_c, **kw)
    p_ff = torch.as_tensor(np.diag(p_diag), **kw)

    f_force = f_c * (rate / lengthscale)
    top = torch.cat([f_force, torch.zeros((p, g), **kw)], dim=1)
    bottom = torch.cat([sens[:, None] * h_c[None, :], -torch.diag(decay)], dim=1)
    f_aug = torch.cat([top, bottom], dim=0)

    # fx column j: (F_f - D_j I) c_j = -S_j P_ff h_c;
    # xx: (D_i + D_j) P_xx[i, j] = sym(S_i (h_c P_fx)[j]).
    rhs = p_ff @ h_c  # (p,)
    eye_p = torch.eye(p, **kw)
    mats = f_force[None, :, :] - decay[:, None, None] * eye_p
    sol, _ = torch.linalg.solve_ex(mats, rhs.expand(g, p)[..., None])
    p_fx = (-sens[:, None] * sol[..., 0]).T  # (p, g)
    hp = h_c @ p_fx  # (g,)
    mx = sens[:, None] * hp[None, :]
    p_xx = (mx + mx.T) / (decay[:, None] + decay[None, :])
    p_inf = torch.cat([torch.cat([p_ff, p_fx], dim=1), torch.cat([p_fx.T, p_xx], dim=1)],
                      dim=0)
    p0 = F.pad(p_ff, (0, g, 0, g))
    h_force = torch.cat([h_c, torch.zeros((g,), **kw)])
    return f_aug, p_inf, p0, h_force


def _symmetrize(p):
    return 0.5 * (p + p.mT)


def _osc_matrix(alpha, spring):
    """(G, 2, 2) oscillator blocks ``[[0, 1], [-k_j, -2 alpha_j]]``."""
    zero, one = torch.zeros_like(alpha), torch.ones_like(alpha)
    return torch.stack([torch.stack([zero, one], -1),
                        torch.stack([-spring, -2.0 * alpha], -1)], -2)


def build_lfm2_ssm(alpha, omega, sens, lengthscale, order: int = 10,
                   force_kernel: str = "rbf"):
    """Augmented state-space model of the second-order (spring-damper) LFM
    (``models.simm2``): ``x_j'' + 2 alpha_j x_j' + k_j x_j = B_j + S_j f``,
    ``k_j = alpha_j^2 + omega_j^2``, linear state evolution in ``(x_j, v_j)``
    under the force prior of :func:`build_lfm_ssm`. State
    ``z = [f-state (p), x (G), v (G)]``, m = p + 2G; the t=0 convention of the
    closed forms (position at the steady state, velocity 0, both
    deterministic, force stationary). Its only transcendental is the
    ``expm`` of a stable matrix, so it stays finite where the complex-erf
    closed forms overflow (``omega l`` past ~12).

    The stationary blocks solve the Lyapunov equation column by column in
    the row-major vec form: per gene the (2p, 2p) system
    ``(F_f (x) I_2 + I_p (x) A_j) vec C_j = -vec(P_ff M_j^T)`` and per gene
    pair the 4 x 4 system ``(A_i (x) I_2 + I_2 (x) A_j) vec P_ij =
    -vec(M_i C_j + (M_j C_i)^T)``, each a batched ``solve_ex`` (no host
    sync), differentiable in alpha, omega, sens and lengthscale.

    Returns ``(F, P_inf, P0, h_force)``."""
    dtype, dev = alpha.dtype, alpha.device
    f_c, h_c, p_diag, rate = _force_system(order, force_kernel)
    p = f_c.shape[0]
    g = alpha.shape[0]
    kw = dict(dtype=dtype, device=dev)
    spring = alpha**2 + omega**2

    f_c = torch.as_tensor(f_c, **kw)
    h_c = torch.as_tensor(h_c, **kw)
    p_ff = torch.as_tensor(np.diag(p_diag), **kw)
    f_force = f_c * (rate / lengthscale)

    zeros_pg = torch.zeros((p, g), **kw)
    zeros_gg = torch.zeros((g, g), **kw)
    eye_g = torch.eye(g, **kw)
    f_aug = torch.cat([
        torch.cat([f_force, zeros_pg, zeros_pg], dim=1),
        torch.cat([zeros_pg.T, zeros_gg, eye_g], dim=1),  # dx = v
        torch.cat([sens[:, None] * h_c[None, :], -torch.diag(spring),
                   -torch.diag(2.0 * alpha)], dim=1),  # dv = S f - k x - 2 a v
    ], dim=0)

    a_mat = _osc_matrix(alpha, spring)  # (G, 2, 2)
    eye2 = torch.eye(2, **kw)
    eye_p = torch.eye(p, **kw)
    # kron(F_f, I_2) and the per-gene kron(I_p, A_j), row-major.
    kron_f = (f_force[:, None, :, None] * eye2[None, :, None, :]).reshape(2 * p, 2 * p)
    kron_a = (eye_p[None, :, None, :, None] * a_mat[:, None, :, None, :]).reshape(g, 2 * p, 2 * p)
    rhs_base = p_ff @ h_c  # (p,)
    b = torch.stack([torch.zeros((g, p), **kw), sens[:, None] * rhs_base[None, :]], dim=-1)
    sol, _ = torch.linalg.solve_ex(kron_f[None] + kron_a, -b.reshape(g, 2 * p, 1))
    c_blocks = sol.reshape(g, p, 2)  # (G, p, 2): cov(f-state, (x_j, v_j))

    # Gene pairs: b[r, s] = d_{r1} S_i (h_c C_j)[s] + d_{s1} S_j (h_c C_i)[r].
    hc_c = torch.einsum("i,gis->gs", h_c, c_blocks)  # (G, 2)
    sel = eye2[1]  # e_1
    b2 = (sel[None, None, :, None] * (sens[:, None, None] * hc_c[None, :, :])[:, :, None, :]
          + sel[None, None, None, :] * (sens[None, :, None] * hc_c[:, None, :])[:, :, :, None])
    kron_i = (a_mat[:, None, :, None, :, None] * eye2[None, None, None, :, None, :]).reshape(
        g, 1, 4, 4)
    kron_j = (eye2[None, None, :, None, :, None] * a_mat[None, :, None, :, None, :]).reshape(
        1, g, 4, 4)
    sol2, _ = torch.linalg.solve_ex(kron_i + kron_j, -b2.reshape(g, g, 4, 1))
    pair = sol2.reshape(g, g, 2, 2)  # [i, j] = P_{(x_i, v_i), (x_j, v_j)}

    c_x, c_v = c_blocks[:, :, 0].T, c_blocks[:, :, 1].T  # (p, G)
    p_inf = torch.cat([
        torch.cat([p_ff, c_x, c_v], dim=1),
        torch.cat([c_x.T, pair[:, :, 0, 0], pair[:, :, 0, 1]], dim=1),
        torch.cat([c_v.T, pair[:, :, 1, 0], pair[:, :, 1, 1]], dim=1),
    ], dim=0)
    p_inf = _symmetrize(p_inf)

    p0 = F.pad(p_ff, (0, 2 * g, 0, 2 * g))
    h_force = torch.cat([h_c, torch.zeros((2 * g,), **kw)])
    return f_aug, p_inf, p0, h_force


def build_multiforce_ssm(decay, sens, lengthscales, order: int = 10, force_kernels=None):
    """Augmented state-space model of the R-force SIMM (``models.multisimm``):
    ``dx_j/dt = B_j + sum_r S_jr f_r - D_j x_j`` with R independent force
    priors, each ``'rbf'`` (order-``order`` SDE of the Lawrence-convention
    prior the closed forms integrate) or an exact Matern
    (``force_kernels``, a tuple of R kinds; default all ``'rbf'``). The
    force blocks are ragged (dims p_r) and block-diagonal; per force one
    batched ``solve_ex`` over the genes gives the (p_r, G) cross block, and
    the gene-gene block sums the per-force closed forms.

    ``sens``: (G, R); ``lengthscales``: (R,). State ``z = [f_1-state, ...,
    f_R-state, x (G)]``. Returns ``(F, P_inf, P0, h_forces)``, ``h_forces``
    (R, m) reading each force out of the state."""
    dtype, dev = decay.dtype, decay.device
    kw = dict(dtype=dtype, device=dev)
    g, r = sens.shape
    if force_kernels is None:
        force_kernels = ("rbf",) * r
    if len(force_kernels) != r:
        raise ValueError(f"force_kernels has {len(force_kernels)} entries for {r} forces")

    h_cs, p_ffs, f_blocks = [], [], []
    for i, kind in enumerate(force_kernels):
        f_c, h_c, p_diag, rate = _force_system(order, kind)
        h_cs.append(torch.as_tensor(h_c, **kw))
        p_ffs.append(torch.as_tensor(np.diag(p_diag), **kw))
        f_blocks.append(torch.as_tensor(f_c, **kw) * (rate / lengthscales[i]))
    dims = [h.shape[0] for h in h_cs]
    p_tot = sum(dims)
    offs = np.concatenate([[0], np.cumsum(dims)])

    # Row j of the gene block reads sum_r S_jr f_r, f_r = h_c_r . z_r.
    coupling = torch.cat([sens[:, i:i + 1] * h_cs[i][None, :] for i in range(r)], dim=1)
    f_aug = torch.cat([
        torch.cat([torch.block_diag(*f_blocks), torch.zeros((p_tot, g), **kw)], dim=1),
        torch.cat([coupling, -torch.diag(decay)], dim=1),
    ], dim=0)

    # Per force r: (F_r - D_j I) c_rj = -S_jr P_ff_r h_c_r, batched over j;
    # gene-gene: (D_i + D_j) P_xx[i, j] = sum_r sym(S_ir (h_r P_fx_r)_j).
    p_fx_parts, hp_parts = [], []
    for i in range(r):
        rhs = p_ffs[i] @ h_cs[i]
        mats = f_blocks[i][None, :, :] - decay[:, None, None] * torch.eye(dims[i], **kw)
        sol, _ = torch.linalg.solve_ex(mats, rhs.expand(g, dims[i])[..., None])
        p_fx_i = (-sens[:, i:i + 1] * sol[..., 0]).T  # (p_i, G)
        p_fx_parts.append(p_fx_i)
        hp_parts.append(h_cs[i] @ p_fx_i)
    mx = sum(sens[:, i][:, None] * hp_parts[i][None, :] for i in range(r))
    p_xx = (mx + mx.T) / (decay[:, None] + decay[None, :])
    p_fx = torch.cat(p_fx_parts, dim=0)  # (p_tot, G)
    p_ff = torch.block_diag(*p_ffs)
    p_inf = torch.cat([torch.cat([p_ff, p_fx], dim=1), torch.cat([p_fx.T, p_xx], dim=1)], dim=0)
    p0 = F.pad(p_ff, (0, g, 0, g))
    h_forces = torch.zeros((r, p_tot + g), **kw)
    for i in range(r):
        h_forces[i, offs[i]:offs[i + 1]] = h_cs[i]
    return f_aug, p_inf, p0, h_forces


def discretize(f_aug, p_inf, dts, max_unique: int | None = None):
    """Exact discretization over step sizes ``dts`` (scalar or (T,)):
    ``A = expm(F dt)`` and ``Q = P_inf - A P_inf A^T`` (the stationarity
    identity). A scalar step returns (m, m) matrices; a (T,) vector returns
    (T, m, m), one ``matrix_exp`` per DISTINCT step gathered to the steps
    (the steps are read on the host; equal steps get bitwise-equal
    transitions). Steps that require a gradient take one batched
    ``matrix_exp`` over all T instead, differentiable in ``dts`` (JAX's
    branch for traced steps).

    ``max_unique``: a checked bound on the number of distinct steps of the
    bucketed branch — ``ValueError`` when ``dts`` holds more (the JAX
    package's silent nearest-bucket gather under jit has no counterpart in
    the port)."""

    def expm_q(dt):
        a = torch.linalg.matrix_exp(f_aug * dt[..., None, None])
        return a, _symmetrize(p_inf - a @ p_inf @ a.mT)

    if not isinstance(dts, torch.Tensor):
        dts = torch.as_tensor(dts, dtype=f_aug.dtype, device=f_aug.device)
    if dts.ndim == 0 or dts.requires_grad:
        return expm_q(dts)
    u, inv = np.unique(_host(dts), return_inverse=True)
    if max_unique is not None and u.size > max_unique:
        raise ValueError(
            f"the step sizes hold {u.size} distinct values, more than "
            f"max_unique={max_unique}"
        )
    a_u, q_u = expm_q(torch.as_tensor(u, dtype=dts.dtype, device=f_aug.device))
    idx = torch.as_tensor(inv.reshape(-1), device=f_aug.device)
    return a_u[idx], q_u[idx]


# Pade [13/13] (float64) and [7/7] (float32): the 1-norm below which the
# approximant needs no scaling, and its coefficients b_0..b_q (Higham 2005;
# jax.scipy.linalg.expm's highest degree for each type).
_PADE = {
    torch.float64: (5.371920351148152, (
        64764752532480000.0, 32382376266240000.0, 7771770303897600.0, 1187353796428800.0,
        129060195264000.0, 10559470521600.0, 670442572800.0, 33522128640.0, 1323241920.0,
        40840800.0, 960960.0, 16380.0, 182.0, 1.0)),
    torch.float32: (3.925724783138660, (
        17297280.0, 8648640.0, 1995840.0, 277200.0, 25200.0, 1512.0, 56.0, 1.0)),
}
# Squarings that _expm_device can apply: a larger 1-norm gives NaN.
EXPM_MAX_SQUARINGS = 20


def _expm_device(x):
    """``expm(x)`` (batched over leading axes) by scaling and squaring with
    no host sync: the scaling ``s`` is computed on the device and the
    squarings run ``EXPM_MAX_SQUARINGS`` times, each kept or dropped by a
    device-side select (``torch.linalg.matrix_exp`` reads its scaling on
    the host, one sync a call). A 1-norm above ``2^EXPM_MAX_SQUARINGS``
    times the Pade bound gives NaN, never a wrong finite transition."""
    theta, b = _PADE[x.dtype]
    eye = torch.eye(x.shape[-1], dtype=x.dtype, device=x.device)
    s = torch.clamp(torch.ceil(torch.log2(x.abs().sum(-2).amax(-1) / theta)), min=0.0)
    xs = x * torch.exp2(-s)[..., None, None]
    x2 = xs @ xs
    x4 = x2 @ x2
    x6 = x4 @ x2
    if len(b) == 14:
        u = xs @ (x6 @ (b[13] * x6 + b[11] * x4 + b[9] * x2)
                  + b[7] * x6 + b[5] * x4 + b[3] * x2 + b[1] * eye)
        v = x6 @ (b[12] * x6 + b[10] * x4 + b[8] * x2) + b[6] * x6 + b[4] * x4 + b[2] * x2 \
            + b[0] * eye
    else:
        u = xs @ (b[7] * x6 + b[5] * x4 + b[3] * x2 + b[1] * eye)
        v = b[6] * x6 + b[4] * x4 + b[2] * x2 + b[0] * eye
    r, _ = torch.linalg.solve_ex(v - u, v + u)
    squaring = torch.arange(EXPM_MAX_SQUARINGS, device=x.device) < s[..., None]
    for k in range(EXPM_MAX_SQUARINGS):
        r = torch.where(squaring[..., k, None, None], r @ r, r)
    return torch.where((s > EXPM_MAX_SQUARINGS)[..., None, None], torch.nan, r)


def _discretize_device(f_aug, p_inf, dt):
    """:func:`discretize` of a step held on the device (scalar or batched),
    without a host sync (:func:`_expm_device`)."""
    a = _expm_device(f_aug * dt[..., None, None])
    return a, _symmetrize(p_inf - a @ p_inf @ a.mT)


def gene_observation_matrix(order: int, num_genes: int, replicates: int = 1,
                            dtype=torch.float64, device=None):
    """H reading the gene states out of ``z``, replicate-tiled (replicates
    share one latent trajectory and differ only in observation noise)."""
    h_x = torch.cat([torch.zeros((num_genes, order), dtype=dtype, device=device),
                     torch.eye(num_genes, dtype=dtype, device=device)], dim=1)
    return h_x.repeat(replicates, 1)


# ---------------------------------------------------------------------------
# Kalman filtering (the sequential schedule).
# ---------------------------------------------------------------------------


def _cholesky(s_mat):
    """Lower Cholesky factor without a host sync: NaN where ``s_mat`` is not
    positive definite (``jnp.linalg.cholesky``'s answer)."""
    chol, info = torch.linalg.cholesky_ex(s_mat)
    return torch.where((info > 0)[..., None, None], torch.nan, chol)


def _gauss_ll_chol(r, chol):
    """log N(r; 0, L L^T) from the innovation covariance's factor, batched
    over leading axes of ``r`` (..., n_o) and ``chol`` (..., n_o, n_o)."""
    al = torch.linalg.solve_triangular(chol, r[..., None], upper=False)[..., 0]
    return (
        -0.5 * torch.sum(al * al, dim=-1)
        - torch.sum(torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)), dim=-1)
        - 0.5 * r.shape[-1] * LOG_2PI
    )


def _joseph_update(m_pred, p_pred, h, r_var, y):
    """One measurement update: ``(m, P, ll)``, Joseph-form covariance; one
    Cholesky of the innovation covariance serves the gain and the
    log-density."""
    hp = h @ p_pred
    s_mat = hp @ h.T + torch.diag(r_var)
    chol = _cholesky(s_mat)
    r = y - h @ m_pred
    gain = torch.cholesky_solve(hp, chol).T  # P H^T S^-1
    m_new = m_pred + gain @ r
    ikh = torch.eye(p_pred.shape[0], dtype=p_pred.dtype, device=p_pred.device) - gain @ h
    p_new = ikh @ p_pred @ ikh.T + (gain * r_var[None, :]) @ gain.T
    return m_new, _symmetrize(p_new), _gauss_ll_chol(r, chol)


def _joseph_update_sel(m_pred, p_pred, p_off, r_var, y):
    """:func:`_joseph_update` for the selection ``H = [0 | I_{n_o} | 0]``
    reading state coordinates ``p_off : p_off + n_o``: ``H P`` is a row
    slice, ``S`` a corner slice and ``I - K H`` a column update."""
    n_o = y.shape[0]
    m_dim = p_pred.shape[0]
    pg = p_pred[p_off:p_off + n_o, :]  # H P  (n_o, m)
    s_mat = pg[:, p_off:p_off + n_o] + torch.diag(r_var)
    chol = _cholesky(s_mat)
    r = y - m_pred[p_off:p_off + n_o]
    gain = torch.cholesky_solve(pg, chol).T  # (m, n_o)
    m_new = m_pred + gain @ r
    eye = torch.eye(m_dim, dtype=p_pred.dtype, device=p_pred.device)
    ikh = eye - F.pad(gain, (p_off, m_dim - p_off - n_o))
    p_new = ikh @ p_pred @ ikh.T + (gain * r_var[None, :]) @ gain.T
    return m_new, _symmetrize(p_new), _gauss_ll_chol(r, chol)


def _mask_obs(h, r_var, ys, obs_mask):
    """Per-entry masking as an exact input transform: a missing entry's H
    row is zeroed, its noise variance set to 1 and its (possibly NaN)
    observation to 0, so its innovation coordinate is N(0; 0, 1),
    decoupled from the rest; :func:`_mask_ll_correction` adds back the
    constant it contributes. Returns per-step ``h`` (T, n_o, m) and
    sanitised ``(r_var, ys)``."""
    h_t = h[None, :, :] * obs_mask[:, :, None]
    r_var = torch.where(obs_mask > 0, r_var, torch.ones_like(r_var))
    ys = torch.where(obs_mask > 0, ys, torch.zeros_like(ys))
    return h_t, r_var, ys


def _mask_ll_correction(obs_mask):
    """(T,) per-step corrections for :func:`_mask_obs`: +log(2 pi)/2 per
    masked entry."""
    n_o = obs_mask.shape[1]
    return 0.5 * LOG_2PI * (n_o - obs_mask.sum(dim=1))


def kalman_filter(a, q, h, r_var, ys, p0, m0=None, mask=None, obs_mask=None,
                  obs_slice=None):
    """Sequential Kalman filter.

    ``a``/``q``: (m, m) shared by all steps or (T, m, m); ``h``: (n_o, m);
    ``r_var``: (n_o,) or (T, n_o); ``ys``: (T, n_o) centered observations;
    ``p0``: the prior covariance before the first transition. ``mask``:
    optional (T,) {0, 1}, read on the host — steps with 0 skip the update
    and add no likelihood. ``obs_mask``: optional (T, n_o) {0, 1} per-entry
    missingness (those entries of ``ys`` may be NaN). ``obs_slice``: the
    promise that ``h`` is the selection ``[0 | I | 0]`` of the coordinates
    ``obs_slice : obs_slice + n_o`` (the sliced update; ignored with
    ``obs_mask``).

    Returns ``(ms, ps, ll)``: filtered means (T, m), covariances (T, m, m)
    and the marginal log-likelihood. No step syncs with the host.
    """
    assert_full_fp32(_WHO)
    t_steps, n_o = ys.shape
    m_dim = p0.shape[0]
    dtype, dev = p0.dtype, p0.device
    if m0 is None:
        m0 = torch.zeros((m_dim,), dtype=dtype, device=dev)
    r_var = torch.broadcast_to(torch.as_tensor(r_var, dtype=dtype, device=dev), (t_steps, n_o))
    h_t = ll_corr = None
    if obs_mask is not None:
        obs_mask = torch.as_tensor(obs_mask, dtype=dtype, device=dev)
        h_t, r_var, ys = _mask_obs(h, r_var, ys, obs_mask)
        ll_corr = _mask_ll_correction(obs_mask)
        obs_slice = None
    weights = None if mask is None else _host(mask).reshape(t_steps).tolist()
    shared_aq = a.ndim == 2

    m_cur, p_cur = m0, p0
    ll = torch.zeros((), dtype=dtype, device=dev)
    ms, ps = [], []
    for i in range(t_steps):
        a_i, q_i = (a, q) if shared_aq else (a[i], q[i])
        m_pred = a_i @ m_cur
        p_pred = _symmetrize(a_i @ p_cur @ a_i.T + q_i)
        w = 1.0 if weights is None else weights[i]
        if w > 0:
            if obs_slice is not None:
                m_cur, p_cur, ll_i = _joseph_update_sel(m_pred, p_pred, obs_slice, r_var[i], ys[i])
            else:
                h_i = h if h_t is None else h_t[i]
                m_cur, p_cur, ll_i = _joseph_update(m_pred, p_pred, h_i, r_var[i], ys[i])
            if ll_corr is not None:
                ll_i = ll_i + ll_corr[i]
            ll = ll + (ll_i if w == 1.0 else w * ll_i)
        else:
            m_cur, p_cur = m_pred, p_pred
        ms.append(m_cur)
        ps.append(p_cur)
    return torch.stack(ms), torch.stack(ps), ll


# ---------------------------------------------------------------------------
# The filtering semigroup and the log-depth and blocked schedules.
# ---------------------------------------------------------------------------


def _mv(mat, vec):
    """Batched matrix-vector product over arbitrary leading axes."""
    return (mat @ vec[..., None])[..., 0]


def _filter_element(a, q, h, rv, ys, mask):
    """Per-step elements of the filtering semigroup (Sarkka &
    Garcia-Fernandez 2021, eq. 10), batched over the T steps: ``(A, b, C,
    eta, J)`` such that composing elements left to right gives the
    filtered posterior. ``a``/``q`` (T, m, m), ``h`` (n_o, m) or (T, n_o,
    m), ``rv``/``ys`` (T, n_o), ``mask`` (T,) or None. A masked step (no
    observation) is the pure prediction element (A_i, 0, Q_i, 0, 0)."""
    hq = h @ q
    chol = _cholesky(hq @ h.mT + torch.diag_embed(rv))
    ha = h @ a
    m_dim = q.shape[-1]
    # S^-1 [H Q | H A]: one solve for the gain and for J's factor.
    sinv = torch.cholesky_solve(torch.cat([hq, ha], dim=-1), chol)
    gain = sinv[..., :m_dim].mT  # Q H^T S^-1  (T, m, n_o)
    sinv_ha = sinv[..., m_dim:]
    ikh = torch.eye(m_dim, dtype=q.dtype, device=q.device) - gain @ h
    a_e = ikh @ a
    b_e = _mv(gain, ys)
    c_e = _symmetrize(ikh @ q)
    eta_e = _mv(sinv_ha.mT, ys)
    j_e = _symmetrize(ha.mT @ sinv_ha)
    if mask is None:
        return a_e, b_e, c_e, eta_e, j_e
    keep = mask > 0
    k2, k3 = keep[:, None], keep[:, None, None]
    return (torch.where(k3, a_e, a), torch.where(k2, b_e, 0.0), torch.where(k3, c_e, q),
            torch.where(k2, eta_e, 0.0), torch.where(k3, j_e, 0.0))


def _combine(e1, e2):
    """Associative composition of filtering elements (ibid., lemma 8),
    ``e1`` the earlier interval, batched over leading axes. ``C1`` and
    ``J2`` are symmetric, so the lemma's two resolvents ``(I + C1 J2)^-1``
    and ``(I + J2 C1)^-1`` are one matrix ``E = I + J2 C1`` solved
    transposed and plain: one LU (``lu_factor_ex``, no host check) serves
    both ``lu_solve`` calls, as JAX's ``lu_solve`` trans=0/1 share one."""
    a1, b1, c1, eta1, j1 = e1
    a2, b2, c2, eta2, j2 = e2
    e_mat = j2 @ c1
    e_mat.diagonal(dim1=-2, dim2=-1).add_(1.0)
    lu, piv, _ = torch.linalg.lu_factor_ex(e_mat)
    a2d = torch.linalg.lu_solve(lu, piv, a2.mT).mT  # A2 (I + C1 J2)^-1
    a_new = a2d @ a1
    b_new = _mv(a2d, b1 + _mv(c1, eta2)) + b2
    c_new = _symmetrize(a2d @ c1 @ a2.mT + c2)
    a1t_einv = torch.linalg.lu_solve(lu, piv, a1, adjoint=True).mT  # A1^T (I + J2 C1)^-1
    eta_new = _mv(a1t_einv, eta2 - _mv(j2, b1)) + eta1
    j_new = _symmetrize(a1t_einv @ j2 @ a1 + j1)
    return a_new, b_new, c_new, eta_new, j_new


def _apply_state(m_s, p_s, elem):
    """Fold a filtered state ``(m, P)`` through a composite element:
    ``combine((0, m, P, 0, 0), elem)``'s two outputs,
    ``m' = A2 (I + P J2)^-1 (m + P eta2) + b2`` and
    ``P' = A2 (I + P J2)^-1 P A2^T + C2`` — one LU, three products.
    Batched over leading axes."""
    a2, b2, c2, eta2, j2 = elem
    e_mat = j2 @ p_s
    e_mat.diagonal(dim1=-2, dim2=-1).add_(1.0)
    lu, piv, _ = torch.linalg.lu_factor_ex(e_mat)
    a2d = torch.linalg.lu_solve(lu, piv, a2.mT).mT  # A2 (I + P J2)^-1
    m_new = _mv(a2d, m_s + _mv(p_s, eta2)) + b2
    p_new = _symmetrize(a2d @ p_s @ a2.mT + c2)
    return m_new, p_new


def _identity_element(m_dim, dtype, device=None):
    """Identity of the filtering semigroup: combine(e, I) == e == combine(I, e)."""
    kw = dict(dtype=dtype, device=device)
    return (torch.eye(m_dim, **kw), torch.zeros((m_dim,), **kw), torch.zeros((m_dim, m_dim), **kw),
            torch.zeros((m_dim,), **kw), torch.zeros((m_dim, m_dim), **kw))


def _prior_element(m0, p0):
    """The prior as a semigroup element ``(0, m0, P0, 0, 0)``: composed on
    the left of the per-step elements it gives the filtered posterior at
    every prefix (:func:`parallel_filter` puts the step-0 posterior in
    element 0 this way)."""
    m_dim = m0.shape[0]
    zeros = torch.zeros((m_dim, m_dim), dtype=p0.dtype, device=p0.device)
    return zeros, m0, p0, torch.zeros_like(m0), zeros


def _associative_scan(fn, elems, reverse=False):
    """Inclusive scan of the associative ``fn`` over the leading axis of a
    tuple of (T, ...) tensors, by ``jax.lax.associative_scan``'s odd/even
    recursion: combine neighbouring pairs, scan the half-length sequence,
    combine back into the even positions. One call makes about
    2 ceil(log2 T) batched ``fn`` calls, each over up to T/2 elements; any
    T works. ``reverse=True`` scans from the end (JAX's element flip, so
    ``fn`` receives the later interval first). Gradients come from
    autograd through the slices."""
    if reverse:
        elems = tuple(torch.flip(e, (0,)) for e in elems)
    out = _scan_levels(fn, elems)
    if reverse:
        out = tuple(torch.flip(e, (0,)) for e in out)
    return out


def _scan_levels(fn, elems):
    n = elems[0].shape[0]
    if n < 2:
        return elems
    reduced = fn(tuple(e[0:-1:2] for e in elems), tuple(e[1::2] for e in elems))
    odd = _scan_levels(fn, reduced)
    if n % 2 == 0:
        even = fn(tuple(e[:-1] for e in odd), tuple(e[2::2] for e in elems))
    else:
        even = fn(odd, tuple(e[2::2] for e in elems))
    even = tuple(torch.cat([e[:1], r]) for e, r in zip(elems, even))
    return tuple(_interleave(a, b) for a, b in zip(even, odd))


def _interleave(a, b):
    """``a0 b0 a1 b1 ...`` along the leading axis (len(a) - len(b) in {0, 1})."""
    n_b = b.shape[0]
    pairs = torch.stack([a[:n_b], b], dim=1).reshape((2 * n_b,) + b.shape[1:])
    return pairs if a.shape[0] == n_b else torch.cat([pairs, a[n_b:]])


def _schedule_inputs(a, q, h, r_var, ys, p0, m0, mask, obs_mask):
    """Shared set-up of the semigroup schedules: per-step (A, Q), noise,
    the masked observation model and the per-step likelihood corrections,
    and the elements of every step."""
    t_steps, n_o = ys.shape
    m_dim = p0.shape[0]
    dtype, dev = p0.dtype, p0.device
    if m0 is None:
        m0 = torch.zeros((m_dim,), dtype=dtype, device=dev)
    r_var = torch.broadcast_to(torch.as_tensor(r_var, dtype=dtype, device=dev), (t_steps, n_o))
    if mask is not None:
        mask = torch.as_tensor(mask, dtype=dtype, device=dev).reshape(t_steps)
    h_t, ll_corr = h, None
    if obs_mask is not None:
        obs_mask = torch.as_tensor(obs_mask, dtype=dtype, device=dev)
        h_t, r_var, ys = _mask_obs(h, r_var, ys, obs_mask)
        ll_corr = _mask_ll_correction(obs_mask)
    if a.ndim == 2:
        a = torch.broadcast_to(a, (t_steps, m_dim, m_dim))
        q = torch.broadcast_to(q, (t_steps, m_dim, m_dim))
    elems = _filter_element(a, q, h_t, r_var, ys, mask)
    return a, q, h_t, r_var, ys, m0, mask, ll_corr, elems


def _prefix_ll(a, q, h_t, r_var, ys, m0, p0, ms, ps, mask, ll_corr):
    """The exact log-likelihood from the filtered prefix: every step's
    one-step predictive density ``N(y_i; H A_i m_{i-1}, H (A_i P_{i-1}
    A_i^T + Q_i) H^T + R_i)``, batched over the steps."""
    m_prev = torch.cat([m0[None], ms[:-1]])
    p_prev = torch.cat([p0[None], ps[:-1]])
    p_pred = a @ p_prev @ a.mT + q
    chol = _cholesky(h_t @ p_pred @ h_t.mT + torch.diag_embed(r_var))
    lls = _gauss_ll_chol(ys - _mv(h_t, _mv(a, m_prev)), chol)
    if ll_corr is not None:
        lls = lls + ll_corr
    return torch.sum(lls if mask is None else mask * lls)


def parallel_filter(a, q, h, r_var, ys, p0, m0=None, mask=None, obs_mask=None):
    """Log-depth Kalman filter: :func:`_associative_scan` over the
    filtering semigroup. The output contract of :func:`kalman_filter`
    (filtered means and covariances, the exact MLL, ``mask`` and per-entry
    ``obs_mask``); ``mask`` is used on the device, not read on the host.

    The prior is folded into element 0 (A = 0, (b, C) the filtered
    posterior at step 0), so every prefix composite is the filtered
    result; the log-likelihood is read off the filtered prefix
    (:func:`_prefix_ll`)."""
    assert_full_fp32(_WHO)
    a, q, h_t, r_var, ys, m0, mask, ll_corr, elems = _schedule_inputs(
        a, q, h, r_var, ys, p0, m0, mask, obs_mask)
    h0 = h_t if h_t.ndim == 2 else h_t[0]
    m_pred0 = a[0] @ m0
    p_pred0 = _symmetrize(a[0] @ p0 @ a[0].T + q[0])
    m_f0, p_f0, _ = _joseph_update(m_pred0, p_pred0, h0, r_var[0], ys[0])
    if mask is not None:
        m_f0 = torch.where(mask[0] > 0, m_f0, m_pred0)
        p_f0 = torch.where(mask[0] > 0, p_f0, p_pred0)
    elems = tuple(torch.cat([f[None], e[1:]]) for f, e in zip(_prior_element(m_f0, p_f0), elems))
    _, ms, ps, _, _ = _associative_scan(_combine, elems)
    return ms, ps, _prefix_ll(a, q, h_t, r_var, ys, m0, p0, ms, ps, mask, ll_corr)


def _blocked_layout(t_steps, block):
    """``(L, B, pad)`` of the blocked schedules: L the within-block length
    (batched combines, depth L), B the number of blocks (the sequential
    composite chain, depth B). ``block=None`` picks L ~ sqrt(T) rounded to
    a power of two, where the depth L + B is least."""
    if block is None:
        block = 1 << max(1, round(math.log2(max(t_steps, 4)) / 2))
    block = max(2, min(int(block), t_steps))
    n_blocks = -(-t_steps // block)
    return block, n_blocks, n_blocks * block - t_steps


def _to_blocks(elems, ident, block_l, n_blocks, pad):
    """(T, ...) elements padded with ``ident`` to L * B and laid out
    (L, B, ...): the within-block offset leads, so one level is a B-wide
    batch."""
    if pad:
        elems = tuple(torch.cat([e, i.expand((pad,) + i.shape)]) for e, i in zip(elems, ident))
    return tuple(e.reshape((n_blocks, block_l) + e.shape[1:]).movedim(0, 1) for e in elems)


def _from_blocks(levels):
    """A list of L tuples of (B, ...) tensors -> a tuple of (B * L, ...)
    tensors in time order."""
    return tuple(torch.stack(f, dim=1).reshape((-1,) + f[0].shape[1:]) for f in zip(*levels))


def blocked_filter(a, q, h, r_var, ys, p0, m0=None, mask=None, obs_mask=None,
                   block: int | None = None):
    """Blocked Kalman filter: batched combines inside blocks, a sequential
    chain across them (depth L + B ~ 2 sqrt(T), ~2T combines in all). The
    output contract of :func:`kalman_filter`.

    1. the T elements, batched;
    2. an L-level loop whose carry is the B-wide batch of block-local
       prefixes, one batched :func:`_combine` a level;
    3. the B composites chained through :func:`_apply_state` into
       block-start states;
    4. one batched :func:`_apply_state` expanding every prefix from its
       block's start state, and the likelihood read off the filtered prefix.

    Padding to L * B uses true identity elements; ``block=None`` resolves
    L ~ sqrt(T) (:func:`_blocked_layout`)."""
    assert_full_fp32(_WHO)
    t_steps = ys.shape[0]
    a, q, h_t, r_var, ys, m0, mask, ll_corr, elems = _schedule_inputs(
        a, q, h, r_var, ys, p0, m0, mask, obs_mask)
    m_dim = p0.shape[0]
    block_l, n_blocks, pad = _blocked_layout(t_steps, block)
    ident = _identity_element(m_dim, p0.dtype, p0.device)
    elems_lb = _to_blocks(elems, ident, block_l, n_blocks, pad)
    carry = tuple(i.expand((n_blocks,) + i.shape) for i in ident)
    prefixes = []
    for j in range(block_l):
        carry = _combine(carry, tuple(e[j] for e in elems_lb))
        prefixes.append(carry)
    # Block-start states: the prior chained through the composites.
    state, starts = (m0, p0), []
    for b in range(n_blocks):
        starts.append(state)
        state = _apply_state(*state, tuple(c[b] for c in carry))
    starts_m = torch.stack([s[0] for s in starts]).repeat_interleave(block_l, dim=0)
    starts_p = torch.stack([s[1] for s in starts]).repeat_interleave(block_l, dim=0)
    ms, ps = _apply_state(starts_m, starts_p, _from_blocks(prefixes))
    ms, ps = ms[:t_steps], ps[:t_steps]
    return ms, ps, _prefix_ll(a, q, h_t, r_var, ys, m0, p0, ms, ps, mask, ll_corr)


# ---------------------------------------------------------------------------
# Schedules, the MLL and its steady-state tail.
# ---------------------------------------------------------------------------


# The smallest T from which ``parallel=None`` picks the blocked pair on a
# CUDA device (None: never). The port's own constant, set from the card:
# at the dense10k ss shape (50 genes, m = 60, float32) the blocked loss and
# gradient beat the sequential one by more than the larger interquartile
# spread at both T measured, 200 and 2000, in two whole runs of
# ``chip_smoke.py`` (``[ss auto]``; NVIDIA H100 80GB HBM3 at 700 W: 159.7 /
# 145.2 ms against 482.8 / 581.1 ms at T = 200; PERF.md). The sequential
# filter makes ~35 launches a step and the card waits on them; the blocked
# schedule makes ~L + T/L levels of batched ones. The JAX package's
# constant is None: on a v5e a scan step costs no launch.
_AUTO_BLOCKED_MIN_T = 200


def _select_schedule(parallel, t_steps, device=None):
    """The (filter, smoother) pair of ``parallel``, with the signatures of
    :func:`kalman_filter` / :func:`rts_smoother`:

    - ``None``: the blocked pair on a CUDA ``device`` (default: the port's
      default device, ``cuda``) when ``T >= _AUTO_BLOCKED_MIN_T``, else the
      sequential pair; never the full associative pair.
    - ``False``: the sequential pair. ``True``: the associative-scan pair.
    - ``'blocked'``: the blocked pair; an int >= 2: the blocked pair with
      that block length (an int < 2 raises ``ValueError``)."""
    if parallel is None:
        on_card = torch.device("cuda" if device is None else device).type == "cuda"
        if on_card and _AUTO_BLOCKED_MIN_T is not None and t_steps >= _AUTO_BLOCKED_MIN_T:
            return blocked_filter, blocked_rts_smoother
        return kalman_filter, rts_smoother
    if parallel == "blocked":
        return blocked_filter, blocked_rts_smoother
    if isinstance(parallel, int) and not isinstance(parallel, bool):
        if parallel < 2:
            raise ValueError(
                f"parallel={parallel}: an integer selects the blocked "
                "schedule's block length and must be >= 2; pass "
                "True/False for the associative/sequential schedules"
            )
        return (functools.partial(blocked_filter, block=parallel),
                functools.partial(blocked_rts_smoother, block=parallel))
    if parallel:
        return parallel_filter, parallel_rts_smoother
    return kalman_filter, rts_smoother


def _sel_kwargs(fil, obs_slice):
    """Forward the selection-H promise to the sequential filter."""
    if fil is kalman_filter and obs_slice is not None:
        return {"obs_slice": obs_slice}
    return {}


def _refuse_shard(shard):
    if shard is not None:
        raise NotImplementedError(
            "shard=: the temporally-sharded filter is not yet ported "
            "(ROADMAP Queue 1 item 17)"
        )


def lfm_mll_ss(params, timepoints, y, *, jitter: float, replicates: int = 1,
               order: int = 10, parallel=None, uniform: bool = True, shard=None,
               obs_mask=None, force_kernel: str = "rbf",
               stationary_after: int | None = None):
    """State-space marginal log-likelihood of gridded SIMM data: the
    layout of ``ExactSIMM.mll_gridded`` (gene-major blocks of one shared
    time grid, replicate-tiled) and its noise convention (``jitter +
    obs_stddev^2``), in O(T (p+G)^3) by Kalman filtering.

    ``uniform=True`` (a promise that the grid is evenly spaced)
    discretizes once for steps 1..T-1, the step from the t=0 prior to
    ``t[0]`` apart; ``uniform=False`` discretizes every step (one
    ``matrix_exp`` per distinct step). ``obs_mask``: optional {0, 1}
    per-entry missingness in ``y``'s layout (masked entries may be NaN).
    ``stationary_after=K``: K exact steps, then the frozen-gain tail
    (:func:`_stationary_tail_ll`); needs ``uniform=True`` and no
    ``obs_mask``. ``force_kernel``: ``'rbf'`` (order-``order`` SDE) or an
    exact ``'matern12'``/``'matern32'``/``'matern52'`` prior.
    ``parallel``: the filter's schedule (:func:`_select_schedule`; the
    selection-H update is the sequential filter's only). ``shard=`` is not
    yet ported.
    """
    assert_full_fp32(_WHO)
    f_aug, p_inf, p0, _ = build_lfm_ssm(
        params.decay, params.sensitivity, params.lengthscale, order=order,
        force_kernel=force_kernel,
    )
    g = params.decay.shape[0]
    t = torch.as_tensor(timepoints)
    h = gene_observation_matrix(p0.shape[0] - g, g, replicates, t.dtype, t.device)
    mean_obs = (params.basal / params.decay).repeat(replicates)
    r_var = torch.full((replicates * g,), jitter, dtype=t.dtype, device=t.device) \
        + params.obs_stddev**2
    return _gridded_ssm_mll(
        f_aug, p_inf, p0, h, mean_obs, t, y, r_var,
        parallel=parallel, uniform=uniform, shard=shard, obs_mask=obs_mask,
        obs_slice=(p0.shape[0] - g) if replicates == 1 else None,
        stationary_after=stationary_after,
    )


def lfm2_mll_ss(params, timepoints, y, *, jitter: float, replicates: int = 1,
                order: int = 10, parallel=None, uniform: bool = True, shard=None,
                obs_mask=None, force_kernel: str = "rbf",
                stationary_after: int | None = None):
    """State-space MLL of the second-order family (``models.simm2``): the
    contract of :func:`lfm_mll_ss` with ``params`` a ``SIMM2Params``
    (alpha/omega in place of decay), the position block observed
    (``H = [0 | I_G | 0]``), mean ``B / k``. O(T (p + 2G)^3), and finite
    where the complex-erf closed forms overflow (:func:`build_lfm2_ssm`)."""
    assert_full_fp32(_WHO)
    f_aug, p_inf, p0, _ = build_lfm2_ssm(
        params.alpha, params.omega, params.sensitivity, params.lengthscale, order=order,
        force_kernel=force_kernel,
    )
    g = params.alpha.shape[0]
    t = torch.as_tensor(timepoints)
    p_f = p0.shape[0] - 2 * g
    h = F.pad(gene_observation_matrix(p_f, g, replicates, t.dtype, t.device), (0, g))
    spring = params.alpha**2 + params.omega**2
    mean_obs = (params.basal / spring).repeat(replicates)
    r_var = torch.full((replicates * g,), jitter, dtype=t.dtype, device=t.device) \
        + params.obs_stddev**2
    return _gridded_ssm_mll(
        f_aug, p_inf, p0, h, mean_obs, t, y, r_var,
        parallel=parallel, uniform=uniform, shard=shard, obs_mask=obs_mask,
        obs_slice=p_f if replicates == 1 else None,
        stationary_after=stationary_after,
    )


def multisimm_mll_ss(params, timepoints, y, *, jitter: float, replicates: int = 1,
                     order: int = 10, parallel=None, uniform: bool = True, shard=None,
                     obs_mask=None, force_kernels=None, stationary_after: int | None = None):
    """State-space MLL of the R-force family (``models.multisimm``): the
    contract of :func:`lfm_mll_ss` with ``params`` a ``MultiSIMMParams``
    (sensitivity (G, R), lengthscale (R,)) and ``force_kernels`` a tuple of
    R priors (:func:`build_multiforce_ssm`). O(T (sum p_r + G)^3)."""
    assert_full_fp32(_WHO)
    f_aug, p_inf, p0, _ = build_multiforce_ssm(
        params.decay, params.sensitivity, params.lengthscale, order=order,
        force_kernels=force_kernels,
    )
    g = params.sensitivity.shape[0]
    t = torch.as_tensor(timepoints)
    h = gene_observation_matrix(p0.shape[0] - g, g, replicates, t.dtype, t.device)
    mean_obs = (params.basal / params.decay).repeat(replicates)
    r_var = torch.full((replicates * g,), jitter, dtype=t.dtype, device=t.device) \
        + params.obs_stddev**2
    return _gridded_ssm_mll(
        f_aug, p_inf, p0, h, mean_obs, t, y, r_var,
        parallel=parallel, uniform=uniform, shard=shard, obs_mask=obs_mask,
        obs_slice=(p0.shape[0] - g) if replicates == 1 else None,
        stationary_after=stationary_after,
    )


def _delay_event_grid(params, t, replicates: int):
    """The delay family's observation events: gene j's observation at
    ``t_i`` reads the shared zero-delay state at ``w_ij = max(t_i -
    delta_j, 0)`` (``models.delaysimm``), so each (timepoint, gene) pair is
    one filter step that observes that gene's replicate rows only.

    Returns ``(ev_t, step_ids, gene_sel, order_idx)``: the T*G warped event
    times sorted stably (equal times, such as genes clamped to t = 0, keep
    their k = i*G + j order), each event's timepoint index, its (T*G, n_o)
    one-gene observation selector and the sort permutation. The sort runs
    on the device; ``ev_t`` is differentiable in ``delay`` through the
    gathered values."""
    g = params.decay.shape[0]
    n_o = replicates * g
    w = torch.maximum(t[:, None] - params.delay[None, :], torch.zeros((), dtype=t.dtype,
                                                                       device=t.device))
    ev_t = w.reshape(-1)  # event k = (i, j) at k = i*G + j
    order_idx = torch.argsort(ev_t, stable=True)
    col = torch.arange(n_o, device=t.device)
    gene_sel = (col[None, :] % g) == (order_idx % g)[:, None]
    return ev_t[order_idx], order_idx // g, gene_sel, order_idx


def delaysimm_mll_ss(params, timepoints, y, *, jitter: float, replicates: int = 1,
                     order: int = 10, parallel=None, shard=None, obs_mask=None,
                     force_kernel: str = "rbf"):
    """State-space MLL of the delayed-response family
    (``models.delaysimm``): the contract of :func:`lfm_mll_ss` with
    ``params`` a ``DelaySIMMParams``. Each (timepoint, gene) pair is one
    warped-time filter step (:func:`_delay_event_grid`) that observes one
    gene through a per-entry ``obs_mask``; O(T G (p+G)^3). The delays are
    differentiable through the warped steps, so :func:`discretize` takes
    one batched ``matrix_exp`` over the T*G events.

    The sequential filter (``parallel`` resolving to it, e.g. ``False`` or
    ``None`` on the CPU), with no ``obs_mask`` and one replicate, runs the
    scalar-observation chain :func:`_scalar_obs_filter_ll`: every event
    then reads exactly one state coordinate. Every other schedule runs the
    masked chain. ``shard=`` is not yet ported."""
    assert_full_fp32(_WHO)
    _refuse_shard(shard)
    g = params.decay.shape[0]
    t = torch.as_tensor(timepoints)
    t_steps = t.shape[0]
    n_o = replicates * g
    dtype, dev = t.dtype, t.device
    f_aug, p_inf, p0, _ = build_lfm_ssm(
        params.decay, params.sensitivity, params.lengthscale, order=order,
        force_kernel=force_kernel,
    )
    h = gene_observation_matrix(p0.shape[0] - g, g, replicates, dtype, dev)
    mean_obs = (params.basal / params.decay).repeat(replicates)
    r_var = torch.full((n_o,), jitter, dtype=dtype, device=dev) + params.obs_stddev**2

    ev_t, step_ids, gene_sel, order_idx = _delay_event_grid(params, t, replicates)
    ys_full = y.reshape(n_o, t_steps).T - mean_obs[None, :]  # (T, n_o)
    dts = torch.diff(ev_t, prepend=torch.zeros((1,), dtype=dtype, device=dev))
    a, q = discretize(f_aug, p_inf, dts)
    fil, _ = _select_schedule(parallel, ev_t.shape[0], dev)
    if fil is kalman_filter and obs_mask is None and replicates == 1:
        gene_ids = order_idx % g
        return _scalar_obs_filter_ll(a, q, p0, p0.shape[0] - g + gene_ids, r_var[0],
                                     ys_full[step_ids, gene_ids])
    ys_ev = torch.where(gene_sel, ys_full[step_ids], torch.zeros((), dtype=dtype, device=dev))
    om_ev = gene_sel.to(dtype)
    if obs_mask is not None:
        om_user = torch.as_tensor(obs_mask, dtype=dtype, device=dev).reshape(n_o, t_steps).T
        om_ev = om_ev * om_user[step_ids]
    _, _, ll = fil(a, q, h, r_var, ys_ev, p0, obs_mask=om_ev)
    return ll


def _scalar_obs_filter_ll(a, q, p0, state_idx, r_var_sc, ys_sc):
    """Sequential Kalman MLL of a chain of scalar observations, step i
    reading state coordinate ``state_idx[i]``: the innovation covariance is
    a scalar, so an update is one gathered covariance column and a division
    (the Joseph form collapses to ``P - c c^T / s``). O(T m^2) work a step
    instead of O(m^2 G). The coordinate is gathered with ``index_select``,
    which reads nothing on the host."""
    m_dim = p0.shape[0]
    m_cur = torch.zeros((m_dim,), dtype=p0.dtype, device=p0.device)
    p_cur = p0
    ll = torch.zeros((), dtype=p0.dtype, device=p0.device)
    for i in range(ys_sc.shape[0]):
        idx = state_idx[i:i + 1]
        m_pred = a[i] @ m_cur
        p_pred = _symmetrize(a[i] @ p_cur @ a[i].T + q[i])
        col = p_pred.index_select(1, idx)[:, 0]
        s = col.index_select(0, idx)[0] + r_var_sc
        r = ys_sc[i] - m_pred.index_select(0, idx)[0]
        m_cur = m_pred + col * (r / s)
        p_cur = _symmetrize(p_pred - torch.outer(col, col) / s)
        ll = ll + -0.5 * (r * r / s + torch.log(s) + LOG_2PI)
    return ll


def _stationary_tail_ll(a, q, h, r_var, ys_tail, m_k, p_k):
    """Frozen-gain (steady-state) likelihood of the remaining steps of a
    uniform-grid chain from the exact filtered state ``(m_k, P_k)``: the
    gain, innovation factor and log-det frozen at their step-K values, each
    step ``m_t = M m_{t-1} + K_ss y_t`` with ``M = (I - K_ss H) A``. The
    mean recursion is the loop (one fused multiply-add a step); the
    innovations ``y_t - H A m_{t-1}`` and their triangular solve are batched
    after it."""
    dtype = m_k.dtype
    p_pred = _symmetrize(a @ p_k @ a.T + q)
    s_mat = h @ p_pred @ h.T + torch.diag(r_var)
    chol = _cholesky(s_mat)
    gain = torch.cholesky_solve(h @ p_pred, chol).T
    m_dim = m_k.shape[0]
    mmat = (torch.eye(m_dim, dtype=dtype, device=m_k.device) - gain @ h) @ a
    ha = h @ a
    n_o = r_var.shape[0]
    const = torch.sum(torch.log(torch.diagonal(chol))) + 0.5 * n_o * LOG_2PI
    drive = ys_tail @ gain.T  # (T_tail, m): K_ss y_t
    prev = [m_k]
    for i in range(ys_tail.shape[0] - 1):
        prev.append(torch.addmv(drive[i], mmat, prev[-1]))
    resid = ys_tail - torch.stack(prev) @ ha.T  # (T_tail, n_o)
    al = torch.linalg.solve_triangular(chol, resid.T, upper=False)
    return -0.5 * torch.sum(al * al) - ys_tail.shape[0] * const


def _gridded_ssm_mll(f_aug, p_inf, p0, h, mean_obs, t, y, r_var, *, parallel, uniform,
                     shard, obs_mask=None, obs_slice=None, stationary_after=None):
    """The gridded MLL's filter routine (see :func:`lfm_mll_ss`): center the
    gene-major flat ``y``, discretize per the grid promise, run the
    sequential filter."""
    _refuse_shard(shard)
    dtype = t.dtype
    t_steps = t.shape[0]
    n_o = mean_obs.shape[0]

    ys = y.reshape(n_o, t_steps).T - mean_obs[None, :]
    om = None if obs_mask is None else \
        torch.as_tensor(obs_mask, dtype=dtype, device=t.device).reshape(n_o, t_steps).T

    fil, _ = _select_schedule(parallel, t_steps, t.device)
    if uniform and t_steps >= 2:
        # Step 0 (prior at t=0 -> first observation) apart; steps 1..T-1
        # share one (A, Q).
        a0, q0 = discretize(f_aug, p_inf, t[0])
        p_pred0 = _symmetrize(a0 @ p0 @ a0.T + q0)  # the mean stays 0 (centered)
        if om is None:
            h0, rv0, y0 = h, r_var, ys[0]
            corr0 = torch.zeros((), dtype=dtype, device=t.device)
        else:
            h_both, rv_both, ys_both = _mask_obs(
                h, torch.broadcast_to(r_var, (1, n_o)), ys[:1], om[:1]
            )
            h0, rv0, y0 = h_both[0], rv_both[0], ys_both[0]
            corr0 = _mask_ll_correction(om[:1])[0]
        m_f0, p_f0, ll0 = _joseph_update(
            torch.zeros((p0.shape[0],), dtype=dtype, device=t.device), p_pred0, h0, rv0, y0
        )
        ll0 = ll0 + corr0
        a, q = discretize(f_aug, p_inf, (t[-1] - t[0]) / (t_steps - 1))
        if stationary_after is not None:
            if om is not None:
                raise ValueError(
                    "stationary_after requires no shard and no obs_mask "
                    "(the frozen gain presumes every step's update "
                    "pattern is identical)"
                )
            k_ex = max(0, min(int(stationary_after), t_steps - 1))
            ll = ll0
            m_k, p_k = m_f0, p_f0
            if k_ex > 0:
                ms_k, ps_k, ll_ex = kalman_filter(
                    a, q, h, r_var, ys[1:1 + k_ex], p_f0, m0=m_f0,
                    **_sel_kwargs(kalman_filter, obs_slice),
                )
                m_k, p_k = ms_k[-1], ps_k[-1]
                ll = ll + ll_ex
            if k_ex < t_steps - 1:
                rv_vec = torch.broadcast_to(torch.as_tensor(r_var, dtype=dtype), (n_o,))
                ll = ll + _stationary_tail_ll(a, q, h, rv_vec, ys[1 + k_ex:], m_k, p_k)
            return ll
        _, _, ll = fil(
            a, q, h, r_var, ys[1:], p_f0, m0=m_f0,
            obs_mask=None if om is None else om[1:],
            **_sel_kwargs(fil, obs_slice),
        )
        return ll0 + ll
    if stationary_after is not None:
        raise ValueError(
            "stationary_after requires uniform=True (the frozen gain is "
            "the shared-(A, Q) covariance fixed point)"
        )
    dts = torch.diff(t, prepend=torch.zeros((1,), dtype=dtype, device=t.device))
    a, q = discretize(f_aug, p_inf, dts)
    _, _, ll = fil(a, q, h, r_var, ys, p0, obs_mask=om, **_sel_kwargs(fil, obs_slice))
    return ll


# ---------------------------------------------------------------------------
# Smoothing and prediction.
# ---------------------------------------------------------------------------


def _rts_rcond(dtype):
    """Relative eigenvalue cutoff of the RTS pseudo-solve."""
    return 1e-12 if dtype == torch.float64 else 1e-6


def _pseudo_gain(p_f_at, p_pred, rcond):
    """RTS gain ``(P_f A^T) P_pred^+`` (batched over leading dims) by the
    eigendecomposition pseudo-solve with a relative cutoff: deterministic
    directions (the t=0 gene block, dt=0 steps) get zero correction. The
    cutoff uses the double-``where`` form so that gradients stay finite
    through cut-off eigenvalues."""
    w, v = torch.linalg.eigh(_symmetrize(p_pred))
    keep = w > rcond * w[..., -1:]
    w_inv = torch.where(keep, 1.0 / torch.where(keep, w, torch.ones_like(w)),
                        torch.zeros_like(w))
    return (p_f_at @ v) * w_inv[..., None, :] @ v.mT


def _chol_gain(p_f_at, p_pred):
    """RTS gain by a Cholesky of ``P_pred`` shifted by ``64 eps tr(P)/m``:
    a research knob only (``rts_smoother(chol_gain_from=...)``); the JAX
    package measured it NaN-ing smoothed means at SDE orders >= 10, where
    ``P_pred`` holds eigenvalues below the noise floor."""
    m_dim = p_pred.shape[-1]
    scale = torch.diagonal(p_pred, dim1=-2, dim2=-1).sum(-1) / m_dim
    delta = 64 * torch.finfo(p_pred.dtype).eps * scale
    eye = torch.eye(m_dim, dtype=p_pred.dtype, device=p_pred.device)
    shifted = _symmetrize(p_pred) + delta[..., None, None] * eye
    return torch.cholesky_solve(p_f_at.mT, _cholesky(shifted)).mT


def rts_smoother(a, q, ms, ps, chol_gain_from: int | None = None):
    """Rauch-Tung-Striebel backward pass over filtered ``(ms, ps)``.

    ``a``/``q``: (m, m) or (T, m, m) as in :func:`kalman_filter`. The gains
    depend only on the filtered moments, so they are built batched before
    the backward loop (one batched ``eigh``, :func:`_pseudo_gain`), and the
    loop keeps the correction-form recursion
    ``m_s[k] = m_f[k] + G_k (m_s[k+1] - A m_f[k])``,
    ``P_s[k] = P_f[k] + G_k (P_s[k+1] - P_pred[k+1]) G_k^T``.
    ``chol_gain_from``: shifted-Cholesky gains (:func:`_chol_gain`) from
    that step on. Returns smoothed means (T, m) and covariances (T, m, m).
    """
    assert_full_fp32(_WHO)
    t_steps = ms.shape[0]
    rcond = _rts_rcond(ms.dtype)
    a_n, q_n = (a, q) if a.ndim == 2 else (a[1:], q[1:])  # transitions into k + 1
    n_gain = t_steps - 1
    p_f, m_f = ps[:n_gain], ms[:n_gain]
    p_f_at = p_f @ a_n.mT
    p_preds = _symmetrize(a_n @ p_f @ a_n.mT + q_n)
    am_f = m_f @ a_n.mT if a.ndim == 2 else (a_n @ m_f[..., None])[..., 0]
    k_split = n_gain if chol_gain_from is None else max(0, min(int(chol_gain_from), n_gain))
    parts = []
    if k_split > 0:
        parts.append(_pseudo_gain(p_f_at[:k_split], p_preds[:k_split], rcond))
    if k_split < n_gain:
        parts.append(_chol_gain(p_f_at[k_split:], p_preds[k_split:]))
    gains = torch.cat(parts) if parts else p_f_at

    m_next, p_next = ms[-1], ps[-1]
    out_m, out_p = [m_next], [p_next]
    for k in range(n_gain - 1, -1, -1):
        gain = gains[k]
        m_next = ms[k] + gain @ (m_next - am_f[k])
        p_next = _symmetrize(ps[k] + gain @ (p_next - p_preds[k]) @ gain.T)
        out_m.append(m_next)
        out_p.append(p_next)
    return torch.stack(out_m[::-1]), torch.stack(out_p[::-1])


def _smoother_element(a_n, q_n, m_f, p_f, rcond):
    """Elements of the smoothing semigroup (Sarkka & Garcia-Fernandez 2021,
    sec. IV), batched over leading axes: ``(E, g, L)`` with
    ``m_s[k] = E_k m_s[k+1] + g_k`` and ``P_s[k] = E_k P_s[k+1] E_k^T +
    L_k``. ``a_n``/``q_n`` are the transitions into step k+1; the gain is
    the sequential smoother's pseudo-solve (:func:`_pseudo_gain`)."""
    p_pred = _symmetrize(a_n @ p_f @ a_n.mT + q_n)
    gain = _pseudo_gain(p_f @ a_n.mT, p_pred, rcond)
    g_vec = m_f - _mv(gain, _mv(a_n, m_f))
    l_mat = _symmetrize(p_f - gain @ p_pred @ gain.mT)
    return gain, g_vec, l_mat


def _combine_smoother(e1, e2):
    """Associative composition of smoothing elements; ``e1`` the earlier
    interval (the composite maps the smoothed state after ``e2``'s span
    onto ``e1``'s start)."""
    ea, ga, la = e1
    eb, gb, lb = e2
    return ea @ eb, _mv(ea, gb) + ga, _symmetrize(ea @ lb @ ea.mT + la)


def _combine_smoother_rev(e2, e1):
    """:func:`_combine_smoother` with its arguments flipped, for the
    reverse scan, whose accumulated (later) interval arrives first."""
    return _combine_smoother(e1, e2)


def _smoother_identity(m_dim, dtype, device=None):
    """Identity of the smoothing semigroup: (I, 0, 0)."""
    kw = dict(dtype=dtype, device=device)
    return torch.eye(m_dim, **kw), torch.zeros((m_dim,), **kw), torch.zeros((m_dim, m_dim), **kw)


def _build_smoother_elements(a, q, ms, ps, rcond):
    """Elements of steps 0..T-1; the terminal one is the absorbing
    ``(0, m_f[T-1], P_f[T-1])``, so every suffix composite's (g, L) is the
    smoothed moment pair. ``a``/``q`` (m, m) or (T, m, m) as in
    :func:`rts_smoother`."""
    a_n, q_n = (a, q) if a.ndim == 2 else (a[1:], q[1:])
    e, g, l_mat = _smoother_element(a_n, q_n, ms[:-1], ps[:-1], rcond)
    m_dim = ms.shape[1]
    e = torch.cat([e, torch.zeros((1, m_dim, m_dim), dtype=ms.dtype, device=ms.device)])
    return e, torch.cat([g, ms[-1:]]), torch.cat([l_mat, ps[-1:]])


def parallel_rts_smoother(a, q, ms, ps):
    """Log-depth RTS smoother: a reverse :func:`_associative_scan` over the
    smoothing semigroup. The output contract of :func:`rts_smoother`."""
    assert_full_fp32(_WHO)
    elems = _build_smoother_elements(a, q, ms, ps, _rts_rcond(ms.dtype))
    _, ms_s, ps_s = _associative_scan(_combine_smoother_rev, elems, reverse=True)
    return ms_s, ps_s


def blocked_rts_smoother(a, q, ms, ps, block: int | None = None):
    """Blocked RTS smoother, the backward mirror of :func:`blocked_filter`
    (depth L + B): within each block an L-level reverse loop carries the
    B-wide batch of block-local suffix composites, the B block composites
    chain backward into each block's boundary composite, and one batched
    combine expands every local suffix. Padding uses the smoothing
    identity, an exact pass-through after the absorbing terminal element.
    The output contract of :func:`rts_smoother`."""
    assert_full_fp32(_WHO)
    t_steps, m_dim = ms.shape
    elems = _build_smoother_elements(a, q, ms, ps, _rts_rcond(ms.dtype))
    block_l, n_blocks, pad = _blocked_layout(t_steps, block)
    ident = _smoother_identity(m_dim, ms.dtype, ms.device)
    elems_lb = _to_blocks(elems, ident, block_l, n_blocks, pad)
    carry = tuple(i.expand((n_blocks,) + i.shape) for i in ident)
    suffixes = [None] * block_l
    for j in range(block_l - 1, -1, -1):
        carry = _combine_smoother(tuple(e[j] for e in elems_lb), carry)
        suffixes[j] = carry
    # Boundary composites: for block b, the composite of blocks b+1..B-1.
    bound, bounds = ident, [None] * n_blocks
    for b in range(n_blocks - 1, -1, -1):
        bounds[b] = bound
        bound = _combine_smoother(tuple(c[b] for c in carry), bound)
    bounds_t = tuple(torch.stack(f).repeat_interleave(block_l, dim=0) for f in zip(*bounds))
    _, ms_s, ps_s = _combine_smoother(_from_blocks(suffixes), bounds_t)
    return ms_s[:t_steps], ps_s[:t_steps]


def lfm_predict_ss(params, timepoints, y, t_test, *, noise_var, replicates: int = 1,
                   order: int = 10, obs_mask=None, parallel=None, shard=None,
                   unique_dts=None, force_kernel: str = "rbf", interp: str = "union"):
    """Smoothed latent-force posterior at ``t_test`` and the gene states:
    ``(f_mean, f_var, x_mean, x_var)``, x per gene with its mean added back.
    Runs under ``torch.no_grad``.

    ``interp='union'``: filter and smoother on the union of the train and
    test grids, updates masked to train steps. ``interp='bridge'``:
    smoother on the train grid only, each test time conditioned on its
    bracketing smoothed states (:func:`_bridge_smooth`). ``noise_var``:
    scalar, (G*R,) or (T_train, G*R). ``parallel``: the filter and
    smoother pair (:func:`_select_schedule`).

    Contracts:

    - ``unique_dts`` is a checked bound (``ValueError`` when exceeded) on
      the distinct step sizes, counting the step from 0 to the first time:
      for ``'union'`` those of the sorted union grid (a duplicate time
      gives a 0 step), for ``'bridge'`` those of the train grid.
    - Order of the returned points: ``'union'`` returns them sorted by
      time (stably); ``'bridge'`` in ``t_test``'s own order.
    - Negative test times: ``'bridge'`` clamps them to the t=0 node;
      ``'union'`` raises ``ValueError`` (the model starts at t=0; the JAX
      package builds negative-step transitions there).
    """
    assert_full_fp32(_WHO)
    _refuse_shard(shard)
    with torch.no_grad():
        t_train = torch.as_tensor(timepoints)
        t_test = torch.as_tensor(t_test, dtype=t_train.dtype, device=t_train.device)
        g = params.decay.shape[0]
        f_aug, p_inf, p0, h_force = build_lfm_ssm(
            params.decay, params.sensitivity, params.lengthscale, order=order,
            force_kernel=force_kernel,
        )
        p = p0.shape[0] - g
        h = gene_observation_matrix(p, g, replicates, t_train.dtype, t_train.device)
        mean = params.basal / params.decay
        m_t, p_t = _pick_smooth(interp)(
            f_aug, p_inf, p0, h, t_train, t_test, y, mean.repeat(replicates), noise_var,
            obs_mask=obs_mask, parallel=parallel, unique_dts=unique_dts,
            obs_slice=p if replicates == 1 else None,
        )
        f_mean = m_t @ h_force
        f_var = torch.einsum("i,tij,j->t", h_force, p_t, h_force)
        x_mean = m_t[:, p:] + mean[None, :]
        x_var = torch.diagonal(p_t, dim1=1, dim2=2)[:, p:]
    return f_mean, f_var, x_mean, x_var


def lfm2_predict_ss(params, timepoints, y, t_test, *, noise_var, replicates: int = 1,
                    order: int = 10, obs_mask=None, parallel=None, shard=None,
                    unique_dts=None, force_kernel: str = "rbf", interp: str = "union"):
    """Smoothed posterior of the second-order family, the state-space
    analogue of ``SecondOrderSIMM.latent_predict`` (the closed forms use the
    consistent force prior, so mean and variance match the dense path to
    the SDE order's error): ``(f_mean, f_var, x_mean, x_var)``, x the
    position block with ``B / k`` added back. The contracts of
    :func:`lfm_predict_ss` (``interp``, ``unique_dts``, the order of the
    returned points, negative test times). Runs under ``torch.no_grad``."""
    assert_full_fp32(_WHO)
    _refuse_shard(shard)
    with torch.no_grad():
        t_train = torch.as_tensor(timepoints)
        t_test = torch.as_tensor(t_test, dtype=t_train.dtype, device=t_train.device)
        g = params.alpha.shape[0]
        f_aug, p_inf, p0, h_force = build_lfm2_ssm(
            params.alpha, params.omega, params.sensitivity, params.lengthscale, order=order,
            force_kernel=force_kernel,
        )
        p_f = p0.shape[0] - 2 * g
        h = F.pad(gene_observation_matrix(p_f, g, replicates, t_train.dtype, t_train.device),
                  (0, g))
        mean = params.basal / (params.alpha**2 + params.omega**2)
        m_t, p_t = _pick_smooth(interp)(
            f_aug, p_inf, p0, h, t_train, t_test, y, mean.repeat(replicates), noise_var,
            obs_mask=obs_mask, parallel=parallel, unique_dts=unique_dts,
            obs_slice=p_f if replicates == 1 else None,
        )
        f_mean = m_t @ h_force
        f_var = torch.einsum("i,tij,j->t", h_force, p_t, h_force)
        x_mean = m_t[:, p_f:p_f + g] + mean[None, :]
        x_var = torch.diagonal(p_t, dim1=1, dim2=2)[:, p_f:p_f + g]
    return f_mean, f_var, x_mean, x_var


def multisimm_predict_ss(params, timepoints, y, t_test, *, noise_var, replicates: int = 1,
                         order: int = 10, obs_mask=None, parallel=None, shard=None,
                         unique_dts=None, force_kernels=None, interp: str = "union"):
    """Smoothed posterior of the R-force family across all forces in one
    pass, the state-space analogue of ``ExactMultiSIMM.latent_predict`` (its
    closed forms use the consistent force prior, so mean and variance match
    to the SDE order's error): ``(f_mean, f_var, x_mean, x_var)``, f (R,
    T_test) and x (T_test, G) with ``B / D`` added back. The contracts of
    :func:`lfm_predict_ss`. Runs under ``torch.no_grad``."""
    assert_full_fp32(_WHO)
    _refuse_shard(shard)
    with torch.no_grad():
        t_train = torch.as_tensor(timepoints)
        t_test = torch.as_tensor(t_test, dtype=t_train.dtype, device=t_train.device)
        g = params.sensitivity.shape[0]
        f_aug, p_inf, p0, h_forces = build_multiforce_ssm(
            params.decay, params.sensitivity, params.lengthscale, order=order,
            force_kernels=force_kernels,
        )
        p_tot = p0.shape[0] - g
        h = gene_observation_matrix(p_tot, g, replicates, t_train.dtype, t_train.device)
        mean = params.basal / params.decay
        m_t, p_t = _pick_smooth(interp)(
            f_aug, p_inf, p0, h, t_train, t_test, y, mean.repeat(replicates), noise_var,
            obs_mask=obs_mask, parallel=parallel, unique_dts=unique_dts,
            obs_slice=p_tot if replicates == 1 else None,
        )
        f_mean = (m_t @ h_forces.T).T
        f_var = torch.einsum("ri,tij,rj->rt", h_forces, p_t, h_forces)
        x_mean = m_t[:, p_tot:] + mean[None, :]
        x_var = torch.diagonal(p_t, dim1=1, dim2=2)[:, p_tot:]
    return f_mean, f_var, x_mean, x_var


def delaysimm_predict_ss(params, timepoints, y, t_test, *, noise_var, replicates: int = 1,
                         order: int = 10, obs_mask=None, parallel=None, shard=None,
                         force_kernel: str = "rbf"):
    """Smoothed posterior of the delay family in one pass, the state-space
    analogue of ``ExactDelaySIMM.latent_predict`` and
    ``multi_gene_predict``: ``(f_mean, f_var, x_mean, x_var)``, x (T_test,
    G). The event grid holds the warped training observations (T*G, one
    gene each), the warped gene reads (T_test*G, no update: gene j at tau
    is the state's gene-j entry at ``max(tau - delta_j, 0)``) and the
    unwarped force reads (T_test), sorted stably on the device; the filter
    updates on the training events only. Runs under ``torch.no_grad``;
    ``shard=`` is not yet ported."""
    assert_full_fp32(_WHO)
    _refuse_shard(shard)
    with torch.no_grad():
        g = params.decay.shape[0]
        t_train = torch.as_tensor(timepoints)
        dtype, dev = t_train.dtype, t_train.device
        t_test = torch.as_tensor(t_test, dtype=dtype, device=dev)
        t_steps, n_test = t_train.shape[0], t_test.shape[0]
        n_o = replicates * g
        f_aug, p_inf, p0, h_force = build_lfm_ssm(
            params.decay, params.sensitivity, params.lengthscale, order=order,
            force_kernel=force_kernel,
        )
        p_f = p0.shape[0] - g
        h = gene_observation_matrix(p_f, g, replicates, dtype, dev)
        mean = params.basal / params.decay
        zero = torch.zeros((), dtype=dtype, device=dev)

        w_train = torch.maximum(t_train[:, None] - params.delay[None, :], zero).reshape(-1)
        w_test = torch.maximum(t_test[:, None] - params.delay[None, :], zero).reshape(-1)
        ev_t = torch.cat([w_train, w_test, t_test])
        order_idx = torch.argsort(ev_t, stable=True)
        inv = torch.argsort(order_idx)  # original event k sits at sorted row inv[k]
        step_tr = torch.clamp(order_idx // g, 0, t_steps - 1)
        train = (order_idx < t_steps * g)[:, None]
        col = torch.arange(n_o, device=dev)
        gene_sel = (col[None, :] % g) == (order_idx % g)[:, None]

        ys_full = y.reshape(n_o, t_steps).T - mean.repeat(replicates)[None, :]
        ys_ev = torch.where(gene_sel & train, ys_full[step_tr], zero)
        # Steps that take no update keep all-ones observation masks (their
        # likelihood term is unused).
        om_ev = torch.where(train, gene_sel.to(dtype), torch.ones((), dtype=dtype, device=dev))
        if obs_mask is not None:
            om_user = torch.as_tensor(obs_mask, dtype=dtype, device=dev).reshape(n_o, t_steps).T
            om_ev = torch.where(train, om_ev * om_user[step_tr], om_ev)
        nv = torch.broadcast_to(torch.as_tensor(noise_var, dtype=dtype, device=dev),
                                (t_steps, n_o))
        rv_ev = torch.where(train, nv[step_tr], torch.ones((), dtype=dtype, device=dev))

        dts = torch.diff(ev_t[order_idx], prepend=torch.zeros((1,), dtype=dtype, device=dev))
        a, q = discretize(f_aug, p_inf, dts)
        fil, smo = _select_schedule(parallel, ev_t.shape[0], dev)
        ms, ps, _ = fil(a, q, h, rv_ev, ys_ev, p0, mask=train[:, 0].to(dtype), obs_mask=om_ev)
        ms_s, ps_s = smo(a, q, ms, ps)

        force_at = inv[t_steps * g + n_test * g:]
        f_mean = ms_s[force_at] @ h_force
        f_var = torch.einsum("i,tij,j->t", h_force, ps_s[force_at], h_force)
        # Gene reads: original events k = i*G + j after the training ones.
        gene_at = inv[t_steps * g: t_steps * g + n_test * g]
        rows = torch.arange(n_test * g, device=dev)
        pick = p_f + torch.arange(g, device=dev).repeat(n_test)
        x_mean = ms_s[gene_at][rows, pick].reshape(n_test, g) + mean[None, :]
        x_var = torch.diagonal(ps_s[gene_at], dim1=1, dim2=2)[rows, pick].reshape(n_test, g)
    return f_mean, f_var, x_mean, x_var


def _train_inputs(t_train, y, mean_obs, noise_var, obs_mask):
    """Centered (T, n_o) observations, (T, n_o) noise variances and the
    (T, n_o) entry mask (or None) from the block-major flat inputs."""
    dtype, dev = t_train.dtype, t_train.device
    n_o, t_steps = mean_obs.shape[0], t_train.shape[0]
    ys = y.reshape(n_o, t_steps).T - mean_obs[None, :]
    rv = torch.broadcast_to(torch.as_tensor(noise_var, dtype=dtype, device=dev), (t_steps, n_o))
    om = None if obs_mask is None else \
        torch.as_tensor(obs_mask, dtype=dtype, device=dev).reshape(n_o, t_steps).T
    return ys, rv, om


def _union_grid_smooth(f_aug, p_inf, p0, h, t_train, t_test, y, mean_obs, noise_var,
                       obs_mask=None, parallel=None, unique_dts=None, obs_slice=None):
    """Filter + RTS smoother on the union grid of train and test times,
    updates masked to the train steps. The sort and the train/test
    positions are computed on the host from the concrete grids. Returns the
    smoothed state ``(m_t, p_t)`` at the test times in time-sorted order
    (means centered)."""
    dev = t_train.device
    a, q, ys, rv_all, om_all, is_train, test_pos = _union_inputs(
        f_aug, p_inf, t_train, t_test, y, mean_obs, noise_var, obs_mask, unique_dts)
    fil, smo = _select_schedule(parallel, ys.shape[0], dev)
    ms, ps, _ = fil(a, q, h, rv_all, ys, p0, mask=is_train.astype(np.float64),
                    obs_mask=om_all, **_sel_kwargs(fil, obs_slice))
    ms_s, ps_s = smo(a, q, ms, ps)
    return ms_s[test_pos], ps_s[test_pos]


def _union_inputs(f_aug, p_inf, t_train, t_test, y, mean_obs, noise_var, obs_mask, unique_dts):
    """The union grid of train and test times (stable sort, computed on the
    host from the concrete grids): its transitions, the centered train
    observations scattered into it (zeros elsewhere), noise rows (1.0 on
    test steps, which are never updated), the entry mask, the host boolean
    train flags and the test positions."""
    dtype, dev = t_train.dtype, t_train.device
    n_o = mean_obs.shape[0]
    tt_host = _host(t_test)
    if np.any(tt_host < 0):
        raise ValueError(
            "interp='union' needs t_test >= 0 (the model starts at t=0); "
            "interp='bridge' clamps negative times to the t=0 node"
        )
    n_train = t_train.shape[0]
    order_idx = np.argsort(np.concatenate([_host(t_train), tt_host]), kind="stable")
    is_train = order_idx < n_train
    train_pos = torch.as_tensor(np.nonzero(is_train)[0], device=dev)
    test_pos = torch.as_tensor(np.nonzero(~is_train)[0], device=dev)
    t_sorted = torch.cat([t_train, t_test])[torch.as_tensor(order_idx, device=dev)]
    n_all = t_sorted.shape[0]
    dts = torch.diff(t_sorted, prepend=torch.zeros((1,), dtype=dtype, device=dev))
    a, q = discretize(f_aug, p_inf, dts, max_unique=unique_dts)

    ys_train, rv_train, om_train = _train_inputs(t_train, y, mean_obs, noise_var, obs_mask)
    ys = torch.zeros((n_all, n_o), dtype=dtype, device=dev)
    ys[train_pos] = ys_train
    # Masked steps never use their noise row; 1.0 keeps the Cholesky happy.
    rv_all = torch.ones((n_all, n_o), dtype=dtype, device=dev)
    rv_all[train_pos] = rv_train
    om_all = None
    if om_train is not None:
        om_all = torch.ones((n_all, n_o), dtype=dtype, device=dev)
        om_all[train_pos] = om_train
    return a, q, ys, rv_all, om_all, is_train, test_pos


def _bridge_smooth(f_aug, p_inf, p0, h, t_train, t_test, y, mean_obs, noise_var,
                   obs_mask=None, parallel=None, unique_dts=None, obs_slice=None):
    """Bridge interpolation: filter + RTS smoother on the TRAIN grid, then
    each test time conditioned on its two bracketing smoothed states
    through the discretized prior's Gaussian bridge (exact by the Markov
    property; the JAX package's derivation in
    ``dis_project_tpu/ops/statespace.py:_bridge_smooth``)::

        x* | x_L, x_R ~ N(W_a x_L + W_b x_R, Lambda),
        W_b = Q_1 A_2^T S^+,  W_a = A_1 - W_b A_2 A_1,
        Lambda = Q_1 - W_b A_2 Q_1,   S = A_2 Q_1 A_2^T + Q_2,

    with the pairwise smoothed cross-covariance ``G_k Sigma_R``. Times past
    the last train node extrapolate from the terminal smoothed state; times
    in ``[0, t_train[0])`` bridge against a virtual t=0 node; negative times
    clamp to it. The per-test work is batched over the test points; the
    brackets are found on the host. Returns the moments in ``t_test``'s
    order (means centered)."""
    dtype, dev = t_train.dtype, t_train.device
    t_steps = t_train.shape[0]
    zero = torch.zeros((1,), dtype=dtype, device=dev)

    dts = torch.diff(t_train, prepend=zero)
    a, q = discretize(f_aug, p_inf, dts, max_unique=unique_dts)
    ys, rv, om = _train_inputs(t_train, y, mean_obs, noise_var, obs_mask)
    fil, smo = _select_schedule(parallel, t_steps, dev)
    ms, ps, _ = fil(a, q, h, rv, ys, p0, obs_mask=om, **_sel_kwargs(fil, obs_slice))
    ms_s, ps_s = smo(a, q, ms, ps)

    rcond = _rts_rcond(dtype)
    # Virtual t=0 node: the chain's prior (m0 = 0, p0), smoothed backward one step.
    a0, q0 = a[0], q[0]
    p_pred0 = _symmetrize(a0 @ p0 @ a0.T + q0)
    g0 = _pseudo_gain(p0 @ a0.T, p_pred0, rcond)
    m_node = torch.cat([(g0 @ ms_s[0])[None], ms_s])
    s_node = torch.cat([_symmetrize(p0 + g0 @ (ps_s[0] - p_pred0) @ g0.T)[None], ps_s])
    pf_node = torch.cat([p0[None], ps])
    t_node = torch.cat([zero, t_train])

    k_host = np.clip(np.searchsorted(_host(t_node), _host(t_test), side="right") - 1,
                     0, t_steps - 1)
    k = torch.as_tensor(k_host, device=dev)
    dt1 = torch.clamp(t_test - t_node[k], min=0.0)
    dt2 = torch.clamp(t_node[k + 1] - t_test, min=0.0)
    a1, q1 = discretize(f_aug, p_inf, dt1)
    a2, q2 = discretize(f_aug, p_inf, dt2)
    m_l, m_r = m_node[k], m_node[k + 1]
    s_l, s_r = s_node[k], s_node[k + 1]
    pf_k = pf_node[k]
    # Pairwise smoothed joint over the bracket; the full-step transition is
    # the composite of the two half-steps.
    a12 = a2 @ a1
    q12 = _symmetrize(a2 @ q1 @ a2.mT + q2)
    p_pred = _symmetrize(a12 @ pf_k @ a12.mT + q12)
    g_k = _pseudo_gain(pf_k @ a12.mT, p_pred, rcond)
    c_lr = g_k @ s_r  # Cov(x_L, x_R | Y)
    w_b = _pseudo_gain(q1 @ a2.mT, q12, rcond)
    w_b_a2 = w_b @ a2
    w_a = a1 - w_b_a2 @ a1
    lam = q1 - w_b_a2 @ q1
    cross = w_a @ c_lr @ w_b.mT
    m_in = (w_a @ m_l[..., None] + w_b @ m_r[..., None])[..., 0]
    p_in = _symmetrize(lam + w_a @ s_l @ w_a.mT + w_b @ s_r @ w_b.mT + cross + cross.mT)
    # One-sided extrapolation past the terminal node.
    dte = torch.clamp(t_test - t_node[-1], min=0.0)
    ae, qe = discretize(f_aug, p_inf, dte)
    m_ex = ae @ m_node[-1]
    p_ex = _symmetrize(ae @ s_node[-1] @ ae.mT + qe)
    is_ex = (t_test > t_node[-1])[:, None]
    return torch.where(is_ex, m_ex, m_in), torch.where(is_ex[..., None], p_ex, p_in)


def _pick_smooth(interp):
    if interp == "union":
        return _union_grid_smooth
    if interp == "bridge":
        return _bridge_smooth
    raise ValueError(f"interp must be 'union' or 'bridge', got {interp!r}")


# ---------------------------------------------------------------------------
# Extended Kalman engine for the nonlinear-response family (models.nlfm).
# ---------------------------------------------------------------------------


def _gauss_ll(r, s_mat):
    """log N(r; 0, s_mat) for one innovation (n_o,); NaN where ``s_mat`` is
    not positive definite."""
    return _gauss_ll_chol(r, _cholesky(s_mat))


def _joseph_update_solve(m_pred, p_pred, h, r_var, y):
    """The LU-gain measurement update of the EKF routes: ``(m, P, ll)``.
    The extended filter's linearized covariance integration can leave the
    innovation covariance slightly indefinite, where a Cholesky gain is NaN
    but an LU gain stays finite; the log-density still goes through the
    Cholesky, NaN there. ``solve_ex`` and ``cholesky_ex`` read no status on
    the host."""
    hp = h @ p_pred
    s_mat = hp @ h.T + torch.diag(r_var)
    r = y - h @ m_pred
    gain = torch.linalg.solve_ex(s_mat.T, hp)[0].T  # P H^T S^-1
    m_new = m_pred + gain @ r
    ikh = torch.eye(p_pred.shape[0], dtype=p_pred.dtype, device=p_pred.device) - gain @ h
    p_new = ikh @ p_pred @ ikh.T + (gain * r_var[None, :]) @ gain.T
    return m_new, _symmetrize(p_new), _gauss_ll(r, s_mat)


def _response_and_deriv(name: str):
    """Elementwise response g and its derivative g' (closed forms, the four
    responses of ``ops.odeint.RESPONSE_NAMES``)."""
    if name == "identity":
        return (lambda f: f), torch.ones_like
    if name == "exp":
        return torch.exp, torch.exp
    if name == "softplus":
        return (lambda f: torch.logaddexp(torch.zeros_like(f), f),
                lambda f: 1.0 / (1.0 + torch.exp(-f)))
    if name == "sigmoid":
        def _sig(f):
            return 1.0 / (1.0 + torch.exp(-f))

        return _sig, (lambda f: _sig(f) * (1.0 - _sig(f)))
    raise ValueError(f"unknown response {name!r}")


def _nlfm_ekf_pieces(params, response: str, order: int, force_kernel: str = "rbf"):
    """The EKF's drift, Jacobian, diffusion and initial moments, for the
    state ``z = [f-state (p), x (G)]`` with absolute gene levels:

        dz_f = F_f z_f dt + dW      (the order-p force SDE)
        dx_j = (B_j + S_j g(h z_f) - D_j x_j) dt

    (x(0) = B/D, the force from t = 0); the diffusion on the force block
    solves ``F P_inf + P_inf F^T + Qc = 0``. Returns ``(drift, jac, qc, m0,
    p0, h_force, m)``."""
    decay, sens, basal = params.decay, params.sensitivity, params.basal
    dtype, dev = decay.dtype, decay.device
    kw = dict(dtype=dtype, device=dev)
    g_genes = decay.shape[0]
    f_c, h_c, p_diag, rate = _force_system(order, force_kernel)
    p = f_c.shape[0]
    m = p + g_genes
    h_c = torch.as_tensor(h_c, **kw)
    p_ff = torch.as_tensor(np.diag(p_diag), **kw)
    f_force = torch.as_tensor(f_c, **kw) * (rate / params.lengthscale)
    qc = F.pad(-(f_force @ p_ff + p_ff @ f_force.T), (0, g_genes, 0, g_genes))
    g_fn, gp_fn = _response_and_deriv(response)
    top = torch.cat([f_force, torch.zeros((p, g_genes), **kw)], dim=1)
    neg_d = -torch.diag(decay)

    def drift(mz):
        zf, x = mz[:p], mz[p:]
        fval = h_c @ zf
        return torch.cat([f_force @ zf, basal + sens * g_fn(fval) - decay * x])

    def jac(mz):
        fval = h_c @ mz[:p]
        jl = sens[:, None] * (gp_fn(fval) * h_c)[None, :]
        return torch.cat([top, torch.cat([jl, neg_d], dim=1)], dim=0)

    m0 = torch.cat([torch.zeros((p,), **kw), basal / decay])
    p0 = F.pad(p_ff, (0, g_genes, 0, g_genes))
    h_force = torch.cat([h_c, torch.zeros((g_genes,), **kw)])
    return drift, jac, qc, m0, p0, h_force, m


def _ekf_propagate(drift, jac, qc, mz, P, phi, dt: float, substeps: int,
                   with_phi: bool = True):
    """RK4 integration of the EKF moment ODE over one interval of length
    ``dt`` (a host number: the grid is data):

        dm/dt   = a(m)
        dP/dt   = J(m) P + P J(m)^T + Qc      (linearized Lyapunov)
        dPhi/dt = J(m) Phi                    (the interval's sensitivity)

    in ``substeps`` fixed steps, P symmetrized after each. ``with_phi=False``
    (the MLL) carries no Phi and returns ``phi`` as given."""
    h = dt / substeps

    def ode(state):
        mz, P, phi = state
        J = jac(mz)
        return (drift(mz), J @ P + P @ J.T + qc, J @ phi if with_phi else None)

    def shift(state, k, c):
        return tuple(a + c * b if a is not None else None for a, b in zip(state, k))

    state = (mz, P, phi if with_phi else None)
    for _ in range(substeps):
        k1 = ode(state)
        k2 = ode(shift(state, k1, 0.5 * h))
        k3 = ode(shift(state, k2, 0.5 * h))
        k4 = ode(shift(state, k3, h))
        mz, P, phi_n = (
            a + (h / 6.0) * (b1 + 2 * b2 + 2 * b3 + b4) if a is not None else None
            for a, b1, b2, b3, b4 in zip(state, k1, k2, k3, k4)
        )
        state = (mz, _symmetrize(P), phi_n)
    mz, P, phi_n = state
    return mz, P, (phi_n if with_phi else phi)


def _host_steps(t) -> list:
    """The steps ``diff(t, prepend=0)`` in ``t``'s dtype, read to the host
    once (one sync for a CUDA grid) as Python numbers."""
    return torch.diff(t, prepend=torch.zeros((1,), dtype=t.dtype, device=t.device)).tolist()


def nlfm_mll_ekf(params, timepoints, y, *, response: str = "exp", jitter: float,
                 replicates: int = 1, order: int = 10, substeps: int = 4,
                 force_kernel: str = "rbf"):
    """Extended-Kalman approximate marginal likelihood of the
    nonlinear-response family, the force integrated out, O(T (p+G)^3):
    the gene drift is linearized around the filtered mean (the classic
    continuous-discrete EKF). With ``response='identity'`` the drift is
    linear and the value matches :func:`lfm_mll_ss` to the RK4-vs-expm
    integration error. The data layout and noise convention are
    :func:`lfm_mll_ss`'s (gene-major flat ``y``, ``jitter +
    obs_stddev^2``), with absolute (uncentered) gene levels.

    The filter is sequential: the prediction step depends on the state, so
    the semigroup schedules do not apply. Nothing in its loop reads the
    host: the steps are read once before it, and the update's solve and
    factor are ``solve_ex`` / ``cholesky_ex``. The EKF biases the marginal
    low for convex responses (the JAX package measured -0.48 nats for exp
    at 6 observations of 2 genes); ``(dt / substeps) * rho(F_f)`` must
    stay inside RK4's stability region."""
    assert_full_fp32(_WHO)
    g_count = params.decay.shape[0]
    t = torch.as_tensor(timepoints)
    t_steps = t.shape[0]
    n_o = replicates * g_count
    drift, jac, qc, m0, p0, _, m = _nlfm_ekf_pieces(params, response, order, force_kernel)
    dtype, dev = m0.dtype, m0.device
    h = gene_observation_matrix(m - g_count, g_count, replicates, dtype, dev)
    r_var = torch.full((n_o,), jitter, dtype=dtype, device=dev) + params.obs_stddev**2
    ys = y.reshape(n_o, t_steps).T  # absolute levels, not centered
    dts = _host_steps(t)
    mz, P, ll = m0, p0, torch.zeros((), dtype=dtype, device=dev)
    for i in range(t_steps):
        mz, P, _ = _ekf_propagate(drift, jac, qc, mz, P, None, dts[i], substeps,
                                  with_phi=False)
        mz, P, ll_i = _joseph_update_solve(mz, P, h, r_var, ys[i])
        ll = ll + ll_i
    return ll


def _ekf_rts_smoother(phis, ms, ps, m_preds, p_preds):
    """Extended RTS backward pass over the EKF's outputs. The prediction is
    affine in the previous state (the drift carries the basal constants),
    so the recursion uses the stored nonlinear prediction moments
    ``(m_pred, P_pred)`` directly; the gains are :func:`rts_smoother`'s
    pseudo-solve, batched before the loop. ``phis[k]`` is the sensitivity
    of the k-1 -> k prediction map."""
    rcond = _rts_rcond(ms.dtype)
    n = ms.shape[0]
    gains = _pseudo_gain(ps[:-1] @ phis[1:].mT, p_preds[1:], rcond)
    m_next, p_next = ms[-1], ps[-1]
    out_m, out_p = [m_next], [p_next]
    for k in range(n - 2, -1, -1):
        gain = gains[k]
        m_next = ms[k] + gain @ (m_next - m_preds[k + 1])
        p_next = _symmetrize(ps[k] + gain @ (p_next - p_preds[k + 1]) @ gain.T)
        out_m.append(m_next)
        out_p.append(p_next)
    return torch.stack(out_m[::-1]), torch.stack(out_p[::-1])


def nlfm_predict_ekf(params, timepoints, y, t_test, *, response: str = "exp", noise_var,
                     replicates: int = 1, order: int = 10, substeps: int = 4,
                     force_kernel: str = "rbf"):
    """Extended-RTS smoothed posterior of the nonlinear family at
    ``t_test``: the EKF forward on the union grid (updates at the train
    steps only), recording each interval's sensitivity ``Phi`` and its
    prediction moments, then :func:`_ekf_rts_smoother`. Returns ``(f_mean,
    f_var, x_mean, x_var)`` at ``t_test`` in sorted (stable) order, the
    variances floored at 0 (the extended smoother's covariance subtraction
    can go slightly indefinite along near-deterministic directions).
    ``noise_var`` as :func:`lfm_predict_ss`'s. Runs under
    ``torch.no_grad``."""
    assert_full_fp32(_WHO)
    with torch.no_grad():
        g_count = params.decay.shape[0]
        t_train = torch.as_tensor(timepoints)
        t_test = torch.as_tensor(t_test, dtype=t_train.dtype, device=t_train.device)
        n_o = replicates * g_count
        drift, jac, qc, m0, p0, h_force, m = _nlfm_ekf_pieces(params, response, order,
                                                              force_kernel)
        dtype, dev = m0.dtype, m0.device
        h = gene_observation_matrix(m - g_count, g_count, replicates, dtype, dev)
        n_train = t_train.shape[0]
        t_all = torch.cat([t_train, t_test])
        order_idx = torch.argsort(t_all, stable=True)
        is_train = (order_idx < n_train).tolist()
        dts = _host_steps(t_all[order_idx])
        ys = y.reshape(n_o, n_train).T
        noise = torch.broadcast_to(torch.as_tensor(noise_var, dtype=dtype, device=dev),
                                   (n_train, n_o))
        eye_m = torch.eye(m, dtype=dtype, device=dev)
        mz, P = m0, p0
        ms, ps, phis, m_preds, p_preds = [], [], [], [], []
        k_train = 0
        for i, dt in enumerate(dts):
            m_pred, p_pred, phi = _ekf_propagate(drift, jac, qc, mz, P, eye_m, dt, substeps)
            if is_train[i]:
                mz, P, _ = _joseph_update_solve(m_pred, p_pred, h, noise[k_train], ys[k_train])
                k_train += 1
            else:
                mz, P = m_pred, p_pred
            for out, v in zip((ms, ps, phis, m_preds, p_preds), (mz, P, phi, m_pred, p_pred)):
                out.append(v)
        ms_s, ps_s = _ekf_rts_smoother(*(torch.stack(v) for v in (phis, ms, ps, m_preds,
                                                                   p_preds)))
        test_pos = [i for i, tr in enumerate(is_train) if not tr]
        m_t, p_t = ms_s[test_pos], ps_s[test_pos]
        p = m - g_count
        f_mean = m_t @ h_force
        f_var = torch.clamp_min(torch.einsum("i,tij,j->t", h_force, p_t, h_force), 0.0)
        x_mean = m_t[:, p:]
        x_var = torch.clamp_min(torch.diagonal(p_t, dim1=1, dim2=2)[:, p:], 0.0)
    return f_mean, f_var, x_mean, x_var


# ---------------------------------------------------------------------------
# Streaming (online) inference: constant memory, one update an arrival.
# ---------------------------------------------------------------------------


class FilterCarry(NamedTuple):
    """Streaming filter state, the sufficient statistics of everything
    absorbed so far: the filtered (centered) mean (m,) and covariance
    (m, m), the time of the last absorbed observation (the prior sits at
    t = 0) and the marginal log-likelihood of the absorbed prefix."""

    mean: torch.Tensor
    cov: torch.Tensor
    t_last: torch.Tensor
    ll: torch.Tensor


def _on(x, dtype, device):
    """``x`` as a tensor of ``dtype`` on ``device``: a tensor already there
    is returned as it is, a Python number is filled on the device (no
    host-to-device copy, so no host sync on a card)."""
    if isinstance(x, torch.Tensor):
        return x.to(dtype=dtype, device=device)
    if isinstance(x, (int, float)):
        return torch.full((), float(x), dtype=dtype, device=device)
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)


def streaming_init(params, *, replicates: int = 1, order: int = 10, force_kernel: str = "rbf"):
    """Start streaming SIMM inference: ``(carry, aux)``, ``aux``
    holding the static model pieces ``(f_aug, p_inf, h, mean_obs,
    h_force)`` that :func:`streaming_update` and :func:`streaming_predict`
    take. Each new observation vector then costs one O((p+G)^3) update at
    constant memory; the batch filter over the same grid gives the same
    trajectory."""
    g = params.decay.shape[0]
    f_aug, p_inf, p0, h_force = build_lfm_ssm(
        params.decay, params.sensitivity, params.lengthscale, order=order,
        force_kernel=force_kernel,
    )
    dtype, dev = p0.dtype, p0.device
    h = gene_observation_matrix(p0.shape[0] - g, g, replicates, dtype, dev)
    mean_obs = (params.basal / params.decay).repeat(replicates)
    zero = torch.zeros((), dtype=dtype, device=dev)
    carry = FilterCarry(mean=torch.zeros((p0.shape[0],), dtype=dtype, device=dev), cov=p0,
                        t_last=zero, ll=zero)
    return carry, (f_aug, p_inf, h, mean_obs, h_force)


def streaming_update(carry: FilterCarry, aux, t_new, y_new, noise_var, obs_mask=None):
    """Absorb one observation vector ``y_new`` (n_o,) at ``t_new``: predict
    across the gap, measurement-update, accumulate the likelihood.
    ``noise_var``: (n_o,) or scalar; ``obs_mask``: optional (n_o,) {0, 1}
    per-entry missingness (masked entries may be NaN; deleted exactly, as
    the batch filter deletes them). Returns the new carry.

    An out-of-order ``t_new < carry.t_last`` poisons the carry's ``ll`` to
    NaN at this call and leaves the moments at their pre-call state. The
    gap is discretized on the device (:func:`_expm_device`), and a Python
    number or a tensor already on the device is taken without a copy, so
    an arrival makes no host sync."""
    assert_full_fp32(_WHO)
    f_aug, p_inf, h, mean_obs, _ = aux
    dtype, dev = carry.mean.dtype, carry.mean.device
    n_o = mean_obs.shape[0]
    t_new = _on(t_new, dtype, dev)
    in_order = t_new >= carry.t_last
    yc = _on(y_new, dtype, dev) - mean_obs
    rv = torch.broadcast_to(_on(noise_var, dtype, dev), (n_o,))
    a, q = _discretize_device(f_aug, p_inf, t_new - carry.t_last)
    m_pred = a @ carry.mean
    p_pred = _symmetrize(a @ carry.cov @ a.T + q)
    corr = 0.0
    h_u, rv_u, yc_u = h, rv, yc
    if obs_mask is not None:
        om = _on(obs_mask, dtype, dev)[None, :]
        h_m, rv_m, yc_m = _mask_obs(h, rv[None, :], yc[None, :], om)
        corr = _mask_ll_correction(om)[0]
        h_u, rv_u, yc_u = h_m[0], rv_m[0], yc_m[0]
    m_up, p_up, ll_i = _joseph_update(m_pred, p_pred, h_u, rv_u, yc_u)
    return FilterCarry(
        mean=torch.where(in_order, m_up, carry.mean),
        cov=torch.where(in_order, p_up, carry.cov),
        t_last=torch.maximum(t_new, carry.t_last),
        ll=torch.where(in_order, carry.ll + ll_i + corr, torch.nan),
    )


def streaming_freeze(carry: FilterCarry, aux, dt, noise_var):
    """Freeze the per-arrival update at the steady-state gain of a fixed
    arrival cadence ``dt``: a pack for :func:`streaming_update_frozen`,
    whose arrival costs an m^2 matvec and a triangular solve instead of the
    O(m^3) covariance update. The gain and innovation factor are frozen at
    the fixed point implied by the carry's covariance, so call it after a
    warm-up of exact updates (the error contract of ``stationary_after``).
    ``noise_var``: (n_o,) or scalar, fixed across arrivals."""
    assert_full_fp32(_WHO)
    f_aug, p_inf, h, mean_obs, _ = aux
    dtype, dev = carry.mean.dtype, carry.mean.device
    n_o = mean_obs.shape[0]
    rv = torch.broadcast_to(_on(noise_var, dtype, dev), (n_o,))
    dt = _on(dt, dtype, dev)
    a, q = _discretize_device(f_aug, p_inf, dt)
    p_pred = _symmetrize(a @ carry.cov @ a.T + q)
    chol = _cholesky(h @ p_pred @ h.T + torch.diag(rv))
    gain = torch.cholesky_solve(h @ p_pred, chol).T
    ikh = torch.eye(carry.mean.shape[0], dtype=dtype, device=dev) - gain @ h
    p_filt = _symmetrize(ikh @ p_pred @ ikh.T + (gain * rv[None, :]) @ gain.T)
    const = torch.sum(torch.log(torch.diagonal(chol))) + 0.5 * n_o * LOG_2PI
    return {"dt": dt, "mmat": ikh @ a, "ha": h @ a, "gain": gain, "chol": chol,
            "const": const, "p_filt": p_filt, "mean_obs": mean_obs}


def streaming_update_frozen(carry: FilterCarry, pack, y_new):
    """Absorb one on-cadence observation through a :func:`streaming_freeze`
    pack: the O(m^2) serving update. The carry's covariance is pinned at the
    pack's steady filtered covariance, so :func:`streaming_predict` keeps
    working off the same carry."""
    assert_full_fp32(_WHO)
    yc = _on(y_new, carry.mean.dtype, carry.mean.device) - pack["mean_obs"]
    r = yc - pack["ha"] @ carry.mean
    al = torch.linalg.solve_triangular(pack["chol"], r[:, None], upper=False)[:, 0]
    m_new = pack["mmat"] @ carry.mean + pack["gain"] @ yc
    ll_i = -0.5 * torch.sum(al * al) - pack["const"]
    return FilterCarry(mean=m_new, cov=pack["p_filt"], t_last=carry.t_last + pack["dt"],
                       ll=carry.ll + ll_i)


def streaming_predict(carry: FilterCarry, aux, params, t_query):
    """Forecast the latent force and the gene levels at ``t_query`` (>=
    ``carry.t_last``) from the carry: filtered and predictive, conditioned
    on the absorbed prefix only. Returns ``(f_mean, f_var, x_mean, x_var)``,
    x per gene with its mean added back."""
    assert_full_fp32(_WHO)
    f_aug, p_inf, _, _, h_force = aux
    dtype, dev = carry.mean.dtype, carry.mean.device
    a, q = _discretize_device(f_aug, p_inf, _on(t_query, dtype, dev) - carry.t_last)
    m_q = _mv(a, carry.mean)
    p_q = _symmetrize(a @ carry.cov @ a.mT + q)
    order = carry.mean.shape[0] - params.decay.shape[0]
    return (m_q @ h_force, (p_q @ h_force) @ h_force, m_q[..., order:] + params.basal / params.decay,
            torch.diagonal(p_q, dim1=-2, dim2=-1)[..., order:])


# ---------------------------------------------------------------------------
# Trajectory sampling: FFBS posterior draws and prior draws, O(T) each.
# ---------------------------------------------------------------------------


def _psd_sqrt_traced(p):
    """Symmetric PSD square root ``v sqrt(max(w, 0))`` from ``eigh``, batched:
    the sampling covariances are exactly singular along deterministic
    directions (the t = 0 gene block, dt = 0 steps), where a Cholesky
    fails."""
    w, v = torch.linalg.eigh(_symmetrize(p))
    return v * torch.sqrt(torch.clamp(w, min=0.0))[..., None, :]


def _ffbs_pieces(a, q, ms, ps, rcond):
    """The draw-independent pieces of the backward pass over filtered
    ``(ms, ps)`` and per-step ``(a, q)``: the gains ``G_k`` (n-1, m, m),
    the square roots of ``P_f[k] - G_k P_pred G_k^T`` (n-1, m, m) and of
    the terminal ``P_f[n-1]`` (one batched ``eigh`` for all)."""
    a_n, q_n, p_f = a[1:], q[1:], ps[:-1]
    p_pred = _symmetrize(a_n @ p_f @ a_n.mT + q_n)
    gains = _pseudo_gain(p_f @ a_n.mT, p_pred, rcond)
    cov = _symmetrize(p_f - gains @ p_pred @ gains.mT)
    roots = _psd_sqrt_traced(torch.cat([cov, ps[-1:]]))
    return gains, roots[:-1], roots[-1]


def _ffbs_backward(m_f, a_n, gains, sqrts, z_t, eps):
    """The backward pass shared by all S draws over the filtered means
    ``m_f`` (n-1, m) of steps 0..n-2 and the transitions ``a_n`` into steps
    1..n-1: ``z_t`` (S, m) the terminal draw, ``eps`` (n-1, S, m) standard
    normals; each step ``z_k = m_k + (z_{k+1} - A m_k) G_k^T + e_k sq_k^T``
    on the (S, m) batch. Returns the (n, S, m) trajectories."""
    am = _mv(a_n, m_f)
    noise = eps @ sqrts.mT
    z, out = z_t, [z_t]
    for k in range(m_f.shape[0] - 1, -1, -1):
        z = torch.addmm(m_f[k], z - am[k], gains[k].mT) + noise[k]
        out.append(z)
    return torch.stack(out[::-1])


def posterior_sample_ss(params, timepoints, y, t_test, generator, *, noise_var,
                        num_samples: int = 1, replicates: int = 1, order: int = 10,
                        force_kernel: str = "rbf", unique_dts=None):
    """Joint posterior draws of the latent force at ``t_test`` by
    forward-filter backward-sampling (Carter & Kohn 1994) on the union
    train/test grid: ``z_T ~ N(m_T, P_T)``, then ``z_k | z_{k+1} ~ N(m_k +
    G_k (z_{k+1} - A m_k), P_k - G_k P_pred G_k^T)`` with the smoother's
    pseudo-solve gain. The gains and noise square roots are shared by all
    draws, and the backward pass carries the (S, m) batch, so S draws cost
    one chain. ``generator``: a ``torch.Generator`` on the inputs' device
    (JAX's ``key``); the terminal normals are drawn first, then the rest.

    Returns ``(num_samples, T_test)`` draws in time-sorted (stable) order.
    ``noise_var``, ``unique_dts`` (a checked bound) and negative test times
    as :func:`lfm_predict_ss` with ``interp='union'``."""
    assert_full_fp32(_WHO)
    g = params.decay.shape[0]
    t_train = torch.as_tensor(timepoints)
    t_test = torch.as_tensor(t_test, dtype=t_train.dtype, device=t_train.device)
    dtype, dev = t_train.dtype, t_train.device
    f_aug, p_inf, p0, h_force = build_lfm_ssm(
        params.decay, params.sensitivity, params.lengthscale, order=order,
        force_kernel=force_kernel,
    )
    m_dim = p0.shape[0]
    h = gene_observation_matrix(m_dim - g, g, replicates, dtype, dev)
    mean_obs = (params.basal / params.decay).repeat(replicates)
    a, q, ys, rv_all, _, is_train, test_pos = _union_inputs(
        f_aug, p_inf, t_train, t_test, y, mean_obs, noise_var, None, unique_dts)
    ms, ps, _ = kalman_filter(a, q, h, rv_all, ys, p0, mask=is_train.astype(np.float64),
                              obs_slice=(m_dim - g) if replicates == 1 else None)
    gains, sqrts, sqrt_t = _ffbs_pieces(a, q, ms, ps, _rts_rcond(dtype))
    kw = dict(generator=generator, dtype=dtype, device=dev)
    z_t = ms[-1][None, :] + torch.randn((num_samples, m_dim), **kw) @ sqrt_t.mT
    eps = torch.randn((ms.shape[0] - 1, num_samples, m_dim), **kw)
    traj = _ffbs_backward(ms[:-1], a[1:], gains, sqrts, z_t, eps)
    return (traj @ h_force).T[:, test_pos]


def _prior_forward(a, sqrts, z0, eps):
    """Prior trajectories ``z_i = A_i z_{i-1} + sq_i e_i`` from ``z0`` (S, m)
    with standard normals ``eps`` (T, S, m): (T, S, m)."""
    noise = eps @ sqrts.mT
    z, out = z0, []
    for i in range(a.shape[0]):
        z = torch.addmm(noise[i], z, a[i].mT)
        out.append(z)
    return torch.stack(out)


def sample_trajectory_ss(params, timepoints, generator, *, num_samples: int = 1,
                         order: int = 10, force_kernel: str = "rbf"):
    """Prior draws of (force, gene) trajectories at the times
    ``timepoints``, one forward pass over the (S, m) batch, O(T (p+G)^3).
    The t = 0 convention of the generative model (force at its stationary
    marginal, genes deterministic at ``B/D``); with a Matern
    ``force_kernel`` the draw is from the exact prior. ``generator`` as in
    :func:`posterior_sample_ss` (the t = 0 normals first). Returns ``(f,
    x)``, (num_samples, T) and (num_samples, T, G), gene means added."""
    assert_full_fp32(_WHO)
    g = params.decay.shape[0]
    t = torch.as_tensor(timepoints)
    dtype, dev = t.dtype, t.device
    f_aug, p_inf, p0, h_force = build_lfm_ssm(
        params.decay, params.sensitivity, params.lengthscale, order=order,
        force_kernel=force_kernel,
    )
    m_dim = p0.shape[0]
    a, q = discretize(f_aug, p_inf, torch.diff(t, prepend=torch.zeros((1,), dtype=dtype,
                                                                       device=dev)))
    roots = _psd_sqrt_traced(torch.cat([p0[None], q]))
    kw = dict(generator=generator, dtype=dtype, device=dev)
    z0 = torch.randn((num_samples, m_dim), **kw) @ roots[0].mT
    eps = torch.randn((t.shape[0], num_samples, m_dim), **kw)
    zs = _prior_forward(a, roots[1:], z0, eps)
    f = (zs @ h_force).T
    x = (zs[..., m_dim - g:] + (params.basal / params.decay)).transpose(0, 1)
    return f, x
