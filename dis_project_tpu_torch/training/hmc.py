r"""Hamiltonian Monte Carlo over LFM hyperparameters — full-Bayes kinetics.

Port of ``dis_project_tpu/training/hmc.py``: posterior samples over the
hyperparameters with an exact or state-space MLL as the likelihood and a
flat prior in CONSTRAINED space, moved to the unconstrained sampling space
by the bijector Jacobian (``ops.bijectors.constrain_log_det``).

Standard HMC, as the JAX package runs it:

- a fixed-length leapfrog integrator (:func:`_leapfrog`), one
  value-and-gradient evaluation per inner step and none anywhere else (the
  carried state is ``(q, logp(q), grad(q))``);
- the step size jittered by a factor in [0.67, 1.33) per trajectory;
- dual-averaging step-size adaptation (Hoffman & Gelman 2014, Alg. 5;
  gamma 0.05, t0 10, kappa 0.75, mu = log(10 eps0)) in two warmup
  windows: ~75 % under the identity mass, collecting a Welford variance
  over its second half, then the rest re-tuning the step size under the
  diagonal mass ``where(var > 1e-10, var, 1)``;
- a Metropolis test that rejects a non-finite Hamiltonian
  (``where(isfinite(h_new), min(0, h_old - h_new), -inf)``).

What differs from the JAX package, and why:

- **Randomness.** A ``torch.Generator`` takes the place of JAX's key. Each
  phase (warmup, sampling) draws its tables up front in one call each:
  standard-normal momenta (n, C, d), jitter factors (n, C) and accept
  uniforms (n, C) (:class:`HMCDraws`, :func:`draw_tables`). ``draws=``
  takes the tables ready-made, so one set of random numbers (e.g. JAX's
  own, through ``convert.hmc_draws_from_numpy``) can drive both packages.
- **No scan.** The windows and the sampling phase are Python loops that
  enqueue device work; nothing in them reads the device (the accept test,
  the dual averaging and the Welford update are tensor ops, the step index
  and the Welford window are host integers). The caller reads the result.
  Each evaluation differentiates a fresh leaf and detaches, so no autograd
  graph spans two steps.
- **Chains.** :func:`sample_chains` advances C chains in lockstep as one
  (C, d) position with per-chain step sizes, masses and adaptation state,
  where the JAX package vmaps :func:`sample`. Each chain's log-density is
  called on its own row (a ctypes kernel launch, e.g. the Gram kernel K2,
  takes one parameter set), so C chains launch each kernel C times an
  evaluation. ``mesh=`` is not ported.

The position is flattened in ``jax.flatten_util.ravel_pytree``'s order
(``checkpoint.tree_leaves``: fields in order, depth first), so the
coordinates of a nested NamedTuple land where JAX puts them.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from dis_project_tpu_torch.training import checkpoint

JITTER_LOW, JITTER_HIGH = 0.67, 1.33
# Dual averaging (Hoffman & Gelman 2014, Alg. 5).
GAMMA, T0, KAPPA = 0.05, 10.0, 0.75


class HMCResult(NamedTuple):
    """``samples``: stacked tree of posterior draws (leading axis =
    ``num_samples``); ``accept_rate``: mean Metropolis acceptance over the
    sampling phase; ``step_size``: adapted leapfrog step size;
    ``log_probs``: (num_samples,) log-density trace."""

    samples: object
    accept_rate: torch.Tensor
    step_size: torch.Tensor
    log_probs: torch.Tensor


class MultiChainResult(NamedTuple):
    """``samples``: stacked tree of draws, leading axes ``(num_chains,
    num_samples)``; ``accept_rate``/``step_size``: per-chain ``(C,)``;
    ``log_probs``: ``(C, S)``."""

    samples: object
    accept_rate: torch.Tensor
    step_size: torch.Tensor
    log_probs: torch.Tensor


class HMCDraws(NamedTuple):
    """One phase's random numbers for C chains in a d-dimensional space:
    ``momenta`` (n, C, d) standard normals, ``jitter`` (n, C) step-size
    factors in [0.67, 1.33), ``accept`` (n, C) uniforms in [0, 1) for the
    Metropolis test; row i drives trajectory i of the phase."""

    momenta: torch.Tensor
    jitter: torch.Tensor
    accept: torch.Tensor


def draw_tables(generator: torch.Generator, n: int, num_chains: int, dim: int, dtype,
                device) -> HMCDraws:
    """One phase's :class:`HMCDraws` from ``generator`` (three calls on the
    generator's device, moved to ``device``)."""
    kw = dict(generator=generator, dtype=dtype, device=generator.device)
    momenta = torch.randn((n, num_chains, dim), **kw)
    jitter = JITTER_LOW + (JITTER_HIGH - JITTER_LOW) * torch.rand((n, num_chains), **kw)
    accept = torch.rand((n, num_chains), **kw)
    return HMCDraws(*(a.to(device) for a in (momenta, jitter, accept)))


def ravel(tree):
    """``(flat, unravel)``: the tree's leaves concatenated into one vector
    in ``ravel_pytree``'s order, and the map from a (..., d) tensor back to
    a tree of the same structure whose leaves carry the leading axes."""
    leaves = checkpoint.tree_leaves(tree)
    shapes = [tuple(leaf.shape) for leaf in leaves]
    sizes = [leaf.numel() for leaf in leaves]
    flat = torch.cat([leaf.reshape(-1) for leaf in leaves])

    def unravel(q):
        lead = tuple(q.shape[:-1])
        parts = torch.split(q, sizes, dim=-1)
        return checkpoint.tree_unflatten(
            tree, [p.reshape(lead + s) for p, s in zip(parts, shapes)])

    return flat, unravel


def _value_and_grad(logdensity_fn: Callable, unravel: Callable):
    """``vg(q) -> (logp (C,), grad (C, d))`` for a (C, d) batch of flat
    positions: each row's density on its own, one backward for all, every
    result detached."""

    def vg(q):
        q = q.detach().requires_grad_(True)
        with torch.enable_grad():
            logps = torch.stack([logdensity_fn(unravel(q[c])) for c in range(q.shape[0])])
            (g,) = torch.autograd.grad(logps.sum(), q)
        return logps.detach(), g.detach()

    return vg


def _leapfrog(vg_fn, q, p, logp, g, eps, inv_mass, num_steps):
    """Fixed-length leapfrog from a state whose (logp, grad) are already
    known; returns (q', p', logp', grad'). One ``vg_fn`` evaluation per
    inner step — the only density work in the sampler. ``eps`` broadcasts
    against ``q`` (a scalar, or (C, 1) for C chains)."""
    v = logp
    for _ in range(num_steps):
        p = p + 0.5 * eps * g
        q = q + eps * inv_mass * p
        v, g = vg_fn(q)
        p = p + 0.5 * eps * g
    return q, p, v, g


def _hmc_step(vg_fn, q, logp, g, z, u_jit, u_acc, eps, inv_mass, num_leapfrog):
    """One trajectory and its Metropolis test for C chains: q, g, z,
    inv_mass (C, d); logp, u_jit, u_acc, eps (C,). Returns the new (q,
    logp, g) and the acceptance probability (C,)."""
    eps = eps * u_jit
    # momentum ~ N(0, M) with M = 1 / inv_mass (diagonal).
    p = z / torch.sqrt(inv_mass)
    q_new, p_new, logp_new, g_new = _leapfrog(vg_fn, q, p, logp, g, eps[:, None], inv_mass,
                                              num_leapfrog)
    h_old = -logp + 0.5 * torch.sum(inv_mass * p * p, dim=-1)
    h_new = -logp_new + 0.5 * torch.sum(inv_mass * p_new * p_new, dim=-1)
    log_accept = torch.where(torch.isfinite(h_new), torch.clamp(h_old - h_new, max=0.0),
                             -math.inf)
    accept = torch.log(u_acc) < log_accept
    q = torch.where(accept[:, None], q_new, q)
    logp = torch.where(accept, logp_new, logp)
    g = torch.where(accept[:, None], g_new, g)
    return q, logp, g, torch.exp(log_accept)


def _dual_avg_window(vg_fn, state, draws: HMCDraws, rows: range, inv_mass, eps0,
                     welford_from: int, num_leapfrog: int, target_accept: float):
    """One dual-averaging warmup window under a fixed mass over the draw
    rows ``rows``. Welford accumulation starts at the window's step
    ``welford_from`` (``len(rows)`` disables it). Returns the advanced
    state, the averaged step size (C,) and the Welford (mean, m2, n)."""
    q, logp, g = state
    mu = torch.log(10.0 * eps0)
    log_eps = torch.log(eps0)
    log_eps_bar = log_eps
    h_bar = torch.zeros_like(eps0)
    w_mean, w_m2, w_n = torch.zeros_like(q), torch.zeros_like(q), 0
    for i, row in enumerate(rows):
        q, logp, g, alpha = _hmc_step(vg_fn, q, logp, g, draws.momenta[row], draws.jitter[row],
                                      draws.accept[row], torch.exp(log_eps), inv_mass,
                                      num_leapfrog)
        # dual averaging on the acceptance statistic
        m = i + 1.0
        h_bar = (1.0 - 1.0 / (m + T0)) * h_bar + (target_accept - alpha) / (m + T0)
        log_eps = mu - math.sqrt(m) / GAMMA * h_bar
        w = m ** (-KAPPA)
        log_eps_bar = w * log_eps + (1.0 - w) * log_eps_bar
        # Welford variance over [welford_from, len(rows)).
        if i >= welford_from:
            w_n += 1
            delta = q - w_mean
            w_mean = w_mean + delta / w_n
            w_m2 = w_m2 + delta * (q - w_mean)
    return (q, logp, g), torch.exp(log_eps_bar), (w_mean, w_m2, w_n)


def _draws_for(draws, generator, n_warm, n_samp, num_chains, dim, dtype, device):
    if draws is not None:
        return draws
    if generator is None:
        raise ValueError("HMC needs a torch.Generator or ready-made draws")
    return (draw_tables(generator, n_warm, num_chains, dim, dtype, device),
            draw_tables(generator, n_samp, num_chains, dim, dtype, device))


def _run_chains(vg_fn, q0, draws, num_warmup, num_samples, num_leapfrog, target_accept,
                initial_step_size):
    """The sampler on a (C, d) batch of starting points: warmup windows A
    and B, then the sampling phase. Returns (qs (C, S, d), accept rate
    (C,), step size (C,), log-probs (C, S))."""
    warm, samp = draws
    C, dim = q0.shape
    n_a = (3 * num_warmup) // 4 if num_warmup >= 8 else num_warmup
    n_b = num_warmup - n_a
    logp0, g0 = vg_fn(q0)
    state = (q0, logp0, g0)
    eps0 = torch.full((C,), initial_step_size, dtype=q0.dtype, device=q0.device)
    ones = torch.ones_like(q0)
    # Window A (identity mass): tune eps, collect the Welford variance over
    # its second half. Window B (estimated mass): re-tune eps, because the
    # drift eps * inv_mass * p rescales with the mass.
    state, eps, (_, w_m2, w_n) = _dual_avg_window(
        vg_fn, state, warm, range(0, n_a), ones, eps0, n_a // 2, num_leapfrog, target_accept)
    var = w_m2 / max(w_n - 1.0, 1.0)
    inv_mass = torch.where(var > 1e-10, var, 1.0)
    if n_b > 0:
        state, eps, _ = _dual_avg_window(vg_fn, state, warm, range(n_a, num_warmup), inv_mass,
                                         eps, n_b, num_leapfrog, target_accept)
    q, logp, g = state
    qs, alphas, logps = [], [], []
    for i in range(num_samples):
        q, logp, g, alpha = _hmc_step(vg_fn, q, logp, g, samp.momenta[i], samp.jitter[i],
                                      samp.accept[i], eps, inv_mass, num_leapfrog)
        qs.append(q)
        alphas.append(alpha)
        logps.append(logp)
    if not qs:
        empty = q0.new_zeros((C, 0))
        return q0.new_zeros((C, 0, dim)), empty.mean(dim=1), eps, empty
    return (torch.stack(qs, dim=1), torch.stack(alphas, dim=1).mean(dim=1), eps,
            torch.stack(logps, dim=1))


def sample(
    logdensity_fn: Callable,
    init_position,
    generator: Optional[torch.Generator] = None,
    num_warmup: int = 400,
    num_samples: int = 400,
    num_leapfrog: int = 24,
    target_accept: float = 0.8,
    initial_step_size: float = 0.05,
    draws=None,
) -> HMCResult:
    """HMC posterior samples for a NamedTuple (or any tree) position.

    ``logdensity_fn`` maps the position tree to a scalar log-density (up to
    a constant). NaN/inf proposals are rejected by the Metropolis step, so a
    divergent trajectory lowers acceptance instead of corrupting the chain.
    The random tables come from ``generator`` unless ``draws`` gives them:
    ``(warmup, sampling)`` :class:`HMCDraws` with one chain
    (``num_warmup`` and ``num_samples`` rows)."""
    flat0, unravel = ravel(init_position)
    flat0 = flat0.detach()
    draws = _draws_for(draws, generator, num_warmup, num_samples, 1, flat0.shape[0],
                       flat0.dtype, flat0.device)
    qs, rate, eps, logps = _run_chains(_value_and_grad(logdensity_fn, unravel), flat0[None],
                                       draws, num_warmup, num_samples, num_leapfrog,
                                       target_accept, initial_step_size)
    return HMCResult(samples=unravel(qs[0]), accept_rate=rate[0], step_size=eps[0],
                     log_probs=logps[0])


def sample_chains(
    logdensity_fn: Callable,
    init_position,
    generator: Optional[torch.Generator] = None,
    num_chains: int = 4,
    init_jitter: float = 0.1,
    mesh=None,
    num_warmup: int = 400,
    num_samples: int = 400,
    num_leapfrog: int = 24,
    target_accept: float = 0.8,
    initial_step_size: float = 0.05,
    draws=None,
    init_noise=None,
) -> MultiChainResult:
    """``num_chains`` independent HMC chains, advanced in lockstep as one
    (C, d) position, each with the full :func:`sample` recipe (two-window
    warmup, its own step size and mass). Chains start at ``init_position``
    plus ``init_jitter`` times a standard normal in the UNCONSTRAINED space,
    chain 0 exactly at the seed point. ``init_noise`` ((C, d)) and
    ``draws`` (``(warmup, sampling)`` :class:`HMCDraws` with C chains) take
    the random numbers ready-made; otherwise ``generator`` draws the noise,
    then the tables. Diagnose convergence with :func:`split_rhat` /
    :func:`effective_sample_size` on the (C, S)-leading result."""
    if mesh is not None:
        raise NotImplementedError(
            "sample_chains(mesh=...): sharding the chain axis is not yet ported "
            "(ROADMAP Queue 1 item 17)"
        )
    flat0, unravel = ravel(init_position)
    flat0 = flat0.detach()
    dim = flat0.shape[0]
    if init_noise is None:
        if generator is None:
            raise ValueError("HMC needs a torch.Generator or ready-made draws")
        init_noise = torch.randn((num_chains, dim), generator=generator, dtype=flat0.dtype,
                                 device=generator.device).to(flat0.device)
    noise = init_noise.clone()
    noise[0] = 0.0
    inits = flat0[None, :] + init_jitter * noise
    draws = _draws_for(draws, generator, num_warmup, num_samples, num_chains, dim,
                       flat0.dtype, flat0.device)
    qs, rate, eps, logps = _run_chains(_value_and_grad(logdensity_fn, unravel), inits, draws,
                                       num_warmup, num_samples, num_leapfrog, target_accept,
                                       initial_step_size)
    return MultiChainResult(samples=unravel(qs), accept_rate=rate, step_size=eps,
                            log_probs=logps)


def split_rhat(chains):
    """Split potential-scale-reduction R-hat (Gelman et al. / Stan) per
    coordinate. ``chains``: array-like ``(C, S, ...)``. Each chain is split
    in half before the between/within variance ratio, so a single wandering
    chain is caught too. Returns the trailing shape; near 1 means converged.
    Host numpy."""
    x = np.asarray(chains)
    C, S = x.shape[:2]
    half = S // 2
    if half < 2:
        return np.full(x.shape[2:], np.nan)
    x = np.concatenate([x[:, :half], x[:, half: 2 * half]], axis=0)
    mean_c = x.mean(axis=1)  # (2C, ...)
    var_c = x.var(axis=1, ddof=1)
    W = var_c.mean(axis=0)
    B = half * mean_c.var(axis=0, ddof=1)
    var_plus = (half - 1.0) / half * W + B / half
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.where(W > 0, np.sqrt(var_plus / W), 1.0)


def effective_sample_size(chains):
    """Effective sample size per coordinate (Stan's multi-chain
    autocorrelation estimator, Geyer initial-monotone truncation).
    ``chains``: ``(C, S, ...)``. Returns the trailing shape. Host numpy."""
    x = np.asarray(chains, np.float64)
    C, S = x.shape[:2]
    flat_trail = int(np.prod(x.shape[2:], dtype=int)) if x.ndim > 2 else 1
    xs = x.reshape(C, S, flat_trail)
    out = np.empty(flat_trail)
    for j in range(flat_trail):
        z = xs[:, :, j]
        mean_c = z.mean(axis=1, keepdims=True)
        zc = z - mean_c
        # per-chain autocovariance via FFT
        n_fft = 1 << (2 * S - 1).bit_length()
        f = np.fft.rfft(zc, n=n_fft, axis=1)
        acov = np.fft.irfft(f * np.conj(f), n=n_fft, axis=1)[:, :S].real
        acov /= S  # biased (Stan's convention)
        W = (z.var(axis=1, ddof=1)).mean()
        var_c = acov[:, 0] * S / (S - 1.0)
        B_over_S = z.mean(axis=1).var(ddof=1) if C > 1 else 0.0
        var_plus = var_c.mean() * (S - 1.0) / S + B_over_S
        if var_plus <= 0 or not np.isfinite(var_plus):
            out[j] = np.nan
            continue
        rho = 1.0 - (W - acov.mean(axis=0)) / var_plus  # (S,)
        # Geyer initial monotone sequence on (even, odd) lag pairs.
        tau = -1.0
        prev = np.inf
        m = 0
        while 2 * m + 1 < S:
            pair = rho[2 * m] + rho[2 * m + 1]
            if pair < 0:
                break
            pair = min(pair, prev)
            tau += 2.0 * pair
            prev = pair
            m += 1
        out[j] = C * S / max(tau, 1e-12)
    return out.reshape(x.shape[2:]) if x.ndim > 2 else out[0]


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def pytree_diagnostics(samples):
    """(max split-R-hat, min ESS) over every scalar coordinate of a stacked
    samples tree with leading axes ``(num_chains, num_samples)``. Host
    numpy."""
    rhat_max, ess_min = -np.inf, np.inf
    for leaf in checkpoint.tree_leaves(samples):
        a = _host(leaf)
        rhat_max = max(rhat_max, float(np.nanmax(split_rhat(a))))
        ess_min = min(ess_min, float(np.nanmin(effective_sample_size(a))))
    return rhat_max, ess_min


def mixture_predict(predict_fn, samples, max_components: int = 64):
    """Moment-matched Gaussian of the posterior-predictive mixture (BMA).

    ``samples``: a tree of CONSTRAINED draws with a leading sample axis;
    ``predict_fn(params) -> Gaussian``. The draws are thinned evenly to at
    most ``max_components`` (``round(linspace(0, n-1, take))``), each kept
    draw's predictive is computed by one ``predict_fn`` call (on the card:
    its Gram kernels), and the equal-weight mixture is moment-matched on
    the host:

        mean = E_s[mu_s],  cov = E_s[Sigma_s] + E_s[mu_s mu_s^T] - mean mean^T

    Components with a non-finite predictive or a negative variance are
    dropped first (the reference k_xx family is indefinite at large D*l).
    Returns ``(Gaussian, component_means)``, the means (S_used, N) numpy;
    ``S_used == 0`` gives an all-NaN Gaussian the caller must check."""
    from dis_project_tpu_torch.models.base import Gaussian

    leaves = checkpoint.tree_leaves(samples)
    n = leaves[0].shape[0]
    take = min(int(max_components), n)
    idx = np.round(np.linspace(0, n - 1, take)).astype(int)
    with torch.no_grad():
        dists = [predict_fn(checkpoint.tree_unflatten(samples, [leaf[int(i)] for leaf in leaves]))
                 for i in idx]
        dev = dists[0].mean.device
        mu = _host(torch.stack([d.mean for d in dists]))  # (S, N)
        cov = _host(torch.stack([d.cov for d in dists]))  # (S, N, N)
    finite = (
        np.isfinite(mu).all(axis=1)
        & np.isfinite(cov.reshape(cov.shape[0], -1)).all(axis=1)
        # A draw can survive its Cholesky with a slightly negative
        # posterior variance; it would NaN the mixture's stddev.
        & (np.diagonal(cov, axis1=1, axis2=2).min(axis=1) >= 0)
    )
    mu, cov = mu[finite], cov[finite]
    used = int(finite.sum())
    if used == 0:
        N = mu.shape[1]
        nan = torch.full((N,), math.nan, dtype=torch.from_numpy(mu).dtype, device=dev)
        return Gaussian(mean=nan, cov=torch.full((N, N), math.nan, dtype=nan.dtype,
                                                 device=dev)), mu
    mbar = mu.mean(axis=0)
    dev_ = mu - mbar
    mixed_cov = cov.mean(axis=0) + (dev_.T @ dev_) / used
    return (Gaussian(mean=torch.as_tensor(mbar, device=dev),
                     cov=torch.as_tensor(mixed_cov, device=dev)), mu)


def sample_constrained(logdensity, raw0, generator, num_chains, mesh, constrain_fn, kw,
                       draws=None, init_noise=None):
    """Single-chain :func:`sample` or :func:`sample_chains`, then the
    samples constrained (``constrain_fn`` is elementwise, so it takes the
    stacked leading axes as they are)."""
    if num_chains > 1:
        res = sample_chains(logdensity, raw0, generator, num_chains=num_chains, mesh=mesh,
                            draws=draws, init_noise=init_noise, **kw)
    else:
        res = sample(logdensity, raw0, generator, draws=draws, **kw)
    return res._replace(samples=constrain_fn(res.samples))


def kinetics_posterior(model, params, x, y, generator, num_warmup: int = 400,
                       num_samples: int = 400, num_leapfrog: int = 24, num_chains: int = 1,
                       mesh=None, draws=None, init_noise=None):
    """Posterior over the exact SIMM hyperparameters given expression data.

    Log-density: the exact conjugate MLL (``ExactSIMM.mll``: on the card
    the Gram is K2, its gradient K2's backward) plus the bijector Jacobian,
    i.e. a flat prior on the CONSTRAINED parameters. ``params`` seeds the
    chain (the trained point); samples come back constrained. ``num_chains
    > 1`` returns a :class:`MultiChainResult` with (C, S)-leading samples
    for :func:`pytree_diagnostics`."""
    from dis_project_tpu_torch.models import simm
    from dis_project_tpu_torch.ops import bijectors as bij

    y = y.reshape(-1)

    def logdensity(raw):
        return model.mll(simm.constrain(raw), x, y) + bij.constrain_log_det(
            raw, simm.SIMM_BIJECTORS)

    return sample_constrained(
        logdensity, simm.unconstrain(params), generator, num_chains, mesh, simm.constrain,
        dict(num_warmup=num_warmup, num_samples=num_samples, num_leapfrog=num_leapfrog),
        draws, init_noise)


def kinetics_posterior_ss(params, timepoints, y, generator, *, jitter: float,
                          num_warmup: int = 400, num_samples: int = 400,
                          num_leapfrog: int = 10, num_chains: int = 1, mesh=None,
                          order: int = 10, force_kernel: str = "rbf",
                          stationary_after: Optional[int] = None, draws=None,
                          init_noise=None):
    """Posterior over the SIMM hyperparameters with the O(T) state-space
    likelihood (``ops.statespace.lfm_mll_ss``): full-Bayes kinetics at
    dense scale, where the exact route's O(N^3) per gradient is
    impractical. Same flat-prior-in-constrained-space convention as
    :func:`kinetics_posterior`; the posterior inherits the order-``order``
    SDE approximation of the force prior (``stationary_after``: the
    steady-state likelihood). ``num_leapfrog`` defaults to 10, as in the
    JAX package."""
    from dis_project_tpu_torch.models import simm
    from dis_project_tpu_torch.ops import bijectors as bij
    from dis_project_tpu_torch.ops import statespace as ss_ops

    y = y.reshape(-1)
    t = torch.as_tensor(timepoints)

    def logdensity(raw):
        return ss_ops.lfm_mll_ss(
            simm.constrain(raw), t, y, jitter=jitter, order=order, force_kernel=force_kernel,
            stationary_after=stationary_after,
        ) + bij.constrain_log_det(raw, simm.SIMM_BIJECTORS)

    return sample_constrained(
        logdensity, simm.unconstrain(params), generator, num_chains, mesh, simm.constrain,
        dict(num_warmup=num_warmup, num_samples=num_samples, num_leapfrog=num_leapfrog),
        draws, init_noise)


def delay_posterior_ss(params, timepoints, y, generator, *, jitter: float,
                       num_warmup: int = 400, num_samples: int = 400, num_leapfrog: int = 10,
                       num_chains: int = 1, mesh=None, order: int = 10,
                       force_kernel: str = "rbf", draws=None, init_noise=None):
    """Posterior over (kinetics, per-gene delays) with the O(T G)
    warped-event state-space likelihood (``ops.statespace.delaysimm_mll_ss``),
    the dense-scale full-Bayes route of the delay family. Same conventions
    as :func:`kinetics_posterior_ss`; over the UNCLAMPED model (the gene-0
    delay anchor is a point constraint the posterior does not impose)."""
    from dis_project_tpu_torch.models import delaysimm
    from dis_project_tpu_torch.ops import bijectors as bij
    from dis_project_tpu_torch.ops import statespace as ss_ops

    y = y.reshape(-1)
    t = torch.as_tensor(timepoints)

    def logdensity(raw):
        return ss_ops.delaysimm_mll_ss(
            delaysimm.constrain(raw), t, y, jitter=jitter, order=order, force_kernel=force_kernel
        ) + bij.constrain_log_det(raw, delaysimm.DELAY_BIJECTORS)

    return sample_constrained(
        logdensity, delaysimm.unconstrain(params), generator, num_chains, mesh,
        delaysimm.constrain,
        dict(num_warmup=num_warmup, num_samples=num_samples, num_leapfrog=num_leapfrog),
        draws, init_noise)
