r"""Synthetic LFM data for the dense stress configurations.

Port of the six generators of ``dis_project_tpu/data/synthetic.py``:

- :func:`sample_prior`: an exact joint draw from the first-order SIMM GP
  prior using the port's own closed-form kernels. Replicates share one
  latent-force realisation; only the observation noise differs per
  replicate. The prior Gram is near-low-rank, so its build and Cholesky run
  in float64 whatever the working dtype (an f32 factorisation fails
  outright); on the card they run there in f64.
- :func:`generate_ode`: the first-order quadrature oracle of the sparse
  route: a force drawn from the consistent RBF prior on a fine grid, pushed
  through each gene's ODE by the exponential-kernel trapezoid rule (host
  float64); no closed-form kernel on this path.
- :func:`generate_ode_nonlinear`: :func:`generate_ode`'s draws pushed
  through a response ``g(f)`` of ``ops.odeint`` before the quadrature.
- :func:`generate_ode2`: the second-order (spring-damper) quadrature
  oracle: a force drawn from the consistent RBF prior on a fine grid,
  pushed through the damped oscillator by trapezoid convolution with its
  Green's function, on the host in float64 with NumPy, as the JAX package
  does it; independent of the complex-erf closed forms.
- :func:`generate_ode_multi`: the multi-force quadrature oracle: R
  independent consistent-RBF forces mixed per gene through (G, R)
  sensitivities, integrated by the exponential-kernel trapezoid rule.
- :func:`generate_ode_delay`: the delayed-response quadrature oracle: the
  force switched on at 0 and shifted per gene by its delay (``np.interp``),
  gene 0's delay pinned to 0.

Randomness comes from an explicit ``torch.Generator``; the draws are made on
the CPU, so a seed gives the same data on every device. The JAX package's
``jax.random`` stream cannot be reproduced, so each generator is split into
its draws (:func:`prior_draws`, :func:`ode_draws`, :func:`ode2_draws`,
:func:`multi_draws`, :func:`delay_draws`) and a deterministic function of
them (:func:`prior_from_draws`, :func:`ode_from_draws`,
:func:`ode2_from_draws`, :func:`multi_from_draws`, :func:`delay_from_draws`),
to which parity tests hand JAX-made draws.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from dis_project_tpu_torch.ops import lfm_kernels as lfk
from dis_project_tpu_torch.ops.precision import PARITY_DTYPE, default_device


@dataclasses.dataclass
class SyntheticConfig:
    """Shape and ground-truth distribution of a synthetic LFM dataset.

    The defaults give the N ~ 1e4 dense stress config (50 x 200 x 1).
    """

    num_genes: int = 50
    num_timepoints: int = 200
    num_replicates: int = 1
    t_max: float = 12.0
    lengthscale: float = 2.5
    noise_std: float = 0.1
    basal_range: tuple = (0.01, 0.1)
    sensitivity_range: tuple = (0.5, 1.5)
    decay_range: tuple = (0.2, 1.0)
    jitter: float = 1e-6

    @property
    def n_points(self) -> int:
        return self.num_genes * self.num_timepoints * self.num_replicates


class SyntheticLFMData:
    """P53Data-compatible container for generated data: ``timepoints``,
    ``gene_expressions`` (R, G, T), ``gene_variances``, ``num_genes``,
    ``num_replicates``, ``gene_names``, plus the generating ground truth
    ``params_true`` / ``f_true``."""

    def __init__(self, timepoints, expressions, variances, params_true, f_true):
        self.timepoints = timepoints
        self.gene_expressions = expressions
        self.gene_variances = variances
        self.num_replicates = int(expressions.shape[0])
        self.num_genes = int(expressions.shape[1])
        self.gene_names = [f"g{i:03d}" for i in range(self.num_genes)]
        self.params_true = params_true
        self.f_true = f_true
        self.f_observed = f_true.reshape(1, 1, -1)
        self.replicate = None
        self.selected_indices = list(range(self.num_genes))

    def __len__(self):
        return self.num_replicates * self.num_genes

    def params_ground_truth(self):
        """(B, S, D) for first-order data, (B, S, alpha, omega) for
        second-order data (:func:`generate_ode2`), as host numpy arrays."""
        p = self.params_true
        keys = ("basal", "sensitivity") + (
            ("alpha", "omega") if "alpha" in p else ("decay",))
        return tuple(p[k].detach().cpu().numpy() for k in keys)


def _kxx_gene_rows(t, decay, sens, ell):
    """(G*T, G*T) gene-gene covariance built one gene's row block at a time,
    so peak temporaries are (T, G, T), not (G, T, G, T)."""
    G, T = decay.shape[0], t.shape[0]
    K = torch.empty((G * T, G * T), dtype=t.dtype, device=t.device)
    tt1 = t[:, None, None]
    tt2 = t[None, None, :]
    d_k = decay[None, :, None]
    s_k = sens[None, :, None]
    for j in range(G):
        block = lfk.k_xx(tt1, tt2, decay[j], d_k, sens[j], s_k, ell)
        K[j * T : (j + 1) * T] = block.reshape(T, G * T)
    return K


def _uniform(generator: torch.Generator, n: int, lo_hi, dtype):
    lo, hi = lo_hi
    return lo + (hi - lo) * torch.rand(n, generator=generator, dtype=dtype)


def _sample_kinetics(generator: torch.Generator, cfg: SyntheticConfig, dtype):
    """Kinetics uniforms on the CPU, in the order basal, sensitivity,
    decay, and the lengthscale: a dict of ``dtype`` tensors."""
    G = cfg.num_genes
    return {
        "basal": _uniform(generator, G, cfg.basal_range, dtype),
        "sensitivity": _uniform(generator, G, cfg.sensitivity_range, dtype),
        "decay": _uniform(generator, G, cfg.decay_range, dtype),
        "lengthscale": torch.tensor(cfg.lengthscale, dtype=dtype),
    }


def prior_draws(generator: torch.Generator, cfg: SyntheticConfig, dtype):
    """Every random draw of :func:`sample_prior`, on the CPU: kinetics
    uniforms (basal, sensitivity, decay) in ``dtype``, then the float32
    standard normals for the prior draw (n,) and the noise (R, n)."""
    n = cfg.num_genes * cfg.num_timepoints
    k = _sample_kinetics(generator, cfg, dtype)
    eps = torch.randn(n, generator=generator, dtype=torch.float32)
    noise = torch.randn(cfg.num_replicates, n, generator=generator, dtype=torch.float32)
    return k["basal"], k["sensitivity"], k["decay"], eps, noise


def prior_from_draws(basal, sens, dec, eps, noise, cfg: SyntheticConfig,
                     dtype=PARITY_DTYPE, device="cpu") -> SyntheticLFMData:
    """The prior sample of :func:`sample_prior` from given draws (tensors or
    numpy arrays)."""
    f64 = dict(dtype=torch.float64, device=device)
    G, T, R = cfg.num_genes, cfg.num_timepoints, cfg.num_replicates
    t = torch.linspace(0.0, cfg.t_max, T, dtype=dtype, device=device)
    params = {
        "basal": torch.as_tensor(basal, dtype=dtype, device=device),
        "sensitivity": torch.as_tensor(sens, dtype=dtype, device=device),
        "decay": torch.as_tensor(dec, dtype=dtype, device=device),
        "lengthscale": torch.tensor(cfg.lengthscale, dtype=dtype, device=device),
    }
    t64 = t.to(torch.float64)
    d64 = params["decay"].to(torch.float64)
    s64 = params["sensitivity"].to(torch.float64)
    ell = float(params["lengthscale"])

    Kxx = _kxx_gene_rows(t64, d64, s64, ell)
    jitter = max(cfg.jitter, 1e-9 * float(Kxx.diagonal().abs().max()))
    Kxx.diagonal().add_(jitter)  # in place: the (n, n) f64 buffer is the big one
    L = torch.linalg.cholesky(Kxx)
    del Kxx
    mean = (params["basal"] / params["decay"]).to(torch.float64).repeat_interleave(T)
    x_clean = mean + L @ torch.as_tensor(eps, **f64)

    # Conditional mean of f | x on the same grid — the ground-truth force.
    Kfx = lfk.k_xf_block(t64, t64, d64, s64, ell).T  # (T, n)
    z = torch.linalg.solve_triangular(L, (x_clean - mean)[:, None], upper=False)
    alpha = torch.linalg.solve_triangular(L.T, z, upper=True)[:, 0]
    f_true = (Kfx @ alpha).to(dtype)

    y = x_clean[None, :] + cfg.noise_std * torch.as_tensor(noise, **f64)
    expressions = y.reshape(R, G, T).to(dtype)
    variances = torch.full((R, G, T), cfg.noise_std**2, dtype=dtype, device=device)
    return SyntheticLFMData(t, expressions, variances, params, f_true)


def sample_prior(generator: torch.Generator, cfg: Optional[SyntheticConfig] = None,
                 dtype=PARITY_DTYPE, device=None) -> SyntheticLFMData:
    """Exact joint draw from the SIMM prior at ``cfg``'s shape: one (G*T)
    Gaussian draw from the closed-form gene-gene covariance, its
    conditional latent force on the same grid, tiled over replicates with
    i.i.d. observation noise. Runs on ``device`` (default: the card)."""
    cfg = cfg or SyntheticConfig()
    dev = default_device(device)
    return prior_from_draws(*prior_draws(generator, cfg, dtype), cfg, dtype, dev)


def _host64(a):
    a = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return a.astype(np.float64)


def _fine_force(eps, ell: float, t_fine: np.ndarray) -> np.ndarray:
    """A consistent-RBF force ``L_f eps`` on the fine grid, ``L_f`` the
    Cholesky factor of ``exp(-(t - t')^2 / l^2) + 1e-8 I`` (host float64)."""
    Kff = np.exp(-((t_fine[:, None] - t_fine[None, :]) ** 2) / ell**2)
    return np.linalg.cholesky(Kff + 1e-8 * np.eye(t_fine.shape[0])) @ _host64(eps)


def _first_order_response(b, d, forcing, t_fine, sens=None):
    r"""``B/D + S e^{-D t} \int_0^t e^{D u} g_j(u) du`` per gene by the
    cumulative trapezoid rule on the fine grid (host float64), ``forcing``
    the (G, F) per-gene forcing ``g_j``; ``sens`` (G,) or None (S = 1, the
    sensitivities inside ``g_j``)."""
    dt = t_fine[1] - t_fine[0]
    integrand = np.exp(d[:, None] * t_fine[None, :]) * forcing
    steps = 0.5 * dt * (integrand[:, 1:] + integrand[:, :-1])
    cumint = np.concatenate([np.zeros((d.shape[0], 1)), np.cumsum(steps, axis=1)], axis=1)
    decayed = np.exp(-d[:, None] * t_fine[None, :])
    if sens is not None:
        decayed = sens[:, None] * decayed
    return (b / d)[:, None] + decayed * cumint


def _ode_data(x, f_true, noise, params, cfg, dtype, device):
    """The quadrature generators' container: the (G, T) outputs ``x`` plus
    ``noise_std`` times the noise draws, and the force at the outputs'
    times, as ``dtype`` tensors on ``device``."""
    G, T, R = cfg.num_genes, cfg.num_timepoints, cfg.num_replicates

    def dev_t(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    noise64 = cfg.noise_std * _host64(noise).reshape(R, G, T)
    return SyntheticLFMData(
        torch.linspace(0.0, cfg.t_max, T, dtype=dtype, device=device),
        dev_t(x[None, :, :] + noise64),
        torch.full((R, G, T), cfg.noise_std**2, dtype=dtype, device=device),
        params,
        dev_t(f_true),
    )


def _param(a, dtype, device):
    a = a if isinstance(a, torch.Tensor) else torch.as_tensor(np.array(a))
    return a.to(dtype=dtype, device=device)


def ode_draws(generator: torch.Generator, cfg: SyntheticConfig, oversample: int = 16,
              dtype=PARITY_DTYPE):
    """Every random draw of :func:`generate_ode`, on the CPU: the kinetics
    uniforms (basal, sensitivity, decay) in ``dtype``, then the float32
    standard normals of the fine-grid force (n_fine,) and of the noise
    (R, G, T)."""
    G, T, R = cfg.num_genes, cfg.num_timepoints, cfg.num_replicates
    k = _sample_kinetics(generator, cfg, dtype)
    eps = torch.randn((T - 1) * oversample + 1, generator=generator, dtype=torch.float32)
    noise = torch.randn(R, G, T, generator=generator, dtype=torch.float32)
    return k["basal"], k["sensitivity"], k["decay"], eps, noise


def ode_from_draws(basal, sens, decay, eps, noise, cfg: SyntheticConfig,
                   oversample: int = 16, response=None, dtype=PARITY_DTYPE,
                   device="cpu") -> SyntheticLFMData:
    r"""The first-order data of :func:`generate_ode` from given draws
    (tensors or numpy arrays): the force ``L_f eps`` on the fine grid
    (``(T-1) oversample + 1`` points), and each gene

    .. math:: x_j(t) = \frac{B_j}{D_j} + S_j e^{-D_j t}
        \int_0^t e^{D_j u} g(f(u))\,du

    by the cumulative trapezoid rule (host float64), read every
    ``oversample`` points, plus ``noise_std`` times the noise draws.
    ``response`` is ``g``, a function of a float64 numpy array (None: the
    identity); ``f_true`` is the force f before the response."""
    params = {
        "basal": _param(basal, dtype, device),
        "sensitivity": _param(sens, dtype, device),
        "decay": _param(decay, dtype, device),
        "lengthscale": torch.tensor(cfg.lengthscale, dtype=dtype, device=device),
    }
    n_fine = (cfg.num_timepoints - 1) * oversample + 1
    t_fine = np.linspace(0.0, cfg.t_max, n_fine)
    f_fine = _fine_force(eps, float(params["lengthscale"]), t_fine)
    g_fine = f_fine if response is None else np.asarray(response(f_fine), np.float64)
    x_fine = _first_order_response(_host64(params["basal"]), _host64(params["decay"]),
                                   g_fine[None, :], t_fine,
                                   sens=_host64(params["sensitivity"]))
    return _ode_data(x_fine[:, ::oversample], f_fine[::oversample], noise, params, cfg, dtype,
                     device)


def generate_ode(generator: torch.Generator, cfg: Optional[SyntheticConfig] = None,
                 oversample: int = 16, dtype=PARITY_DTYPE, device=None) -> SyntheticLFMData:
    r"""First-order quadrature oracle at ``cfg``'s shape,
    :math:`\dot x_j = B_j + S_j f(t) - D_j x_j` with x_j(0) = B_j / D_j,
    against a force from the consistent RBF prior on a grid ``oversample``
    times finer than the outputs (:func:`ode_from_draws`). Runs on
    ``device`` (default: the card); the quadrature is host float64."""
    cfg = cfg or SyntheticConfig()
    dev = default_device(device)
    return ode_from_draws(*ode_draws(generator, cfg, oversample, dtype), cfg, oversample,
                          dtype=dtype, device=dev)


def generate_ode_nonlinear(generator: torch.Generator, cfg: Optional[SyntheticConfig] = None,
                           response: str = "exp", oversample: int = 16, dtype=PARITY_DTYPE,
                           device=None) -> SyntheticLFMData:
    r"""Nonlinear-response quadrature oracle for ``models.nlfm``,
    :math:`\dot x_j = B_j + S_j\,g(f(t)) - D_j x_j` with ``g`` one of
    ``ops.odeint.RESPONSE_NAMES``: the draws of :func:`generate_ode`
    (``response='identity'`` gives its data bit for bit on the same
    generator state); ``f_true`` is the force f before the response."""
    from dis_project_tpu_torch.ops import odeint

    cfg = cfg or SyntheticConfig()
    dev = default_device(device)
    return ode_from_draws(*ode_draws(generator, cfg, oversample, dtype), cfg, oversample,
                          response=odeint.response_fn(response, xp=np), dtype=dtype,
                          device=dev)


# The second-order generator's kinetics ranges (JAX generate_ode2's defaults).
ALPHA_RANGE = (0.2, 0.8)
OMEGA_RANGE = (0.6, 1.6)


def ode2_draws(generator: torch.Generator, cfg: SyntheticConfig, oversample: int = 16,
               alpha_range: tuple = ALPHA_RANGE, omega_range: tuple = OMEGA_RANGE,
               dtype=PARITY_DTYPE):
    """Every random draw of :func:`generate_ode2`, on the CPU: basal and
    sensitivity (with the unused decay of the shared kinetics draw), alpha
    and omega uniforms in ``dtype``, then the float32 standard normals of
    the fine-grid force (n_fine,) and of the noise (R, G, T)."""
    G, T, R = cfg.num_genes, cfg.num_timepoints, cfg.num_replicates
    k = _sample_kinetics(generator, cfg, dtype)
    alpha = _uniform(generator, G, alpha_range, dtype)
    omega = _uniform(generator, G, omega_range, dtype)
    eps = torch.randn((T - 1) * oversample + 1, generator=generator, dtype=torch.float32)
    noise = torch.randn(R, G, T, generator=generator, dtype=torch.float32)
    return k["basal"], k["sensitivity"], alpha, omega, eps, noise


def ode2_from_draws(basal, sens, alpha, omega, eps, noise, cfg: SyntheticConfig,
                    oversample: int = 16, dtype=PARITY_DTYPE, device="cpu") -> SyntheticLFMData:
    r"""The second-order data of :func:`generate_ode2` from given draws
    (tensors or numpy arrays): the force ``L_f eps`` on the fine grid
    (``(T-1) oversample + 1`` points; ``L_f`` the Cholesky factor of the
    consistent RBF Gram plus 1e-8 I), and each output

    .. math:: x(t_i) = B/k + S \sum_u w_u\, g(t_i - u) f(u),\qquad
              g(\tau) = e^{-\alpha\tau}\sin(\omega\tau)/\omega\ (\tau \ge 0),

    with trapezoid weights ``w`` over the whole fine grid (resting initial
    conditions x(0) = B/k, x'(0) = 0), read every ``oversample`` points, plus
    ``noise_std`` times the noise draws. Host float64 (NumPy), then
    ``dtype`` tensors on ``device``."""
    params = {
        "basal": _param(basal, dtype, device),
        "sensitivity": _param(sens, dtype, device),
        "alpha": _param(alpha, dtype, device),
        "omega": _param(omega, dtype, device),
        "lengthscale": torch.tensor(cfg.lengthscale, dtype=dtype, device=device),
    }
    n_fine = (cfg.num_timepoints - 1) * oversample + 1
    t_fine = np.linspace(0.0, cfg.t_max, n_fine)
    f_fine = _fine_force(eps, float(params["lengthscale"]), t_fine)

    dt = t_fine[1] - t_fine[0]
    a = _host64(params["alpha"])[:, None]
    w = _host64(params["omega"])[:, None]
    s = _host64(params["sensitivity"])[:, None]
    b = _host64(params["basal"])[:, None]
    spring = a**2 + w**2
    # tau[_, i, f] = t_out[i] - u[f], the Green's function's argument.
    tau = t_fine[None, ::oversample, None] - t_fine[None, None, :]  # (1, T, F)
    green = np.where(
        tau >= 0,
        np.exp(-a[:, :, None] * tau) * np.sin(w[:, :, None] * tau) / w[:, :, None],
        0.0,
    )  # (G, T, F)
    weights = np.full(n_fine, dt)
    weights[0] = weights[-1] = dt / 2.0
    x = b / spring + s * np.einsum("gtf,f,f->gt", green, f_fine, weights)

    return _ode_data(x, f_fine[::oversample], noise, params, cfg, dtype, device)


def generate_ode2(generator: torch.Generator, cfg: Optional[SyntheticConfig] = None,
                  oversample: int = 16, alpha_range: tuple = ALPHA_RANGE,
                  omega_range: tuple = OMEGA_RANGE, dtype=PARITY_DTYPE,
                  device=None) -> SyntheticLFMData:
    r"""Second-order (spring-damper) quadrature oracle at ``cfg``'s shape:
    :math:`\ddot x + 2\alpha \dot x + (\alpha^2+\omega^2) x = B + S f(t)`
    integrated against a force from the consistent RBF prior
    (:func:`ode2_from_draws`); the ground-truth kinetics in ``params_true``
    carry ``alpha``/``omega`` in place of ``decay``. Runs on ``device``
    (default: the card); the convolution is host float64."""
    cfg = cfg or SyntheticConfig()
    dev = default_device(device)
    draws = ode2_draws(generator, cfg, oversample, alpha_range, omega_range, dtype)
    return ode2_from_draws(*draws, cfg, oversample, dtype, dev)


def multi_draws(generator: torch.Generator, cfg: SyntheticConfig, num_forces: int = 2,
                oversample: int = 16, dtype=PARITY_DTYPE):
    """Every random draw of :func:`generate_ode_multi`, on the CPU: basal
    and decay (with the unused sensitivity of the shared kinetics draw) and
    the (G, R) sensitivity uniforms in ``dtype``, then the float32 standard
    normals of the R fine-grid forces (R, n_fine) and of the noise (R_rep,
    G, T)."""
    G, T, R = cfg.num_genes, cfg.num_timepoints, cfg.num_replicates
    k = _sample_kinetics(generator, cfg, dtype)
    lo, hi = cfg.sensitivity_range
    sens = lo + (hi - lo) * torch.rand((G, num_forces), generator=generator, dtype=dtype)
    eps = torch.randn(num_forces, (T - 1) * oversample + 1, generator=generator,
                      dtype=torch.float32)
    noise = torch.randn(R, G, T, generator=generator, dtype=torch.float32)
    return k["basal"], k["decay"], sens, eps, noise


def multi_from_draws(basal, decay, sens, eps, noise, cfg: SyntheticConfig,
                     oversample: int = 16, lengthscales=None, dtype=PARITY_DTYPE,
                     device="cpu") -> SyntheticLFMData:
    r"""The multi-force data of :func:`generate_ode_multi` from given draws
    (tensors or numpy arrays): R forces ``L_r eps_r`` on the fine grid, one
    per lengthscale (default ``linspace(1, 3, R)``, ``cfg.lengthscale`` for
    R = 1), and each gene

    .. math:: x_j(t) = \frac{B_j}{D_j} + e^{-D_j t}
        \int_0^t e^{D_j u} \sum_r S_{jr} f_r(u)\,du

    by the cumulative trapezoid rule (host float64). ``params_true`` holds
    the (G, R) sensitivities and the (R,) lengthscales; ``f_true`` is (R, T)."""
    R = int(np.asarray(eps).shape[0])
    if lengthscales is None:
        lengthscales = np.linspace(1.0, 3.0, R) if R > 1 else [cfg.lengthscale]
    lengthscales = np.asarray(lengthscales, np.float64)
    params = {
        "basal": _param(basal, dtype, device),
        "sensitivity": _param(sens, dtype, device),
        "decay": _param(decay, dtype, device),
        "lengthscale": torch.as_tensor(lengthscales, dtype=dtype, device=device),
    }
    n_fine = (cfg.num_timepoints - 1) * oversample + 1
    t_fine = np.linspace(0.0, cfg.t_max, n_fine)
    eps64 = _host64(eps)
    f_fine = np.stack([_fine_force(eps64[r], lengthscales[r], t_fine) for r in range(R)])
    mixed = _host64(params["sensitivity"]) @ f_fine  # (G, F): per-gene mixed force
    x_fine = _first_order_response(_host64(params["basal"]), _host64(params["decay"]), mixed,
                                   t_fine)
    return _ode_data(x_fine[:, ::oversample], f_fine[:, ::oversample], noise, params, cfg,
                     dtype, device)


def generate_ode_multi(generator: torch.Generator, cfg: Optional[SyntheticConfig] = None,
                       num_forces: int = 2, oversample: int = 16, lengthscales=None,
                       dtype=PARITY_DTYPE, device=None) -> SyntheticLFMData:
    """Multi-force quadrature oracle at ``cfg``'s shape
    (:func:`multi_from_draws`). Runs on ``device`` (default: the card); the
    quadrature is host float64."""
    cfg = cfg or SyntheticConfig()
    dev = default_device(device)
    draws = multi_draws(generator, cfg, num_forces, oversample, dtype)
    return multi_from_draws(*draws, cfg, oversample, lengthscales, dtype, dev)


# The delayed-response generator's default delay range (JAX generate_ode_delay).
DELAY_RANGE = (0.0, 2.0)


def delay_draws(generator: torch.Generator, cfg: SyntheticConfig, oversample: int = 16,
                delay_range: tuple = DELAY_RANGE, dtype=PARITY_DTYPE):
    """Every random draw of :func:`generate_ode_delay`, on the CPU: the
    kinetics uniforms (basal, sensitivity, decay) in ``dtype``, the float32
    normals of the fine-grid force (n_fine,) and of the noise (R, G, T),
    and last, apart from those streams, the float32 delay uniforms (G,)
    with gene 0's set to 0."""
    G, T, R = cfg.num_genes, cfg.num_timepoints, cfg.num_replicates
    k = _sample_kinetics(generator, cfg, dtype)
    eps = torch.randn((T - 1) * oversample + 1, generator=generator, dtype=torch.float32)
    noise = torch.randn(R, G, T, generator=generator, dtype=torch.float32)
    delays = _uniform(generator, G, delay_range, torch.float32)
    delays[0] = 0.0
    return k["basal"], k["sensitivity"], k["decay"], eps, noise, delays


def delay_from_draws(basal, sens, decay, eps, noise, delays, cfg: SyntheticConfig,
                     oversample: int = 16, dtype=PARITY_DTYPE, device="cpu") -> SyntheticLFMData:
    r"""The delayed-response data of :func:`generate_ode_delay` from given
    draws (tensors or numpy arrays): the force ``L_f eps`` on the fine
    grid, shifted per gene by its delay with ``np.interp`` (0 before
    switch-on), and

    .. math:: x_j(t) = \frac{B_j}{D_j} + S_j e^{-D_j t}
        \int_0^t e^{D_j u} f(u - \delta_j)\,du

    by the cumulative trapezoid rule (host float64). ``params_true`` holds
    the delays under ``'delay'``."""
    params = {
        "basal": _param(basal, dtype, device),
        "sensitivity": _param(sens, dtype, device),
        "decay": _param(decay, dtype, device),
        "lengthscale": torch.tensor(cfg.lengthscale, dtype=dtype, device=device),
    }
    delays = _host64(delays)
    params["delay"] = torch.as_tensor(delays, dtype=dtype, device=device)
    n_fine = (cfg.num_timepoints - 1) * oversample + 1
    t_fine = np.linspace(0.0, cfg.t_max, n_fine)
    f_fine = _fine_force(eps, float(params["lengthscale"]), t_fine)
    f_del = np.stack([np.interp(t_fine - dl, t_fine, f_fine, left=0.0) for dl in delays])
    x_fine = _first_order_response(_host64(params["basal"]), _host64(params["decay"]), f_del,
                                   t_fine, sens=_host64(params["sensitivity"]))
    return _ode_data(x_fine[:, ::oversample], f_fine[::oversample], noise, params, cfg, dtype,
                     device)


def generate_ode_delay(generator: torch.Generator, cfg: Optional[SyntheticConfig] = None,
                       oversample: int = 16, delay_range: tuple = DELAY_RANGE,
                       dtype=PARITY_DTYPE, device=None) -> SyntheticLFMData:
    r"""Delayed-response quadrature oracle at ``cfg``'s shape,
    :math:`\dot x_j = B_j + S_j f(t - \delta_j) - D_j x_j`
    (:func:`delay_from_draws`); the ground-truth delays in
    ``params_true['delay']``, gene 0's pinned to 0 (the anchor
    ``delaysimm.fit`` applies). Runs on ``device`` (default: the card); the
    quadrature is host float64."""
    cfg = cfg or SyntheticConfig()
    dev = default_device(device)
    draws = delay_draws(generator, cfg, oversample, delay_range, dtype)
    return delay_from_draws(*draws, cfg, oversample, dtype, dev)
