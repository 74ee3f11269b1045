r"""Synthetic LFM data for the dense stress configurations.

Port of two generators of ``dis_project_tpu/data/synthetic.py`` (the other
ODE quadrature generators come with their model families):

- :func:`sample_prior`: an exact joint draw from the first-order SIMM GP
  prior using the port's own closed-form kernels. Replicates share one
  latent-force realisation; only the observation noise differs per
  replicate. The prior Gram is near-low-rank, so its build and Cholesky run
  in float64 whatever the working dtype (an f32 factorisation fails
  outright); on the card they run there in f64.
- :func:`generate_ode2`: the second-order (spring-damper) quadrature
  oracle: a force drawn from the consistent RBF prior on a fine grid,
  pushed through the damped oscillator by trapezoid convolution with its
  Green's function, on the host in float64 with NumPy, as the JAX package
  does it; independent of the complex-erf closed forms.

Randomness comes from an explicit ``torch.Generator``; the draws are made on
the CPU, so a seed gives the same data on every device. The JAX package's
``jax.random`` stream cannot be reproduced, so each generator is split into
its draws (:func:`prior_draws`, :func:`ode2_draws`) and a deterministic
function of them (:func:`prior_from_draws`, :func:`ode2_from_draws`), to
which parity tests hand JAX-made draws.
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


def _host64(a):
    a = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return a.astype(np.float64)


def ode2_from_draws(basal, sens, alpha, omega, eps, noise, cfg: SyntheticConfig,
                    oversample: int = 16, dtype=PARITY_DTYPE, device="cpu") -> SyntheticLFMData:
    r"""The second-order data of :func:`generate_ode2` from given draws
    (tensors or numpy arrays): the force ``L_f eps`` on the fine grid
    (``(T-1) oversample + 1`` points; ``L_f`` the Cholesky factor of the
    consistent RBF Gram plus 1e-8 I), and each output

    .. math:: x(t_i) = B/k + S \sum_u w_u\, g(t_i - u) f(u),\qquad
              g(	au) = e^{-lpha	au}\sin(\omega	au)/\omega\ (	au \ge 0),

    with trapezoid weights ``w`` over the whole fine grid (resting initial
    conditions x(0) = B/k, x'(0) = 0), read every ``oversample`` points, plus
    ``noise_std`` times the noise draws. Host float64 (NumPy), then
    ``dtype`` tensors on ``device``."""
    G, T, R = cfg.num_genes, cfg.num_timepoints, cfg.num_replicates

    def dev_t(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    def param(a):
        a = a if isinstance(a, torch.Tensor) else torch.as_tensor(np.array(a))
        return a.to(dtype=dtype, device=device)

    params = {
        "basal": param(basal),
        "sensitivity": param(sens),
        "alpha": param(alpha),
        "omega": param(omega),
        "lengthscale": torch.tensor(cfg.lengthscale, dtype=dtype, device=device),
    }
    ell = float(params["lengthscale"])
    n_fine = (T - 1) * oversample + 1
    t_fine = np.linspace(0.0, cfg.t_max, n_fine)
    Kff = np.exp(-((t_fine[:, None] - t_fine[None, :]) ** 2) / ell**2)
    Lf = np.linalg.cholesky(Kff + 1e-8 * np.eye(n_fine))
    f_fine = Lf @ _host64(eps)

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

    noise64 = cfg.noise_std * _host64(noise).reshape(R, G, T)
    return SyntheticLFMData(
        torch.linspace(0.0, cfg.t_max, T, dtype=dtype, device=device),
        dev_t(x[None, :, :] + noise64),
        torch.full((R, G, T), cfg.noise_std**2, dtype=dtype, device=device),
        params,
        dev_t(f_fine[::oversample]),
    )


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
