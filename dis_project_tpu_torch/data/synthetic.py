r"""Synthetic first-order LFM data for the dense stress configuration.

Port of :func:`sample_prior` from ``dis_project_tpu/data/synthetic.py`` (the
ODE quadrature generators are not ported yet): an exact joint draw from the
SIMM GP prior using the port's own closed-form kernels. Replicates share one
latent-force realisation; only the observation noise differs per replicate.

Randomness comes from an explicit ``torch.Generator``; the draws are made on
the CPU, so a seed gives the same data on every device. The JAX package's
``jax.random`` stream cannot be reproduced, so parity tests hand JAX-made
draws to :func:`prior_from_draws`.

The prior Gram is near-low-rank, so its build and Cholesky run in float64
whatever the working dtype (an f32 factorisation fails outright); on the
card they run there in f64.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

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

    def params_ground_truth(self):
        """(B, S, D) as host numpy arrays."""
        p = self.params_true
        return tuple(
            p[k].detach().cpu().numpy() for k in ("basal", "sensitivity", "decay")
        )


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


def prior_draws(generator: torch.Generator, cfg: SyntheticConfig, dtype):
    """Every random draw of :func:`sample_prior`, on the CPU: kinetics
    uniforms (basal, sensitivity, decay) in ``dtype``, then the float32
    standard normals for the prior draw (n,) and the noise (R, n)."""
    G = cfg.num_genes
    n = G * cfg.num_timepoints

    def u(lo_hi):
        lo, hi = lo_hi
        return lo + (hi - lo) * torch.rand(G, generator=generator, dtype=dtype)

    basal = u(cfg.basal_range)
    sens = u(cfg.sensitivity_range)
    dec = u(cfg.decay_range)
    eps = torch.randn(n, generator=generator, dtype=torch.float32)
    noise = torch.randn(cfg.num_replicates, n, generator=generator, dtype=torch.float32)
    return basal, sens, dec, eps, noise


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
