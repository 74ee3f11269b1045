r"""Independent PyTorch (CPU) implementation of the SIMM LFM for
cross-framework validation.

The port's own copy of ``dis_project_tpu/validation/torch_lfm.py`` (the
port imports nothing of the JAX package): the same code, so it gives that
module's values bit for bit. In the port it is the oracle the ``alfi-parity``
route holds ``models.simm.ExactSIMM`` to.

Role: the reference validates its GPJax implementation against a second full
stack in GPyTorch (``src/gpytorch_alfi/``, SURVEY.md §2b) — agreement of the
two latent-force posteriors is its de-facto integration test. This module
plays the same role for the JAX framework: the same math, written a second
time in a different framework with a *different implementation strategy*, so
numerical agreement is meaningful:

- torch autograd (no custom VJP), eager per-epoch training loop
  (vs the JAX side's jit-compiled scan + factorisation-reusing VJP);
- **blockwise Gram assembly** with an explicit Python double loop over gene
  pairs on a 1-D blocked time vector (the reference torch path's encoding,
  ``src/gpytorch_alfi/model_alfi.py:266-300,545-569``) — gene identity by
  block position, not a gene-index column;
- plain torch.linalg for the MVN pieces.

Behavioral contract mirrored from the reference torch stack (SURVEY.md §2
#24, #26): the **fixed per-point measurement variances and the jitter are
added inside the kernel forward** when the Gram is square — so the torch-side
MLL *does* see measurement variances (the GPJax side's MLL deliberately does
not; tests compare like with like) — and the per-epoch p21 clamp fixes
S[3] = 1.0, D[3] = 0.8 under ``no_grad``.

Everything is f64 CPU — this is a parity oracle, not a performance path.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

SQRT_PI = math.sqrt(math.pi)


def _softplus_inv(y: torch.Tensor) -> torch.Tensor:
    return y + torch.log(-torch.expm1(-y))


def split_indices(
    n: int, valid_size: float = 0.0, test_size: float = 0.0, seed: int = 0
):
    """Permutation split of ``n`` observation rows into (train, valid, test).

    The reference torch trainer's dataset-splitting scaffolding
    (``src/gpytorch_alfi/trainer_alfi.py:68-82``): one permutation, the
    first ``floor(valid_size*n)`` rows are validation, the next
    ``floor(test_size*n)`` are test, the remainder train.  Defaults (0, 0)
    put every row in train, matching the reference's default loaders.
    """
    g = torch.Generator().manual_seed(seed)
    perm = torch.randperm(n, generator=g)
    n_valid = int(math.floor(valid_size * n))
    n_test = int(math.floor(test_size * n))
    valid = perm[:n_valid]
    test = perm[n_valid : n_valid + n_test]
    train = perm[n_valid + n_test :]
    return train, valid, test


class TorchP53Dataset(torch.utils.data.Dataset):
    """torch ``Dataset`` view of a loaded p53 dataset (the role of the
    reference's ``PyTorchDataset``, ``src/gpytorch_alfi/dataset_alfi.py``):
    items are ``(timepoints, expression)`` pairs indexed replicate-major
    over genes; the 1-D blocked (train_t, train_y) encoding the torch
    model consumes comes from :meth:`blocked`.

    Construct from the framework's loader so both stacks share one data
    path: ``TorchP53Dataset.from_p53(P53Data(...))``.
    """

    def __init__(self, timepoints, expressions, variances):
        self.timepoints = torch.as_tensor(timepoints, dtype=torch.float64)
        self.expressions = torch.as_tensor(expressions, dtype=torch.float64)
        self.variances = torch.as_tensor(variances, dtype=torch.float64)
        self.num_replicates = int(self.expressions.shape[0])
        self.num_genes = int(self.expressions.shape[1])

    @classmethod
    def from_p53(cls, data):
        import numpy as np

        return cls(
            np.asarray(data.timepoints),
            np.asarray(data.gene_expressions),
            np.asarray(data.gene_variances),
        )

    def __len__(self):
        return self.num_replicates * self.num_genes

    def __getitem__(self, index):
        r, g = divmod(index, self.num_genes)
        return self.timepoints, self.expressions[r, g]

    def blocked(self):
        """1-D blocked (train_t, train_y, variances) — gene identity by
        block position (reference ``model_alfi.py:545-569``)."""
        n_blocks = self.num_replicates * self.num_genes
        train_t = self.timepoints.repeat(n_blocks)
        train_y = self.expressions.reshape(-1)
        return train_t, train_y, self.variances.reshape(-1)


class TorchSIMM(torch.nn.Module):
    """Exact SIMM LFM on a 1-D blocked time vector (torch, f64, CPU)."""

    def __init__(
        self,
        num_genes: int,
        timepoints: torch.Tensor,
        variances: Optional[torch.Tensor] = None,
        jitter: float = 1e-4,
        num_replicates: int = 1,
    ):
        super().__init__()
        self.num_genes = num_genes
        self.num_replicates = num_replicates
        self.jitter = jitter
        self.register_buffer("timepoints", timepoints.to(torch.float64))
        n = num_genes * timepoints.shape[0] * num_replicates
        if variances is None:
            variances = torch.zeros(n, dtype=torch.float64)
        self.register_buffer("variances", variances.reshape(-1).to(torch.float64))

        def raw(v, size):
            t = torch.full((size,), float(v), dtype=torch.float64)
            return torch.nn.Parameter(_softplus_inv(t))

        # Reference inits B=0.05, S=1.0, D=0.4 (src/model.py:99-108).
        self.raw_basal = raw(0.05, num_genes)
        self.raw_sensitivity = raw(1.0, num_genes)
        self.raw_decay = raw(0.4, num_genes)
        # Lengthscale: sigmoid-bounded [0.5, 3.5], init 2.5.
        self.raw_lengthscale = torch.nn.Parameter(
            torch.logit(torch.tensor((2.5 - 0.5) / 3.0, dtype=torch.float64))
        )
        self.raw_obs_stddev = raw(1.0, 1)

    # -- constrained accessors ---------------------------------------------

    @property
    def basal(self):
        return torch.nn.functional.softplus(self.raw_basal)

    @property
    def sensitivity(self):
        return torch.nn.functional.softplus(self.raw_sensitivity)

    @property
    def decay(self):
        return torch.nn.functional.softplus(self.raw_decay)

    @property
    def lengthscale(self):
        return 0.5 + 3.0 * torch.sigmoid(self.raw_lengthscale)

    @property
    def obs_stddev(self):
        return torch.nn.functional.softplus(self.raw_obs_stddev)[0]

    # -- kernel math (independent rewrite of the closed forms) --------------

    def _h(self, d_a, d_b, t1, t2):
        """h(a, b, t1, t2) for time grids t1 (rows) x t2 (cols)."""
        l = self.lengthscale
        g_b = d_b * l / 2.0
        td = t2[None, :] - t1[:, None]
        mult = torch.exp(g_b * g_b) / (d_a + d_b)
        first = torch.exp(-d_b * td) * (
            torch.erf(td / l - g_b) + torch.erf(t1[:, None] / l + g_b)
        )
        second = torch.exp(-(d_b * t2[None, :] + d_a * t1[:, None])) * (
            torch.erf(t2[None, :] / l - g_b) + torch.erf(g_b)
        )
        return mult * (first - second)

    def _kxx_block(self, j, k, t1, t2):
        """(T1, T2) covariance block for gene pair (j, k)."""
        d, s = self.decay, self.sensitivity
        mult = s[j] * s[k] * self.lengthscale * SQRT_PI / 2.0
        # h(k, j, t', t) evaluated on the (t2, t1) grid, then transposed.
        return mult * (self._h(d[k], d[j], t2, t1).T + self._h(d[j], d[k], t1, t2))

    def _kxf_block(self, j, t1, t_f):
        """(T1, Tf) gene-force cross block for gene j."""
        d, s = self.decay, self.sensitivity
        l = self.lengthscale
        g_j = d[j] * l / 2.0
        td = t1[:, None] - t_f[None, :]
        return (
            0.5 * SQRT_PI * l * s[j]
            * torch.exp(g_j * g_j)
            * torch.exp(-d[j] * td)
            * (torch.erf(td / l - g_j) + torch.erf(t_f[None, :] / l + g_j))
        )

    def _kff(self, t1, t2):
        """Reference-convention RBF: exp(-(t-t')^2 / (2*l))."""
        sq = (t1[:, None] - t2[None, :]) ** 2
        return torch.exp(-sq / (2.0 * self.lengthscale))

    # -- Gram assembly (blockwise double loop, ALFI-style) -------------------

    def gram(self, add_noise_diag: bool = True) -> torch.Tensor:
        """Full (R*G*T, R*G*T) training Gram by explicit block assembly.

        Adds diag(variances) + jitter when ``add_noise_diag`` — the torch
        reference path's in-kernel behavior (model_alfi.py:295-299).
        """
        t = self.timepoints
        T = t.shape[0]
        G, R = self.num_genes, self.num_replicates
        blocks = [
            [self._kxx_block(j, k, t, t) for k in range(G)] for j in range(G)
        ]
        block = torch.cat([torch.cat(row, dim=1) for row in blocks], dim=0)
        K = block.repeat(R, R)
        if add_noise_diag:
            n = G * T * R
            K = K + torch.diag(self.variances) + self.jitter * torch.eye(
                n, dtype=K.dtype
            )
        return K

    def mean(self) -> torch.Tensor:
        """Blocked B_j / D_j mean over the training vector."""
        ratio = self.basal / self.decay
        T = self.timepoints.shape[0]
        return ratio.repeat_interleave(T).repeat(self.num_replicates)

    # -- objective & training -----------------------------------------------

    def _sigma_full(self, include_meas_var: bool) -> torch.Tensor:
        """Training Sigma = Gram [+ meas var] + jitter + obs_noise^2."""
        n = self.num_genes * self.timepoints.shape[0] * self.num_replicates
        if include_meas_var:
            base = self.gram()
        else:
            base = self.gram(add_noise_diag=False) + self.jitter * torch.eye(
                n, dtype=torch.float64
            )
        return base + (self.obs_stddev ** 2) * torch.eye(n, dtype=torch.float64)

    def mll(
        self,
        y: torch.Tensor,
        include_meas_var: bool = True,
        rows: Optional[torch.Tensor] = None,
        sigma: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """Exact MLL. With ``include_meas_var`` (default), Sigma includes the
        fixed measurement variances (in-kernel) + jitter + obs_noise^2 — the
        torch reference convention (model_alfi.py:295-299). With False the
        Sigma convention matches the GPJax side's MLL (jitter + obs_noise^2
        only, reference src/objectives.py:70-73) — the like-for-like setting
        for cross-framework MLL deltas at fixed parameters.

        ``rows`` restricts the objective to a row subset (the marginal of
        the same MVN) — the train-rows objective under a validation/test
        split (:func:`split_indices`).

        ``sigma`` optionally reuses a prebuilt full training Sigma (from
        :meth:`_sigma_full`) — the blockwise Gram assembly dominates this
        module's cost, and the split training loop evaluates the train and
        held-out densities at the same parameters."""
        y = y.reshape(-1)
        if sigma is None:
            sigma = self._sigma_full(include_meas_var)
        mu = self.mean()
        if rows is not None:
            y, mu = y[rows], mu[rows]
            sigma = sigma[rows][:, rows]
        n = y.shape[0]
        L = torch.linalg.cholesky(sigma)
        alpha = torch.cholesky_solve((y - mu).unsqueeze(-1), L).squeeze(-1)
        return (
            -0.5 * torch.dot(y - mu, alpha)
            - torch.log(torch.diagonal(L)).sum()
            - 0.5 * n * math.log(2 * math.pi)
        )

    @torch.no_grad()
    def heldout_logpdf(
        self,
        y: torch.Tensor,
        train_rows: torch.Tensor,
        heldout_rows: torch.Tensor,
        include_meas_var: bool = True,
        sigma: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """Conditional log-density of held-out observations given the train
        rows, under the same joint MVN as :meth:`mll`.

        Satisfies the exact MVN chain rule
        ``mll(all rows) = mll(rows=train) + heldout_logpdf(heldout | train)``
        (tested), so the valid/test numbers are directly comparable to
        training MLLs.  This is the live consumer the reference's split
        scaffolding never had (its valid/test loaders are built at
        ``trainer_alfi.py:86-99`` but nothing evaluates on them).
        """
        y = y.reshape(-1)
        if sigma is None:
            sigma = self._sigma_full(include_meas_var)
        mu = self.mean()
        s_tt = sigma[train_rows][:, train_rows]
        s_ht = sigma[heldout_rows][:, train_rows]
        s_hh = sigma[heldout_rows][:, heldout_rows]
        L = torch.linalg.cholesky(s_tt)
        solved = torch.cholesky_solve(s_ht.T, L)  # s_tt^{-1} s_th
        resid = (y[train_rows] - mu[train_rows]).unsqueeze(-1)
        mean_c = mu[heldout_rows] + (solved.T @ resid).squeeze(-1)
        cov_c = s_hh - s_ht @ solved
        Lc = torch.linalg.cholesky(cov_c)
        alpha = torch.cholesky_solve(
            (y[heldout_rows] - mean_c).unsqueeze(-1), Lc
        ).squeeze(-1)
        m = heldout_rows.shape[0]
        return (
            -0.5 * torch.dot(y[heldout_rows] - mean_c, alpha)
            - torch.log(torch.diagonal(Lc)).sum()
            - 0.5 * m * math.log(2 * math.pi)
        )

    def fit(
        self,
        y: torch.Tensor,
        epochs: int = 150,
        lr: float = 0.01,
        fix_params: bool = True,
        clamp_gene: int = 3,
        track_parameters: bool = False,
        valid_size: float = 0.0,
        test_size: float = 0.0,
        split_seed: int = 0,
    ):
        """Eager Adam loop with the per-epoch p21 clamp (applied to the raw
        parameters under no_grad, reference trainer_alfi.py:192-199).

        With ``track_parameters`` the constrained kinetics are recorded each
        epoch into ``self.param_trace`` (list of dicts of numpy arrays) —
        the reference torch trainer's by-name parameter tracing
        (trainer_alfi.py:79-84,186-190), consumed by
        ``validation.torch_report.plot_comparison_torch`` and
        ``plot_param_trace_torch``.

        ``valid_size`` / ``test_size`` enable the reference trainer's
        dataset-split scaffolding (``trainer_alfi.py:68-99``) at observation-
        row granularity: the objective becomes the train-row marginal MLL and
        ``self.valid_history`` records the per-epoch held-out log-density of
        the validation rows (:meth:`heldout_logpdf`); the split lives in
        ``self.train_rows`` / ``self.valid_rows`` / ``self.test_rows``.
        Defaults (0, 0) train on every row — bit-identical to the unsplit
        loop, like the reference's default loaders."""
        n = self.num_genes * self.timepoints.shape[0] * self.num_replicates
        self.train_rows, self.valid_rows, self.test_rows = split_indices(
            n, valid_size, test_size, seed=split_seed
        )
        rows = None if valid_size == 0.0 and test_size == 0.0 else self.train_rows
        opt = torch.optim.Adam(self.parameters(), lr=lr)
        history = []
        self.valid_history = []
        self.param_trace = [] if track_parameters else None
        for _ in range(epochs):
            opt.zero_grad()
            if rows is None:
                loss = -self.mll(y)
            else:
                # ONE Gram build per epoch, shared by the train objective
                # and the held-out density — both evaluated at the params
                # ENTERING the epoch, so history[e] and valid_history[e]
                # describe the same parameter vector.
                sigma = self._sigma_full(True)
                loss = -self.mll(y, rows=rows, sigma=sigma)
                if len(self.valid_rows):
                    self.valid_history.append(
                        float(self.heldout_logpdf(
                            y, self.train_rows, self.valid_rows,
                            sigma=sigma.detach(),
                        ))
                    )
            loss.backward()
            opt.step()
            if fix_params:
                with torch.no_grad():
                    one = torch.tensor(1.0, dtype=torch.float64)
                    d08 = torch.tensor(0.8, dtype=torch.float64)
                    self.raw_sensitivity[clamp_gene] = _softplus_inv(one)
                    self.raw_decay[clamp_gene] = _softplus_inv(d08)
            history.append(float(loss.detach()))
            if track_parameters:
                with torch.no_grad():
                    self.param_trace.append(
                        {
                            "basal": self.basal.numpy().copy(),
                            "sensitivity": self.sensitivity.numpy().copy(),
                            "decay": self.decay.numpy().copy(),
                            "lengthscale": float(self.lengthscale),
                        }
                    )
        return history

    # -- posteriors ----------------------------------------------------------

    @torch.no_grad()
    def predict_f(self, t_test: torch.Tensor) -> tuple:
        """Latent-force posterior (mean, var) at test times."""
        t_test = t_test.to(torch.float64)
        t = self.timepoints
        G, R = self.num_genes, self.num_replicates
        Kxx = self.gram()  # includes variances + jitter
        Kxf = torch.cat(
            [self._kxf_block(j, t, t_test) for j in range(G)], dim=0
        ).repeat(R, 1)
        y_res = self._y_residual
        L = torch.linalg.cholesky(Kxx)
        solved = torch.cholesky_solve(Kxf, L)  # (N, Tf)
        mean = solved.T @ y_res
        Kff = self._kff(t_test, t_test)
        var = torch.diagonal(Kff - solved.T @ Kxf)
        return mean, torch.clamp(var, min=0.0)

    def set_train_targets(self, y: torch.Tensor):
        self._y = y.reshape(-1).to(torch.float64)

    @property
    def _y_residual(self):
        return self._y - self.mean()

    @torch.no_grad()
    def predict_m(self, t_test: torch.Tensor) -> tuple:
        """Gene-expression posterior (means, vars) per gene at test times."""
        t_test = t_test.to(torch.float64)
        t = self.timepoints
        G, R = self.num_genes, self.num_replicates
        n = G * t.shape[0] * R
        sigma = self.gram() + (self.obs_stddev ** 2) * torch.eye(
            n, dtype=torch.float64
        )
        # Kxt: rows = train gene blocks j (replicated), cols = test gene
        # blocks k — assembled blockwise like the training Gram.
        Kxt = torch.cat(
            [
                torch.cat([self._kxx_block(j, k, t, t_test) for k in range(G)], dim=1)
                for j in range(G)
            ],
            dim=0,
        ).repeat(R, 1)
        L = torch.linalg.cholesky(sigma)
        solved = torch.cholesky_solve(Kxt, L)
        mean = self._test_mean(t_test) + solved.T @ self._y_residual
        # Only the diagonal of the test covariance is returned: the G
        # diagonal (j == j) blocks' diagonals suffice, and the correction
        # diagonal is an elementwise sum — no (G*T_test)^2 temporaries or
        # G^2 kernel-block evaluations (r2 review).
        ktt_diag = torch.cat(
            [
                torch.diagonal(self._kxx_block(j, j, t_test, t_test))
                for j in range(G)
            ]
        )
        var = ktt_diag - torch.sum(Kxt * solved, dim=0)
        T_test = t_test.shape[0]
        return (
            mean.reshape(G, T_test),
            torch.clamp(var, min=0.0).reshape(G, T_test),
        )

    def _test_mean(self, t_test):
        ratio = self.basal / self.decay
        return ratio.repeat_interleave(t_test.shape[0])
