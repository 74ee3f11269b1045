"""The reference's complex erf against scipy, and its derivative."""

import numpy as np
import pytest
import torch
from scipy import special

from lfmbench.reference.erf import erf


def _grid():
    re = np.linspace(-8.0, 8.0, 81)
    im = np.linspace(-4.0, 4.0, 41)
    return (re[:, None] + 1j * im[None, :]).ravel()


@pytest.mark.parametrize("dtype, tol", [(torch.complex128, 1e-12), (torch.complex64, 1e-5)])
def test_erf_against_scipy(dtype, tol):
    z = _grid()
    want = special.erf(z)
    got = erf(torch.as_tensor(z, dtype=dtype)).numpy().astype(np.complex128)
    err = np.abs(got - want) / np.maximum(1.0, np.abs(want))
    assert err.max() <= tol


def test_erf_on_the_simm2_domain():
    # arguments of the order-2 tables: (t - t')/l - gamma, t/l + gamma, gamma
    # with gamma = (alpha -+ i omega) l / 2, alpha, omega <= 2.2, l <= 3.5
    rng = np.random.default_rng(0)
    z = rng.uniform(-26, 26, 4000) + 1j * rng.uniform(-4, 4, 4000)
    got = erf(torch.as_tensor(z)).numpy()
    want = special.erf(z)
    assert (np.abs(got - want) / np.maximum(1.0, np.abs(want))).max() <= 1e-12


def test_erf_gradient():
    z0 = torch.tensor([0.3 + 0.7j, -1.2 + 0.1j, 2.0 - 1.5j], dtype=torch.complex128)
    w = torch.tensor([0.5 - 0.2j, 1.0 + 0.3j, -0.4 + 0.9j], dtype=torch.complex128)
    z = z0.clone().requires_grad_(True)
    (erf(z) * w).real.sum().backward()
    h = 1e-6
    for i in range(3):
        for step in (h, 1j * h):
            dz = torch.zeros(3, dtype=torch.complex128)
            dz[i] = step
            fd = ((erf(z0 + dz) - erf(z0 - dz)) * w).real.sum() / (2 * h)
            # d/dx of Re(w erf) is Re(grad); d/dy is Im(grad) (conjugate-Wirtinger cotangent)
            want = z.grad[i].real if step == h else z.grad[i].imag
            assert float(fd) == pytest.approx(float(want), rel=1e-7, abs=1e-9)
