r"""erf of a complex argument for the second-order reference, in plain torch.

PyTorch's ``torch.erf`` takes real input only. This is Weideman's (1994,
SIAM J. Numer. Anal. 31:1497) rational approximation of the Faddeeva
function :math:`w(z) = e^{-z^2}\mathrm{erfc}(-iz)` on the upper half-plane,
a polynomial of degree N-1 in :math:`Z = (L + iz)/(L - iz)`, evaluated by
Horner's rule, with

.. math:: \mathrm{erf}(z) = 1 - e^{-z^2} w(iz) \quad (\mathrm{Re}\,z \ge 0),
          \qquad \mathrm{erf}(-z) = -\mathrm{erf}(z).

64 terms give ~1e-13 relative on the arguments the SIMM closed forms take;
40 terms are kept for complex64, the control's lower precision. The
derivative is the analytic :math:`\tfrac{2}{\sqrt\pi} e^{-z^2}`, handed back
as PyTorch's conjugate-Wirtinger cotangent.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

TERMS = {torch.complex128: 64, torch.complex64: 40}


@functools.lru_cache(maxsize=None)
def _coefficients(n_terms: int):
    """Weideman's coefficients, highest power first, and his scale L."""
    m = 2 * n_terms
    scale = math.sqrt(n_terms / math.sqrt(2.0))
    k = np.arange(-m + 1, m)
    t = scale * np.tan(k * np.pi / (2 * m))
    f = np.concatenate([[0.0], np.exp(-t * t) * (scale * scale + t * t)])
    a = np.real(np.fft.fft(np.fft.fftshift(f))) / (2 * m)
    return tuple(np.flipud(a[1:n_terms + 1]).tolist()), scale


def _w_upper(z, n_terms: int):
    coeffs, scale = _coefficients(n_terms)
    iz = 1j * z
    den = scale - iz
    zm = (scale + iz) / den
    p = torch.zeros_like(z)
    for c in coeffs:
        p = p * zm + c
    return 2.0 * p / (den * den) + (1.0 / math.sqrt(math.pi)) / den


def _erf(z, n_terms: int):
    right = z.real >= 0
    zr = torch.where(right, z, -z)
    val = 1.0 - torch.exp(-zr * zr) * _w_upper(1j * zr, n_terms)
    return torch.where(right, val, -val)


class _Erf(torch.autograd.Function):
    @staticmethod
    def forward(ctx, z):
        ctx.save_for_backward(z)
        with torch.no_grad():
            return _erf(z, TERMS[z.dtype])

    @staticmethod
    def backward(ctx, grad):
        (z,) = ctx.saved_tensors
        return grad * ((2.0 / math.sqrt(math.pi)) * torch.exp(-z * z)).conj()


def erf(z):
    """erf(z) for a complex64 or complex128 tensor."""
    return _Erf.apply(z)
