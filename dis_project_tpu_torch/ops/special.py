r"""Complex-argument special functions: Faddeeva w(z) and erf(z).

Port of ``dis_project_tpu/ops/special.py``. The second-order (spring-damper)
kernels (``ops.lfm_kernels2``) evaluate the first-order closed forms at
complex decay rates, so their erf terms take complex arguments; PyTorch has
no complex erf (``torch.erf`` is real only). It is built from the Faddeeva
function

.. math:: w(z) = e^{-z^2} \mathrm{erfc}(-iz)

by Weideman's (1994, SIAM Rev. 36) rational approximation: a polynomial of
degree N-1 in the Möbius variable Z = (L+iz)/(L-iz), whose coefficients come
from one FFT of ``exp(-t^2)(L^2+t^2)``, computed once with NumPy
(:func:`_weideman_coeffs`). 64 terms give ~1e-13 over the upper half-plane.

Evaluation order (a departure from the JAX package's ``jnp.polyval``, which
is one fused XLA op): eager PyTorch would spend two launches a term on a
Horner loop, so :func:`_polyval` takes the powers Z^0..Z^7 in one
``cumprod``, the 8-term blocks of the polynomial in one product with an
(8, N/8) coefficient matrix, and the blocks against the powers of Z^8 in a
second ``cumprod`` and a sum: a handful of launches whatever N, at most 8
times the input's size in temporaries. |Z| <= 1 on the upper half-plane and
the coefficients fall from ~3.7 to ~1e-16, so the reordering moves the sum
by rounding only.

Domain handling: Weideman's form converges for Im(z) >= 0; the lower
half-plane uses ``w(-z) = 2 exp(-z^2) - w(z)``. ``erf`` uses
``erf(z) = 1 - exp(-z^2) w(iz)`` for Re(z) >= 0 and oddness otherwise (there
``iz`` lies in the upper half-plane, so :func:`erf_complex` calls the
upper-half-plane form directly).

Derivative: :func:`erf_complex` is a ``torch.autograd.Function``. Its
forward runs the whole evaluation without a graph (nothing of the
polynomial is kept for the backward, and the unselected branches of the
reflections, which may overflow, never meet autograd); its backward is the
analytic derivative ``erf'(z) = 2/sqrt(pi) exp(-z^2)``. PyTorch hands a
complex function's backward the conjugate-Wirtinger cotangent, so for the
holomorphic erf it returns ``grad * conj(erf'(z))``.

Overflow note: ``exp(-z^2)`` grows like ``exp(Im(z)^2)``; callers that
multiply ``exp(gamma^2)`` by erf differences (the h-term) should keep
``|Im(gamma)| = w l / 2`` moderate (see ``ops.lfm_kernels2``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

SQRT_PI = 1.7724538509055159

# Terms of the Weideman polynomial by input type. complex64 (the float32
# path) uses 40: the JAX package measured a max abs error of 8.6e-6 against
# the 64-term oracle over the order-2 kernels' working domain (|Re| <= 26,
# |Im| <= 5), where 32 terms reach 2.5e-3 at Im = 5.
_N_TERMS_BY_DTYPE = {torch.complex64: 40, torch.complex128: 64}

_BLOCK = 8  # polynomial terms per block of _polyval


@functools.lru_cache(maxsize=None)
def _weideman_coeffs(n_terms: int):
    """Polynomial coefficients a_1..a_N (highest power first, as
    ``np.polyval`` takes them) and the scale L, float64."""
    N = n_terms
    M = 2 * N
    M2 = 2 * M
    L = np.sqrt(N / np.sqrt(2.0))
    k = np.arange(-M + 1, M)
    theta = k * np.pi / M
    t = L * np.tan(theta / 2.0)
    f = np.exp(-t * t) * (L * L + t * t)
    f = np.concatenate([[0.0], f])
    a = np.real(np.fft.fft(np.fft.fftshift(f))) / M2
    a = np.flipud(a[1 : N + 1])
    return a, float(L)


@functools.lru_cache(maxsize=None)
def _block_coeffs(n_terms: int, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """(8, nb) matrix C with C[k, j] the coefficient of Z^(8j + k), the
    polynomial padded with zero coefficients to a multiple of 8 terms; one
    tensor per type and device, copied there once."""
    a, _ = _weideman_coeffs(n_terms)
    c = a[::-1]  # c[k]: coefficient of Z^k
    nb = -(-n_terms // _BLOCK)
    c = np.concatenate([c, np.zeros(nb * _BLOCK - n_terms)])
    return torch.as_tensor(np.ascontiguousarray(c.reshape(nb, _BLOCK).T), dtype=dtype,
                           device=device)


def _powers(x, n: int):
    """x^0 .. x^(n-1) along a new last axis (one ``cumprod``)."""
    ones = torch.ones_like(x)[..., None]
    if n == 1:
        return ones
    return torch.cat([ones, torch.cumprod(x[..., None].expand(*x.shape, n - 1), dim=-1)], -1)


def _polyval(z_mob, n_terms: int):
    """The Weideman polynomial at ``z_mob`` in blocks of 8 terms (module
    doc): sum_j (sum_k C[k, j] Z^k) (Z^8)^j."""
    coeffs = _block_coeffs(n_terms, z_mob.dtype, z_mob.device)
    zk = _powers(z_mob, _BLOCK + 1)  # Z^0 .. Z^8
    blocks = zk[..., :_BLOCK] @ coeffs  # (..., nb)
    return torch.sum(blocks * _powers(zk[..., _BLOCK], coeffs.shape[1]), dim=-1)


def _w_upper(z, n_terms: int):
    """Weideman's rational approximation of w(z), valid for Im(z) >= 0."""
    _, L = _weideman_coeffs(n_terms)
    iz = 1j * z
    den = L - iz
    p = _polyval((L + iz) / den, n_terms)
    return 2.0 * p / (den * den) + (1.0 / SQRT_PI) / den


def _as_complex(z):
    z = torch.as_tensor(z)
    if not z.is_complex():
        z = z.to(torch.complex128 if z.dtype == torch.float64 else torch.complex64)
    return z


def _terms(z, n_terms):
    return n_terms or _N_TERMS_BY_DTYPE.get(z.dtype, 64)


def faddeeva(z, n_terms: int = 64):
    """w(z) = exp(-z^2) erfc(-iz) for complex z (any half-plane)."""
    z = _as_complex(z)
    upper = z.imag >= 0
    zu = torch.where(upper, z, -z)  # reflected into the upper half-plane
    wu = _w_upper(zu, n_terms)
    # w(-z) = 2 exp(-z^2) - w(z)  =>  for Im(z) < 0: w(z) = 2 e^{-z^2} - w(-z)
    return torch.where(upper, wu, 2.0 * torch.exp(-z * z) - wu)


def _erf_value(z, n_terms: int):
    right = z.real >= 0
    zr = torch.where(right, z, -z)  # reflected into Re >= 0
    # Im(i zr) = Re(zr) >= 0: faddeeva's upper-half-plane branch.
    val = 1.0 - torch.exp(-zr * zr) * _w_upper(1j * zr, n_terms)
    return torch.where(right, val, -val)


class _ErfComplex(torch.autograd.Function):
    @staticmethod
    def forward(ctx, z, n_terms):
        ctx.save_for_backward(z)
        with torch.no_grad():
            return _erf_value(z, n_terms)

    @staticmethod
    def backward(ctx, grad):
        (z,) = ctx.saved_tensors
        deriv = (2.0 / SQRT_PI) * torch.exp(-z * z)
        return grad * deriv.conj(), None


def erf_complex(z, n_terms: int | None = None):
    """erf(z) for complex z: ``1 - exp(-z^2) w(iz)``, odd-reflected. A real
    input is taken as complex (complex128 from float64, else complex64).
    ``n_terms=None`` takes the count of ``_N_TERMS_BY_DTYPE`` (64 for
    complex128, 40 for complex64). Differentiable through the analytic
    derivative at any term count."""
    z = _as_complex(z)
    return _ErfComplex.apply(z, _terms(z, n_terms))


def erfc_complex(z, n_terms: int | None = None):
    """erfc(z) = 1 - erf(z)."""
    return 1.0 - erf_complex(z, n_terms)
