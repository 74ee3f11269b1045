"""Lower-triangle SYRK kernel K3 and the Σ⁻¹-from-factor route of the MLL
backward, with their plain PyTorch versions.

Port of the SYRK part of ``dis_project_tpu/ops/pallas_cholesky.py``:

- :func:`syrk_ltl_tril` — K3, ``csrc/syrk.cu::syrk_ltl_tril_kernel``,
  replacing ``pallas_cholesky.py::_syrk_kernel``: ``tril(Liᵀ Li)`` for a
  lower-triangular float32 ``Li``, over the lower output tiles only.
- :func:`_tril_t_tril` — the plain recursive ``Liᵀ Li`` that skips
  structural zeros (the JAX package's off-TPU route, and K3's plain version).
- :func:`inv_from_factor_tril` — ``tril(Σ⁻¹)`` from the Cholesky factor.

The triangular inverse stays ``torch.linalg.solve_triangular`` (the JAX
package's blocked triangular inverse and factoriser are not ported yet).

Dispatch: on a CUDA tensor :func:`syrk_ltl_tril` launches K3 (float32 only)
or raises; on a CPU tensor it takes the plain version. Each launch adds one
to ``LAUNCHES``.
"""

from __future__ import annotations

import ctypes

import torch

from dis_project_tpu_torch.ops import cuda_build
from dis_project_tpu_torch.ops.cuda_gram import plain_vjp

LAUNCHES = {"syrk_ltl_tril": 0}

SIGNATURES = {
    "syrk_ltl_tril_f32": [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p],
}

# float32 factors above this size take K3 on the card (the JAX package's
# inv_from_factor_tril threshold: below it the plain product is cheap).
SYRK_MIN_N = 2048


def _tril_t_tril(Li, base: int = 1024):
    """``Li.T @ Li`` for lower-triangular ``Li``, skipping structural zeros.

    With Li = [[A, 0], [B, C]]: Liᵀ Li = [[AᵀA + BᵀB, BᵀC], [(BᵀC)ᵀ, CᵀC]];
    recursing on A and C does ~0.7 n³ FLOPs instead of 2 n³. Exactly
    symmetric by construction.
    """
    n = Li.shape[0]
    if n <= base or n % 2:
        return Li.T @ Li
    h = n // 2
    A = Li[:h, :h]
    B = Li[h:, :h]
    C = Li[h:, h:]
    TL = _tril_t_tril(A, base=base) + B.T @ B
    TR = B.T @ C
    BR = _tril_t_tril(C, base=base)
    top = torch.cat([TL, TR], dim=1)
    bot = torch.cat([TR.T, BR], dim=1)
    return torch.cat([top, bot], dim=0)


def syrk_ltl_tril_plain(Li):
    """Plain version of K3."""
    return torch.tril(_tril_t_tril(Li))


def syrk_ltl_tril_kernel(Li):
    """Launch K3 on a CUDA float32 lower-triangular ``Li``."""
    if not Li.is_cuda:
        raise ValueError(f"syrk_ltl_tril kernel runs on CUDA tensors, not {Li.device}")
    if Li.dtype != torch.float32:
        raise TypeError(f"syrk_ltl_tril kernel takes float32, not {Li.dtype}")
    if Li.dim() != 2 or Li.shape[0] != Li.shape[1]:
        raise ValueError(f"Li must be square, got {tuple(Li.shape)}")
    if not Li.is_contiguous():
        raise ValueError("Li must be contiguous (row-major)")
    n = Li.shape[0]
    out = torch.zeros((n, n), dtype=Li.dtype, device=Li.device)  # upper tiles stay 0
    lib = cuda_build.load("syrk", SIGNATURES)
    with torch.cuda.device(Li.device):
        code = lib.syrk_ltl_tril_f32(
            Li.data_ptr(), n, out.data_ptr(), cuda_build.stream_handle(Li.device)
        )
    LAUNCHES["syrk_ltl_tril"] += 1
    cuda_build.check(code, "syrk_ltl_tril")
    return out


class _SyrkLtlTril(torch.autograd.Function):
    @staticmethod
    def forward(ctx, Li):
        ctx.save_for_backward(Li)
        if Li.is_cuda:
            return syrk_ltl_tril_kernel(Li)
        return syrk_ltl_tril_plain(Li)

    @staticmethod
    def backward(ctx, g):
        return plain_vjp(syrk_ltl_tril_plain, ctx.saved_tensors, ctx.needs_input_grad, g)


def syrk_ltl_tril(Li):
    """``tril(Liᵀ Li)`` (diagonal included) for lower-triangular ``Li``:
    K3 on CUDA, plain on CPU."""
    return _SyrkLtlTril.apply(Li)


def syrk_ltl(Li):
    """``Liᵀ Li`` (dense symmetric) via :func:`syrk_ltl_tril` + mirror."""
    lower = syrk_ltl_tril(Li)
    return lower + torch.tril(lower, -1).T


def tri_inv(L):
    """``L⁻¹`` for lower-triangular ``L``, row-major (cuBLAS returns the
    solve column-major; K3 reads rows)."""
    eye = torch.eye(L.shape[0], dtype=L.dtype, device=L.device)
    return torch.linalg.solve_triangular(L, eye, upper=False).contiguous()


def inv_from_factor_tril(L, kernels: bool = True):
    """``tril(Σ⁻¹)`` (diagonal included) from the Cholesky factor ``L``.

    A float32 factor above ``SYRK_MIN_N`` takes :func:`syrk_ltl_tril` (K3
    on the card) when ``kernels`` is set; everything else the plain
    recursive product — the JAX package's dispatch, with the card in place
    of the TPU.
    """
    Li = tri_inv(L)
    if kernels and L.dtype == torch.float32 and L.shape[0] > SYRK_MIN_N:
        return syrk_ltl_tril(Li)
    return syrk_ltl_tril_plain(Li)
