"""The blocking of the redesigned K5 and K6 held to the JAX package on the CPU.

K5 (``csrc/chol_block.cu::chol_cluster_kernel``) and the diagonal routine of
K6 and K7, which is also K4's body (``csrc/chol_block.cuh::chol_inv_block_fast``),
run only on the card, where
``chip_smoke.py`` holds them to their plain versions. Here plain PyTorch
mirrors of their blocking (``ops/cuda_cholesky.py``: the 32-wide panel order,
the TRSM each kernel uses, the block-wise inverse assembly) are held to the
Pallas kernels in interpret mode, as ``tests/test_pallas.py`` runs them (at
its tolerances), and to the f64 factor of real SIMM Σ blocks.

On the CPU, LAPACK's recursive f32 factorisation is 2-4x more accurate on
128-wide real-Σ blocks than any 32-blocked right-looking order (measured with
the 32 x 32 pieces factored in f64 too); on the card the same arithmetic sat
at 0.59x cuSOLVER's error (PERF.md). The limits below say which reference
each holds to.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dis_project_tpu.ops import pallas_cholesky as pc
from dis_project_tpu_torch.ops import cuda_cholesky as cc
from dis_project_tpu_torch.ops import cuda_cholesky_fused as cf

from test_torch_port_blocked import _real_sigma, _spd


def _t(a):
    return torch.as_tensor(np.array(a))


def _f64_error(L, A):
    """max |L - chol(A)| against the f64 factor of the f32 block A."""
    truth = np.linalg.cholesky(A.astype(np.float64))
    return np.abs(np.asarray(L, np.float64) - truth).max()


def _cholesky_ex_error(A):
    return _f64_error(torch.linalg.cholesky_ex(_t(A))[0].numpy(), A)


@pytest.mark.parametrize("B", [96, 100])
def test_k5_mirror_matches_pallas(B):
    """B=96 and a ragged B=100 (identity-padded to 128 in the kernel): L Lᵀ
    vs A and L vs the Pallas kernel at rtol 2e-5 / atol 2e-4
    (tests/test_pallas.py's bounds), a zero upper triangle."""
    A = _spd(B, seed=B).astype(np.float32)
    ref = np.asarray(pc.chol_unblocked(jnp.asarray(A), interpret=True))
    L = cc._chol_cluster_mirror(_t(A))
    assert L.shape == (B, B) and L.dtype == torch.float32
    np.testing.assert_allclose((L @ L.T).numpy(), A, rtol=2e-5, atol=2e-4)
    assert float(torch.triu(L, 1).abs().max()) == 0.0
    np.testing.assert_allclose(L.numpy(), ref, rtol=2e-5, atol=2e-4)


def test_k6_routine_mirror_matches_pallas():
    """The diagonal routine of K6 and K7, and since it became K4's body
    also K4's blocking (``chol_inv_block_fast``), at B=128: L at 1e-4 and
    Li at 5e-5 against the Pallas kernel, and the mirror's own Li·L - I at
    5e-5 (tests/test_pallas.py's bounds)."""
    A = _spd(128, seed=10).astype(np.float32)
    L, Li = (t.numpy() for t in cc._chol_inv_fast_mirror(_t(A)))
    L_ref, Li_ref = (np.asarray(t) for t in pc.chol_inv_unblocked(jnp.asarray(A), interpret=True))
    np.testing.assert_allclose(L, L_ref, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(Li, Li_ref, rtol=5e-5, atol=5e-5)
    np.testing.assert_allclose(Li @ L, np.eye(128), atol=5e-5)
    assert np.all(np.triu(L, 1) == 0) and np.all(np.triu(Li, 1) == 0)


@pytest.mark.parametrize("seed", [0, 1])
def test_k5_mirror_on_real_sigma_block(seed):
    """A real Σ block, B=512 (cond ~6e3): the mirror's error from the f64
    factor at most 2x that of torch's float32 ``cholesky_ex`` (measured
    0.68-0.86x), the limit chip_smoke.py applies on the card."""
    A = _real_sigma(2048, seed=seed)[512:1024, 512:1024].astype(np.float32)
    err = _f64_error(cc._chol_cluster_mirror(_t(A)).numpy(), A)
    assert err <= 2 * _cholesky_ex_error(A)


@pytest.mark.parametrize("B", [128, 256])
def test_k6_routine_mirror_on_real_sigma_block(B):
    """The routine of K6, K7 and K4 (``chol_inv_block_fast``) on real Σ
    blocks: Li·L - I at most 2x the plain version's
    (``cholesky_ex`` + ``tri_inv``; measured 0.75-1.4x), and L from the f64
    factor at most 5x ``cholesky_ex``'s (measured 1.3-4.5x: LAPACK's
    recursive order, see the module note)."""
    A = _real_sigma(2048, seed=3)[1024:1024 + B, 1024:1024 + B].astype(np.float32)
    L, Li = (t.double().numpy() for t in cc._chol_inv_fast_mirror(_t(A)))
    Lp, Lip = (t.double().numpy() for t in cc.chol_inv_unblocked_plain(_t(A)))
    eye = np.eye(B)
    assert np.abs(Li @ L - eye).max() <= 2 * np.abs(Lip @ Lp - eye).max()
    assert _f64_error(L, A) <= 5 * _cholesky_ex_error(A)
    assert np.all(np.triu(L, 1) == 0) and np.all(np.triu(Li, 1) == 0)


def test_fused_mirror_on_real_sigma():
    """K6's tile algorithm with the new diagonal routine at n=1024, B=128 on
    a real Σ (cond ~1e4): finite, its error from the f64 factor at most 2x
    ``cholesky_ex``'s (measured 1.3x), and its reconstruction at most 2x
    that of the plain version (K6 with the old routine)."""
    A = _real_sigma(1024).astype(np.float32)
    L = cf._fused_cholesky_mirror(_t(A), 128)
    assert torch.isfinite(L).all() and torch.equal(L, torch.tril(L))
    assert _f64_error(L.numpy(), A) <= 2 * _cholesky_ex_error(A)
    A64 = A.astype(np.float64)

    def recon(F):
        F = F.double().numpy()
        return np.abs(F @ F.T - A64).max()

    assert recon(L) <= 2 * recon(cf.fused_cholesky_plain(_t(A), 128))


@pytest.mark.parametrize("which", ["k5", "k6"])
def test_mirrors_non_pd_give_nan(which):
    """A negative pivot in the second 32-row block: NaN from there on, the
    rows before it finite, no exception."""
    A = _spd(128, seed=2).astype(np.float32)
    A[40, 40] = -1.0
    L = cc._chol_cluster_mirror(_t(A)) if which == "k5" else cc._chol_inv_fast_mirror(_t(A))[0]
    assert torch.isnan(L[40:]).any()
    assert torch.isfinite(L[:32]).all()


def test_k5_cluster_size_rule():
    """One CTA per 32-row block, 1 to 8: no CTA holds more than two row
    blocks of the padded block, and none holds none, at every B the kernel
    takes."""
    assert [cc.k5_cluster_size(B) for B in (1, 32, 64, 65, 96, 100, 128, 256, 511, 512)] == [
        1, 1, 2, 3, 3, 4, 4, 8, 8, 8]
    for B in range(1, 513):
        C = cc.k5_cluster_size(B)
        row_blocks = -(-B // 32)
        assert 1 <= C <= min(8, row_blocks) and -(-row_blocks // C) <= 2


def test_chol_unblocked_kernel_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA tensors"):
        cc.chol_unblocked_kernel(torch.eye(96))
