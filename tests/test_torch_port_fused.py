"""The port's fused whole-matrix Cholesky (K6, K7) held to the JAX package
on the CPU.

``dis_project_tpu_torch.ops.cuda_cholesky_fused`` against
``dis_project_tpu.ops.pallas_cholesky_fused``, whose kernels run in
interpret mode as ``tests/test_pallas.py`` runs them. On a CPU tensor the
port's ``fused_cholesky`` and ``fused_cholesky2`` take their plain version
(the same tile factorisation in PyTorch); the CUDA kernels are held to it on
the card by ``chip_smoke.py``.

The port departs from the reference on purpose: the JAX kernels stage
their correction products in bf16 and return NaN on a real SIMM Σ, the
port's products are FP32. The tests pin both sides of that.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dis_project_tpu.ops import pallas_cholesky as pc
from dis_project_tpu.ops import pallas_cholesky_fused as pcf
from dis_project_tpu_torch.ops import cuda_cholesky as cc
from dis_project_tpu_torch.ops import cuda_cholesky_fused as cf

from test_torch_port_blocked import _real_sigma, _spd

# (port entry point, JAX entry point, JAX keyword arguments), as
# tests/test_pallas.py::test_fused_cholesky_interpret calls them.
KERNELS = {
    "K6": (cf.fused_cholesky, pcf.fused_cholesky, {}),
    "K7": (cf.fused_cholesky2, pcf.fused_cholesky2, {"chunk": 2}),
}


def _jax(which, A, block=256):
    _, fn, kw = KERNELS[which]
    return np.asarray(fn(jnp.asarray(A), block=block, interpret=True, **kw))


def _port(which, A, **kw):
    return KERNELS[which][0](torch.as_tensor(A), **kw)


@pytest.mark.parametrize("which", sorted(KERNELS))
@pytest.mark.parametrize("n", [768, 1024, 1300])
def test_fused_matches_jax_on_spd(n, which):
    """``M Mᵀ + n I`` in float32 at block 256 (768 and 1300 pad): the port
    against the JAX kernel at test_pallas.py's bound (rtol 2e-3, atol 6e-3,
    what bf16 staging costs the reference), and against the f64 factor at
    1e-6 of its largest entry (measured 1.4e-7; torch's f32 cholesky sits
    ~2e-7 from it), with an exactly zero strict upper triangle."""
    A = _spd(n, seed=n).astype(np.float32)
    truth = np.linalg.cholesky(A.astype(np.float64))
    L = _port(which, A, block=256)
    assert L.shape == (n, n) and L.dtype == torch.float32
    got = L.numpy()
    np.testing.assert_allclose(got, _jax(which, A), rtol=2e-3, atol=6e-3)
    assert np.abs(got - truth).max() <= 1e-6 * np.abs(truth).max()
    assert np.all(np.triu(got, 1) == 0)


@pytest.mark.parametrize("which", sorted(KERNELS))
@pytest.mark.parametrize("n", [768, 1024])
def test_fused_finite_on_real_sigma_where_jax_is_nan(n, which):
    """A real SIMM Σ (cond ~1e4): the JAX kernels' bf16 products give NaN;
    the port's factor is finite, at block 128 and 256, and within 3x the
    error of torch's float32 ``cholesky_ex`` against the f64 factor
    (measured at most 1.3x at block 128 and 2.4x at block 256: the product
    with the diagonal inverse costs accuracy that grows with the block)."""
    A = _real_sigma(n).astype(np.float32)
    truth = np.linalg.cholesky(A.astype(np.float64))
    assert np.isnan(_jax(which, A)).any()
    ref = torch.linalg.cholesky_ex(torch.as_tensor(A))[0].double().numpy()
    ref_err = np.abs(ref - truth).max()
    for block in (128, 256):
        L = _port(which, A, block=block).double().numpy()
        assert np.isfinite(L).all()
        assert np.abs(L - truth).max() <= 3 * ref_err, block


@pytest.mark.parametrize("which", sorted(KERNELS))
def test_small_n_takes_blocked_cholesky(which):
    """n <= block: the port returns its blocked_cholesky's factor, as the JAX
    functions return theirs, and the two agree at f32 roundoff."""
    A = _spd(200, seed=5).astype(np.float32)
    L = _port(which, A, block=256)
    assert torch.equal(L, cc.blocked_cholesky(torch.as_tensor(A)))
    np.testing.assert_allclose(L.numpy(), np.asarray(pc.blocked_cholesky(jnp.asarray(A))),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(L.numpy(), _jax(which, A), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("which", sorted(KERNELS))
def test_float64_raises(which):
    A = _spd(600, seed=6)
    with pytest.raises(ValueError, match="f32-only"):
        _port(which, A, block=256)
    with pytest.raises(ValueError, match="f32-only"):
        _jax(which, A)


@pytest.mark.parametrize("which", sorted(KERNELS))
def test_non_pd_gives_nan(which):
    """A negative pivot in the third of five tiles: NaN, no exception."""
    A = np.eye(600, dtype=np.float32)
    A[300, 300] = -1.0
    L = _port(which, A, block=128)
    assert torch.isnan(L).any()
    assert torch.isfinite(L[:256, :256]).all()  # the tiles before it are done


@pytest.mark.parametrize("which,quantum", [("K6", 4), ("K7", 3)])
def test_cpu_tensor_takes_the_plain_version(monkeypatch, which, quantum):
    """On a CPU tensor the entry point identity-pads to a multiple of
    block * chunk (K6's chunk is 4, K7's is an argument) and calls
    fused_cholesky_plain, never a kernel wrapper; the slice back is the
    plain factor of the unpadded matrix."""
    calls = []
    plain = cf.fused_cholesky_plain

    def counting(a, block):
        calls.append((a.shape[0], block))
        return plain(a, block)

    def no_kernel(a, block):
        raise AssertionError("a kernel wrapper was called on a CPU tensor")

    monkeypatch.setattr(cf, "fused_cholesky_plain", counting)
    monkeypatch.setattr(cf, "fused_cholesky_kernel", no_kernel)
    monkeypatch.setattr(cf, "fused_cholesky2_kernel", no_kernel)
    A = torch.as_tensor(_spd(300, seed=7).astype(np.float32))
    kw = {"chunk": quantum} if which == "K7" else {}
    L = KERNELS[which][0](A, block=128, **kw)
    assert calls == [(128 * quantum, 128)]
    torch.testing.assert_close(L, plain(A, 128), rtol=0, atol=1e-6)


@pytest.mark.parametrize("wrapper", ["fused_cholesky_kernel", "fused_cholesky2_kernel"])
@pytest.mark.parametrize("block,match", [
    (128, "CUDA tensors"),   # a valid block on a CPU tensor
    (64, "multiple of 128"),
    (200, "multiple of 128"),
    (640, "multiple of 128"),
])
def test_kernel_wrapper_refuses(wrapper, block, match):
    """The wrappers launch only on CUDA tensors, with a block the diagonal
    routine takes (a multiple of 128 up to 512); the block is checked first."""
    A = torch.eye(1280)
    with pytest.raises(ValueError, match=match):
        getattr(cf, wrapper)(A, block)
