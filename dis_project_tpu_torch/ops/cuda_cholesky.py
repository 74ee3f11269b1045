"""Blocked Cholesky engine of the exact MLL, its triangular inverses and
Σ⁻¹ routes, and the three kernels on its path, with their plain PyTorch
versions.

Port of ``dis_project_tpu/ops/pallas_cholesky.py``. Kernels (``csrc/``):

- :func:`syrk_ltl_tril` — K3, ``csrc/syrk.cu::syrk_ltl_tril_kernel``,
  replacing ``pallas_cholesky.py::_syrk_kernel``: ``tril(Liᵀ Li)`` for a
  lower-triangular float32 ``Li``, over the lower output tiles only, in
  split 3xTF32 products on the tensor cores (``wgmma``): f32-faithful,
  as the JAX kernel's split-bf16 passes are.
- :func:`chol_inv_unblocked` — K4, ``csrc/chol_block.cu::chol_inv_kernel``,
  replacing ``_chol_inv_kernel``: L and L⁻¹ of one (B, B) SPD block,
  B a multiple of 128 up to 512, float32, by the routine K6 and K7 run on
  their diagonal tiles (``chol_block.cuh::chol_inv_block_fast``); each
  launch leaves its phase stamps (:func:`k4_phase_stamps`).
- :func:`chol_unblocked` — K5, ``csrc/chol_block.cu::chol_cluster_kernel``,
  replacing ``_chol_kernel``: L of one (B, B) SPD block, any B up to 512,
  float32, factored by a thread-block cluster of :func:`k5_cluster_size`
  CTAs with the block in their shared memory.

Around them, the JAX package's matmul-level algorithms, one to one:
:func:`tri_inv` (bottom-up doubling), :func:`tri_inv_panels`,
:func:`tri_inv_from_diag`, :func:`blocked_cholesky` (left-looking, the f64
engine and the ``diag=`` surface), :func:`blocked_cholesky_t` (transposed
two-level form, the f32 engine), :func:`blocked_chol_solve`,
:func:`inv_from_factor` and :func:`inv_from_factor_tril`. Every product
outside a kernel is ``torch.matmul`` with TF32 off
(``ops.precision.pin_full_fp32``) — the port's form of the JAX package's
f32-faithful ``MATMUL_PRECISION``: single-pass low-precision products NaN
the factorisation of a real SIMM Gram.

Dispatch: on a CUDA tensor each kernel wrapper launches its kernel or
raises; on a CPU tensor it takes the plain version. Each launch adds one to
``LAUNCHES``. Non-PD input never raises: the factor comes back NaN (the
kernels write NaN for a non-positive pivot; the plain versions NaN-fill
``cholesky_ex``), so the trainer's finite guard sees a NaN loss.
"""

from __future__ import annotations

import ctypes
import math

import torch

from dis_project_tpu_torch.ops import cuda_build
from dis_project_tpu_torch.ops.cuda_gram import plain_vjp

LAUNCHES = {"syrk_ltl_tril": 0, "chol_inv_unblocked": 0, "chol_unblocked": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int
SYRK_SIGNATURES = {"syrk_ltl_tril_f32": [_P, _I, _P, _P]}
CHOL_SIGNATURES = {
    # (A, lda, B, L, Li, W, stamps, stream) and (A, lda, B, L, cluster, stream)
    "chol_inv_block_f32": [_P, _I, _I, _P, _P, _P, _P, _P],
    "chol_block_f32": [_P, _I, _I, _P, _I, _P],
}

# Default block of the O(N³) ops below mid scale (blocked_cholesky's
# block=None rule moves to 1024 from N=8192).
DEFAULT_BLOCK = 512
# Sub-panel width of K4; its blocks are multiples of it.
_SUB = 128
# Largest block K4 and K5 take; _diag_chol recurses above it.
_PALLAS_CHOL_MAX_B = 512
# float32 factors above this size take K3 and the panel inverses (the JAX
# package's inv_from_factor threshold: below it the plain product is cheap).
SYRK_MIN_N = 2048
# K4's phase stamps (csrc/chol_block.cuh, K4_STAMPS): %globaltimer at entry,
# block loaded, each 32-wide step of the first 128 block, the inverse
# assembled, L and L⁻¹ stored.
K4_PHASES = ("entry", "loaded", "step 0", "step 1", "step 2", "step 3", "assembly", "stored")
_K4_STAMPS: dict = {}  # device -> int64 buffer, overwritten by every launch


# ---------------------------------------------------------------------------
# Helpers.
# ---------------------------------------------------------------------------


def cholesky_nan(a):
    """Lower Cholesky factor; NaN-filled when ``a`` is not PD (no host sync)."""
    L, info = torch.linalg.cholesky_ex(a)
    return L.masked_fill(info != 0, float("nan"))


def _pad_identity(a, npad):
    """``blkdiag(a, I)`` of size npad: chol(blkdiag(A, I)) = blkdiag(L, I)."""
    n = a.shape[0]
    out = a.new_zeros((npad, npad))
    out[:n, :n] = a
    out.diagonal()[n:] = 1.0
    return out


def _mul_dense_tril(X, T, base: int = 512):
    """``X @ T`` for lower-triangular ``T`` (batched), skipping the
    structural zeros: [X1 X2] @ [[A,0],[B,C]] = [X1 A + X2 B, X2 C]."""
    n = T.shape[-1]
    if n <= base or n % 2:
        return X @ T
    h = n // 2
    X1, X2 = X[..., :, :h], X[..., :, h:]
    A, B, C = T[..., :h, :h], T[..., h:, :h], T[..., h:, h:]
    left = _mul_dense_tril(X1, A, base) + X2 @ B
    right = _mul_dense_tril(X2, C, base)
    return torch.cat([left, right], dim=-1)


def _mul_tril_dense(T, X, base: int = 512):
    """``T @ X`` for lower-triangular ``T`` (batched), skipping the
    structural zeros: [[A,0],[B,C]] @ [X1; X2] = [A X1; B X1 + C X2]."""
    n = T.shape[-1]
    if n <= base or n % 2:
        return T @ X
    h = n // 2
    X1, X2 = X[..., :h, :], X[..., h:, :]
    A, B, C = T[..., :h, :h], T[..., h:, :h], T[..., h:, h:]
    top = _mul_tril_dense(A, X1, base)
    bot = B @ X1 + _mul_tril_dense(C, X2, base)
    return torch.cat([top, bot], dim=-2)


def _diag_blocks(X, size, count):
    """The first ``count`` (size, size) diagonal blocks of X, stacked."""
    return torch.stack(
        [X[..., i * size:(i + 1) * size, i * size:(i + 1) * size] for i in range(count)],
        dim=-3,
    )


# ---------------------------------------------------------------------------
# Triangular inverses.
# ---------------------------------------------------------------------------


def _tri_inv_base(L):
    """Leaf inverse of small lower-triangular blocks (one batched solve)."""
    eye = torch.eye(L.shape[-1], dtype=L.dtype, device=L.device)
    return torch.linalg.solve_triangular(L, eye.expand_as(L), upper=False)


def _tri_inv_doubling(L):
    """Inverse of lower-triangular (SB, SB) blocks by nilpotent doubling:
    L = D (I + M), M strictly lower, (I + M)⁻¹ = (I - M)(I + M²)(I + M⁴)…

    Diverges on real Gram factors beyond the 128 scale (the JAX package
    measured |Li·L - I| ~ 1e2 at 512); kept as the ``leaf='doubling'``
    option of :func:`tri_inv`, on no default path.
    """
    SB = L.shape[-1]
    eye = torch.eye(SB, dtype=L.dtype, device=L.device)
    dinv = 1.0 / torch.diagonal(L, dim1=-2, dim2=-1)
    M = L * dinv[..., :, None] - eye  # strictly lower
    P = eye - M
    S = M @ M
    # k doublings cover series exponents < 2^(k+1); nilpotency needs SB-1.
    steps = max((SB - 1).bit_length() - 1, 0)
    for _ in range(steps):
        P = P + P @ S
        S = S @ S
    return P * dinv[..., None, :]


def tri_inv(L, *, base: int = 256, leaf: str = "solve"):
    """Inverse of lower-triangular ``L`` (batched over leading dims) by
    bottom-up block doubling:
    [[A, 0], [B, C]]⁻¹ = [[A⁻¹, 0], [-C⁻¹ B A⁻¹, C⁻¹]].

    All ``base``-sized diagonal blocks are inverted in one batched leaf
    call (``leaf='solve'``: substitution; ``'doubling'``: nilpotent
    doubling), then each level's off-diagonal corrections are one batched
    triangle-aware matmul pair, written in place into one buffer. Sizes that
    are not ``base * 2^k`` split at the largest such size and recurse on the
    remainder, instead of padding.
    """
    n = L.shape[-1]
    leaf_inv = _tri_inv_base if leaf == "solve" else _tri_inv_doubling
    if n <= base:
        return leaf_inv(L)
    m = base << int(math.log2(n / base))
    if m != n:
        Ai = tri_inv(L[..., :m, :m], base=base, leaf=leaf)
        Ci = tri_inv(L[..., m:, m:], base=base, leaf=leaf)
        out = L.new_zeros(L.shape)
        out[..., :m, :m] = Ai
        out[..., m:, :m] = -_mul_tril_dense(Ci, _mul_dense_tril(L[..., m:, :m], Ai))
        out[..., m:, m:] = Ci
        return out
    X = L.clone()
    nb = n // base
    dinv = leaf_inv(_diag_blocks(X, base, nb))
    for i in range(nb):
        X[..., i * base:(i + 1) * base, i * base:(i + 1) * base] = dinv[..., i, :, :]
    # At size s every pair's A⁻¹ and C⁻¹ are in place and its B block is
    # still L's: each level reads and writes disjoint regions of X.
    s = base
    while s < n:
        P = n // (2 * s)

        def gather(r0, c0, s=s, P=P):
            return torch.stack(
                [X[..., p * 2 * s + r0:p * 2 * s + r0 + s, p * 2 * s + c0:p * 2 * s + c0 + s]
                 for p in range(P)], dim=-3)

        off = -_mul_tril_dense(gather(s, s), _mul_dense_tril(gather(s, 0), gather(0, 0)))
        for p in range(P):
            X[..., p * 2 * s + s:p * 2 * s + 2 * s, p * 2 * s:p * 2 * s + s] = off[..., p, :, :]
        s *= 2
    return X


def _row_panel_sweep(X, dinvs, block, out_n, base):
    """``L⁻¹`` from the (nb, block, block) diagonal inverses of the padded
    factor ``X``: ``Li[i, :i] = -dinvs[i] (X[i, :i] Li[:i, :i])``, both
    products triangle-aware, written row panel by row panel into one buffer."""
    npad = X.shape[0]
    Li = X.new_zeros((npad, npad))
    Li[:block, :block] = dinvs[0]
    for i in range(1, dinvs.shape[0]):
        off = i * block
        top = Li[:off, :off]  # finished prefix
        Lrow = X[off:off + block, :off]
        Li[off:off + block, :off] = -_mul_tril_dense(
            dinvs[i], _mul_dense_tril(Lrow, top, base=base), base=base)
        Li[off:off + block, off:off + block] = dinvs[i]
    return Li[:out_n, :out_n] if npad != out_n else Li


def tri_inv_panels(L, *, panel: int = 2048, base: int = 256, leaf: str = "solve"):
    """Two-level triangular inverse: all ``panel``-sized diagonal inverses
    in one batched :func:`tri_inv`, then ``N/panel`` row-panel corrections,
    each two triangle-aware matmuls (the substitution-minimal N³/6 MACs)."""
    n = L.shape[0]
    if n <= panel:
        return tri_inv(L, base=base, leaf=leaf)
    nbp = -(-n // panel)
    npad = nbp * panel
    X = _pad_identity(L, npad) if npad != n else L
    dinv = tri_inv(_diag_blocks(X, panel, nbp), base=base, leaf=leaf)
    return _row_panel_sweep(X, dinv, panel, n, base=panel // 2)


def tri_inv_from_diag(L, dinvs, *, panel: int = 2048):
    """``tril(L⁻¹)`` given the per-block-column diagonal inverses of
    :func:`blocked_cholesky` / :func:`blocked_cholesky_t`
    (``return_diag_inv=True``): the row-panel sweep of :func:`tri_inv_panels`
    without its diagonal stage. Blocks smaller than ``panel`` are first
    combined pairwise (``[[Ai,0],[-Ci (B Ai), Ci]]``, batched over all pairs)
    up to the panel size. Identity-padded tails follow the factorisers'
    padding, so the slice back is exact."""
    n = L.shape[0]
    nb, block = dinvs.shape[0], dinvs.shape[1]
    npad = nb * block
    X = _pad_identity(L, npad) if npad != n else L
    while block < panel and nb % 2 == 0 and nb > 1:
        Ai, Ci = dinvs[0::2], dinvs[1::2]
        Bo = torch.stack([
            X[(2 * p + 1) * block:(2 * p + 2) * block, 2 * p * block:(2 * p + 1) * block]
            for p in range(nb // 2)
        ])
        pairs = dinvs.new_zeros((nb // 2, 2 * block, 2 * block))
        pairs[:, :block, :block] = Ai
        pairs[:, block:, :block] = -_mul_tril_dense(Ci, _mul_dense_tril(Bo, Ai))
        pairs[:, block:, block:] = Ci
        dinvs = pairs
        block *= 2
        nb //= 2
    if nb == 1:
        return dinvs[0][:n, :n]
    return _row_panel_sweep(X, dinvs, block, n, base=max(block // 2, 256))


# ---------------------------------------------------------------------------
# K4 and K5: one (B, B) diagonal block.
# ---------------------------------------------------------------------------


def _check_block(a, what, multiple):
    if not a.is_cuda:
        raise ValueError(f"{what} kernel runs on CUDA tensors, not {a.device}")
    if a.dtype != torch.float32:
        raise TypeError(f"{what} kernel takes float32, not {a.dtype}")
    if a.dim() != 2 or a.shape[0] != a.shape[1]:
        raise ValueError(f"{what}: block must be square, got {tuple(a.shape)}")
    B = a.shape[0]
    if B < 1 or B > _PALLAS_CHOL_MAX_B or B % multiple:
        raise ValueError(
            f"{what}: block size {B} not a multiple of {multiple} in [1, {_PALLAS_CHOL_MAX_B}]")
    # Rows may be strided (a diagonal block of a larger matrix); columns not.
    return a if a.stride(1) == 1 else a.contiguous()


def chol_inv_unblocked_kernel(a, out=None):
    """Launch K4 on a CUDA float32 (B, B) SPD block: ``(L, L⁻¹)``, both
    lower-triangular with zeros above the diagonal. ``out``: an optional
    pair of contiguous (B, B) float32 tensors on ``a``'s device to write
    them into (a caller that launches K4 in a loop saves two allocations a
    call on the host, which then sets the pace)."""
    a = _check_block(a, "chol_inv_unblocked", _SUB)
    B = a.shape[0]
    if out is None:
        L = torch.empty((B, B), dtype=a.dtype, device=a.device)
        Li = torch.empty_like(L)
    else:
        L, Li = out
        for t in out:
            if (t.shape != (B, B) or t.dtype != a.dtype or t.device != a.device
                    or not t.is_contiguous()):
                raise ValueError(f"chol_inv_unblocked: out must be two contiguous ({B}, {B}) "
                                 f"{a.dtype} tensors on {a.device}")
    W = torch.empty_like(L) if B > _SUB else None  # trailing-matrix workspace
    stamps = _K4_STAMPS.get(a.device)
    if stamps is None:
        stamps = _K4_STAMPS[a.device] = torch.zeros(len(K4_PHASES), dtype=torch.int64,
                                                    device=a.device)
    lib = cuda_build.load("chol_block", CHOL_SIGNATURES)
    with torch.cuda.device(a.device):
        code = lib.chol_inv_block_f32(
            a.data_ptr(), a.stride(0), B, L.data_ptr(), Li.data_ptr(),
            W.data_ptr() if W is not None else None, stamps.data_ptr(),
            cuda_build.stream_handle(a.device))
    LAUNCHES["chol_inv_unblocked"] += 1
    cuda_build.check(code, "chol_inv_block")
    return L, Li


def k4_phase_stamps(device):
    """K4's phase stamps of the last launch on ``device``: an int64 CUDA
    tensor, the card's %globaltimer in ns at each point of
    :data:`K4_PHASES` (the phases of the first 128 block). Reading it waits
    for the launch to finish."""
    return _K4_STAMPS[torch.device(device)]


def chol_inv_unblocked_plain(a):
    """Plain version of K4: ``cholesky_ex`` (NaN-filled) + :func:`tri_inv`."""
    L = cholesky_nan(a)
    return L, tri_inv(L, base=min(a.shape[0], 256))


def chol_inv_unblocked(a):
    """L and L⁻¹ of one (B, B) SPD block: K4 on CUDA (float32, B a
    multiple of 128 up to 512), plain on CPU."""
    if a.is_cuda:
        return chol_inv_unblocked_kernel(a)
    return chol_inv_unblocked_plain(a)


def k5_cluster_size(B):
    """CTAs in K5's thread-block cluster for a (B, B) block: one per 32-row
    block, at most 8 (the portable cluster size), so that no CTA holds more
    than two row blocks (64 rows; 202 KB of shared memory at B = 512). The
    fastest size that fits at B = 96, 128, 256 and 512 on an H100
    (``chip_smoke.py``'s ``[K5] ... ms by cluster size`` lines, PERF.md)."""
    return min(8, max(1, -(-B // 32)))


def chol_unblocked_kernel(a):
    """Launch K5 on a CUDA float32 (B, B) SPD block, B <= 512: its lower
    Cholesky factor, zeros above the diagonal. Raises when the cluster
    cannot be launched."""
    a = _check_block(a, "chol_unblocked", 1)
    B = a.shape[0]
    L = torch.empty((B, B), dtype=a.dtype, device=a.device)
    lib = cuda_build.load("chol_block", CHOL_SIGNATURES)
    with torch.cuda.device(a.device):
        code = lib.chol_block_f32(a.data_ptr(), a.stride(0), B, L.data_ptr(),
                                  k5_cluster_size(B), cuda_build.stream_handle(a.device))
    LAUNCHES["chol_unblocked"] += 1
    cuda_build.check(code, "chol_block")
    return L


def chol_unblocked(a):
    """Cholesky factor of one (B, B) SPD block: K5 on CUDA (float32,
    B <= 512), plain ``cholesky_ex`` (NaN-filled) on CPU."""
    if a.is_cuda:
        return chol_unblocked_kernel(a)
    return cholesky_nan(a)


# ---------------------------------------------------------------------------
# Mirrors of the kernels' blocking, in PyTorch (tests only).
# ---------------------------------------------------------------------------


def _warp_chol32_mirror(D):
    """In place, the (w, w) lower block ``D`` (w <= 32) by rank-1 steps in
    the order of ``warp_chol32``; a non-positive pivot gives NaN. (The
    kernel scales each column by a Newton-refined reciprocal square root
    where this divides by the square root: about an ulp apart per entry.)"""
    for k in range(D.shape[0]):
        piv = D[k, k]
        d = torch.where(piv > 0, piv.clamp(min=0).sqrt(), torch.full_like(piv, float("nan")))
        col = D[k + 1:, k] / d
        D[k, k] = d
        D[k + 1:, k] = col
        D[k + 1:, k + 1:] -= torch.outer(col, col).tril()


def _panels32_mirror(R, X=None):
    """In place, the lower factor of ``R`` (size a multiple of 32),
    right-looking over 32-wide panels: the diagonal piece by
    :func:`_warp_chol32_mirror`, the panel below it by substitution, the
    rank-32 trailing update summed per entry and subtracted once. ``X``, if
    given, takes each piece's inverse (by substitution) on its diagonal."""
    n = R.shape[0]
    for off in range(0, n, 32):
        t0 = off + 32
        D = R[off:t0, off:t0]
        _warp_chol32_mirror(D)
        if X is not None:
            X[off:t0, off:t0] = torch.linalg.solve_triangular(
                D, torch.eye(32, dtype=R.dtype), upper=False)
        if t0 < n:
            P = torch.linalg.solve_triangular(D.T, R[t0:, off:t0], upper=True, left=False)
            R[t0:, off:t0] = P
            R[t0:, t0:] -= (P @ P.T).tril()


def _chol_cluster_mirror(a):
    """K5's blocking (``chol_cluster_kernel``): the block identity-padded to
    a multiple of 32, then :func:`_panels32_mirror`."""
    B = a.shape[0]
    R = _pad_identity(a, -(-B // 32) * 32).tril()
    _panels32_mirror(R)
    return R[:B, :B].tril()


def _chol_inv_128_mirror(a):
    """``chol_inv_128_fast``: L and L⁻¹ of a (128, 128) block by
    :func:`_panels32_mirror` with the pieces' inverses, then the inverse by
    right-looking forward substitution over 32-blocks: X[p, :p] =
    X[p, p] P[p, :p], then P[i, :p+1] -= L[i, p] X[p, :p+1] for i > p (P the
    partial rows, each block's product summed and subtracted once)."""
    F = a.tril()
    X = torch.zeros_like(F)
    _panels32_mirror(F, X)
    for off in range(0, _SUB, 32):
        end = off + 32
        if off:
            X[off:end, :off] = X[off:end, off:end] @ X[off:end, :off]
        if end < _SUB:
            X[end:, :end] -= F[end:, off:end] @ X[off:end, :end]
    return F, X


def _chol_inv_fast_mirror(a):
    """``chol_inv_block_fast`` (K6's diagonal routine): L and L⁻¹ of a
    (B, B) block, B a multiple of 128, left-looking over 128-wide panels as
    :func:`chol_inv_unblocked` (the TRSM a product with the panel's
    inverse, the block-wise inverse assembly), each 128 step
    :func:`_chol_inv_128_mirror`."""
    B = a.shape[0]
    W = a.tril()
    L, Li = torch.zeros_like(W), torch.zeros_like(W)
    for off in range(0, B, _SUB):
        end = off + _SUB
        Ld, Xd = _chol_inv_128_mirror(W[off:end, off:end])
        L[off:end, off:end], Li[off:end, off:end] = Ld, Xd
        if end < B:
            Lp = W[end:, off:end] @ Xd.T
            L[end:, off:end] = Lp
            W[end:, end:] -= Lp @ Lp.T
        if off:
            Li[off:end, :off] = -(Xd @ (L[off:end, :off] @ Li[:off, :off]))
    return L, Li


def _diag_chol(a, diag):
    if diag == "pallas" and a.dtype != torch.float64:
        if a.shape[0] > _PALLAS_CHOL_MAX_B:
            return blocked_cholesky(a, block=_PALLAS_CHOL_MAX_B, diag=diag)
        return chol_unblocked(a)
    return cholesky_nan(a)


# ---------------------------------------------------------------------------
# Blocked factorisers.
# ---------------------------------------------------------------------------


def blocked_cholesky_t(a, *, block: int | None = None, inner: int = 128, probe_eps=None,
                       return_diag_inv: bool = False, kernels: bool = True):
    r"""UPPER-triangular Cholesky factor ``Lt = Lᵀ`` by the transposed-layout
    two-level left-looking blocked factorisation (the f32 engine of the MLL).

    The factor lives in ONE (npad, npad) buffer, initialised with the
    identity-padded ``a`` and factored in place (the port updates in place
    where JAX threads immutable slices): row-block ``j`` holds column-block
    ``j`` of L transposed, so every ``block``-wide outer panel is corrected
    by one large product of contiguous row slices,

        P = A[off:off+Bo, off:] - Lt[:off, off:off+Bo]ᵀ Lt[:off, off:],

    and ``inner``-wide columns inside the panel keep the serial diagonal
    chain cheap: each is corrected against the panel's finished rows,
    factored, and its right part multiplied by the diagonal inverse (the
    TRSM as a product).

    The diagonal step: on a CUDA float32 tensor with ``inner`` a multiple
    of 128 up to 512 (and ``kernels`` set), ONE launch of K4
    (:func:`chol_inv_unblocked_kernel`) gives ``lkk`` and its inverse; otherwise
    (CPU, float64, other ``inner``, or ``kernels=False``) it is
    ``cholesky_ex`` + :func:`tri_inv`, as in the JAX package. These are
    API rules, not fallbacks on failure.

    ``block=None``: 512 from N=8192, else the padded N up to 2048.
    ``probe_eps`` (scalar) is added to ``a[0, 0]``. ``return_diag_inv=True``
    also returns the stacked (npad/inner, inner, inner) diagonal inverses
    (identity on padded tails) for :func:`tri_inv_from_diag`. The returned
    ``Lt`` is exactly upper-triangular.
    """
    n = a.shape[0]
    if block is None:
        block = 512 if n >= 8192 else min(2048, -(-n // inner) * inner)
    if block % inner:
        raise ValueError(
            f"blocked_cholesky_t: block ({block}) must be a multiple of inner ({inner})")
    Bo, Bi = block, inner
    npad = -(-n // Bo) * Bo
    Lt = _pad_identity(a, npad)
    if probe_eps is not None:
        Lt[0, 0] += probe_eps
    use_k4 = (kernels and Lt.is_cuda and Lt.dtype == torch.float32
              and Bi % _SUB == 0 and Bi <= _PALLAS_CHOL_MAX_B)
    dinvs = []
    if use_k4:
        # K4's outputs go into buffers made once: the diagonal inverses'
        # stack (or one reused inverse) and one reused factor, copied into
        # Lt at once. With K4 at ~30 us, the host's loop of launches came
        # within a few percent of the device time (PERF.md).
        lkk_buf = Lt.new_empty((Bi, Bi))
        dinv_all = Lt.new_empty((npad // Bi if return_diag_inv else 1, Bi, Bi))
    for off in range(0, npad, Bo):
        P = Lt[off:off + Bo, off:]
        if off:
            P.addmm_(Lt[:off, off:off + Bo].T, Lt[:off, off:], alpha=-1.0)
        for io in range(0, Bo, Bi):
            R = P[io:io + Bi, io:]
            if io:
                R.addmm_(P[:io, io:io + Bi].T, P[:io, io:], alpha=-1.0)
            if use_k4:
                step = (off + io) // Bi if return_diag_inv else 0
                lkk, dinv = chol_inv_unblocked_kernel(R[:, :Bi], out=(lkk_buf, dinv_all[step]))
            else:
                lkk = cholesky_nan(R[:, :Bi])
                dinv = tri_inv(lkk, base=min(Bi, 256))
            if return_diag_inv and not use_k4:
                dinvs.append(dinv)
            if R.shape[1] > Bi:
                R[:, Bi:] = dinv @ R[:, Bi:]
            R[:, :Bi] = lkk.T
    Lt.triu_()  # the strict lower part still holds a's lower triangle
    Lt = Lt[:n, :n] if npad != n else Lt
    if return_diag_inv:
        return Lt, dinv_all if use_k4 else torch.stack(dinvs)
    return Lt


def blocked_cholesky(a, *, block: int | None = None, diag: str = "xla", matmul_dtype=None,
                     return_diag_inv: bool = False):
    """Lower Cholesky factor, left-looking blocked (the float64 engine of
    the MLL and the ``diag=`` surface). For block column k:

        C    = A[k:, k] - L[k:, :k] L[k, :k]ᵀ   # one large matmul, in float64
        L_kk = chol(C[:B])                      # diagonal step
        L_k+1: = C[B:] L_kk⁻ᵀ                   # TRSM as a product

    ``diag`` selects the diagonal step: ``'xla'`` (``cholesky_ex``),
    ``'pallas'`` (K5, :func:`chol_unblocked`, on a CUDA tensor; blocks
    above 512 recurse with block 512) or ``'pallas_inv'`` (K4,
    :func:`chol_inv_unblocked`, which also gives the TRSM's inverse). The
    names stay those of the JAX package. API rules, not fallbacks:
    ``'pallas_inv'`` becomes ``'xla'`` for float64 or a block that is not a
    multiple of 128 or is above 512, and for a single block whose size is
    not a multiple of 128; ``'pallas'`` takes ``cholesky_ex`` in float64.

    ``matmul_dtype`` (e.g. ``torch.bfloat16``) rounds the operands of the
    two panel products to that type. The TRSM product is multiplied and
    accumulated in the input's type; the correction, like every
    correction, in float64, rounded to the input's type once. The JAX
    package takes its correction in the working type (see the comment in
    the loop). Sizes that are not a multiple of ``block`` are padded
    with an identity tail and sliced back. ``block=None``: 1024 from
    N=8192, else 512. ``return_diag_inv=True`` also returns the stacked
    (nb, B, B) diagonal-block inverses (identity on padded tails).
    """
    n = a.shape[0]
    if block is None:
        block = 1024 if n >= 8192 else DEFAULT_BLOCK
    if diag == "pallas_inv" and (
        a.dtype == torch.float64 or block % _SUB or block > _PALLAS_CHOL_MAX_B
    ):
        diag = "xla"
    if n <= block:
        if diag == "pallas_inv" and n % _SUB == 0:
            L, linv = chol_inv_unblocked(a)
            return (L, linv[None]) if return_diag_inv else L
        if diag == "pallas_inv":
            diag = "xla"
        L = torch.tril(_diag_chol(a, diag))
        if return_diag_inv:
            return L, tri_inv(L, base=min(block, 256))[None]
        return L

    def rounded(x):
        return x if matmul_dtype is None else x.to(matmul_dtype).to(x.dtype)

    npad = -(-n // block) * block
    A = _pad_identity(a, npad) if npad != n else a
    L = A.new_zeros((npad, npad))
    dinvs = []
    for off in range(0, npad, block):
        col = A[off:, off:off + block]
        if off:
            # The correction in float64, rounded once: in float32 the
            # diagonal of the difference cancels, and on the real dense10k
            # Σ at block 512 the factor reconstructed Σ ~2x worse than
            # cuSOLVER's, largest on the diagonal (~0.2x in float64).
            left = rounded(L[off:, :off]).double()
            col = (col.double() - left @ left[:block].T).to(a.dtype)
        if diag == "pallas_inv":
            lkk, linv = chol_inv_unblocked(col[:block])
        else:
            lkk, linv = torch.tril(_diag_chol(col[:block], diag)), None
        last = off + block >= npad
        if linv is None and (not last or return_diag_inv):
            linv = tri_inv(lkk, base=min(block, 256))
        if return_diag_inv:
            dinvs.append(linv)
        L[off:off + block, off:off + block] = lkk
        if not last:
            L[off + block:, off:off + block] = rounded(col[block:]) @ rounded(linv.T)
    L = L[:n, :n] if npad != n else L
    if return_diag_inv:
        return L, torch.stack(dinvs)
    return L


# ---------------------------------------------------------------------------
# K3 and Σ⁻¹ from the factor.
# ---------------------------------------------------------------------------


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
    # The kernel writes the lower tiles only: the upper ones keep these zeros.
    out = torch.zeros((n, n), dtype=Li.dtype, device=Li.device)
    lib = cuda_build.load("syrk", SYRK_SIGNATURES)
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


def blocked_chol_solve(L, b, *, block: int = DEFAULT_BLOCK):
    """Solve (L Lᵀ) x = b through the blocked triangular inverse."""
    Li = tri_inv(L, base=min(block, 256))
    return Li.T @ (Li @ b)


def _large_f32(L):
    return L.dtype == torch.float32 and L.shape[0] > SYRK_MIN_N


def inv_from_factor(L, *, block: int = DEFAULT_BLOCK, kernels: bool = True):
    """Σ⁻¹ = L⁻ᵀ L⁻¹ from the Cholesky factor: float32 above N=2048 through
    :func:`tri_inv_panels` and the SYRK (K3 + mirror on the card when
    ``kernels`` is set), else :func:`tri_inv` + the recursive product."""
    if _large_f32(L):
        Li = tri_inv_panels(L).contiguous()  # K3 reads rows
        return syrk_ltl(Li) if kernels else _tril_t_tril(Li)
    return _tril_t_tril(tri_inv(L, base=min(block, 256)))


def inv_from_factor_tril(L, *, block: int = DEFAULT_BLOCK, diag_inv=None,
                         kernels: bool = True):
    """``tril(Σ⁻¹)`` (diagonal included) from the Cholesky factor ``L``.

    float32 above ``SYRK_MIN_N``: ``L⁻¹`` from :func:`tri_inv_from_diag`
    when the factoriser's diagonal inverses ``diag_inv`` are given, else
    :func:`tri_inv_panels`; then :func:`syrk_ltl_tril` (K3 on the card)
    when ``kernels`` is set, its plain version otherwise. Everything else:
    ``L⁻¹`` from ``diag_inv`` or :func:`tri_inv`, then ``tril`` of the
    recursive product. The JAX package's dispatch, with the card in place
    of the TPU.
    """
    if diag_inv is not None:
        Li = tri_inv_from_diag(L, diag_inv)
    elif _large_f32(L):
        Li = tri_inv_panels(L)
    else:
        Li = tri_inv(L, base=min(block, 256))
    if _large_f32(L):
        Li = Li.contiguous()  # K3 reads rows; a solve leaves columns
        return syrk_ltl_tril(Li) if kernels else syrk_ltl_tril_plain(Li)
    return torch.tril(_tril_t_tril(Li))
