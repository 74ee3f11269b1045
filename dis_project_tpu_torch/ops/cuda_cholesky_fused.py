"""Whole-matrix Cholesky in one kernel launch, and its plain version.

Port of ``dis_project_tpu/ops/pallas_cholesky_fused.py``. Kernels
(``csrc/chol_fused.cu``):

- :func:`fused_cholesky` — K6, ``fused_chol_kernel``, replacing
  ``pallas_cholesky_fused.py::_fused_kernel``: the lower factor by a
  left-looking tile factorisation, one CTA per tile of the (column k,
  row tile i) grid, the TPU grid's order; the tiles above the diagonal are
  zero tiles.
- :func:`fused_cholesky2` — K7, ``fused_chol2_kernel``, replacing
  ``_fused_kernel2``: the same factor over the nb(nb+1)/2 active tiles
  only, each off-diagonal tile also writing its zero mirror tile.

Both compute, for each tile (k, i), i >= k, of ``block`` x ``block``::

    C      = A[i, k] - sum_j L[i, j] L[k, j]^T     # j < k, in order
    i == k: L[k, k], Linv_kk = chol_inv(C)          # the diagonal routine
    i >  k: L[i, k] = C Linv_kk^T                   # the TRSM as a product

The TPU grid runs in order; CTAs on the card do not, so each CTA takes an
atomic ticket that names its tile (tickets in dependency order) and waits
on per-tile ready flags before it reads another tile (``csrc/chol_fused.cu``
says how). K6 numbers its tickets in the TPU grid's order; K7 reads the
tile of each ticket from an order table, :func:`tile_order` at the private
look-ahead depth ``_LOOKAHEAD`` (the JAX kernel's order at depth 0), which
hands each diagonal tile out early, so that its own corrections are done
by the time the sub-diagonal tile beside it is. Both run the same tile program with the same
diagonal routine (``chol_block.cuh::chol_inv_block_fast``, K4's body), so
their factors are equal bitwise, and K7's is the same at every depth.
Every product is plain FP32: the JAX kernels stage the correction
operands in bf16 and return NaN on a real SIMM Gram (their own warning,
``pallas_cholesky_fused.py:6-14``); the port holds to the f32-faithful
rule of the rest of the engine and does not copy that.

``block`` on the card: a multiple of 128 up to 512 (what the diagonal
routine takes); anything else raises there. The plain version takes any
block. The defaults (128 for both) are the card's choice, not the JAX
package's v5e values (512 and 1024): at N = 1e4 on the real dense10k Σ,
block 128 is the fastest block whose reconstruction
max|LLᵀ − Σ|/max|Σ| holds 2x cuSOLVER's, for both kernels
(``chip_smoke.py``'s ``[K6]``/``[K7]`` block lines, PERF.md). The chain of
diagonal tiles sets the pace of both (:func:`chain_stamps`).

``chunk`` grouped the TPU's DMA reads of finished columns; here it only
sets the padding quantum (the size is identity-padded to a multiple of
``block * chunk``), which cannot change the factor of the first n rows.
It stays in the signature for parity with the JAX call.

Dispatch: on a CUDA tensor :func:`fused_cholesky` and :func:`fused_cholesky2`
launch their kernel or raise; on a CPU tensor they take
:func:`fused_cholesky_plain`. Each launch adds one to ``LAUNCHES``. A
non-PD input gives a NaN factor and never raises. Each launch also leaves
an error word (:func:`error_word`): 0, or 1 when a CTA gave up waiting
for a tile (a broken dependency; its tile is then NaN).
"""

from __future__ import annotations

import ctypes

import torch

from dis_project_tpu_torch.ops import cuda_build
from dis_project_tpu_torch.ops.cuda_cholesky import (
    _PALLAS_CHOL_MAX_B,
    _SUB,
    _chol_inv_fast_mirror,
    _pad_identity,
    blocked_cholesky,
    chol_inv_unblocked_plain,
)

LAUNCHES = {"fused_cholesky": 0, "fused_cholesky2": 0}

DEFAULT_BLOCK = 128
DEFAULT_BLOCK2 = 128
_CHUNK = 4    # K6's padding quantum is block * _CHUNK, as in the JAX package
_CHUNK2 = 2   # K7's default chunk

_P, _I = ctypes.c_void_p, ctypes.c_int
FUSED_SIGNATURES = {
    # (A, n, B, L, diag_scratch, sync, stamps, stream)
    "fused_chol_f32": [_P, _I, _I, _P, _P, _P, _P, _P],
    # (A, n, B, L, diag_scratch, sync, stamps, order table, stream)
    "fused_chol2_f32": [_P, _I, _I, _P, _P, _P, _P, _P, _P],
    # (which kernel: 6 or 7, int* CTAs per SM)
    "fused_chol_occupancy": [_I, _P],
}

# The sync words of each kernel's last launch: [ticket counter, error word,
# nb * nb tile-ready flags]; and its chain stamps (see chain_stamps).
_LAST_SYNC: dict = {}
_LAST_STAMPS: dict = {}
# Rows of the chain stamps (csrc/chol_fused.cu, ChainRow).
CHAIN_ROWS = ("ticket", "early corrections done", "routine start", "flag", "sub-diagonal flag")

# K7's look-ahead depth (tile_order): the fastest of the depths that
# chip_smoke.py sweeps at N = 1e4, B = 128 on an H100 (PERF.md).
_LOOKAHEAD = 3
_ORDER_TABLES: dict = {}  # (nb, depth, device) -> (tickets, 2) int32 table


# ---------------------------------------------------------------------------
# K7's tile order.
# ---------------------------------------------------------------------------


def tile_order(nb, depth):
    """K7's ticket order of the nb(nb+1)/2 active tiles (k, i), i >= k,
    with look-ahead ``depth``: sorted by (min(k, i - depth), k, i). Wave w
    holds column w's tiles from row w + depth down, then the tiles of row
    w + depth from column w + 1 to its diagonal: so each diagonal tile, and
    the ``depth`` tiles left of it in its row, are handed out ``depth``
    columns early, each right after the far tiles of that earlier column
    (the tiles that feed them all come earlier). ``depth`` 0 is the JAX
    kernel's scalar-prefetch order (``kidx``/``iidx``), ``nb - 1`` and
    above is row order. Every tile that (k, i) reads, (j, i) and (j, k) for
    j < k and (k, k) for i > k, has a smaller key, so every depth gives a
    legal order, which cannot deadlock."""
    if depth < 0:
        raise ValueError(f"tile_order: depth must be >= 0, got {depth}")
    tiles = [(k, i) for k in range(nb) for i in range(k, nb)]
    tiles.sort(key=lambda t: (min(t[0], t[1] - depth), t[0], t[1]))
    return tiles


def _order_table(nb, depth, device):
    """:func:`tile_order` as a (tickets, 2) int32 tensor on ``device``,
    built once per (nb, depth, device)."""
    key = (nb, depth, torch.device(device))
    table = _ORDER_TABLES.get(key)
    if table is None:
        table = torch.tensor(tile_order(nb, depth), dtype=torch.int32, device=device)
        _ORDER_TABLES[key] = table
    return table


# ---------------------------------------------------------------------------
# The plain version.
# ---------------------------------------------------------------------------


def fused_cholesky_plain(a, block):
    """Plain version of K6 and K7: the same tile factorisation, in the
    kernels' order and arithmetic, with PyTorch products (each column's
    tiles batched into one product per finished column block). The size is
    identity-padded to a multiple of ``block`` and sliced back."""
    return _tile_factor(a, block, chol_inv_unblocked_plain)


def _fused_cholesky_mirror(a, block):
    """K6's blocking (tests only): the tile factorisation with its diagonal
    tiles through the mirror of ``chol_inv_block_fast``."""
    return _tile_factor(a, block, _chol_inv_fast_mirror)


def _tile_program_mirror(a, block, order):
    """K7's tile program (tests only): one tile at a time in the ticket
    order ``order`` (a list of (k, i)), each as the kernel's CTA runs it:
    its correction steps j < k in order, each product subtracted from C
    once, then :func:`~dis_project_tpu_torch.ops.cuda_cholesky._chol_inv_fast_mirror`
    (the diagonal) or the product with the column's inverse (the TRSM).
    A tile reads L as it stands, so an order that hands out a tile before
    one it reads gives another factor. ``a``: (n, n), n a multiple of
    ``block``."""
    L = torch.zeros_like(a)
    linv = {}
    for k, i in order:
        rows, cols = slice(i * block, (i + 1) * block), slice(k * block, (k + 1) * block)
        C = a[rows, cols].clone()
        for j in range(k):
            js = slice(j * block, (j + 1) * block)
            C -= L[rows, js] @ L[cols, js].T
        if i == k:
            L[rows, cols], linv[k] = _chol_inv_fast_mirror(C)
        else:
            L[rows, cols] = C @ linv.get(k, torch.zeros_like(C)).T
    return L


def _tile_factor(a, block, diag):
    n = a.shape[0]
    npad = -(-n // block) * block
    A = _pad_identity(a, npad) if npad != n else a
    L = torch.zeros_like(A)
    for off in range(0, npad, block):
        C = A[off:, off:off + block].clone()
        for j in range(0, off, block):
            C -= L[off:, j:j + block] @ L[off:off + block, j:j + block].T
        lkk, linv = diag(C[:block])
        L[off:off + block, off:off + block] = lkk
        L[off + block:, off:off + block] = C[block:] @ linv.T
    return L[:n, :n] if npad != n else L


# ---------------------------------------------------------------------------
# The kernel wrappers.
# ---------------------------------------------------------------------------


def _check(a, block, what):
    # The blocks the diagonal routine (K4's chol_inv_block) takes.
    if block % _SUB or not _SUB <= block <= _PALLAS_CHOL_MAX_B:
        raise ValueError(f"{what}: block {block} is not a multiple of {_SUB} "
                         f"in [{_SUB}, {_PALLAS_CHOL_MAX_B}]")
    if not a.is_cuda:
        raise ValueError(f"{what} kernel runs on CUDA tensors, not {a.device}")
    if a.dtype != torch.float32:
        raise TypeError(f"{what} kernel takes float32, not {a.dtype}")
    if a.dim() != 2 or a.shape[0] != a.shape[1] or a.shape[0] % block:
        raise ValueError(
            f"{what}: input must be square with a size that is a multiple of {block}, "
            f"got {tuple(a.shape)}")
    if not a.is_contiguous() or a.data_ptr() % 16:
        raise ValueError(f"{what}: input must be contiguous (row-major) and 16-byte aligned")


def _launch(a, block, what, symbol, depth=None):
    _check(a, block, what)
    n = a.shape[0]
    nb = n // block
    L = torch.empty_like(a)
    # Per column: the diagonal tile's inverse (read by the column's other
    # tiles), and the diagonal routine's L and trailing workspace.
    diag = torch.empty((nb, 3, block, block), dtype=a.dtype, device=a.device)
    sync = torch.zeros(2 + nb * nb, dtype=torch.int32, device=a.device)
    stamps = torch.zeros((len(CHAIN_ROWS), nb), dtype=torch.int64, device=a.device)
    # K7 only: its order table.
    order = () if depth is None else (_order_table(nb, depth, a.device).data_ptr(),)
    lib = cuda_build.load("chol_fused", FUSED_SIGNATURES)
    with torch.cuda.device(a.device):
        code = getattr(lib, symbol)(a.data_ptr(), n, block, L.data_ptr(), diag.data_ptr(),
                                    sync.data_ptr(), stamps.data_ptr(), *order,
                                    cuda_build.stream_handle(a.device))
    LAUNCHES[what] += 1
    cuda_build.check(code, symbol)
    _LAST_SYNC[what] = sync
    _LAST_STAMPS[what] = stamps
    return L


def fused_cholesky_kernel(a, block):
    """Launch K6 on a CUDA float32 (n, n) SPD matrix, n a multiple of
    ``block``: its lower factor, exactly zero above the diagonal."""
    return _launch(a, block, "fused_cholesky", "fused_chol_f32")


def fused_cholesky2_kernel(a, block, depth=_LOOKAHEAD):
    """Launch K7 on a CUDA float32 (n, n) SPD matrix, n a multiple of
    ``block``: its lower factor, exactly zero above the diagonal. Its
    tickets follow :func:`tile_order` at look-ahead ``depth``; the factor is
    the same bitwise at every depth."""
    return _launch(a, block, "fused_cholesky2", "fused_chol2_f32", depth)


def error_word(what):
    """The error word of the last launch of ``what`` (``'fused_cholesky'``
    or ``'fused_cholesky2'``): 0, or 1 when a CTA timed out waiting for a
    tile. Reading it waits for the launch to finish."""
    return int(_LAST_SYNC[what][1])


def chain_stamps(what):
    """The chain stamps of the last launch of ``what``: a (5, nb) int64 CUDA
    tensor, the card's %globaltimer in ns (rows :data:`CHAIN_ROWS`) at which
    diagonal tile k took its ticket, finished its corrections j < k - 1,
    began its diagonal routine, and set its ready flag; and at which the
    sub-diagonal tile (k - 1, k) set its ready flag (0 for k = 0). Reading
    it waits for the launch to finish."""
    return _LAST_STAMPS[what]


def occupancy(what):
    """CTAs per SM of ``what``'s kernel at its shared memory
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``); needs the card."""
    lib = cuda_build.load("chol_fused", FUSED_SIGNATURES)
    out = ctypes.c_int(0)
    which = 6 if what == "fused_cholesky" else 7
    cuda_build.check(lib.fused_chol_occupancy(which, ctypes.addressof(out)),
                     "fused_chol_occupancy")
    return out.value


# ---------------------------------------------------------------------------
# Entry points.
# ---------------------------------------------------------------------------


def _fused(a, block, quantum, what, kernel):
    if a.dtype != torch.float32:
        raise ValueError(f"{what} is f32-only, got {a.dtype}")
    n = a.shape[0]
    if n <= block:
        return blocked_cholesky(a)
    npad = -(-n // quantum) * quantum
    A = _pad_identity(a, npad) if npad != n else a.contiguous()
    L = kernel(A, block) if A.is_cuda else fused_cholesky_plain(A, block)
    return L[:n, :n] if npad != n else L


def fused_cholesky(a, *, block: int = DEFAULT_BLOCK):
    """Lower Cholesky factor of a float32 SPD matrix through K6 (CUDA) or
    its plain version (CPU). Sizes that are not a multiple of
    ``block * 4`` are identity-padded and sliced back; ``n <= block``
    takes :func:`~dis_project_tpu_torch.ops.cuda_cholesky.blocked_cholesky`."""
    return _fused(a, block, block * _CHUNK, "fused_cholesky", fused_cholesky_kernel)


def fused_cholesky2(a, *, block: int = DEFAULT_BLOCK2, chunk: int = _CHUNK2):
    """Lower Cholesky factor of a float32 SPD matrix through K7 (CUDA) or
    its plain version (CPU); ``chunk`` sets only the padding quantum
    ``block * chunk``. Otherwise as :func:`fused_cholesky`."""
    return _fused(a, block, block * chunk, "fused_cholesky2", fused_cholesky2_kernel)
