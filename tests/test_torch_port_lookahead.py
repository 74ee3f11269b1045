"""K7's ticket order held to the JAX package on the CPU.

K7 (``csrc/chol_fused.cu::fused_chol2_kernel``) reads the tile each ticket
names from an index table, the card's form of the Pallas kernel's
scalar-prefetched ``kidx``/``iidx`` (``pallas_cholesky_fused.py``), and the
wrapper passes a look-ahead order (``cuda_cholesky_fused.tile_order``). On
the TPU the order is what makes the sequential grid correct; on the card it
is only a schedule, and any order in which every tile a tile reads comes
earlier gives the same factor. The tests pin that: every order is a legal
permutation of the active tiles, depth 0 is the JAX order exactly and the
deepest is row order, and a Python run of the tile program in ticket order gives the same factor
bitwise under the look-ahead and the JAX order (the kernel's own bitwise
check runs on the card, in ``chip_smoke.py``).
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dis_project_tpu.ops import pallas_cholesky_fused as pcf
from dis_project_tpu_torch.ops import cuda_cholesky_fused as cf

from test_torch_port_blocked import _real_sigma

DEPTHS = [0, 1, 2, 4, 8, "nb"]


def _depth(d, nb):
    return nb if d == "nb" else d


def _jax_order(nb, monkeypatch):
    """The (k, i) lists the JAX package's ``fused_cholesky2`` hands its
    kernel as ``kidx``/``iidx`` for nb tiles: its pallas_call is replaced by
    a recorder, so the lists come from the JAX code itself."""
    seen = {}

    def pallas_call(*args, **kwargs):
        def run(kidx, iidx, A):
            seen["order"] = list(zip(np.asarray(kidx).tolist(), np.asarray(iidx).tolist()))
            return (A,) * 3
        return run

    pl = types.SimpleNamespace(**{k: getattr(pcf.pl, k) for k in dir(pcf.pl)
                                  if not k.startswith("__")})
    pl.pallas_call = pallas_call
    monkeypatch.setattr(pcf, "pl", pl)
    block = 8
    pcf.fused_cholesky2.__wrapped__(np.eye(nb * block, dtype=np.float32), block=block,
                                    chunk=1)
    return seen["order"]


@pytest.mark.parametrize("d", DEPTHS)
def test_tile_order_is_legal(d):
    """nb = 1..40: a permutation of the active tiles in which every tile
    that (k, i) reads, (j, i) and (j, k) for j < k and (k, k) for i > k,
    has a smaller ticket."""
    for nb in range(1, 41):
        order = cf.tile_order(nb, _depth(d, nb))
        assert sorted(order) == [(k, i) for k in range(nb) for i in range(k, nb)]
        ticket = {t: n for n, t in enumerate(order)}
        for (k, i), t in ticket.items():
            for j in range(k):
                assert ticket[(j, i)] < t and ticket[(j, k)] < t, (nb, d, k, i, j)
            if i > k:
                assert ticket[(k, k)] < t, (nb, d, k, i)


def test_tile_order_ends(monkeypatch):
    """nb = 2..40: depth 0 (and 1, which hoists nothing) is exactly the
    Pallas kernel's ``kidx`` / ``iidx`` order (nb = 1 never reaches the
    kernel there); depth nb - 1 and deeper is row order."""
    assert cf.tile_order(1, 0) == [(0, 0)]
    for nb in range(2, 41):
        jax_order = _jax_order(nb, monkeypatch)
        assert cf.tile_order(nb, 0) == cf.tile_order(nb, 1) == jax_order, nb
        rows = sorted(jax_order, key=lambda t: (t[1], t[0]))
        for depth in (nb - 1, nb, nb + 5):
            assert cf.tile_order(nb, depth) == rows, (nb, depth)


def test_tile_order_refuses_negative_depth():
    with pytest.raises(ValueError, match="depth"):
        cf.tile_order(4, -1)


@pytest.fixture(scope="module")
def sigma512():
    return torch.as_tensor(_real_sigma(512, seed=5).astype(np.float32))


@pytest.mark.parametrize("d", [2, 3])
def test_tile_program_same_bitwise_in_every_order(sigma512, d):
    """A real Σ, n = 512, B = 128 (nb = 4): the tile program run one tile
    at a time in ticket order gives the same factor bitwise under each
    look-ahead order as under the JAX order (depth 0); a tile handed out
    before one it reads would change it (checked with each column's tiles
    reversed)."""
    ref = cf._tile_program_mirror(sigma512, 128, cf.tile_order(4, 0))
    got = cf._tile_program_mirror(sigma512, 128, cf.tile_order(4, d))
    assert torch.equal(got, ref)
    illegal = sorted(cf.tile_order(4, 0), key=lambda t: (t[0], -t[1]))
    assert not torch.equal(cf._tile_program_mirror(sigma512, 128, illegal), ref)


def test_tile_program_matches_fused_mirror(sigma512):
    """The tile program in the look-ahead order against
    ``_fused_cholesky_mirror`` (the same tiles, each column's products
    batched, so not bitwise) at the mirror tests' bound for L (rtol and
    atol 1e-4), finite and exactly lower."""
    got = cf._tile_program_mirror(sigma512, 128, cf.tile_order(4, cf._LOOKAHEAD))
    ref = cf._fused_cholesky_mirror(sigma512, 128)
    assert torch.isfinite(got).all() and torch.equal(got, torch.tril(got))
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)
