"""The hoisted arithmetic of K2 and K2's backward, and the dense route's
Gram choice, held to the JAX package on the CPU.

``cuda_gram.gram_sym_hoisted`` writes out in PyTorch what the CUDA kernels
``gram_sym_kernel`` and ``gram_sym_bwd_kernel`` compute: the one-index
terms once per row, the per-entry terms, and the reverse-mode adjoints
derived by hand. Here it is held in float64 to JAX's closed form
(``ops.gram.cross_covariance_kind``) and to ``jax.vjp`` of it; the kernels
are held to it and to the plain closed form on the card by
``chip_smoke.py``. The port's ``ExactSIMM.mll_gridded`` is held to JAX's,
and ``main.run_dense`` picks the row Gram only on the card in float32, as
the JAX package does only on its accelerator. Inputs are made with numpy
from a seed and handed to both packages.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dis_project_tpu.models import simm as jsimm
from dis_project_tpu.ops import gram as jgram
from dis_project_tpu_torch import convert
from dis_project_tpu_torch import config as tcfg
from dis_project_tpu_torch import main as tmain
from dis_project_tpu_torch.models import simm
from dis_project_tpu_torch.ops import cuda_gram
from dis_project_tpu_torch.training import generic

G = 5
F64 = torch.float64


def _rows(rng, n, kind, genes=(0, G + 1)):
    """(n, 3) rows over [0, 12] of the kind's population; expression rows
    draw genes from ``genes`` (G is out of range and must clamp to G-1),
    force rows carry gene -1."""
    t = rng.uniform(0, 12, n)
    f = {"xx": np.ones(n), "ff": np.zeros(n), "mixed": rng.integers(0, 2, n)}[kind]
    g = np.where(f == 1, rng.integers(*genes, n), -1)
    return np.stack([t, g, f], axis=1).astype(np.float64)


def _kinetics(rng):
    return rng.uniform(0.2, 1.0, G), rng.uniform(0.5, 1.5, G), np.float64(1.7)


@functools.lru_cache(maxsize=None)
def _case(kind, n=70, genes=(0, G + 1)):
    rng = np.random.default_rng(7 + n)
    x, (d, s, l) = _rows(rng, n, kind, genes), _kinetics(rng)
    return x, d, s, l, rng.standard_normal((n, n))


@functools.partial(jax.jit, static_argnames="kind")
def _jax_vjp(x, d, s, l, g, kind):
    K, vjp = jax.vjp(lambda d, s, l: jgram.cross_covariance_kind(x, x, d, s, l, kind=kind),
                     d, s, l)
    return K, vjp(g)


@functools.lru_cache(maxsize=None)
def _jax_ref(kind, genes=(0, G + 1)):
    """JAX's closed form and its VJP against the case's cotangent."""
    K, grads = _jax_vjp(*(jnp.asarray(a) for a in _case(kind, genes=genes)), kind=kind)
    return np.asarray(K), [np.asarray(r) for r in grads]


def _port(*arrays):
    return [torch.as_tensor(np.asarray(a), dtype=F64) for a in arrays]


# ---------------------------------------------------------------------------
# (a) The hoisted forward against JAX's closed form, f64 at 1e-12 (as the
# plain closed forms agree in tests/test_torch_port_kernels.py), on N = 70
# rows: ragged against the kernels' 64-row tiles and 4-wide blocks.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", list(cuda_gram.SYM_KINDS))
def test_hoisted_gram_matches_jax_closed_form(kind):
    x, d, s, l, _ = _case(kind)
    got = cuda_gram.gram_sym_hoisted(*_port(x, d, s, l), kind)
    assert torch.equal(got, got.T)
    np.testing.assert_allclose(got.numpy(), _jax_ref(kind)[0], rtol=1e-12, atol=1e-12)


# ---------------------------------------------------------------------------
# (b) The hand-derived adjoints against jax.vjp of the same closed form, f64
# at 1e-10 relative to each group's largest entry, on a non-symmetric
# cotangent (the MLL backward hands over a lower-triangle form).
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", list(cuda_gram.SYM_KINDS))
def test_hoisted_adjoints_match_jax_vjp(kind):
    x, d, s, l, g = _case(kind)
    K, got = cuda_gram.gram_sym_hoisted(*_port(x, d, s, l), kind, torch.as_tensor(g))
    assert K.shape == (70, 70) and got[2].shape == ()
    for name, gt, r in zip(("decay", "sens", "lengthscale"), got, _jax_ref(kind)[1]):
        scale = max(np.abs(r).max(), 1e-300)
        np.testing.assert_allclose(gt.numpy(), r, rtol=0, atol=1e-10 * scale, err_msg=name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_hoisted_adjoints_credit_no_gene_for_force_rows(dtype):
    """'mixed' rows whose expression rows avoid gene 0: force rows carry
    gene -1, which the gathers clamp to 0, yet gene 0's decay and
    sensitivity gradients are exactly 0 (JAX's are 0 too: its force-row
    terms carry zero weights), and every other gene's are not."""
    x, d, s, l, g = _case("mixed", genes=(1, G + 1))
    ref = _jax_ref("mixed", genes=(1, G + 1))[1]
    _, (gd, gs, _) = cuda_gram.gram_sym_hoisted(
        *(t.to(dtype) for t in _port(x, d, s, l)), "mixed", torch.as_tensor(g, dtype=dtype))
    assert ref[0][0] == 0 and ref[1][0] == 0
    assert gd[0] == 0 and gs[0] == 0
    assert torch.all(gd[1:] != 0) and torch.all(gs[1:] != 0)


def test_hoisted_matches_the_port_plain_versions_in_float32():
    """Against the port's own plain K2 and plain VJP, in float32 on the
    CPU: the forward within 5e-5 absolute (chip_smoke.py's kernel limit),
    the gradient per group no further from the f64 plain VJP than twice
    the f32 plain VJP is."""
    x, d, s, l, g = _case("xx")
    args32 = [t.float() for t in _port(x, d, s, l)]
    K, got = cuda_gram.gram_sym_hoisted(*args32, "xx", torch.as_tensor(g).float())
    plain = cuda_gram.gram_sym_plain(*args32, "xx")
    assert float((K - plain).abs().max()) <= 5e-5
    needs = (False, True, True, True)
    ref = cuda_gram.gram_sym_vjp_plain(*_port(x, d, s, l), "xx", torch.as_tensor(g), needs)[1:]
    p32 = cuda_gram.gram_sym_vjp_plain(*args32, "xx", torch.as_tensor(g).float(), needs)[1:]
    for name, gt, r, p in zip(("decay", "sens", "lengthscale"), got, ref, p32):
        m = float(r.abs().max())
        e_hoisted = float((gt.double() - r).abs().max()) / m
        e_plain = float((p.double() - r).abs().max()) / m
        assert e_hoisted <= 2 * e_plain, (name, e_hoisted, e_plain)


# ---------------------------------------------------------------------------
# (c) F2: the gridded MLL and the dense route's Gram choice.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("replicates", [1, 3])
def test_mll_gridded_matches_jax(replicates):
    """Value and raw-parameter gradients of ``mll_gridded`` at perturbed
    parameters, f64 at 1e-10, on a uniform grid of 9 times."""
    rng = np.random.default_rng(replicates)
    genes, T = 4, 9
    t = np.linspace(0.0, 12.0, T)
    y = rng.standard_normal(replicates * genes * T)
    p = jsimm.init_params(genes)
    p = p._replace(decay=p.decay * jnp.asarray(rng.uniform(0.7, 1.5, genes)),
                   sensitivity=p.sensitivity * jnp.asarray(rng.uniform(0.8, 1.2, genes)),
                   lengthscale=jnp.asarray(1.7), obs_stddev=jnp.asarray(0.3))
    raw = jsimm.unconstrain(p)
    jmodel = jsimm.ExactSIMM(num_genes=genes, jitter=1e-4)
    ref_v, ref_g = jax.jit(jax.value_and_grad(lambda r: jmodel.mll_gridded(
        jsimm.constrain(r), jnp.asarray(t), jnp.asarray(y), replicates)))(raw)
    tmodel = simm.ExactSIMM(num_genes=genes, jitter=1e-4)
    traw = convert.params_from_numpy({k: np.asarray(v) for k, v in raw._asdict().items()},
                                     device="cpu")
    tt, ty = torch.as_tensor(t), torch.as_tensor(y)
    got_v, got_g = generic.value_and_grad(
        lambda r: tmodel.mll_gridded(simm.constrain(r), tt, ty, replicates), traw)
    assert float(got_v) == pytest.approx(float(ref_v), rel=1e-10)
    for name in got_g._fields:
        np.testing.assert_allclose(getattr(got_g, name).numpy(), np.asarray(getattr(ref_g, name)),
                                   rtol=1e-10, atol=1e-12, err_msg=name)


@pytest.mark.parametrize("device, dtype, route", [
    ("cuda", torch.float32, "row"),
    ("cuda", torch.float64, "gridded"),
    ("cpu", torch.float32, "gridded"),
    ("cpu", torch.float64, "gridded"),
])
def test_dense_gram_route_follows_device_and_dtype(device, dtype, route):
    """Decided from the device and dtype alone; no card is needed."""
    assert tmain.dense_gram(torch.device(device), dtype) == route
    assert tmain.dense_gram(device, dtype) == route


@pytest.mark.parametrize("x64", [False, True])
def test_run_dense_on_the_cpu_trains_through_the_gridded_gram(x64, monkeypatch, capsys):
    """On the CPU, run_dense never calls the row objective ``ExactSIMM.mll``
    and says which Gram it uses."""
    def row_objective(*_):
        raise AssertionError("run_dense took the row Gram on the CPU")

    monkeypatch.setattr(simm.ExactSIMM, "mll", row_objective)
    out = tmain.run_dense(tcfg.RunConfig(preset="dense10k", synth_genes=3, synth_timepoints=8,
                                         num_iters=2, x64=x64, device="cpu"))
    assert "gridded Gram" in capsys.readouterr().out
    assert np.all(np.isfinite(out.result.history.numpy()))
