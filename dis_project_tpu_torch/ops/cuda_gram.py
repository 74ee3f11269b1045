"""SIMM covariance kernels K1 (rectangular) and K2 (symmetric), K2's
backward kernel, and their plain PyTorch versions.

Port of ``dis_project_tpu/ops/pallas_gram.py``:

- :func:`cross_covariance` — K1, ``csrc/simm_gram.cu::gram_rect_kernel``,
  replacing ``pallas_gram.py::_gram_kernel``: the dense (N, M) covariance.
- :func:`gram_sym` — K2, ``csrc/simm_gram.cu::gram_sym_kernel``, replacing
  ``pallas_gram.py::_gram_sym_kernel``: the square Gram over lower-triangle
  tiles only, each off-diagonal tile mirrored by a transposed second write.
- K2's gradient — ``csrc/simm_gram.cu::gram_sym_bwd_kernel``
  (:func:`gram_sym_bwd_kernel`), replacing the XLA fusion of
  ``pallas_gram.py::_gram_sym_bwd``: the gradient with respect to decay,
  sensitivity and lengthscale over the same lower tiles, reading both
  triangles of the (not necessarily symmetric) cotangent.

All take (t, gene, flag) rows, pack per-row ``[t, decay, sens, flag]``
metadata (gene indices clamped, as ``ops.gram`` does) and evaluate the
closed form of ``kind`` ∈ {'xx', 'ff', 'xf', 'fx', 'mixed'}.

Dispatch: on a CUDA tensor the wrapper launches the kernel (float32 or
float64) or raises; on a CPU tensor it takes the plain version — never a
fallback from one to the other. Each launch adds one to ``LAUNCHES``.

Gradients: ``torch.autograd.Function``s. K1's backward differentiates the
plain ``ops.gram.cross_covariance_kind`` closed form, as the JAX package's
``_ccov_bwd`` does. K2's backward launches ``gram_sym_bwd_kernel`` on a
CUDA tensor; the gradient with respect to the rows ``x`` (which no main
path asks for) is the plain VJP, counted in ``PLAIN_X_GRADS``. Flag
columns carry no gradient under a declared kind.
"""

from __future__ import annotations

import ctypes

import torch

from dis_project_tpu_torch.ops import cuda_build
from dis_project_tpu_torch.ops import gram as gram_ops

KIND_CODES = {"xx": 0, "ff": 1, "xf": 2, "fx": 3, "mixed": 4}
# A square Gram is a covariance only for these populations; 'xf'/'fx' on one
# row set is not symmetric, and the JAX kernel's answer for it depends on its
# tile size (diagonal tiles are computed whole, off-diagonal ones mirrored).
SYM_KINDS = ("xx", "ff", "mixed")

# Plain-integer launch counters, one per kernel.
LAUNCHES = {"gram_rect": 0, "gram_sym": 0, "gram_sym_bwd": 0}
# Plain VJPs that K2's backward runs on a CUDA tensor for the gradient with
# respect to the rows x (the kernel gives decay, sens and lengthscale only).
PLAIN_X_GRADS = {"gram_sym_x": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {
    "simm_gram_rect_f32": [_P, _I, _P, _I, _P, _P, _I, _P],
    "simm_gram_rect_f64": [_P, _I, _P, _I, _P, _P, _I, _P],
    "simm_gram_sym_f32": [_P, _I, _P, _P, _I, _P],
    "simm_gram_sym_f64": [_P, _I, _P, _P, _I, _P],
    # (meta, gene, n, G, ell, g, grad, kind, stream)
    "simm_gram_sym_bwd_f32": [_P, _P, _I, _I, _P, _P, _P, _I, _P],
    "simm_gram_sym_bwd_f64": [_P, _P, _I, _I, _P, _P, _P, _I, _P],
}
# Largest dynamic shared memory of the backward's 2G+1 float64 bins.
_BWD_BINS_MAX_BYTES = 160 * 1024
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def pack_meta(x, decay, sens):
    """(N, 3) rows -> contiguous (4, N) ``[t, decay, sens, flag]``."""
    t, g, f = gram_ops.split_rows(x)
    return torch.stack(
        [t, gram_ops._gather(decay, g), gram_ops._gather(sens, g), f]
    ).contiguous()


def _check_cuda_inputs(xs, decay, sens, lengthscale, kind):
    tensors = (*xs, decay, sens, lengthscale)
    dev = xs[0].device
    dtype = xs[0].dtype
    if dev.type != "cuda":
        raise ValueError(f"SIMM Gram kernel runs on CUDA tensors, not {dev}")
    for a in tensors:
        if a.device != dev:
            raise ValueError(f"SIMM Gram kernel: tensors on {a.device} and {dev}")
        if a.dtype != dtype:
            raise ValueError(f"SIMM Gram kernel: dtypes {a.dtype} and {dtype} differ")
    if dtype not in _SUFFIX:
        raise TypeError(f"SIMM Gram kernel takes float32 or float64, not {dtype}")
    for x in xs:
        if x.dim() != 2 or x.shape[1] != 3:
            raise ValueError(f"rows must be (N, 3), got {tuple(x.shape)}")
    if decay.dim() != 1 or sens.shape != decay.shape:
        raise ValueError("decay and sens must be matching (G,) vectors")
    if lengthscale.numel() != 1:
        raise ValueError("lengthscale must be a scalar")
    if kind not in KIND_CODES:
        raise ValueError(f"unknown kind {kind!r}")
    return dev, dtype


def gram_rect_kernel(x1, x2, decay, sens, lengthscale, kind="mixed"):
    """Launch K1 on CUDA tensors: the (N, M) covariance."""
    dev, dtype = _check_cuda_inputs((x1, x2), decay, sens, lengthscale, kind)
    m1 = pack_meta(x1, decay, sens)
    m2 = pack_meta(x2, decay, sens)
    ell = lengthscale.reshape(1).contiguous()
    n, m = x1.shape[0], x2.shape[0]
    out = torch.empty((n, m), dtype=dtype, device=dev)
    lib = cuda_build.load("simm_gram", SIGNATURES)
    fn = getattr(lib, f"simm_gram_rect_{_SUFFIX[dtype]}")
    with torch.cuda.device(dev):
        code = fn(m1.data_ptr(), n, m2.data_ptr(), m, ell.data_ptr(),
                  out.data_ptr(), KIND_CODES[kind], cuda_build.stream_handle(dev))
    LAUNCHES["gram_rect"] += 1
    cuda_build.check(code, "simm_gram_rect")
    return out


def _check_sym_kind(kind):
    if kind not in SYM_KINDS:
        raise ValueError(f"a square Gram takes kind in {SYM_KINDS}, not {kind!r}")


def gram_sym_kernel(x, decay, sens, lengthscale, kind="mixed"):
    """Launch K2 on CUDA tensors: the (N, N) Gram from its lower triangle."""
    _check_sym_kind(kind)
    dev, dtype = _check_cuda_inputs((x,), decay, sens, lengthscale, kind)
    meta = pack_meta(x, decay, sens)
    ell = lengthscale.reshape(1).contiguous()
    n = x.shape[0]
    out = torch.empty((n, n), dtype=dtype, device=dev)
    lib = cuda_build.load("simm_gram", SIGNATURES)
    fn = getattr(lib, f"simm_gram_sym_{_SUFFIX[dtype]}")
    with torch.cuda.device(dev):
        code = fn(meta.data_ptr(), n, ell.data_ptr(), out.data_ptr(),
                  KIND_CODES[kind], cuda_build.stream_handle(dev))
    LAUNCHES["gram_sym"] += 1
    cuda_build.check(code, "simm_gram_sym")
    return out


def gram_sym_plain(x, decay, sens, lengthscale, kind="mixed"):
    """Plain version of K2: the closed form's lower triangle, mirrored —
    exactly what the kernel writes."""
    _check_sym_kind(kind)
    K = gram_ops.cross_covariance_kind(x, x, decay, sens, lengthscale, kind)
    return torch.tril(K) + torch.tril(K, -1).T


def gram_sym_bwd_kernel(x, decay, sens, lengthscale, kind, g):
    """Launch K2's backward on CUDA tensors: the gradient of
    ``<g, gram_sym(x, decay, sens, lengthscale, kind)>`` with respect to
    ``decay`` (G,), ``sens`` (G,) and ``lengthscale`` (shaped like it), for
    an (N, N) cotangent ``g`` that need not be symmetric. Each entry's
    partials are in the working dtype, every sum in float64; the result
    comes back in the working dtype."""
    _check_sym_kind(kind)
    dev, dtype = _check_cuda_inputs((x,), decay, sens, lengthscale, kind)
    n, G = x.shape[0], decay.shape[0]
    if g.shape != (n, n):
        raise ValueError(f"cotangent must be ({n}, {n}), got {tuple(g.shape)}")
    if (2 * G + 1) * 8 > _BWD_BINS_MAX_BYTES:
        raise ValueError(f"K2 backward: {G} genes need more shared memory than a CTA has")
    meta = pack_meta(x, decay, sens)
    gene = x[:, 1].to(torch.int32).contiguous()  # unclamped; the kernel clamps
    ell = lengthscale.reshape(1).contiguous()
    g = g.to(dtype).contiguous()
    grad = torch.zeros(2 * G + 1, dtype=torch.float64, device=dev)
    lib = cuda_build.load("simm_gram", SIGNATURES)
    fn = getattr(lib, f"simm_gram_sym_bwd_{_SUFFIX[dtype]}")
    with torch.cuda.device(dev):
        code = fn(meta.data_ptr(), gene.data_ptr(), n, G, ell.data_ptr(), g.data_ptr(),
                  grad.data_ptr(), KIND_CODES[kind], cuda_build.stream_handle(dev))
    LAUNCHES["gram_sym_bwd"] += 1
    cuda_build.check(code, "simm_gram_sym_bwd")
    grad = grad.to(dtype)
    return grad[:G], grad[G:2 * G], grad[2 * G].reshape(lengthscale.shape)


def gram_sym_vjp_plain(x, decay, sens, lengthscale, kind, g, needs):
    """Plain version of K2's backward: the VJP of the closed form
    ``cross_covariance_kind(x, x, ...)`` against ``g`` for the inputs
    flagged in ``needs`` (x, decay, sens, lengthscale; None for the
    others), as the JAX package's ``_gram_sym_bwd`` takes it."""
    _check_sym_kind(kind)
    return plain_vjp(
        lambda x, d, s, l: gram_ops.cross_covariance_kind(x, x, d, s, l, kind),
        (x, decay, sens, lengthscale), needs, g,
    )


def plain_vjp(fn, inputs, needs_grad, grad_out):
    """Gradients of ``fn(*inputs)`` against ``grad_out`` for the inputs
    flagged in ``needs_grad`` (None for the others) — the backward of every
    kernel wrapper: differentiate the plain version."""
    with torch.enable_grad():
        leaves = [a.detach().requires_grad_(bool(nd)) for a, nd in zip(inputs, needs_grad)]
        out = fn(*leaves)
        wanted = [a for a, nd in zip(leaves, needs_grad) if nd]
        # An output that depends on none of them (k_ff and the kinetics)
        # has no graph: every gradient is None.
        grads = iter(torch.autograd.grad(
            out, wanted, grad_out.to(out.dtype), allow_unused=True
        ) if out.requires_grad else [None] * len(wanted))
    return tuple(next(grads) if nd else None for nd in needs_grad)


class _CrossCovariance(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x1, x2, decay, sens, lengthscale, kind):
        ctx.save_for_backward(x1, x2, decay, sens, lengthscale)
        ctx.kind = kind
        if x1.is_cuda:
            return gram_rect_kernel(x1, x2, decay, sens, lengthscale, kind)
        return gram_ops.cross_covariance_kind(x1, x2, decay, sens, lengthscale, kind)

    @staticmethod
    def backward(ctx, g):
        kind = ctx.kind
        grads = plain_vjp(
            lambda *a: gram_ops.cross_covariance_kind(*a, kind),
            ctx.saved_tensors, ctx.needs_input_grad[:5], g,
        )
        return (*grads, None)


class _GramSym(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, decay, sens, lengthscale, kind):
        ctx.save_for_backward(x, decay, sens, lengthscale)
        ctx.kind = kind
        if x.is_cuda:
            return gram_sym_kernel(x, decay, sens, lengthscale, kind)
        return gram_sym_plain(x, decay, sens, lengthscale, kind)

    @staticmethod
    def backward(ctx, g):
        x, decay, sens, lengthscale = ctx.saved_tensors
        needs = ctx.needs_input_grad[:4]
        if not x.is_cuda:
            grads = gram_sym_vjp_plain(x, decay, sens, lengthscale, ctx.kind, g, needs)
            return (*grads, None)
        gx = None
        if needs[0]:
            # The rows' gradient has no kernel: the plain VJP, counted.
            PLAIN_X_GRADS["gram_sym_x"] += 1
            gx = gram_sym_vjp_plain(x, decay, sens, lengthscale, ctx.kind, g,
                                    (True, False, False, False))[0]
        gd = gs = gl = None
        if any(needs[1:]):
            gd, gs, gl = gram_sym_bwd_kernel(x, decay, sens, lengthscale, ctx.kind, g)
        return (gx, gd if needs[1] else None, gs if needs[2] else None,
                gl if needs[3] else None, None)


def cross_covariance(x1, x2, decay, sens, lengthscale, kind="mixed"):
    """Dense (N, M) SIMM covariance (K1 on CUDA, plain on CPU);
    differentiable."""
    return _CrossCovariance.apply(x1, x2, decay, sens, lengthscale, kind)


def gram_sym(x, decay, sens, lengthscale, kind="mixed"):
    """Symmetric (N, N) SIMM Gram from lower-triangle tiles (K2 on CUDA,
    plain on CPU); exactly symmetric, differentiable."""
    return _GramSym.apply(x, decay, sens, lengthscale, kind)
