"""Precision and device policy for the PyTorch port.

Two dtype tiers, chosen explicitly by every entry point (there is no global
x64 switch as in JAX):

- **f64** — the parity tier: golden values, CPU tests against the JAX
  package, and the canonical route.
- **f32** — the performance tier: the dense stress route on the card.

Float32 matrix products must be f32-faithful. On a TPU, single-pass bf16
products NaN'd the Cholesky of a real SIMM Gram (cond ~1e3); TF32 keeps the
same ~10-bit mantissa and carries the same hazard on the H100. So
:func:`pin_full_fp32` turns TF32 off for cuBLAS matmuls and cuDNN and sets
the float32 matmul precision to ``"highest"``. :func:`default_device` calls
it, so every entry point runs with these settings.

Devices: entry points run on ``cuda`` unless the caller asks for another
device (``device="cpu"``). Without a card and without such a request they
raise — nothing drops silently to the CPU.
"""

from __future__ import annotations

import torch

PARITY_DTYPE = torch.float64
PERF_DTYPE = torch.float32


def pin_full_fp32() -> None:
    """Disable TF32 everywhere and pin float32 matmuls to full precision."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def assert_full_fp32(who: str) -> None:
    """Raise unless float32 products are full FP32 (TF32 off): the check
    that ``who``'s entry points make before they compute."""
    if torch.backends.cuda.matmul.allow_tf32 or torch.get_float32_matmul_precision() != "highest":
        raise RuntimeError(
            f"{who} needs full-FP32 products: TF32 is on "
            "(ops.precision.pin_full_fp32 turns it off)"
        )


def default_device(device=None) -> torch.device:
    """The device an entry point runs on: ``device`` when given, else
    ``cuda``. Raises when ``cuda`` is wanted and no card is visible."""
    pin_full_fp32()
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible; pass device='cpu' (CLI: --device cpu) "
            "to run the port on the CPU"
        )
    return dev


def dtype_for(x64: bool) -> torch.dtype:
    """The parity dtype for ``x64`` runs, else the performance dtype."""
    return PARITY_DTYPE if x64 else PERF_DTYPE
