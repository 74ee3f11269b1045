"""Work counted from shapes, and the peaks of one NVIDIA H100 SXM.

The counts are what the shapes need, not what an implementation does, so
a later kernel doing the same work reads against the same count. The
bound arithmetic follows the port's kernel table (3.35 TB/s HBM; float32
products at the f32-faithful 3xTF32 ceiling).

Peaks (NVIDIA's data sheet, dense, at the 700 W limit): 495 TFLOP/s TF32 on
the tensor cores, of which an f32-faithful product (three TF32 products,
split operands) reaches a third, the float32 peak used here; 67 TFLOP/s
float32 outside the tensor cores, stated beside it and not used as a
bound; 67 TFLOP/s float64 on the tensor cores, the float64 peak; 3.35 TB/s.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 495e12 / 3.0, "float64": 67e12}
ITEMSIZE = {"float32": 4, "float64": 8}


def bound_seconds(flops: float = 0.0, nbytes: float = 0.0, dtype: str = "float32") -> float:
    """The least time the card could take: the larger of the two bounds."""
    return max(flops / PEAK_FLOPS[dtype], nbytes / HBM_BYTES_PER_S)


def gram_bytes(rows: int, cols: int, dtype: str = "float32") -> float:
    """A Gram written once (or its cotangent read once)."""
    return float(ITEMSIZE[dtype] * rows * cols)


def train_step_flops(n: int) -> float:
    """One exact-MLL Adam step: the factor n^3/3, L^-1 n^3/3, Sigma^-1
    n^3/3, and the two solves of the residual 2 n^2."""
    return n**3 + 2.0 * n * n


def predict_flops(n: int, m: int) -> float:
    """One expression posterior at m test rows: the factor n^3/3, the
    solve pair on m columns 2 n^2 m, the covariance product 2 m^2 n, and
    the mean 2 n m."""
    return n**3 / 3.0 + 2.0 * n * n * m + 2.0 * m * m * n + 2.0 * n * m
