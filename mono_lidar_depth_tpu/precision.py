"""Matmul-precision control for precision-critical stages.

On an NVIDIA H100, XLA may run float32 matmuls, einsums and
convolutions at default precision in TF32: float32 range with a 10-bit
mantissa, about 1e-3 relative error per product.  The depth-association
decisions have quantization margins, but the VO/BA/pose-graph geometry
does not: `p = R @ X` at 40 m with 1e-3 error is ~4 cm ≈ 0.7 px of
reprojection noise, and the Schur complements of the pose and BA
solves cancel large terms.  Every traced
stage is therefore pinned to full f32, either as a whole
(`f32_matmuls`) or per operation (`precision=HI`).  The contractions
are tiny ([3,3]x[3,N], [12,2048]-class), so the pin costs nothing
measurable.
"""

from __future__ import annotations

import functools

import jax


def f32_matmuls(fn):
    """Trace `fn` under jax.default_matmul_precision('float32')."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with jax.default_matmul_precision("float32"):
            return fn(*args, **kwargs)

    return wrapped


# Per-op pin for the residual-critical tiny matmuls (projections,
# rotation compositions) in code that is not traced under `f32_matmuls`
# as a whole.  Hessian/gradient terms are elementwise broadcast-reduce
# sums, exact f32 by construction (see vo/ba.py).
HI = jax.lax.Precision.HIGHEST
