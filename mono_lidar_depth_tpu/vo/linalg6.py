"""Closed-form small-system solvers for the VO hot path.

`jnp.linalg.solve` on a [6, 6] system lowers to an LU library call, a
launch of its own per solve — the pose Gauss-Newton loop makes ~17
such calls per frame, so launch latency would dominate the whole
estimator.  A 6x6 SPD system splits into 3x3 blocks

    [[A, B], [Bt, C]] [x1, x2] = [g1, g2]

and solves in closed form via two adjugate 3x3 inverses and a Schur
complement — ~20 tiny fused vector HLOs, no custom call.

Every product here is precision-pinned to exact f32: the Schur
complement M = C - Bᵀ A⁻¹ B cancels strongly for monocular pose
Hessians (large trans/rot coupling at f ≈ 240), and reduced-precision
(bf16- or TF32-input) matmuls corrupt the GN step direction enough that
the solve stops converging on frames where exact f32 converges.  The
matrices are 3x3; pinning costs nothing.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_HI = jax.lax.Precision.HIGHEST


def _mm(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    return jnp.matmul(a, b, precision=_HI)


def inv3(M: jnp.ndarray) -> jnp.ndarray:
    """Closed-form inverse of a single 3x3 (adjugate / determinant)."""
    a, b, c = M[0, 0], M[0, 1], M[0, 2]
    d, e, f = M[1, 0], M[1, 1], M[1, 2]
    g, h, i = M[2, 0], M[2, 1], M[2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    inv_det = 1.0 / det
    adj = jnp.array([
        [A, -(b * i - c * h), b * f - c * e],
        [B, a * i - c * g, -(a * f - c * d)],
        [C, -(a * h - b * g), a * e - b * d],
    ])
    return adj * inv_det


def inv6_spd(H: jnp.ndarray) -> jnp.ndarray:
    """Closed-form inverse of a symmetric positive-definite [6, 6] via
    the same 3x3 block Schur structure as solve6_spd:

        H = [[A, B], [Bt, C]]
        H^-1 = [[Ai + AiB Mi AiB^T, -AiB Mi], [-(AiB Mi)^T, Mi]]

    with M = C - B^T A^-1 B.  Used where the full inverse (not just one
    solve) is needed — e.g. the pose-graph chain preconditioner stores
    S_k^-1 for reuse across many CG applications."""
    A = H[:3, :3]
    B = H[:3, 3:]
    C = H[3:, 3:]
    Ai = inv3(A)
    AiB = _mm(Ai, B)
    M = C - _mm(B.T, AiB)
    Mi = inv3(M)
    AiBMi = _mm(AiB, Mi)
    top_left = Ai + _mm(AiBMi, AiB.T)
    return jnp.block([[top_left, -AiBMi], [-AiBMi.T, Mi]])


def solve6_spd(H: jnp.ndarray, g: jnp.ndarray) -> jnp.ndarray:
    """Solve H x = g for symmetric positive-definite H [6, 6] via the
    3x3 block Schur complement.  H must be well-conditioned enough for
    the 3x3 closed-form inverses (the GN callers damp the diagonal)."""
    A = H[:3, :3]
    B = H[:3, 3:]
    C = H[3:, 3:]
    g1 = g[:3]
    g2 = g[3:]
    Ai = inv3(A)
    AiB = _mm(Ai, B)
    M = C - _mm(B.T, AiB)
    Mi = inv3(M)
    Aig1 = _mm(Ai, g1[:, None])[:, 0]
    x2 = _mm(Mi, (g2 - _mm(B.T, Aig1[:, None])[:, 0])[:, None])[:, 0]
    x1 = Aig1 - _mm(AiB, x2[:, None])[:, 0]
    return jnp.concatenate([x1, x2])
