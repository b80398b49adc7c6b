"""Gauss-Newton 3D→2D pose estimation with robust weights.

The per-frame motion estimator of the VO layer: given landmarks in the
reference (previous-keyframe) camera frame and their observations in
the current image, solve for the rigid transform ref→cur minimizing
Huber-robust reprojection error.  Everything is batched over the N
observations; the normal equations are a single 6x6 solve per
iteration inside a lax.fori_loop — one jitted program regardless of N.

With lidar depth priors attached to landmarks (the whole point of the
LIMO pipeline) an optional depth residual term constrains scale.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..core.geometry import PinholeCamera
from .lie import se3_exp
from .linalg6 import solve6_spd
from ..precision import HI, f32_matmuls


class PoseEstimate(NamedTuple):
    rotation: jnp.ndarray  # [3, 3] ref→cur
    translation: jnp.ndarray  # [3]
    inliers: jnp.ndarray  # [N] final inlier mask
    mean_error: jnp.ndarray  # scalar mean reprojection error of inliers
    num_inliers: jnp.ndarray
    # [6, 6] final Gauss-Newton Hessian J^T W J at the solution, in the
    # left-perturbation coords [rho (3), phi (3)] (px^2/m^2, px^2/rad^2
    # diag blocks).  Cov ~= mean_error^2 * H^-1 — the measurement
    # information used to weight loop-closure edges in the pose graph
    # (translation is often weakly observed at wide closure baselines
    # while rotation is strong; a scalar edge weight cannot express
    # that).
    hessian: jnp.ndarray


@partial(jax.jit, static_argnames=("camera", "iters", "huber_px",
                                   "outlier_px", "min_depth"))
@f32_matmuls
def estimate_pose_gn(
    camera: PinholeCamera,
    landmarks_ref: jnp.ndarray,
    obs_uv: jnp.ndarray,
    valid: jnp.ndarray,
    R_init: jnp.ndarray | None = None,
    t_init: jnp.ndarray | None = None,
    iters: int = 10,
    huber_px: float = 3.0,
    outlier_px: float = 6.0,
    min_depth: float = 0.25,
) -> PoseEstimate:
    """Estimate the transform T such that x_cur = T(x_ref).

    Args:
      landmarks_ref: [N, 3] 3D points in the reference camera frame.
      obs_uv: [N, 2] their pixel observations in the current frame.
      valid: [N] mask.
      R_init/t_init: warm start (e.g. previous frame's motion).
    """
    N = landmarks_ref.shape[0]
    f = camera.focal_length
    if R_init is None:
        R_init = jnp.eye(3, dtype=jnp.float32)
    if t_init is None:
        t_init = jnp.zeros(3, dtype=jnp.float32)

    # N-minor layout throughout: p [3, N], J [2, 6, N] — the feature
    # axis stays contiguous (same layout as vo/ba.py).
    X_t = landmarks_ref.T  # [3, N]

    def residuals_and_jac(R, t):
        p = jnp.matmul(R, X_t, precision=HI) + t[:, None]  # [3, N]
        z = jnp.maximum(p[2], min_depth)
        inv_z = 1.0 / z
        u = f * p[0] * inv_z + camera.cx
        v = f * p[1] * inv_z + camera.cy
        r = jnp.stack([u - obs_uv[:, 0], v - obs_uv[:, 1]], axis=0)  # [2,N]
        x, y = p[0], p[1]
        xiz = x * inv_z
        yiz = y * inv_z
        fiz = f * inv_z
        zero = jnp.zeros_like(fiz)
        # rows of Jp @ [I | -hat(p)] (left-perturbation exp(xi) ∘ T),
        # same closed form as vo/ba.py _jacobians_lanes
        Ju = jnp.stack([fiz, zero, -fiz * xiz,
                        -f * xiz * yiz, f * (1.0 + xiz * xiz), -f * yiz], 0)
        Jv = jnp.stack([zero, fiz, -fiz * yiz,
                        -f * (1.0 + yiz * yiz), f * xiz * yiz, f * xiz], 0)
        J = jnp.stack([Ju, Jv], axis=0)  # [2, 6, N]
        behind = p[2] <= min_depth
        return r, J, behind

    def make_step(sel_mask):
        def step(_, state):
            R, t = state
            r, J, behind = residuals_and_jac(R, t)
            err = jnp.sqrt(jnp.sum(r * r, axis=0) + 1e-18)
            w_h = jnp.where(err <= huber_px, 1.0,
                            huber_px / jnp.maximum(err, 1e-9))
            w = jnp.where(sel_mask & ~behind, w_h, 0.0)[None, None, :]
            # broadcast-reduce: exact f32 without the multi-pass cost of
            # precision-pinned skinny einsums (same rationale as
            # vo/ba.py); the gradient sets the GN fixed point (g == 0)
            Jw = J * w
            H = jnp.sum(Jw[:, :, None, :] * J[:, None, :, :], axis=(0, 3))
            g = jnp.sum(Jw * r[:, None, :], axis=(0, 2))
            H = H + 1e-6 * jnp.eye(6, dtype=H.dtype)
            # closed-form block solve: ~17 jnp.linalg.solve custom
            # calls per frame cost ~80 us of launch latency EACH
            dx = -solve6_spd(H, g)
            dR, dt = se3_exp(dx)
            return (jnp.matmul(dR, R, precision=HI),
                    jnp.matmul(dR, t[..., None],
                               precision=HI)[..., 0] + dt)
        return step

    R, t = jax.lax.fori_loop(0, iters, make_step(valid), (R_init, t_init))

    # Second stage: hard-reject outliers of the first fit and refit —
    # IRLS alone still lets gross outliers bias the solution through
    # their bounded-but-nonzero Huber weight.
    r, _, behind = residuals_and_jac(R, t)
    err = jnp.sqrt(jnp.sum(r * r, axis=0) + 1e-18)
    stage2_valid = valid & ~behind & (err < outlier_px)
    enough = jnp.sum(stage2_valid) >= 6

    R2, t2 = jax.lax.fori_loop(0, max(iters // 2, 3),
                               make_step(stage2_valid), (R, t))
    R = jnp.where(enough, R2, R)
    t = jnp.where(enough, t2, t)

    r, J, behind = residuals_and_jac(R, t)
    err = jnp.sqrt(jnp.sum(r * r, axis=0) + 1e-18)
    inliers = valid & ~behind & (err < outlier_px)
    n_in = jnp.sum(inliers)
    mean_err = jnp.sum(jnp.where(inliers, err, 0.0)) / jnp.maximum(n_in, 1)
    w_fin = jnp.where(inliers, 1.0, 0.0)[None, None, :]
    Jw = J * w_fin
    H_fin = jnp.sum(Jw[:, :, None, :] * J[:, None, :, :], axis=(0, 3))
    return PoseEstimate(rotation=R, translation=t, inliers=inliers,
                        mean_error=mean_err, num_inliers=n_in,
                        hessian=H_fin)
