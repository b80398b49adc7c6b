"""Sliding-window bundle adjustment with depth priors (Schur form).

The keyframe BA backend of the VO layer (the north-star extension,
BASELINE.json; the reference repo produces this solver's INPUT —
depth-augmented tracklets — and feeds LIMO's external
keyframe_bundle_adjustment).

Structure: the observation set is a dense [K, L] grid (K keyframes ×
L landmark slots) with a mask — no sparse indexing, so every
Jacobian/Hessian contraction is a dense einsum or broadcast-reduce.
One Gauss-Newton iteration is:

  residuals:  reprojection [K, 2, L] + lidar depth prior [K, L]
  blocks:     Hpp [K,6,6], Hll [3,3,L], Hpl [K,6,3,L], gradients
  Schur:      S = Hpp ⊕ − W Hplᵀ with W = Hpl Hll⁻¹   (landmarks
              eliminated with a closed-form adjugate 3x3 inverse)
  solve:      dense [6K, 6K] system (K is the window size, ~5-10)
  back-sub:   dl = Hll⁻¹ (−bl − Hplᵀ dxi)

Memory layout: every per-landmark tensor keeps L as the MINOR
dimension — [K, 2, 6, L], [3, 3, L] — so the tiny (2, 6) and (3, 3)
factors never sit on the contiguous axis.  Contractions over (r, l) or
(m, l) reshape to a single big minor axis and run as one matmul per
block.  (Whether this layout or [K, L, 2, 6] suits the GPU better is
open until a profile judges it; tests/test_ba_layout.py pins the two
to each other.)

The same blocks are what the distributed version psums across devices
(landmarks sharded, reduced camera system replicated) — see dist/.

Conventions: poses are camera-from-world (p_cam = R p_world + t);
updates are left-multiplied se3 exponentials; pose 0 (or any subset)
can be gauge-fixed.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from .lie import se3_exp
from ..precision import HI


class BAProblem(NamedTuple):
    R: jnp.ndarray  # [K, 3, 3] camera-from-world rotations
    t: jnp.ndarray  # [K, 3]
    landmarks: jnp.ndarray  # [L, 3] world points
    obs_uv: jnp.ndarray  # [K, L, 2]
    obs_mask: jnp.ndarray  # [K, L]
    depth_prior: jnp.ndarray  # [K, L] lidar depth of landmark in cam k
    depth_mask: jnp.ndarray  # [K, L]
    fixed: jnp.ndarray  # [K] gauge-fixed poses (no update)
    lm_valid: jnp.ndarray  # [L] landmark slot in use


class BAResult(NamedTuple):
    problem: BAProblem
    initial_cost: jnp.ndarray
    final_cost: jnp.ndarray


def _residuals_lanes(camera, pb: BAProblem, min_depth=0.25):
    """Project all landmarks into all cameras, L-minor layout.

    Returns (r [K,2,L], p [K,3,L], inv_z [K,L], active [K,L],
             r_d [K,L], active_d [K,L]).
    """
    # [K, 3, L] = R @ X^T + t  — one [3,3]x[3,L] matmul per camera.
    p = jnp.einsum("kij,jl->kil", pb.R, pb.landmarks.T,
                  precision=HI) + pb.t[:, :, None]
    z = p[:, 2]
    behind = z <= min_depth
    inv_z = 1.0 / jnp.maximum(z, min_depth)
    f = camera.focal_length
    u = f * p[:, 0] * inv_z + camera.cx
    v = f * p[:, 1] * inv_z + camera.cy
    obs = jnp.swapaxes(pb.obs_uv, 1, 2)  # [K, 2, L]
    r = jnp.stack([u, v], axis=1) - obs
    active = pb.obs_mask & pb.lm_valid[None, :] & ~behind

    r_d = z - pb.depth_prior
    active_d = (pb.depth_mask & pb.obs_mask & pb.lm_valid[None, :]
                & (z > min_depth) & (pb.depth_prior > 0))
    return r, p, inv_z, active, r_d, active_d


def _jacobians_lanes(camera, pb: BAProblem, p, inv_z):
    """Reprojection + depth-prior Jacobians, L-minor layout.

    Jpose [K,2,6,L]: d(u,v)/d(se3 twist [t, w]), left-multiplied
      convention (standard projection Jacobian times [I | -hat(p)]).
    Jlm   [K,2,3,L]: d(u,v)/d(world point) = Jp @ R.
    Jpose_d [K,6,L], Jlm_d [K,3,L]: depth-residual rows (r_d = p_z - d).
    """
    f = camera.focal_length
    x, y = p[:, 0], p[:, 1]
    xiz = x * inv_z  # x/z
    yiz = y * inv_z
    fiz = f * inv_z
    zero = jnp.zeros_like(fiz)
    # rows of Jp @ [I | -hat(p)] written out (verified against the
    # einsum-built form; see tests/test_odometry.py ba parity fuzz):
    Ju = jnp.stack([fiz, zero, -fiz * xiz,
                    -f * xiz * yiz, f * (1.0 + xiz * xiz), -f * yiz], axis=1)
    Jv = jnp.stack([zero, fiz, -fiz * yiz,
                    -f * (1.0 + yiz * yiz), f * xiz * yiz, f * xiz], axis=1)
    Jpose = jnp.stack([Ju, Jv], axis=1)  # [K, 2, 6, L]

    # Jp [K,2,3,L] entries, then Jlm = einsum over the tiny i index.
    Jp = jnp.stack([
        jnp.stack([fiz, zero, -fiz * xiz], axis=1),
        jnp.stack([zero, fiz, -fiz * yiz], axis=1),
    ], axis=1)  # [K, 2, 3, L]
    Jlm = jnp.sum(Jp[:, :, :, None, :]
                  * pb.R[:, None, :, :, None], axis=2)  # [K, 2, 3, L]

    one = jnp.ones_like(x)
    Jpose_d = jnp.stack([zero, zero, one, y, -x, zero], axis=1)  # [K, 6, L]
    Jlm_d = pb.R[:, 2, :, None] * jnp.ones_like(x)[:, None, :]  # [K, 3, L]
    return Jpose, Jlm, Jpose_d, Jlm_d


def _inv3x3_lanes(H):
    """Closed-form inverse of [3, 3, L] matrices (adjugate / det) —
    pure elementwise lanes, no LAPACK, no batched-loop lowering."""
    a, b, c = H[0, 0], H[0, 1], H[0, 2]
    d, e, f_ = H[1, 0], H[1, 1], H[1, 2]
    g, h, i = H[2, 0], H[2, 1], H[2, 2]
    A = e * i - f_ * h
    B = -(d * i - f_ * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    inv_det = 1.0 / det
    adj = jnp.stack([
        jnp.stack([A, -(b * i - c * h), b * f_ - c * e], axis=0),
        jnp.stack([B, a * i - c * g, -(a * f_ - c * d)], axis=0),
        jnp.stack([C, -(a * h - b * g), a * e - b * d], axis=0),
    ], axis=0)
    return adj * inv_det


def _huber_w(err, delta):
    return jnp.where(err <= delta, 1.0, delta / jnp.maximum(err, 1e-9))


def ba_cost(camera, pb: BAProblem, huber_px: float = 2.0,
            depth_weight: float = 1.0, huber_depth: float = 0.5,
            axis_name: str | None = None) -> jnp.ndarray:
    r, _, _, active, r_d, active_d = _residuals_lanes(camera, pb)
    err = jnp.sqrt(jnp.sum(r * r, axis=1) + 1e-18)  # [K, L]
    c = jnp.sum(jnp.where(active, jnp.minimum(err, huber_px) *
                          (err - 0.5 * jnp.minimum(err, huber_px)), 0.0))
    ed = jnp.abs(r_d)
    c_d = jnp.sum(jnp.where(
        active_d, depth_weight * jnp.minimum(ed, huber_depth) *
        (ed - 0.5 * jnp.minimum(ed, huber_depth)), 0.0))
    total = c + c_d
    if axis_name is not None:
        total = jax.lax.psum(total, axis_name)
    return total


def ba_iteration(camera, pb: BAProblem, huber_px: float, depth_weight: float,
                 huber_depth: float, damping: float,
                 axis_name: str | None = None) -> BAProblem:
    """One damped Gauss-Newton iteration.

    When `axis_name` is given the landmark dimension is assumed SHARDED
    over that mesh axis: each device assembles blocks for its landmark
    shard and the reduced camera system (S, b_red — the only
    cross-landmark quantities) is psum'd, then solved replicated; the
    landmark back-substitution stays local.  This is the distributed
    Schur-complement reduction of the north-star design (BASELINE.json):
    per-device work scales with L/D, communication is O(K^2) only.
    """
    K = pb.R.shape[0]
    r, p, inv_z, active, r_d, active_d = _residuals_lanes(camera, pb)
    Jpose, Jlm, Jpose_d, Jlm_d = _jacobians_lanes(camera, pb, p, inv_z)

    err = jnp.sqrt(jnp.sum(r * r, axis=1) + 1e-18)  # [K, L]
    w = jnp.where(active, _huber_w(err, huber_px), 0.0)  # [K, L]
    w_d = jnp.where(active_d,
                    depth_weight * _huber_w(jnp.abs(r_d), huber_depth),
                    0.0)

    # Weighted Jacobians (fold w into one operand so every Hessian
    # block is a plain contraction).
    Jpw = Jpose * w[:, None, None, :]
    Jlw = Jlm * w[:, None, None, :]
    Jpdw = Jpose_d * w_d[:, None, :]
    Jldw = Jlm_d * w_d[:, None, :]

    # Hessian blocks (reprojection + depth prior) as broadcast-
    # multiply-reduce: the contracted dims are tiny (r = 2, m/j = 3),
    # and the Hll -> Hll_inv -> W -> S chain feeds the Schur complement
    # S = Hpp - W Hpl^T — a small difference of large terms, so it needs
    # FULL f32 (bf16 or TF32 matmul inputs give order-unity cancellation
    # error in S).  Elementwise reductions are exact f32 by construction
    # and need no precision pin.
    Hpp = (jnp.sum(Jpw[:, :, :, None, :] * Jpose[:, :, None, :, :],
                   axis=(1, 4))
           + jnp.sum(Jpdw[:, :, None, :] * Jpose_d[:, None, :, :], axis=3))
    Hll = (jnp.sum(Jlw[:, :, :, None, :] * Jlm[:, :, None, :, :],
                   axis=(0, 1))
           + jnp.sum(Jldw[:, :, None, :] * Jlm_d[:, None, :, :],
                     axis=0))  # [3, 3, L]
    Hpl = (jnp.sum(Jpw[:, :, :, None, :] * Jlm[:, :, None, :, :], axis=1)
           + Jpdw[:, :, None, :] * Jlm_d[:, None, :, :])  # [K, 6, 3, L]
    # gradients: the outer GN fixed point is (bp, bl) == 0, so gradient
    # precision sets solution accuracy — same exact-f32 reductions
    bp = (jnp.sum(Jpw * r[:, :, None, :], axis=(1, 3))
          + jnp.sum(Jpdw * r_d[:, None, :], axis=2))
    bl = (jnp.sum(Jlw * r[:, :, None, :], axis=(0, 1))
          + jnp.sum(Jldw * r_d[:, None, :], axis=0))  # [3, L]

    # Relative (Marquardt) damping: the absolute scale of Hll blocks is
    # ~f^2/z^2 and varies by orders of magnitude; damping proportional
    # to the block trace bounds the condition number at ~3/damping so
    # the f32 block inverse cannot overflow (a fixed 1e-4 floor let
    # cond reach ~5e7 and the inverse returned inf).
    obs_cnt = jnp.sum(w, axis=0) + jnp.sum(w_d, axis=0)  # [L]
    lm_free = (obs_cnt > 0) & pb.lm_valid
    tr_l = (Hll[0, 0] + Hll[1, 1] + Hll[2, 2]) / 3.0  # [L]
    lam = damping * jnp.maximum(tr_l, 1.0) + 1e-8
    eye3 = jnp.eye(3, dtype=Hll.dtype)[:, :, None]
    Hll = Hll + lam[None, None, :] * eye3
    Hll = jnp.where(lm_free[None, None, :], Hll, eye3)
    bl = jnp.where(lm_free[None, :], bl, 0.0)

    Hll_inv = _inv3x3_lanes(Hll)  # [3, 3, L]
    W = jnp.sum(Hpl[:, :, :, None, :] * Hll_inv[None, None, :, :, :],
                axis=2)  # [K, 6, 3, L]

    # Reduced camera system (same exact-f32 elementwise form; the
    # [K,K,6,6,3,L] broadcast is ~11M elements).
    S_cross = jnp.sum(W[:, None, :, None, :, :]
                      * Hpl[None, :, None, :, :, :],
                      axis=(4, 5))  # [K, K, 6, 6]
    b_red_lm = jnp.sum(W * bl[None, None, :, :], axis=(2, 3))  # [K, 6]

    if axis_name is not None:
        # Reduce the camera system over landmark shards.
        Hpp = jax.lax.psum(Hpp, axis_name)
        S_cross = jax.lax.psum(S_cross, axis_name)
        bp = jax.lax.psum(bp, axis_name)
        b_red_lm = jax.lax.psum(b_red_lm, axis_name)

    tr_p = jnp.trace(Hpp, axis1=-2, axis2=-1) / 6.0
    Hpp = Hpp + (damping * jnp.maximum(tr_p, 1.0))[:, None, None] \
        * jnp.eye(6, dtype=Hpp.dtype)
    S = -S_cross
    S = S.at[jnp.arange(K), jnp.arange(K)].add(Hpp)
    b_red = bp - b_red_lm

    # gauge: fixed poses get identity rows/cols and zero gradient
    fix = pb.fixed
    S = jnp.where(fix[:, None, None, None] | fix[None, :, None, None],
                  0.0, S)
    S = S.at[jnp.arange(K), jnp.arange(K)].add(
        jnp.where(fix[:, None, None], jnp.eye(6, dtype=S.dtype), 0.0))
    b_red = jnp.where(fix[:, None], 0.0, b_red)

    Sd = S.transpose(0, 2, 1, 3).reshape(6 * K, 6 * K)
    # The blocked LU inside linalg.solve uses dot_general at DEFAULT
    # precision — pin it: the reduced camera system is the end of the
    # Schur cancellation chain and bf16 factor products corrupt the
    # pose update the same way solve6_spd did (see vo/linalg6.py).
    with jax.default_matmul_precision("float32"):
        dxi = -jnp.linalg.solve(Sd, b_red.reshape(-1)).reshape(K, 6)
    dxi = jnp.where(fix[:, None], 0.0, dxi)

    # back-substitute landmarks (local to each shard)
    rhs = -bl - jnp.sum(Hpl * dxi[:, :, None, None], axis=(0, 1))  # [3, L]
    dl = jnp.sum(Hll_inv * rhs[None, :, :], axis=1)  # [3, L]
    dl = jnp.where(lm_free[None, :], dl, 0.0)

    dR, dt = se3_exp(dxi)
    R_new = jnp.matmul(dR, pb.R, precision=HI)
    t_new = jnp.einsum("kij,kj->ki", dR, pb.t, precision=HI) + dt
    return pb._replace(R=R_new, t=t_new, landmarks=pb.landmarks + dl.T)


@partial(jax.jit, static_argnames=("camera", "iters", "huber_px",
                                   "depth_weight", "huber_depth", "damping",
                                   "compute_cost"))
def run_ba(camera, problem: BAProblem, iters: int = 8,
           huber_px: float = 2.0, depth_weight: float = 1.0,
           huber_depth: float = 0.5, damping: float = 1e-4,
           compute_cost: bool = True) -> BAResult:
    """Run `iters` damped Gauss-Newton iterations (single device).

    `compute_cost=False` skips the initial/final diagnostic cost
    evaluations (two full residual passes, ~40% of a 6-iteration solve's
    wall clock) — the VO hot path uses only the optimized poses."""

    def iteration(_, pb):
        return ba_iteration(camera, pb, huber_px, depth_weight,
                            huber_depth, damping)

    zero = jnp.float32(0)
    c0 = ba_cost(camera, problem, huber_px, depth_weight, huber_depth) \
        if compute_cost else zero
    out = jax.lax.fori_loop(0, iters, iteration, problem)
    c1 = ba_cost(camera, out, huber_px, depth_weight, huber_depth) \
        if compute_cost else zero
    return BAResult(problem=out, initial_cost=c0, final_cost=c1)
