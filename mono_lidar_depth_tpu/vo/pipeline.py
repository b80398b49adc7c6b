"""Full visual odometry pipeline with lidar depth priors.

Composes the framework layers into metric monocular odometry
(the LIMO recipe — the reference repo provides stage 2; stages 3-4 are
its companion backend, rebuilt here as batched JAX):

  1. feature tracking            (tracker/)           — or external tracks
  2. lidar depth association     (tracks/pipeline)
  3. frame-to-frame pose GN      (vo/pose)            — metric scale from
                                                        depth-augmented
                                                        landmarks
  4. sliding-window BA           (vo/ba)              — last W frames,
                                                        landmark slots ==
                                                        track slots

Per-frame device work is two jitted programs (the tracklet-depth step
and the odometry step); the host only keeps the trajectory list.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import DepthEstimatorConfig
from ..core.geometry import SE3, PinholeCamera
from ..tracks.pipeline import FrameInput, TrackletDepthState, process_frame
from .ba import BAProblem, run_ba
from .pose import estimate_pose_gn
from ..precision import HI


class OdometryConfig(NamedTuple):
    ba_window: int = 5  # frames in the BA window
    ba_iters: int = 6
    ba_every: int = 1  # run BA every n frames
    depth_weight: float = 2.0
    min_motion_tracks: int = 12
    gn_iters: int = 10  # frame-to-frame pose GN iterations (stage 2
    #                     adds max(gn_iters // 2, 3) refit iterations)
    # Acceptance gates beyond the inlier count (all three must pass,
    # else the frame coasts on the constant-velocity model).  A solve
    # can "succeed" with enough inliers yet be garbage — observed as
    # single-frame |t_rel| of 2.8 m against a true 0.55 m when a
    # precision bug degraded the GN step (diag record, frame 54); these
    # gates make that failure class coast instead of corrupting the
    # trajectory, on ANY backend.
    accept_max_err: float = 1.5  # px: mean inlier reprojection error
    accel_gate_m: float = 1.0  # max |t_rel| change per frame (m);
    #                            ~100 m/s^2 at 10 Hz — kinematically
    #                            impossible for a vehicle, so anything
    #                            beyond it is a solver failure
    # Retry-from-identity triggers (warm start outside the GN basin):
    retry_inlier_ratio: float = 0.5  # inliers < ratio * usable
    retry_max_err: float = 1.0  # px
    # Carry BA-optimized landmark positions across frames (slots
    # invalidated when their track slot is reused).  Off: landmarks are
    # re-unprojected from the newest in-window depth every frame
    # (cheap, discards the BA's triangulation refinement —
    # scripts/make_parity_record.py's config 3 measures the difference).
    persist_landmarks: bool = False


class OdometryState(NamedTuple):
    """Device-side odometry state."""

    tracklets: TrackletDepthState
    # Ring of the last `ba_window` camera-from-world poses, slot 0 newest.
    win_R: jnp.ndarray  # [W, 3, 3]
    win_t: jnp.ndarray  # [W, 3]
    win_valid: jnp.ndarray  # [W]
    frame_idx: jnp.ndarray  # scalar int32
    # last relative motion (cur←prev), the constant-velocity warm start
    rel_R: jnp.ndarray  # [3, 3]
    rel_t: jnp.ndarray  # [3]
    # persisted BA landmarks (used when ocfg.persist_landmarks):
    # world positions per track slot + the owning track id (slot reuse
    # by the tracker invalidates the persisted estimate)
    lm_world: jnp.ndarray  # [L, 3]
    lm_id: jnp.ndarray  # [L] int32 track id, -1 = empty
    # True once a motion solve has been ACCEPTED — until then rel_t is
    # "unknown", not "measured zero", and the acceleration gate must
    # not bind (a first frame moving faster than accel_gate_m would
    # otherwise be rejected against the zero prior forever, freezing
    # the trajectory at the origin)
    motion_ok: jnp.ndarray  # scalar bool

    @classmethod
    def create(cls, cfg: DepthEstimatorConfig, ocfg: OdometryConfig,
               max_tracks: int, max_length: int) -> "OdometryState":
        W = ocfg.ba_window
        eye = jnp.broadcast_to(jnp.eye(3, dtype=jnp.float32), (W, 3, 3))
        return cls(
            tracklets=TrackletDepthState.create(cfg, max_tracks, max_length),
            win_R=eye, win_t=jnp.zeros((W, 3), jnp.float32),
            win_valid=jnp.zeros((W,), bool).at[0].set(True),
            frame_idx=jnp.int32(0),
            rel_R=jnp.eye(3, dtype=jnp.float32),
            rel_t=jnp.zeros(3, jnp.float32),
            lm_world=jnp.zeros((max_tracks, 3), jnp.float32),
            lm_id=jnp.full((max_tracks,), -1, jnp.int32),
            motion_ok=jnp.asarray(False))


@partial(jax.jit, static_argnames=("cfg", "ocfg", "camera"))
def odometry_step(
    cfg: DepthEstimatorConfig,
    ocfg: OdometryConfig,
    camera: PinholeCamera,
    lidar_to_cam: SE3,
    state: OdometryState,
    frame: FrameInput,
) -> tuple["OdometryState", jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """One full odometry frame.

    Returns (state', R_cw [3,3], t_cw [3], diagnostics [3]) where
    (R_cw, t_cw) is the camera-from-world pose of this frame and
    diagnostics = [num_motion_tracks, num_inliers, mean reproj error].
    """
    # Depth association's contractions are pinned to full f32 in
    # core/depth_estimator.py, and the geometry below is pinned here
    # (see precision.py).
    tl_state, depths, codes = process_frame(
        cfg, camera, lidar_to_cam, state.tracklets, frame)
    return _odometry_tail(cfg, ocfg, camera, state, tl_state,
                          depths, codes)


def _odometry_tail(cfg, ocfg, camera, state, tl_state, depths, codes):
    """Pose GN + window BA + state update.  Residual-critical matmuls
    are precision-pinned per op (precision.HI) and the GN/BA Hessian
    terms are broadcast-reduce sums, exact f32 (see precision.py)."""
    table = tl_state.table

    # ---- frame-to-frame motion -------------------------------------
    # Landmarks: tracks observed in BOTH this and the previous frame
    # with a valid depth at the previous frame.  Previous-frame camera
    # coordinates: unproject (uv, depth) at table column 1.
    uv_prev = table.uv[:, 1]
    d_prev = table.depth[:, 1]
    uv_cur = table.uv[:, 0]
    usable = (table.active() & (table.length >= 2) & (d_prev > 0))
    rays = camera.viewing_rays(uv_prev)
    # depth is camera-z (the pipeline's depth convention): scale so z = d
    rz = jnp.maximum(rays[:, 2], 1e-6)
    lm_prev = rays / rz[:, None] * d_prev[:, None]
    n_usable = jnp.sum(usable)

    # constant-velocity warm start from the previous relative motion
    est = estimate_pose_gn(camera, lm_prev, uv_cur, usable,
                           R_init=state.rel_R, t_init=state.rel_t,
                           iters=ocfg.gn_iters)

    # Recovery restart: after a long coasting stretch (tracker starved
    # through a turn) the warm start can be far outside the GN basin —
    # the solve then "succeeds" with ZERO inliers, and accepting it
    # poisons every later warm start (observed: pose error growing
    # monotonically to 600 m after a U-turn while usable tracks were
    # back above 100).  When the warm-started solve has too few
    # inliers, retry from identity (lax.cond: the retry only executes
    # on those frames).
    def _retry(_):
        return estimate_pose_gn(camera, lm_prev, uv_cur, usable,
                                R_init=jnp.eye(3, dtype=jnp.float32),
                                t_init=jnp.zeros(3, jnp.float32),
                                iters=ocfg.gn_iters)

    need_retry = ((est.num_inliers < ocfg.min_motion_tracks)
                  | (est.num_inliers.astype(jnp.float32)
                     < ocfg.retry_inlier_ratio * n_usable)
                  | (est.mean_error > ocfg.retry_max_err))
    est2 = jax.lax.cond(need_retry, _retry, lambda _: est, None)
    est = jax.tree.map(
        lambda a, b: jnp.where(est2.num_inliers > est.num_inliers, b, a),
        est, est2)

    # Acceptance gates (see OdometryConfig): enough inliers, converged
    # residual, and kinematically plausible translation change.
    # Otherwise coast on the constant-velocity model (prevents turn
    # dropouts from zeroing the motion OR feeding back diverged
    # estimates).
    # The gate scales with speed (fast driving turns the rel-translation
    # VECTOR by ~|t|·dtheta per frame), and a high-confidence solve
    # (3x the inlier floor at sub-pixel error) overrides it — otherwise
    # a stale constant-velocity model after a long coast could reject a
    # genuine recovery forever.
    # Until the first ACCEPTED motion, the zero rel_t prior is
    # "unknown", not "measured stationary" — the gate must not bind or
    # a sequence entering faster than accel_gate_m per frame would
    # coast at identity forever (rel_t never updates, so the same
    # rejection repeats every frame).
    gate = jnp.maximum(ocfg.accel_gate_m,
                       0.5 * jnp.linalg.norm(state.rel_t))
    plausible = ((~state.motion_ok)
                 | (jnp.linalg.norm(est.translation - state.rel_t) <= gate))
    confident = ((est.num_inliers >= 3 * ocfg.min_motion_tracks)
                 & (est.mean_error <= 0.8))
    enough = ((est.num_inliers >= ocfg.min_motion_tracks)
              & (est.mean_error <= ocfg.accept_max_err)
              & (plausible | confident))
    R_rel = jnp.where(enough, est.rotation, state.rel_R)
    t_rel = jnp.where(enough, est.translation, state.rel_t)

    # new camera-from-world pose: T_cur←w = T_cur←prev ∘ T_prev←w
    R_prev, t_prev = state.win_R[0], state.win_t[0]
    R_cw = jnp.matmul(R_rel, R_prev, precision=HI)
    t_cw = jnp.matmul(R_rel, t_prev[..., None], precision=HI)[..., 0] + t_rel

    # shift the window ring
    W = state.win_R.shape[0]
    win_R = jnp.concatenate([R_cw[None], state.win_R[:-1]], axis=0)
    win_t = jnp.concatenate([t_cw[None], state.win_t[:-1]], axis=0)
    win_valid = jnp.concatenate(
        [jnp.ones((1,), bool), state.win_valid[:-1]], axis=0)

    # ---- sliding-window BA ------------------------------------------
    # Landmark slot l == track slot l; window frame k == table column k.
    L = table.capacity
    cols = jnp.arange(W)
    obs_mask = (table.active()[None, :]
                & (cols[:, None] < table.length[None, :])
                & win_valid[:, None])
    obs_uv = jnp.swapaxes(table.uv[:, :W], 0, 1)  # [W, L, 2]
    dpri = jnp.swapaxes(table.depth[:, :W], 0, 1)  # [W, L]
    dmask = obs_mask & (dpri > 0)

    # landmark init: unproject the NEWEST in-window depth observation
    # into world coordinates using the current window poses.
    has_d = dmask
    first_k = jnp.argmax(has_d, axis=0)  # newest column with depth
    any_d = jnp.any(has_d, axis=0)
    uv_init = jnp.take_along_axis(obs_uv, first_k[None, :, None], axis=0)[0]
    d_init = jnp.take_along_axis(dpri, first_k[None, :], axis=0)[0]
    rays_l = camera.viewing_rays(uv_init)
    lm_cam = rays_l / jnp.maximum(rays_l[:, 2:3], 1e-6) * d_init[:, None]
    R_k = win_R[first_k]  # [L, 3, 3]
    t_k = win_t[first_k]
    lm_world = jnp.einsum("lji,lj->li", R_k, lm_cam - t_k,
                          precision=HI)  # R^T (p - t)

    if ocfg.persist_landmarks:
        # Reuse the BA-refined position where the slot still belongs to
        # the same track; slots reused by the tracker (different id)
        # fall back to the fresh depth unprojection.
        persisted = (state.lm_id == table.track_id) & (state.lm_id >= 0)
        lm_world = jnp.where(persisted[:, None], state.lm_world, lm_world)

    lm_valid = (table.active() & any_d
                & (jnp.sum(obs_mask, axis=0) >= 2))

    run_it = (state.frame_idx % ocfg.ba_every == 0) & (state.frame_idx >= 1)
    # Gauge: fix the OLDEST valid pose in the window (plus all invalid
    # slots) — otherwise the early, partially-filled window would be
    # gauge-free and could drift wholesale.
    oldest_valid = jnp.sum(win_valid.astype(jnp.int32)) - 1
    problem = BAProblem(
        R=win_R, t=win_t, landmarks=lm_world,
        obs_uv=obs_uv, obs_mask=obs_mask,
        depth_prior=dpri, depth_mask=dmask,
        fixed=(jnp.arange(W) == oldest_valid) | ~win_valid,
        lm_valid=lm_valid)
    # lax.cond actually SKIPS the solve on frames where BA is gated off
    # (jnp.where would run it and discard the result).
    def _solve(pb):
        res = run_ba(camera, pb, iters=ocfg.ba_iters,
                     depth_weight=ocfg.depth_weight, compute_cost=False)
        return res.problem.R, res.problem.t, res.problem.landmarks

    ba_R, ba_t, ba_lm = jax.lax.cond(
        run_it, _solve, lambda pb: (pb.R, pb.t, pb.landmarks), problem)

    if ocfg.persist_landmarks:
        lm_world_out = jnp.where(lm_valid[:, None], ba_lm, 0.0)
        lm_id_out = jnp.where(lm_valid, table.track_id, -1)
    else:
        lm_world_out = state.lm_world
        lm_id_out = state.lm_id

    new_state = OdometryState(
        tracklets=tl_state,
        win_R=ba_R, win_t=ba_t, win_valid=win_valid,
        frame_idx=state.frame_idx + 1,
        rel_R=R_rel, rel_t=t_rel,
        lm_world=lm_world_out, lm_id=lm_id_out,
        motion_ok=state.motion_ok | enough)
    diag = jnp.stack([n_usable.astype(jnp.float32),
                      est.num_inliers.astype(jnp.float32),
                      est.mean_error])
    return new_state, ba_R[0], ba_t[0], diag


def run_odometry(cfg: DepthEstimatorConfig, ocfg: OdometryConfig,
                 camera: PinholeCamera, lidar_to_cam: SE3,
                 frames: list[FrameInput],
                 max_tracks: int = 2048, max_length: int = 12,
                 ) -> tuple[np.ndarray, list]:
    """Host loop over a frame list; returns ([F, 4, 4] world←cam poses,
    diagnostics per frame)."""
    state = OdometryState.create(cfg, ocfg, max_tracks, max_length)
    poses = []
    diags = []
    for frame in frames:
        state, R_cw, t_cw, diag = odometry_step(
            cfg, ocfg, camera, lidar_to_cam, state, frame)
        R_cw = np.asarray(R_cw)
        t_cw = np.asarray(t_cw)
        T = np.eye(4)
        T[:3, :3] = R_cw.T  # world←cam
        T[:3, 3] = -R_cw.T @ t_cw
        poses.append(T)
        diags.append(np.asarray(diag))
    return np.stack(poses), diags
