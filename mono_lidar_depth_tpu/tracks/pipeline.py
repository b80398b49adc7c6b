"""Per-frame tracklet-depth association pipeline.

Batched replacement for `TrackletDepthModule::process`
(tracklet_depth_module.cpp:261-405).  One call per frame:

  1. split incoming tracks into known / brand-new
     (ExractNewTrackletFrames two-feature seeding rule, :23-61);
  2. estimate depths of the PREVIOUS-frame features of new tracks
     against the LAST frame's cloud + ground plane
     (CalculateFeatureDepthsLastFrame, :84-117);
  3. estimate depths of all NEWEST features against the CURRENT cloud
     (CalculateFeatureDepthsCurFrame, :63-82);
  4. update the track table (SaveFeatureDepths + TidyUp*, :119-207).

The reference's per-frame degradation path (invalid cloud →
ExceptionPclInvalid → all depths -1 and cache invalidation,
:315-351) maps to the `cloud_valid` mask / `gp.ok` flag: an empty or
invalid frame produces RadiusSearchInsufficientPoints for every
feature and an inert road pass — no host-side exception flow needed.

State (last cloud + last ground plane, tracklet_depth_module.h:145-152)
is an explicit pytree, so the whole per-frame step jits and the
sequence loop can be a `lax.scan`.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..config import DepthEstimatorConfig
from ..core.depth_estimator import (estimate_depths_from_frame,
                                    rasterize_cloud)
from ..core.geometry import SE3, PinholeCamera
from ..core.projection import POINT_NOT_DEFINED, FrameCloud
from ..core.ransac import (GroundPlane, fit_ground_plane_ransac,
                           fit_ground_plane_semantic)
from ..core.result_types import NUM_RESULT_TYPES
from .table import TrackTable, match_tracks, update_tracks


def _empty_frame_cloud(cfg: DepthEstimatorConfig) -> FrameCloud:
    """All-invalid rasterized frame (cold-start 'last frame')."""
    P = cfg.max_points
    H, W = cfg.image_height, cfg.image_width
    return FrameCloud(
        points_lidar=jnp.zeros((P, 3), jnp.float32),
        points_cam=jnp.zeros((P, 3), jnp.float32),
        uv=jnp.zeros((P, 2), jnp.float32),
        valid=jnp.zeros((P,), bool),
        visible=jnp.zeros((P,), bool),
        grid=jnp.full((H, W), POINT_NOT_DEFINED, jnp.int32),
        planes=jnp.zeros((2, H, W), jnp.float32),
        winner_flat=jnp.full((P,), H * W, jnp.int32),
    )


class TrackletDepthState(NamedTuple):
    """Cross-frame state (replaces _cloud_last_frame / groundPlaneLast_
    / _trackletMap / _timestamps).

    The last frame is cached RASTERIZED (FrameCloud) rather than as the
    raw cloud: the previous-frame estimator pass then skips the
    transform + projection + scatter stage —
    the reference caches only the raw PCL cloud and re-ingests it
    (tracklet_depth_module.h:148, DepthEstimator::setInputCloud)."""

    table: TrackTable
    frame_last: FrameCloud
    gp_last: GroundPlane
    counters: jnp.ndarray  # [NUM_RESULT_TYPES] accumulated outcomes

    @classmethod
    def create(cls, cfg: DepthEstimatorConfig, max_tracks: int,
               max_length: int) -> "TrackletDepthState":
        P = cfg.max_points
        from ..core.depth_estimator import no_ground_plane
        return cls(
            table=TrackTable.create(max_tracks, max_length),
            frame_last=_empty_frame_cloud(cfg),
            gp_last=no_ground_plane(P),
            counters=jnp.zeros((NUM_RESULT_TYPES,), jnp.int32),
        )


class FrameInput(NamedTuple):
    """One synchronized frame (replaces the 3/4-way ROS message sync —
    arrays are aligned by construction, SURVEY.md §2.7).

    `semantic` carries the optional per-frame segmentation image: when
    present the ground plane comes from the semantic road classes
    (`fit_ground_plane_semantic`, the reference's callbackSemantic
    4-way-sync path, tracklet_depth_interface.cpp:61-99 +
    tracklet_depth_module.cpp:269-284); when None, from RANSAC
    (callbackRansac, the 3-way path)."""

    cloud: jnp.ndarray  # [P, 3] lidar-frame points
    cloud_valid: jnp.ndarray  # [P]
    ids: jnp.ndarray  # [M] int32 track ids from the feature tracker
    ids_valid: jnp.ndarray  # [M]
    uv_new: jnp.ndarray  # [M, 2] newest feature per track
    uv_prev: jnp.ndarray  # [M, 2] previous-frame feature per track
    stamp: jnp.ndarray  # scalar time
    rng: jax.Array  # PRNG key for the RANSAC ground plane
    semantic: Optional[jnp.ndarray] = None  # [H, W] label image or None


@partial(jax.jit, static_argnames=("cfg", "camera"))
def prime_state(cfg: DepthEstimatorConfig, camera: PinholeCamera,
                lidar_to_cam: SE3, state: TrackletDepthState,
                cloud: jnp.ndarray, cloud_valid: jnp.ndarray,
                key: jax.Array,
                semantic: Optional[jnp.ndarray] = None
                ) -> TrackletDepthState:
    """Install a cloud (+ its ground plane, rasterized) as the 'last
    frame' BEFORE the first processed frame, so that the previous-frame
    features of the first tracks get real depths instead of the
    cold-start -1s (which otherwise make the first frame's motion
    unobservable to the VO layer)."""
    from ..core.depth_estimator import no_ground_plane

    if not cfg.do_use_ransac_plane:
        gp = no_ground_plane(cfg.max_points)
    elif semantic is not None:
        gp = fit_ground_plane_semantic(
            cloud, cloud_valid, semantic,
            lidar_to_cam.rotation, lidar_to_cam.translation,
            camera.intrinsics(),
            ground_labels=cfg.semantic_ground_labels,
            inlier_threshold=cfg.ransac_plane_refinement_treshold)
    else:
        gp = fit_ground_plane_ransac(
            cloud, cloud_valid, key,
            distance_threshold=cfg.ransac_plane_distance_treshold,
            min_z=cfg.ransac_plane_min_z, max_z=cfg.ransac_plane_max_z,
            num_hypotheses=cfg.ransac_num_hypotheses,
            subsample=cfg.ransac_subsample_points,
            axis_max_angle_deg=cfg.ransac_axis_max_angle_deg,
            use_refinement=cfg.ransac_plane_use_refinement,
            refinement_threshold=cfg.ransac_plane_refinement_treshold)
    frame = rasterize_cloud(cfg, camera, lidar_to_cam, cloud, cloud_valid, gp)
    return state._replace(frame_last=frame, gp_last=gp)


@partial(jax.jit, static_argnames=("cfg", "camera"))
def process_frame(
    cfg: DepthEstimatorConfig,
    camera: PinholeCamera,
    lidar_to_cam: SE3,
    state: TrackletDepthState,
    frame: FrameInput,
) -> tuple[TrackletDepthState, jnp.ndarray, jnp.ndarray]:
    """Process one frame; returns (state', depths_new [M], codes_new [M])."""
    # Ground plane for the current cloud: from the semantic image when
    # the frame carries one (the reference's live 4-way callback builds
    # a SemanticPlane per frame, tracklet_depth_module.cpp:269-284),
    # else from RANSAC (built inside setInputCloud when none is
    # supplied, DepthEstimator.cpp:274-283).
    if not cfg.do_use_ransac_plane:
        gp = None
    elif frame.semantic is not None:
        gp = fit_ground_plane_semantic(
            frame.cloud, frame.cloud_valid, frame.semantic,
            lidar_to_cam.rotation, lidar_to_cam.translation,
            camera.intrinsics(),
            ground_labels=cfg.semantic_ground_labels,
            inlier_threshold=cfg.ransac_plane_refinement_treshold)
    else:
        gp = fit_ground_plane_ransac(
            frame.cloud, frame.cloud_valid, frame.rng,
            distance_threshold=cfg.ransac_plane_distance_treshold,
            min_z=cfg.ransac_plane_min_z, max_z=cfg.ransac_plane_max_z,
            num_hypotheses=cfg.ransac_num_hypotheses,
            subsample=cfg.ransac_subsample_points,
            axis_max_angle_deg=cfg.ransac_axis_max_angle_deg,
            use_refinement=cfg.ransac_plane_use_refinement,
            refinement_threshold=cfg.ransac_plane_refinement_treshold)

    slot_exist, is_new = match_tracks(state.table, frame.ids, frame.ids_valid)

    from ..core.depth_estimator import estimate_depths_pair, no_ground_plane
    gp_eff = gp if gp is not None else no_ground_plane(cfg.max_points)

    frame_cur = rasterize_cloud(cfg, camera, lidar_to_cam, frame.cloud,
                                frame.cloud_valid, gp_eff)
    # One fused pipeline for both estimator passes: previous-frame
    # features of NEW tracks against the CACHED rasterization of the
    # last frame + its plane, and all newest features against the
    # current frame (CalculateFeatureDepths{Last,Cur}Frame).
    est_prev, est_new = estimate_depths_pair(
        cfg, camera, lidar_to_cam,
        state.frame_last, frame.uv_prev, is_new, state.gp_last,
        frame_cur, frame.uv_new, frame.ids_valid, gp_eff)

    table, _ = update_tracks(
        state.table, frame.ids, frame.ids_valid, frame.uv_new,
        frame.uv_prev, est_new.depths, est_prev.depths, frame.stamp,
        match=(slot_exist, is_new))

    new_state = TrackletDepthState(
        table=table,
        frame_last=frame_cur,
        gp_last=gp_eff,
        counters=state.counters + est_new.counters + est_prev.counters,
    )
    return new_state, est_new.depths, est_new.codes


def process_sequence(cfg: DepthEstimatorConfig, camera: PinholeCamera,
                     lidar_to_cam: SE3, state: TrackletDepthState,
                     frames: FrameInput):
    """lax.scan over a stacked sequence of frames (leading time axis on
    every FrameInput leaf).  Returns (final state, depths [F, M],
    codes [F, M])."""

    def step(carry, frame):
        new_state, depths, codes = process_frame(
            cfg, camera, lidar_to_cam, carry, frame)
        return new_state, (depths, codes)

    final, (depths, codes) = jax.lax.scan(step, state, frames)
    return final, depths, codes
