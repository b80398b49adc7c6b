"""The fused per-frame depth-estimation pipeline.

Batched redesign of `Mono_Lidar::DepthEstimator`
(DepthEstimator.cpp:220-1037).  The reference walks a branchy
per-feature state machine with ~10 early exits inside an OpenMP loop;
here every branch is evaluated for ALL features as masked dense lanes
and the final (result code, depth) is a pure select cascade — one jitted
device program per frame, no data-dependent control flow.

Pipeline stages (reference call stack in SURVEY.md §3.3-3.4):
  1. cloud transform + projection + pixel grid     (projection.py)
  2. window gather, primary scale                  (neighbors.py)
  3. first-local-max histogram segmentation        (histogram.py)
  4. max-spanning triangle / PCA + planarity       (planefit.py)
  5. viewing ray ∩ local plane + threshold gates   (geometry.py)
  6. road fallback: wide window, ground-plane
     inlier filter, M-estimator fit, gates         (planefit.py)
  7. result-code select cascade + statistics

Result codes use the reference enum verbatim (result_types.py).

Documented semantic fix vs the reference: the M-estimator's prior
weights are computed as the distance of each LIDAR-frame neighbor to
the LIDAR-frame ground plane.  The reference hands the lidar-frame
plane coefficients to a distance computation over CAMERA-frame points
(DepthEstimator.cpp:286-292 + PlaneEstimationMEstimator.cpp:34),
mixing frames; only the weights are affected, not the fit itself,
which runs on camera-frame points in both builds.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..config import DepthEstimatorConfig
from ..precision import f32_matmuls
from .geometry import SE3, PinholeCamera, plane_from_points, point_plane_distance, ray_plane_intersection
from .histogram import filter_points_min_dist_blob
from .neighbors import gather_neighbors, gather_neighbors_two_scales
from .planefit import (check_planar, check_xz_flatness, first_three_points,
                       least_squares_plane, max_spanning_triangle,
                       mestimator_plane, pca_classify)
from .projection import FrameCloud, build_frame_cloud
from .ransac import GroundPlane
from .result_types import NUM_RESULT_TYPES, DepthResultType as R


class DepthDebug(NamedTuple):
    """Per-feature forensic record (the reference's
    DepthCalcStatsSinglePoint, DepthCalcStatsSinglePoint.h:20-68),
    produced for ALL features at once when cfg.collect_debug is set."""

    neighbor_count: jnp.ndarray  # [N] primary-window hits
    seg_count: jnp.ndarray  # [N] histogram-segmented point count
    hist_bin: jnp.ndarray  # [N] selected bin id (-1 none)
    hist_lower: jnp.ndarray  # [N] bin lower border
    hist_upper: jnp.ndarray  # [N] bin upper border
    corners: jnp.ndarray  # [N, 3, 3] spanning-triangle corners
    road_count: jnp.ndarray  # [N] road-pass ground-inlier count


class DepthEstimate(NamedTuple):
    depths: jnp.ndarray  # [N] estimated depth, -1 on failure
    codes: jnp.ndarray  # [N] int32 DepthResultType
    counters: jnp.ndarray  # [NUM_RESULT_TYPES] int32 outcome histogram
    debug: Optional[DepthDebug] = None  # set when cfg.collect_debug


def no_ground_plane(max_points: int) -> GroundPlane:
    """Placeholder ground plane (gp.ok == False disables the road pass,
    like passing a null GroundPlane::Ptr in the reference)."""
    return GroundPlane(
        coeffs=jnp.array([0.0, 0.0, 1.0, 0.0], jnp.float32),
        inlier_mask=jnp.zeros((max_points,), bool),
        ok=jnp.asarray(False),
    )


@partial(jax.jit, static_argnames=("cfg", "camera"))
@f32_matmuls
def estimate_depths(
    cfg: DepthEstimatorConfig,
    camera: PinholeCamera,
    lidar_to_cam: SE3,
    cloud_lidar: jnp.ndarray,
    cloud_valid: jnp.ndarray,
    features_uv: jnp.ndarray,
    features_valid: jnp.ndarray,
    ground_plane: Optional[GroundPlane] = None,
) -> DepthEstimate:
    """Estimate a metric depth for every feature point.

    Replaces `DepthEstimator::CalculateDepth(Matrix2Xd, ...)`
    (DepthEstimator.cpp:429-600) + `setInputCloud` (:220-312).

    Args:
      cfg: static pipeline configuration.
      camera: static pinhole intrinsics.
      lidar_to_cam: extrinsics (traced).
      cloud_lidar: [P, 3] padded lidar cloud.
      cloud_valid: [P] bool padding mask.
      features_uv: [N, 2] feature pixel coordinates.
      features_valid: [N] bool padding mask.
      ground_plane: lidar-frame ground-plane estimate, or None.
    """
    N = features_uv.shape[0]
    if ground_plane is None:
        ground_plane = no_ground_plane(cloud_lidar.shape[0])

    if cfg.set_all_depths_to_zero:  # DepthEstimator.cpp:448-453
        codes = jnp.where(features_valid, jnp.int32(R.Success), jnp.int32(R.Unspecified))
        return DepthEstimate(
            depths=jnp.full((N,), -1.0, jnp.float32),
            codes=codes,
            counters=_count(codes, features_valid))

    frame = rasterize_cloud(cfg, camera, lidar_to_cam, cloud_lidar,
                            cloud_valid, ground_plane)
    return estimate_depths_from_frame(
        cfg, camera, lidar_to_cam, frame, features_uv, features_valid,
        ground_plane)


@partial(jax.jit, static_argnames=("cfg", "camera"))
@f32_matmuls
def rasterize_cloud(
    cfg: DepthEstimatorConfig,
    camera: PinholeCamera,
    lidar_to_cam: SE3,
    cloud_lidar: jnp.ndarray,
    cloud_valid: jnp.ndarray,
    ground_plane: GroundPlane,
) -> FrameCloud:
    """Frame ingest: transform + project + rasterize one cloud (the
    `setInputCloud` half of the reference pipeline).  The result is a
    reusable pytree — the tracklet layer caches it across frames so the
    last-frame estimator pass (tracks/pipeline.py) does not re-rasterize.

    The ground-inlier mask rides the rasterization in the z plane's
    sign bit, so the road pass reads it as part of the window slice
    instead of a random [N, K] gather over the raw cloud
    (GroundPlane::CheckPointInPlane, RansacPlane.h:99-123, keyed by
    raw index in the reference) — which means the cached FrameCloud is
    tied to the ground plane it was built with.
    """
    flags = ground_plane.inlier_mask if cfg.do_use_ransac_plane else None
    return build_frame_cloud(
        cloud_lidar, cloud_valid, lidar_to_cam, camera,
        cfg.image_height, cfg.image_width, cfg.grid_collision_rule,
        point_flags=flags, fast=cfg.fast_rasterization)


def plane_to_camera(lidar_to_cam: SE3, coeffs: jnp.ndarray) -> jnp.ndarray:
    """Transform lidar-frame plane coefficients [a,b,c,d] into the
    camera frame: n_c = R n_l, d_c = d_l − n_c·t.  Rigid transforms
    preserve point-plane distance, so the road pass evaluates distances
    against this [4]-vector instead of gathering lidar-frame points
    (the reference maps each neighbor back, DepthEstimator.cpp:810-812)."""
    n_c = (lidar_to_cam.rotation @ coeffs[:3][..., None])[..., 0]
    d_c = coeffs[3] - jnp.sum(n_c * lidar_to_cam.translation)
    return jnp.concatenate([n_c, d_c[None]])


def _gather_two_scales(cfg, camera, frame: FrameCloud, features_uv):
    """Window gathers for both search scales (primary + road retry)."""
    need_idx = cfg.do_use_depth_segmentation
    hx = cfg.pixelarea_search_witdh * 0.5
    hy = cfg.pixelarea_search_height * 0.5
    if cfg.do_use_ransac_plane:
        return gather_neighbors_two_scales(
            frame, camera, features_uv, hx, hy,
            cfg.road_search_scale_x, cfg.road_search_scale_y,
            cfg.primary_window, cfg.road_window, with_indices=need_idx)
    nb1 = gather_neighbors(frame, camera, features_uv, hx, hy,
                           cfg.primary_window, with_indices=need_idx)
    return nb1, None


@partial(jax.jit, static_argnames=("cfg", "camera"))
@f32_matmuls
def estimate_depths_from_frame(
    cfg: DepthEstimatorConfig,
    camera: PinholeCamera,
    lidar_to_cam: SE3,
    frame: FrameCloud,
    features_uv: jnp.ndarray,
    features_valid: jnp.ndarray,
    ground_plane: GroundPlane,
) -> DepthEstimate:
    """Per-feature depth estimation against a pre-rasterized FrameCloud
    (must have been built by `rasterize_cloud` with the SAME ground
    plane).  See `estimate_depths` for the one-shot form."""
    N = features_uv.shape[0]

    if cfg.set_all_depths_to_zero:  # DepthEstimator.cpp:448-453
        codes = jnp.where(features_valid, jnp.int32(R.Success), jnp.int32(R.Unspecified))
        return DepthEstimate(
            depths=jnp.full((N,), -1.0, jnp.float32),
            codes=codes,
            counters=_count(codes, features_valid))

    nb1, nb2 = _gather_two_scales(cfg, camera, frame, features_uv)
    return _depth_cascade(
        cfg, camera, nb1, nb2, features_uv, features_valid,
        plane_to_camera(lidar_to_cam, ground_plane.coeffs),
        ground_plane.ok, frame=frame)


@partial(jax.jit, static_argnames=("cfg", "camera"))
@f32_matmuls
def estimate_depths_pair(
    cfg: DepthEstimatorConfig,
    camera: PinholeCamera,
    lidar_to_cam: SE3,
    frame_a: FrameCloud,
    uv_a: jnp.ndarray,
    valid_a: jnp.ndarray,
    gp_a: GroundPlane,
    frame_b: FrameCloud,
    uv_b: jnp.ndarray,
    valid_b: jnp.ndarray,
    gp_b: GroundPlane,
) -> tuple[DepthEstimate, DepthEstimate]:
    """Estimate depths for two feature sets against two frames in ONE
    fused pipeline: the window gathers stay per-frame, but everything
    downstream (histogram segmentation, plane fits, gates, road
    fallback, statistics) runs once over the concatenated [2N] lanes —
    halving the fixed cost of the per-feature stages.  This is the
    tracklet layer's shape: the previous-frame features of new tracks
    against the cached last frame, and all newest features against the
    current frame (CalculateFeatureDepths{Last,Cur}Frame,
    tracklet_depth_module.cpp:63-117)."""
    if cfg.set_all_depths_to_zero or cfg.do_use_depth_segmentation:
        # region growing is frame-local (row segmentation of each
        # cloud); run the two passes separately for those configs.
        return (estimate_depths_from_frame(cfg, camera, lidar_to_cam,
                                           frame_a, uv_a, valid_a, gp_a),
                estimate_depths_from_frame(cfg, camera, lidar_to_cam,
                                           frame_b, uv_b, valid_b, gp_b))

    # Per-frame window gathers, downstream fused over [2N] lanes.
    Na = uv_a.shape[0]
    nb1a, nb2a = _gather_two_scales(cfg, camera, frame_a, uv_a)
    nb1b, nb2b = _gather_two_scales(cfg, camera, frame_b, uv_b)

    def cat(a, b):
        return jax.tree.map(lambda x, y: jnp.concatenate([x, y], axis=0),
                            a, b)

    nb1 = cat(nb1a, nb1b)
    nb2 = cat(nb2a, nb2b) if nb2a is not None else None
    uv = jnp.concatenate([uv_a, uv_b], axis=0)
    valid = jnp.concatenate([valid_a, valid_b], axis=0)
    ca = plane_to_camera(lidar_to_cam, gp_a.coeffs)
    cb = plane_to_camera(lidar_to_cam, gp_b.coeffs)
    coeffs = jnp.concatenate([jnp.broadcast_to(ca, (Na, 4)),
                              jnp.broadcast_to(cb, (uv_b.shape[0], 4))])
    gp_ok = jnp.concatenate([jnp.broadcast_to(gp_a.ok, (Na,)),
                             jnp.broadcast_to(gp_b.ok, (uv_b.shape[0],))])
    est = _depth_cascade(cfg, camera, nb1, nb2, uv, valid, coeffs, gp_ok,
                         frame=None)
    est_a = DepthEstimate(depths=est.depths[:Na], codes=est.codes[:Na],
                          counters=_count(est.codes[:Na], valid_a),
                          debug=None if est.debug is None else
                          jax.tree.map(lambda x: x[:Na], est.debug))
    est_b = DepthEstimate(depths=est.depths[Na:], codes=est.codes[Na:],
                          counters=_count(est.codes[Na:], valid_b),
                          debug=None if est.debug is None else
                          jax.tree.map(lambda x: x[Na:], est.debug))
    return est_a, est_b


def _depth_cascade(
    cfg: DepthEstimatorConfig,
    camera: PinholeCamera,
    nb1,
    nb2,
    features_uv: jnp.ndarray,
    features_valid: jnp.ndarray,
    gp_coeffs_cam: jnp.ndarray,  # [4] or [N, 4] camera-frame plane
    gp_ok: jnp.ndarray,  # scalar or [N]
    frame: Optional[FrameCloud],
) -> DepthEstimate:
    """The per-feature select cascade given gathered neighbor windows.
    `frame` is only needed for the region-growing branch."""
    N = features_uv.shape[0]

    # Viewing rays (camera_pinhole.h:52-69); z is positive for any
    # finite pixel, but keep the reference's z<0 flip for safety
    # (DepthEstimator.cpp:938-939).
    ray_dir = camera.viewing_rays(features_uv.astype(jnp.float32))
    ray_dir = jnp.where(ray_dir[..., 2:3] < 0, -ray_dir, ray_dir)
    ray_origin = jnp.zeros_like(ray_dir)

    enough1 = nb1.count >= cfg.radiusSearch_count_min

    depth1 = nb1.z
    if cfg.do_use_histogram_segmentation:
        hist = filter_points_min_dist_blob(
            depth1, nb1.mask,
            cfg.histogram_segmentation_bin_witdh,
            cfg.histogram_segmentation_min_pointcount,
            cfg.histogram_bins)
        seg_mask, hist_found = hist.seg_mask, hist.found
    else:  # DepthEstimator.cpp:762-764: use all neighbors
        seg_mask, hist_found = nb1.mask, jnp.ones((N,), bool)

    depth_p, code_p, corners_p = _segment_depth(
        cfg, nb1.points_cam, seg_mask, ray_dir, ray_origin,
        check_planar_enabled=cfg.do_check_triangleplanar_condition)
    code_p = jnp.where(hist_found, code_p, jnp.int32(R.HistogramNoLocalMax))
    code_p = jnp.where(enough1, code_p, jnp.int32(R.RadiusSearchInsufficientPoints))

    primary_success = code_p == jnp.int32(R.Success)
    depth_primary = jnp.where(primary_success, depth_p, -1.0)
    # Adjust-mode clamps still count as success with modified depth.

    # ---- region growing (optional fast path) ---------------------------
    # The reference wires this feature but its entry point throws
    # (DepthEstimator.cpp:608); here it WORKS (core/row_segmentation.py).
    # Semantics per DepthEstimator.cpp:513-558: seed = minimum-depth
    # window neighbor; hard returns when no seed exists (code 3) or the
    # seed depth exceeds the global max (code 4); a successful grow +
    # segment-depth yields SuccessRegionGrowing and wins over the
    # primary path; any region failure falls through to the primary
    # result (the reference's codes 17-19 are always overwritten by the
    # later stages and never surface — replicated by falling through).
    if cfg.do_use_depth_segmentation:
        from .histogram import nearest_point
        from .row_segmentation import grow_regions, segment_rows

        rows = segment_rows(frame, cfg.max_scan_rows)
        seed_k, has_any = nearest_point(depth1, nb1.mask)
        seed_raw = jnp.take_along_axis(nb1.indices, seed_k[:, None], 1)[:, 0]
        seed_z = jnp.take_along_axis(depth1, seed_k[:, None], 1)[:, 0]
        seed_in_range = seed_z <= cfg.treshold_depth_max
        grow = grow_regions(
            rows, seed_raw, has_any & seed_in_range, features_uv,
            max_dist_threshold=cfg.depth_segmentation_max_treshold_gradient,
            seed_to_seed_start=cfg.depth_segmentation_max_seedpoint_to_seedpoint_distance,
            seed_to_seed_gradient=cfg.depth_segmentation_max_seedpoint_to_seedpoint_distance_gradient,
            neighbor_to_seed_start=cfg.depth_segmentation_max_neighbor_to_seedpoint_distance,
            neighbor_to_seed_gradient=cfg.depth_segmentation_max_neighbor_to_seedpoint_distance_gradient,
            neighbor_start=cfg.depth_segmentation_max_neighbor_distance,
            neighbor_gradient=cfg.depth_segmentation_max_neighbor_distance_gradient,
            max_pointcount=cfg.depth_segmentation_max_pointcount,
            window=cfg.region_grow_window)
        safe_raw = jnp.clip(grow.raw_indices, 0, frame.points_cam.shape[0] - 1)
        rg_points = jnp.where(grow.mask[..., None],
                              jnp.take(frame.points_cam, safe_raw, axis=0), 0.0)
        # planarity check disabled on the region path
        # (DepthEstimator.cpp:551 passes checkPlanar=false)
        depth_rg, code_rg, _ = _segment_depth(
            cfg, rg_points, grow.mask, ray_dir, ray_origin,
            check_planar_enabled=False)
        rg_success = (grow.status == 1) & (code_rg == jnp.int32(R.Success))
        code_p = jnp.where(rg_success & enough1,
                           jnp.int32(R.SuccessRegionGrowing), code_p)
        depth_primary = jnp.where(rg_success & enough1, depth_rg,
                                  depth_primary)
        # hard returns of the region branch
        no_seed = enough1 & ~has_any
        too_deep = enough1 & has_any & ~seed_in_range
        code_p = jnp.where(no_seed, jnp.int32(R.HistogramNoLocalMax), code_p)
        code_p = jnp.where(
            too_deep, jnp.int32(R.TresholdDepthGlobalGreaterMax), code_p)
        depth_primary = jnp.where(no_seed | too_deep, -1.0, depth_primary)
        primary_success = (code_p == jnp.int32(R.Success)) | (
            code_p == jnp.int32(R.SuccessRegionGrowing))
        # the hard returns also skip the road fallback
        primary_success = primary_success | no_seed | too_deep

    # ---- road fallback -------------------------------------------------
    if cfg.do_use_ransac_plane:
        code_f, depth_f, road_count = _road_pass(
            cfg, nb2, ray_origin, ray_dir, gp_coeffs_cam, gp_ok,
            code_p, depth_primary, enough1, primary_success)
    else:
        code_f, depth_f = code_p, depth_primary
        road_count = jnp.zeros((N,), jnp.int32)

    code_f = jnp.where(features_valid, code_f, jnp.int32(R.Unspecified))
    depth_f = jnp.where(features_valid, depth_f, -1.0)
    debug = None
    if cfg.collect_debug:
        if cfg.do_use_histogram_segmentation:
            h_bin, h_lo, h_hi = hist.bin_id, hist.lower, hist.upper
        else:
            h_bin = jnp.full((N,), -1, jnp.int32)
            h_lo = jnp.full((N,), -1.0)
            h_hi = jnp.full((N,), -1.0)
        debug = DepthDebug(
            neighbor_count=nb1.count,
            seg_count=jnp.sum(seg_mask, axis=-1).astype(jnp.int32),
            hist_bin=h_bin, hist_lower=h_lo, hist_upper=h_hi,
            corners=corners_p, road_count=road_count)
    return DepthEstimate(depths=depth_f, codes=code_f,
                         counters=_count(code_f, features_valid),
                         debug=debug)


def _segment_depth(cfg, points, seg_mask, ray_dir, ray_origin,
                   check_planar_enabled: bool):
    """Depth from a segmented point set — the CalculateDepthSegmented
    state machine (DepthEstimator.cpp:903-1037) as a select cascade:
    triangle/first-3/PCA plane, planarity + orthogonality gates, ray
    intersection, global/local depth gates, behind-camera check.

    Returns (depth [N], code [N], corners [N, 3, 3]) with code Success
    where all gates pass; the caller layers its own earlier-stage
    failure codes on top.
    """
    N = ray_dir.shape[0]
    use_triangle = (not cfg.do_use_PCA) and cfg.do_use_triangle_size_maximation
    if use_triangle:
        tri = max_spanning_triangle(points, seg_mask)
        tri_fail_code = jnp.int32(R.TriangleNotPlanarInsufficientPoints)
    else:
        tri = first_three_points(points, seg_mask)
        tri_fail_code = jnp.int32(R.HistogramNoLocalMax)  # DepthEstimator.cpp:920-921

    if (not cfg.do_use_PCA) and check_planar_enabled:
        planar_ok = check_planar(tri.corners,
                                 cfg.triangleplanar_crossnorm_treshold)
    else:
        planar_ok = jnp.ones((N,), bool)

    if cfg.do_use_PCA:
        pca = pca_classify(points, seg_mask,
                           cfg.pca_treshold_3_abs_min,
                           cfg.pca_treshold_3_2_rel_max,
                           cfg.pca_treshold_2_1_rel_min)
        n_unit = pca.normal
        offset = -jnp.sum(n_unit * pca.anchor, axis=-1)
    else:
        n_unit, offset = plane_from_points(
            tri.corners[:, 0], tri.corners[:, 1], tri.corners[:, 2])

    # Orthogonality gate (LinePlaneIntersectionOrthogonalTreshold.cpp:16-48).
    cosang = jnp.abs(jnp.sum(n_unit * ray_dir, axis=-1))
    if cfg.viewray_plane_orthoganality_treshold > 0:
        ortho_ok = cosang >= cfg.viewray_plane_orthoganality_treshold
    else:
        ortho_ok = jnp.ones((N,), bool)

    _, depth = ray_plane_intersection(n_unit, offset, ray_origin, ray_dir)
    depth, gate_code = _apply_depth_gates(cfg, depth, points[..., 2], seg_mask)

    # Select cascade: the FIRST failure in the reference's execution
    # order wins, so overrides are applied lowest-precedence first.
    code = jnp.full((N,), jnp.int32(R.Success))
    code = jnp.where(gate_code != 0, gate_code, code)
    code = jnp.where(ortho_ok, code, jnp.int32(R.PlaneViewrayNotOrthogonal))
    if cfg.do_use_PCA:
        code = jnp.where(pca.is_cubic, jnp.int32(R.PcaIsCubic), code)
        code = jnp.where(pca.is_linear, jnp.int32(R.PcaIsLine), code)
        code = jnp.where(pca.is_point, jnp.int32(R.PcaIsPoint), code)
    else:
        code = jnp.where(planar_ok, code, jnp.int32(R.TriangleNotPlanar))
    code = jnp.where(tri.ok, code, tri_fail_code)
    return depth, code, tri.corners


def _road_pass(cfg, nb2, ray_origin, ray_dir, gp_coeffs_cam, gp_ok,
               code_p, depth_primary, enough1, primary_success):
    """Road-feature fallback (DepthEstimator.cpp:578-597 + :782-900 +
    RoadDepthEstimator*.cpp).

    Ground-plane distances: the reference maps each camera-frame
    neighbor back to the lidar frame (DepthEstimator.cpp:810-812);
    a rigid transform preserves point-plane distance, so the caller
    transforms the PLANE once into the camera frame (plane_to_camera)
    and this pass reuses the already-gathered camera-frame points —
    identical values, one [4]-vector transform instead of an
    [N, K, 3] gather.  `gp_coeffs_cam` is [4] (one plane for all
    features) or [N, 4] (the fused two-frame path); `gp_ok` broadcasts
    likewise.
    """
    N = ray_dir.shape[0]
    enough2 = nb2.count >= cfg.radiusSearch_count_min

    coeffs_cam = gp_coeffs_cam
    if coeffs_cam.ndim == 2:
        coeffs_cam = coeffs_cam[:, None, :]  # [N, 1, 4] vs points [N, K, 3]
    gp_dist = point_plane_distance(nb2.points_cam, coeffs_cam)
    any_far = jnp.any(
        nb2.mask & (gp_dist > cfg.ransac_plane_point_distance_treshold), axis=-1)

    # Inlier flags come rasterized with the window slice (nb2.flags).
    road_mask = nb2.mask & nb2.flags
    road_count = jnp.sum(road_mask, axis=-1)
    if cfg.road_any_far_veto:
        # Reference parity (DepthEstimator.cpp:815-816): ANY neighbor
        # farther than the threshold from the ground plane vetoes the
        # whole road pass — even though the fit below only ever uses
        # inlier-flagged points.  A known reference defect: the widened
        # road window routinely clips a wall/obstacle edge, killing
        # road features that the flagged-inlier fit would handle fine.
        road_seg_ok = ~any_far & (road_count >= 3)
    else:
        # Improved mode (road_any_far_veto=False): off-plane neighbors
        # are simply not in `road_mask`; require enough on-plane
        # support and let the (M-estimator/LS/triangle) fit run.
        road_seg_ok = road_count >= 3

    if cfg.plane_estimator_use_mestimator:
        # Prior weights: distance of each neighbor to the ground plane
        # (frame-independent; see the frame-mix note in the module
        # docstring).  The fit runs on camera-frame points, like the
        # reference.
        fit = mestimator_plane(nb2.points_cam, road_mask, prior_dist=gp_dist)
        road_normal, road_anchor, fit_ok = fit.normal, fit.anchor, fit.ok
    elif cfg.plane_estimator_use_leastsquares:
        ls = least_squares_plane(nb2.points_cam, road_mask)
        road_normal, road_anchor, fit_ok = ls.normal, ls.anchor, ls.ok
    else:  # RoadDepthEstimatorMaxSpanningTriangle.cpp:24-40
        rtri = max_spanning_triangle(nb2.points_cam, road_mask)
        road_normal, _ = plane_from_points(
            rtri.corners[:, 0], rtri.corners[:, 1], rtri.corners[:, 2])
        flat_ok = check_xz_flatness(nb2.points_cam, road_mask,
                                    cfg.plane_estimator_z_x_min_relation)
        road_anchor = rtri.corners[:, 0]
        fit_ok = rtri.ok & flat_ok

    road_offset = -jnp.sum(road_normal * road_anchor, axis=-1)
    _, depth_r = ray_plane_intersection(road_normal, road_offset,
                                        ray_origin, ray_dir)
    depth_r, gate_code_r = _apply_depth_gates(
        cfg, depth_r, nb2.z, road_mask)

    code_r = jnp.full((N,), jnp.int32(R.SuccessRoad))
    code_r = jnp.where(gate_code_r != 0, gate_code_r, code_r)
    if cfg.plane_estimator_use_triangle_maximation:
        # RoadDepthEstimatorMaxSpanningTriangle.cpp:33-40: triangle
        # failure → RadiusSearchInsufficientPoints, flatness failure →
        # InsufficientRoadPoints (checked in that order).
        code_r = jnp.where(flat_ok, code_r, jnp.int32(R.InsufficientRoadPoints))
        code_r = jnp.where(rtri.ok, code_r,
                           jnp.int32(R.RadiusSearchInsufficientPoints))
    del fit_ok  # m-estimator / LS fits always "succeed" in the reference
    depth_r = jnp.where(code_r == jnp.int32(R.SuccessRoad), depth_r, -1.0)

    # Assemble (DepthEstimator.cpp:578-599): road runs only when the
    # primary pass got past the neighbor check but did not succeed, and
    # a segmented ground plane exists.
    road_applicable = gp_ok & enough1 & ~primary_success
    # neighbor-gather failure in the road pass overrides the old code:
    code = jnp.where(road_applicable,
                     jnp.where(enough2,
                               jnp.where(road_seg_ok, code_r, code_p),
                               jnp.int32(R.RadiusSearchInsufficientPoints)),
                     code_p)
    depth = jnp.where(road_applicable,
                      jnp.where(enough2 & road_seg_ok, depth_r, -1.0),
                      depth_primary)
    return code, depth, road_count




def _apply_depth_gates(cfg: DepthEstimatorConfig, depth, neighbor_depths,
                       seg_mask):
    """Global + local threshold gates + behind-camera check.

    Returns (possibly adjusted depth, gate code — 0 if the depth passed).
    Order matches CalculateDepthSegmented (DepthEstimator.cpp:1006-1026):
    global min, global max, local min, local max, behind-camera.
    """
    N = depth.shape[0]
    code = jnp.zeros((N,), jnp.int32)

    if cfg.treshold_depth_enabled:
        below = depth < cfg.treshold_depth_min
        above = depth > cfg.treshold_depth_max
        if cfg.treshold_depth_mode == 0:  # Dispose
            code = jnp.where(above & (code == 0),
                             jnp.int32(R.TresholdDepthGlobalGreaterMax), code)
            code = jnp.where(below & (code == 0),
                             jnp.int32(R.TresholdDepthGlobalSmallerMin), code)
        else:  # Adjust
            depth = jnp.clip(depth, cfg.treshold_depth_min, cfg.treshold_depth_max)

    if cfg.treshold_depth_local_enabled:
        big = jnp.asarray(jnp.inf, depth.dtype)
        z = neighbor_depths
        min_z = jnp.min(jnp.where(seg_mask, z, big), axis=-1)
        max_z = jnp.max(jnp.where(seg_mask, z, -big), axis=-1)
        interval = max_z - min_z
        if cfg.treshold_depth_local_valuetype == 1:  # relative
            tol = interval * cfg.treshold_depth_local_value
        else:
            tol = jnp.full_like(interval, cfg.treshold_depth_local_value)
        lo = min_z - tol
        hi = max_z + tol
        below = depth < lo
        above = depth > hi
        has_pts = jnp.any(seg_mask, axis=-1)
        if cfg.treshold_depth_local_mode == 0:  # Dispose
            code = jnp.where(has_pts & below & (code == 0),
                             jnp.int32(R.TresholdDepthLocalSmallerMin), code)
            code = jnp.where(has_pts & above & (code == 0),
                             jnp.int32(R.TresholdDepthLocalGreaterMax), code)
        else:
            depth = jnp.where(has_pts, jnp.clip(depth, lo, hi), depth)

    if cfg.do_use_cut_behind_camera:
        code = jnp.where((depth < 0) & (code == 0),
                         jnp.int32(R.CornerBehindCamera), code)
    return depth, code


def _count(codes, valid):
    onehot = jax.nn.one_hot(codes, NUM_RESULT_TYPES, dtype=jnp.int32)
    return jnp.sum(onehot * valid[:, None].astype(jnp.int32), axis=0)
