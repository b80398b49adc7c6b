"""Batched RANSAC / semantic ground-plane estimation.

Batched replacement for `RansacPlane` / `SemanticPlane`
(RansacPlane.cpp:26-274).  The reference runs PCL's sequential RANSAC
(adaptive iteration count, p = 0.999 early exit, <= 10000 iterations) on
a 6000-point random subsample.  Here the hypothesis loop becomes a
fixed-size tensor program: S pre-drawn 3-point hypotheses evaluated
simultaneously, residuals as one [S, P_sub] matmul, argmax
inlier count.  With S = 1024 parallel hypotheses the failure probability
for inlier ratio r is (1 - r^3)^S — < 1e-9 for r >= 0.25, matching the
sequential scheme's 0.999 guarantee with margin.

Replicated reference quirks (documented):
  * The axis constraint is |angle(n, z_lidar)| <= 10 deg
    (RansacPlane.cpp:94-99, SampleConsensusModelPerpendicularPlane).
  * Refinement (RansacPlane.cpp:117-126): coefficients come from an LS
    fit on the RANSAC inliers, but the final inlier set comes from
    `selectWithinDistance(UNrefined coeffs, refinement_threshold)` over
    the SUBSAMPLE only — so with the default refinement threshold of
    10.2 m the inlier set is effectively "the subsample", and only
    subsampled points can ever pass `CheckPointInPlane`.  Set
    `inliers_from_full_cloud=True` for the corrected semantics
    (select over the full cloud with the refined coefficients).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import jax
import jax.numpy as jnp

from .geometry import smallest_eigenvector_sym3x3
from ..precision import f32_matmuls


class GroundPlane(NamedTuple):
    """Ground-plane estimate in the LIDAR frame (the reference fits on
    the raw lidar cloud; tracklets pass it around per frame)."""

    coeffs: jnp.ndarray  # [4] (a, b, c, d): a x + b y + c z + d = 0, |n|=1
    inlier_mask: jnp.ndarray  # [P] bool over the raw cloud
    ok: jnp.ndarray  # scalar bool: fit valid (>= 3 usable points)


def _ls_plane(points: jnp.ndarray, w: jnp.ndarray) -> jnp.ndarray:
    """Weighted LS plane through masked points → coeffs [4], unit normal."""
    wsum = jnp.sum(w)
    safe = jnp.where(wsum == 0, 1.0, wsum)
    c = jnp.sum(points * w[:, None], axis=0) / safe
    centered = (points - c) * jnp.sqrt(w)[:, None]
    scatter = centered.T @ centered
    n = smallest_eigenvector_sym3x3(scatter)
    return jnp.concatenate([n, -jnp.sum(n * c)[None]])


@f32_matmuls
def fit_ground_plane_ransac(
    points_lidar: jnp.ndarray,
    valid: jnp.ndarray,
    key: jax.Array,
    *,
    distance_threshold: float = 0.3,
    min_z: float = -10000.0,
    max_z: float = 10000.0,
    num_hypotheses: int = 1024,
    subsample: int = 6000,
    axis_max_angle_deg: float = 10.0,
    use_refinement: bool = True,
    refinement_threshold: float = 10.2,
    inliers_from_full_cloud: bool = False,
) -> GroundPlane:
    """Fit the ground plane to a lidar cloud with batched RANSAC.

    Args:
      points_lidar: [P, 3] padded cloud (lidar frame, z up).
      valid: [P] bool padding mask.
      key: PRNG key (subsample + hypothesis draws).
    """
    P = points_lidar.shape[0]
    pts32 = points_lidar.astype(jnp.float32)

    # z pass-through filter — only active when min_z > -1001
    # (RansacPlane.cpp:58-64 guards on min_z > -1001).
    zmask = valid
    if min_z > -1001.0:
        zmask = zmask & (points_lidar[:, 2] > min_z) & (points_lidar[:, 2] < max_z)

    # Random subsample of `subsample` candidate points.  The reference
    # samples without replacement (pcl::RandomSample,
    # RansacPlane.cpp:66-74); we draw uniform indices WITH replacement —
    # an O(S) draw instead of an O(P log P) argsort; for 6000 of ~120k
    # points the expected duplicate fraction is ~2.5%, statistically
    # immaterial to the consensus count.  Indices that land on padded /
    # z-filtered points are masked out of the evaluation.
    k_sub, k_hyp = jax.random.split(key)
    n_valid_prefix = jnp.sum(valid)  # pad_cloud packs valid points first
    sub_idx = jax.random.randint(
        k_sub, (subsample,), 0, jnp.maximum(n_valid_prefix, 1))
    sub_pts = pts32[sub_idx]  # [S_sub, 3]
    sub_ok = zmask[sub_idx]  # protects non-packed clouds too
    n_usable = jnp.sum(zmask)

    # Pre-drawn minimal sample sets: [S, 3] indices into the subsample.
    # Degenerate draws (repeats / collinear) produce near-zero normals
    # and are killed by the axis constraint below.
    picks = jax.random.randint(k_hyp, (num_hypotheses, 3), 0, subsample)
    tri = sub_pts[picks]  # [S, 3, 3]
    tri_ok = jnp.all(sub_ok[picks], axis=-1)
    n_raw = jnp.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    n_norm = jnp.linalg.norm(n_raw, axis=-1, keepdims=True)
    n_unit = n_raw / jnp.where(n_norm < 1e-12, 1.0, n_norm)
    d = -jnp.sum(n_unit * tri[:, 0], axis=-1)  # [S]

    cos_eps = math.cos(math.radians(axis_max_angle_deg))
    axis_ok = jnp.abs(n_unit[:, 2]) >= cos_eps
    hyp_ok = tri_ok & axis_ok & (n_norm[:, 0] >= 1e-12)

    # Residuals for all hypotheses over the subsample: one matmul.
    res = jnp.abs(sub_pts @ n_unit.T + d[None, :])  # [S_sub, S]
    inl = (res < distance_threshold) & sub_ok[:, None]
    counts = jnp.where(hyp_ok, jnp.sum(inl, axis=0), -1)
    best = jnp.argmax(counts)
    best_coeffs = jnp.concatenate([n_unit[best], d[best][None]])
    best_inl_sub = inl[:, best]  # [S_sub]

    if use_refinement:
        refined = _ls_plane(sub_pts, best_inl_sub.astype(jnp.float32))
        if inliers_from_full_cloud:
            dist_full = jnp.abs(pts32 @ refined[:3] + refined[3])
            inlier_mask = zmask & (dist_full < refinement_threshold)
        else:
            # Reference: select within refinement distance of the
            # UNrefined model, over the subsample only.
            dist_sub = jnp.abs(sub_pts @ best_coeffs[:3] + best_coeffs[3])
            sel = sub_ok & (dist_sub < refinement_threshold)
            inlier_mask = jnp.zeros((P,), dtype=bool).at[sub_idx].set(sel)
        coeffs = refined
    else:
        coeffs = best_coeffs
        inlier_mask = jnp.zeros((P,), dtype=bool).at[sub_idx].set(best_inl_sub)

    ok = (n_usable >= 3) & (counts[best] > 0)
    coeffs = _orient_up(coeffs)
    return GroundPlane(coeffs=coeffs, inlier_mask=inlier_mask & valid, ok=ok)


@f32_matmuls
def fit_ground_plane_semantic(
    points_lidar: jnp.ndarray,
    valid: jnp.ndarray,
    semantic_image: jnp.ndarray,
    lidar_to_cam_rotation: jnp.ndarray,
    lidar_to_cam_translation: jnp.ndarray,
    intrinsics: jnp.ndarray,
    *,
    ground_labels: tuple[int, ...] = (6, 7, 8, 9),
    inlier_threshold: float = 10.2,
) -> GroundPlane:
    """Ground plane from a semantic segmentation image.

    Replicates SemanticPlane::CalculateInliersPlane
    (RansacPlane.cpp:195-274): project the cloud into the image, keep
    points labeled as road (labels {6,7,8,9}, RansacPlane.h:217), LS-fit
    a plane to them IN THE LIDAR FRAME, re-select inliers within
    `inlier_threshold` over the FULL cloud, refit on those.

    Args:
      semantic_image: [H, W] integer label image.
      lidar_to_cam_*: extrinsics used only for projection.
      intrinsics: [3, 3] camera matrix.
    """
    H, W = semantic_image.shape
    pts32 = points_lidar.astype(jnp.float32)
    p_cam = pts32 @ lidar_to_cam_rotation.T + lidar_to_cam_translation
    proj = p_cam @ intrinsics.T
    z = proj[:, 2]
    safe_z = jnp.where(z == 0, 1.0, z)
    u = proj[:, 0] / safe_z
    v = proj[:, 1] / safe_z
    # Reference bounds check uses 0 <= u <= cols (RansacPlane.cpp:203-205)
    # and does not test z > 0; points behind the camera project mirrored.
    # We additionally require z > 0 (correctness fix, documented).
    in_img = (u >= 0) & (u <= W) & (v >= 0) & (v <= H) & (z > 0)
    ui = jnp.clip(u.astype(jnp.int32), 0, W - 1)
    vi = jnp.clip(v.astype(jnp.int32), 0, H - 1)
    labels = semantic_image[vi, ui]
    on_ground = jnp.zeros_like(in_img)
    for lab in ground_labels:
        on_ground = on_ground | (labels == lab)
    seed = valid & in_img & on_ground

    coeffs0 = _ls_plane(pts32, seed.astype(jnp.float32))
    dist = jnp.abs(pts32 @ coeffs0[:3] + coeffs0[3])
    refined_mask = valid & (dist < inlier_threshold)
    coeffs = _ls_plane(pts32, refined_mask.astype(jnp.float32))
    ok = jnp.sum(seed) >= 3
    return GroundPlane(coeffs=_orient_up(coeffs), inlier_mask=refined_mask, ok=ok)


def _orient_up(coeffs: jnp.ndarray) -> jnp.ndarray:
    """Canonical orientation: normal z-component >= 0."""
    flip = jnp.where(coeffs[2] < 0, -1.0, 1.0)
    return coeffs * flip
