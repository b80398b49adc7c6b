"""Batched local plane estimation over masked neighbor sets.

Batched replacements for the reference's per-feature plane machinery:
  * max-spanning triangle   (PlaneEstimationCalcMaxSpanningTriangle.cpp:37-144)
  * triangle planarity check (PlaneEstimationCheckPlanar.cpp:18-44)
  * M-estimator plane fit    (PlaneEstimationMEstimator.cpp:18-55)
  * least-squares plane fit  (PlaneEstimationLeastSquares.cpp — the
    reference's Ceres version has a misparenthesized residual
    (ErrorPlane.h:31-32) and an out-of-bounds read
    (PlaneEstimationLeastSquares.cpp:41); we implement the intended
    orthogonal-distance LS fit in closed form instead)
  * PCA patch classifier     (PCA.cpp:21-62)
  * XZ flatness check        (LinePlaneIntersectionCeckXZTreshold.cpp:15-50)

All operate on [N, K, 3] point tensors with [N, K] masks; the O(K²)
pairwise-distance searches are dense masked tensors (K is the static
window size, ~70), evaluated for all N features at once.  3x3
eigenproblems use the closed-form solver in `geometry` — no LAPACK, no
iterative SVD.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from .geometry import smallest_eigenvector_sym3x3, sym3x3_eigenvalues


class TriangleResult(NamedTuple):
    corners: jnp.ndarray  # [N, 3, 3] the three corner points
    ok: jnp.ndarray  # [N] bool


def max_spanning_triangle(points: jnp.ndarray, mask: jnp.ndarray,
                          dist_threshold: float = 0.0) -> TriangleResult:
    """Pick 3 points spanning the maximal triangle, per feature.

    Replicates PlaneEstimationCalcMaxSpanningTriangle.cpp:37-144: the
    farthest pair (i, j) by squared distance (first maximizer in
    row-major scan order, matching the reference's strict-> update), then
    the third point k maximizing d(k,i)+d(k,j) with both legs >
    dist_threshold.  Fails if < 3 points, all points coincide
    (maxdist <= threshold), or no valid third point.

    Deviation (documented): the reference's third-corner loop runs
    `k < pointsCount - 1`, silently never considering the LAST point as
    third corner; we consider all points.
    """
    N, K, _ = points.shape
    # Pairwise squared distances via the Gram matrix — the inner products
    # are one batched contraction instead of [N, K, K, 3] differences.
    sq = jnp.sum(points * points, axis=-1)  # [N, K]
    gram = jnp.einsum("nki,nji->nkj", points, points,
                      preferred_element_type=points.dtype)
    d2 = jnp.maximum(sq[:, :, None] + sq[:, None, :] - 2.0 * gram, 0.0)
    pair_ok = mask[:, :, None] & mask[:, None, :]
    iu = jnp.triu(jnp.ones((K, K), dtype=bool), k=1)
    d2_pairs = jnp.where(pair_ok & iu, d2, -1.0)

    flat = d2_pairs.reshape(N, K * K)
    best = jnp.argmax(flat, axis=-1)
    maxdist = jnp.take_along_axis(flat, best[:, None], axis=-1)[:, 0]
    i_idx = (best // K).astype(jnp.int32)
    j_idx = (best % K).astype(jnp.int32)

    count = jnp.sum(mask, axis=-1)
    ok = (count >= 3) & (maxdist > dist_threshold)

    d_i = jnp.take_along_axis(d2, i_idx[:, None, None], axis=2)[:, :, 0]  # [N,K]
    d_j = jnp.take_along_axis(d2, j_idx[:, None, None], axis=2)[:, :, 0]
    k_range = jnp.arange(K, dtype=jnp.int32)
    k_ok = (mask
            & (k_range[None, :] != i_idx[:, None])
            & (k_range[None, :] != j_idx[:, None])
            & (d_i > dist_threshold)
            & (d_j > dist_threshold))
    score = jnp.where(k_ok, d_i + d_j, -1.0)
    k_idx = jnp.argmax(score, axis=-1).astype(jnp.int32)
    k_valid = jnp.take_along_axis(score, k_idx[:, None], axis=-1)[:, 0] > -1.0
    ok = ok & k_valid

    c1 = jnp.take_along_axis(points, i_idx[:, None, None], axis=1)[:, 0]
    c2 = jnp.take_along_axis(points, j_idx[:, None, None], axis=1)[:, 0]
    c3 = jnp.take_along_axis(points, k_idx[:, None, None], axis=1)[:, 0]
    corners = jnp.stack([c1, c2, c3], axis=1)
    return TriangleResult(corners=corners, ok=ok)


def first_three_points(points: jnp.ndarray, mask: jnp.ndarray
                       ) -> TriangleResult:
    """First three masked points in scan order (the reference's
    no-triangle-maximization path, DepthEstimator.cpp:919-926)."""
    N, K, _ = points.shape
    order = jnp.cumsum(mask.astype(jnp.int32), axis=-1) - 1  # rank of each pt
    corners = []
    for r in range(3):
        sel = mask & (order == r)
        idx = jnp.argmax(sel, axis=-1)
        corners.append(jnp.take_along_axis(points, idx[:, None, None], axis=1)[:, 0])
    ok = jnp.sum(mask, axis=-1) >= 3
    return TriangleResult(corners=jnp.stack(corners, axis=1), ok=ok)


def check_planar(corners: jnp.ndarray, threshold: float) -> jnp.ndarray:
    """Triangle non-degeneracy: all pairwise cross products of the
    normalized edges have norm >= threshold
    (PlaneEstimationCheckPlanar.cpp:18-44).  corners [N, 3, 3] → [N]."""
    c1, c2, c3 = corners[:, 0], corners[:, 1], corners[:, 2]
    e1 = _unit(c2 - c1)
    e2 = _unit(c3 - c1)
    e3 = _unit(c3 - c2)
    l12 = jnp.linalg.norm(jnp.cross(e1, e2), axis=-1)
    l13 = jnp.linalg.norm(jnp.cross(e1, e3), axis=-1)
    l23 = jnp.linalg.norm(jnp.cross(e2, e3), axis=-1)
    return (l12 >= threshold) & (l13 >= threshold) & (l23 >= threshold)


class PlaneFit(NamedTuple):
    normal: jnp.ndarray  # [N, 3] unit normal
    anchor: jnp.ndarray  # [N, 3] point on the plane
    ok: jnp.ndarray  # [N]


def mestimator_plane(points: jnp.ndarray, mask: jnp.ndarray,
                     prior_normal: jnp.ndarray = None,
                     prior_offset: jnp.ndarray = None,
                     prior_dist: jnp.ndarray = None,
                     eps: float = 1e-9) -> PlaneFit:
    """Weighted plane fit with prior-distance weights.

    Replicates PlaneEstimationMEstimator.cpp:18-55: weights
    w_i = 1 / |prior_n·p_i + prior_d|, weighted centroid, plane normal =
    smallest eigenvector of the weighted scatter matrix
    Σ w_i (p_i - c)(p_i - c)ᵀ (== left singular vector of the weighted
    centered matrix for its smallest singular value).  The reference
    divides by the raw distance (inf weights on the prior plane); we
    clamp the distance at `eps`.

    Supply EITHER (prior_normal [N,3]/[3] + prior_offset [N]/scalar),
    or precomputed prior distances `prior_dist` [N, K] (used by the
    road pass, whose prior lives in a different frame than the points).
    """
    if prior_dist is None:
        prior_dist = jnp.abs(
            jnp.sum(points * prior_normal[..., None, :], axis=-1)
            + prior_offset[..., None])
    w = jnp.where(mask, 1.0 / jnp.maximum(prior_dist, eps), 0.0)  # [N, K]
    wsum = jnp.sum(w, axis=-1, keepdims=True)
    safe_wsum = jnp.where(wsum == 0, 1.0, wsum)
    center = jnp.sum(w[..., None] * points, axis=-2) / safe_wsum  # [N, 3]
    centered = (points - center[..., None, :]) * jnp.sqrt(w)[..., None]
    scatter = jnp.einsum("nki,nkj->nij", centered, centered)
    normal = smallest_eigenvector_sym3x3(scatter)
    ok = (jnp.sum(mask, axis=-1) >= 3) & (wsum[..., 0] > 0)
    return PlaneFit(normal=normal, anchor=center, ok=ok)


def least_squares_plane(points: jnp.ndarray, mask: jnp.ndarray) -> PlaneFit:
    """Unweighted orthogonal-distance LS plane fit (intended behavior of
    PlaneEstimationLeastSquares.cpp; see module docstring)."""
    m = mask[..., None].astype(points.dtype)
    cnt = jnp.sum(mask, axis=-1, keepdims=True).astype(points.dtype)
    safe_cnt = jnp.where(cnt == 0, 1.0, cnt)
    center = jnp.sum(points * m, axis=-2) / safe_cnt
    centered = (points - center[..., None, :]) * m
    scatter = jnp.einsum("nki,nkj->nij", centered, centered)
    normal = smallest_eigenvector_sym3x3(scatter)
    return PlaneFit(normal=normal, anchor=center,
                    ok=jnp.sum(mask, axis=-1) >= 3)


class PCAResult(NamedTuple):
    # Classification codes: 0=Plane, 1=Point, 2=Linear, 3=Cubic.
    is_plane: jnp.ndarray  # [N]
    is_point: jnp.ndarray
    is_linear: jnp.ndarray
    is_cubic: jnp.ndarray
    normal: jnp.ndarray  # [N, 3] smallest-eigenvalue eigenvector
    anchor: jnp.ndarray  # [N, 3] mean


def pca_classify(points: jnp.ndarray, mask: jnp.ndarray,
                 treshold_3_abs_min: float,
                 treshold_3_2_rel_max: float,
                 treshold_2_1_rel_min: float) -> PCAResult:
    """PCA patch classification (PCA.cpp:21-62).

    The reference uses the RAW scatter matrix (centered @ centeredᵀ, not
    normalized by count) — replicated.  Eigenvalues ascending e1<=e2<=e3:
      cubic  if (e2-e1)/e3 <  treshold_2_1_rel_min     ("planarity")
      linear if (e3-e2)/e3 >  treshold_3_2_rel_max     ("linearity")
      point  if  e3        <  treshold_3_abs_min
      plane  otherwise; normal = eigenvector of e1, anchor = mean.
    Checks apply in that order (PCA.cpp:27-39).
    """
    m = mask[..., None].astype(points.dtype)
    cnt = jnp.sum(mask, axis=-1, keepdims=True).astype(points.dtype)
    safe_cnt = jnp.where(cnt == 0, 1.0, cnt)
    mean = jnp.sum(points * m, axis=-2) / safe_cnt
    centered = (points - mean[..., None, :]) * m
    cov = jnp.einsum("nki,nkj->nij", centered, centered)
    evals = sym3x3_eigenvalues(cov)
    e1, e2, e3 = evals[..., 0], evals[..., 1], evals[..., 2]
    safe_e3 = jnp.where(e3 == 0, 1.0, e3)
    planarity = (e2 - e1) / safe_e3
    linearity = (e3 - e2) / safe_e3
    is_cubic = planarity < treshold_2_1_rel_min
    is_linear = ~is_cubic & (linearity > treshold_3_2_rel_max)
    is_point = ~is_cubic & ~is_linear & (e3 < treshold_3_abs_min)
    is_plane = ~is_cubic & ~is_linear & ~is_point
    normal = smallest_eigenvector_sym3x3(cov)
    return PCAResult(is_plane=is_plane, is_point=is_point,
                     is_linear=is_linear, is_cubic=is_cubic,
                     normal=normal, anchor=mean)


def check_xz_flatness(points: jnp.ndarray, mask: jnp.ndarray,
                      threshold: float) -> jnp.ndarray:
    """Flatness ratio sizeZ/sizeX >= threshold over the masked set
    (LinePlaneIntersectionCeckXZTreshold.cpp:15-50), used by the
    triangle-based road estimator."""
    x = points[..., 0]
    z = points[..., 2]
    big = jnp.asarray(jnp.inf, points.dtype)
    min_x = jnp.min(jnp.where(mask, x, big), axis=-1)
    max_x = jnp.max(jnp.where(mask, x, -big), axis=-1)
    min_z = jnp.min(jnp.where(mask, z, big), axis=-1)
    max_z = jnp.max(jnp.where(mask, z, -big), axis=-1)
    size_x = max_x - min_x
    size_z = max_z - min_z
    safe_x = jnp.where(size_x == 0, 1e-30, size_x)
    return jnp.where(jnp.any(mask, axis=-1), size_z / safe_x >= threshold, False)


def _unit(v: jnp.ndarray) -> jnp.ndarray:
    n = jnp.linalg.norm(v, axis=-1, keepdims=True)
    return v / jnp.where(n == 0, 1.0, n)
