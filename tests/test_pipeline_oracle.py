"""Whole-pipeline literal oracle fuzz.

A plain-numpy, per-feature-loop port of the reference's depth state
machine (`DepthEstimator::CalculateDepth`, DepthEstimator.cpp:491-600;
`CalculateDepthSegmented` :903-1037; road fallback :782-900 +
RoadDepthEstimator*.cpp) — exactly as written, including code
precedence — fuzzed against the batched pipeline across random
scenes x configs.

Where the batched build deliberately deviates from the reference (each
deviation documented at its implementation site), the oracle follows
the build's documented semantics:
  * grid collision rule "nearest" (packed zq|idx scatter-min) instead
    of scan-order-dependent first-wins (projection.py);
  * neighbor x/y reconstructed from the quantized subpixel planes
    (projection.py — exactness argument there);
  * M-estimator prior weights from frame-independent plane distances
    (depth_estimator.py module docstring);
  * least-squares road fit = the INTENDED orthogonal-distance fit (the
    reference's Ceres residual is buggy, planefit.py);
  * the triangle search considers the last point as third corner
    (planefit.py: the reference's loop runs k < n-1).

Scenes are generated with QUANTIZATION MARGINS — feature/point
subpixel positions away from cell borders, depths away from histogram
bin edges — so f32-rounding differences between XLA and numpy cannot
flip discretization decisions; a small residual mismatch budget covers
argmax near-ties in the triangle search (f32 Gram-matmul distances vs
numpy differences).
"""

import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from mono_lidar_depth_tpu import (DepthEstimatorConfig, GroundPlane,
                                  PinholeCamera, SE3, estimate_depths)
from mono_lidar_depth_tpu.core.result_types import DepthResultType as R

W_IMG, H_IMG = 256, 128
CAM = PinholeCamera(width=250, height=120, focal_length=160.0,
                    cx=125.0, cy=60.0)
P_MAX = 4096
N_FEAT = 128

_IDX_BITS = 17
_ZQ_MAX = (1 << (31 - _IDX_BITS)) - 2
_ZQ_RANGE = 160.0


# ---------------------------------------------------------------------------
# The literal numpy oracle
# ---------------------------------------------------------------------------


def _project(cfg, cam, T_R, T_t, cloud, valid):
    """Projection + grid construction, mirroring projection.py."""
    p_cam = (cloud.astype(np.float32) @ T_R.T.astype(np.float32)
             + T_t.astype(np.float32))
    z = p_cam[:, 2]
    safe_z = np.where(z == 0, np.float32(1.0), z)
    u = np.float32(cam.focal_length) * p_cam[:, 0] / safe_z + np.float32(cam.cx)
    v = np.float32(cam.focal_length) * p_cam[:, 1] / safe_z + np.float32(cam.cy)
    visible = ((u > 0) & (u < cam.width) & (v > 0) & (v < cam.height)
               & (z != 0) & valid & (z > 0))
    H, W = cfg.image_height, cfg.image_width
    x_pix = np.clip(u.astype(np.int32), 0, W - 1)
    y_pix = np.clip(v.astype(np.int32), 0, H - 1)
    grid = np.full((H, W), -1, np.int64)
    if cfg.grid_collision_rule == "nearest":
        zq = np.clip((z * np.float32(_ZQ_MAX / _ZQ_RANGE)).astype(np.int64),
                     0, _ZQ_MAX)
        key = (zq << _IDX_BITS) | np.arange(len(cloud), dtype=np.int64)
    else:
        key = np.arange(len(cloud), dtype=np.int64)
    best = {}
    for i in np.nonzero(visible)[0]:
        cell = (y_pix[i], x_pix[i])
        if cell not in best or key[i] < best[cell]:
            best[cell] = key[i]
            grid[cell] = i
    # decoded winner coordinates (the build's subpixel-quantized x, y)
    qu = np.clip(np.floor((u - x_pix) * np.float32(4096.0)), 0, 4095)
    qv = np.clip(np.floor((v - y_pix) * np.float32(4096.0)), 0, 4095)
    uu = x_pix + (qu + 0.5) / 4096.0
    vv = y_pix + (qv + 0.5) / 4096.0
    x_dec = (uu - cam.cx) / cam.focal_length * z.astype(np.float64)
    y_dec = (vv - cam.cy) / cam.focal_length * z.astype(np.float64)
    pts_dec = np.stack([x_dec, y_dec, z.astype(np.float64)], axis=1)
    return grid, pts_dec, u, v


def _neighbors(cfg, cam, grid, pts_dec, fu, fv, scale_x=1.0, scale_y=1.0):
    """Rect scan, row-major (NeighborFinderPixel.cpp:60-95)."""
    H, W = grid.shape
    hx = cfg.pixelarea_search_witdh * 0.5 * scale_x
    hy = cfg.pixelarea_search_height * 0.5 * scale_y
    left = max(np.float32(fu) - np.float32(hx), 0.0)
    right = min(np.float32(fu) + np.float32(hx), float(W - 1))
    top = max(np.float32(fv) - np.float32(hy), 0.0)
    bottom = min(np.float32(fv) + np.float32(hy), float(H - 1))
    idxs = []
    for y in range(int(top), int(bottom) + 1):
        for x in range(int(left), int(right) + 1):
            if grid[y, x] >= 0:
                idxs.append(int(grid[y, x]))
    pts = [pts_dec[i] for i in idxs]
    return idxs, pts


def _histogram_select(depths, bin_width, min_count):
    """Literal FilterPointsMinDistBlob (HistogramPointDepth.cpp:36-122)."""
    depths = [min(float(d), 999.0) for d in depths]
    max_dist = 0
    for d in depths:
        if d > max_dist:
            max_dist = math.ceil(d)
    bin_count = int(max_dist / bin_width + 1)
    if bin_count <= 1:
        return False, []
    counts = [0] * bin_count
    for d in depths:
        b = int(min(abs(d) / bin_width, bin_count - 1))
        counts[b] += 1
    bin_max_id, bin_max_val, bin_value = -1, -1, 0
    for i in range(bin_count):
        last = bin_value
        bin_value = counts[i]
        if bin_value > bin_max_val and bin_value >= min_count:
            bin_max_val = bin_value
            bin_max_id = i
        elif bin_value < bin_max_val:
            break
        if last > 0 and bin_value == 0:
            return False, []
    if bin_max_id < 0:
        return False, []
    lower = bin_max_id * bin_width
    upper = lower + bin_width
    return True, [k for k, d in enumerate(depths) if lower <= d < upper]


def _max_spanning_triangle(pts, dist_threshold=0.0):
    """PlaneEstimationCalcMaxSpanningTriangle.cpp:37-144 with the
    documented last-point deviation (all points considered as third)."""
    n = len(pts)
    if n < 3:
        return None
    best_d, bi, bj = -1.0, -1, -1
    for i in range(n):
        for j in range(i + 1, n):
            d = float(np.sum((np.float32(pts[i]) - np.float32(pts[j])) ** 2))
            if d > best_d:
                best_d, bi, bj = d, i, j
    if best_d <= dist_threshold:
        return None
    best_s, bk = -1.0, -1
    for k in range(n):
        if k == bi or k == bj:
            continue
        d_i = float(np.sum((np.float32(pts[k]) - np.float32(pts[bi])) ** 2))
        d_j = float(np.sum((np.float32(pts[k]) - np.float32(pts[bj])) ** 2))
        if d_i > dist_threshold and d_j > dist_threshold:
            s = d_i + d_j
            if s > best_s:
                best_s, bk = s, k
    if bk < 0:
        return None
    return np.asarray(pts[bi]), np.asarray(pts[bj]), np.asarray(pts[bk])


def _check_planar(c1, c2, c3, threshold):
    def unit(v):
        nv = np.linalg.norm(v)
        return v / (nv if nv else 1.0)
    e1, e2, e3 = unit(c2 - c1), unit(c3 - c1), unit(c3 - c2)
    return (np.linalg.norm(np.cross(e1, e2)) >= threshold
            and np.linalg.norm(np.cross(e1, e3)) >= threshold
            and np.linalg.norm(np.cross(e2, e3)) >= threshold)


def _ray(cam, fu, fv):
    d = np.array([(fu - cam.cx) / cam.focal_length,
                  (fv - cam.cy) / cam.focal_length, 1.0])
    d = d / np.linalg.norm(d)
    return d if d[2] >= 0 else -d


def _intersect(normal, offset, ray_dir):
    denom = float(np.dot(normal, ray_dir))
    if denom == 0:
        return -np.inf
    t = -offset / denom
    return float(t * ray_dir[2])


def _gates(cfg, depth, seg_z):
    """Global + local gates + behind-camera (order of
    CalculateDepthSegmented, DepthEstimator.cpp:1006-1026).
    Returns (depth', code or None)."""
    if cfg.treshold_depth_enabled:
        if cfg.treshold_depth_mode == 0:
            if depth > cfg.treshold_depth_max:
                return -1.0, int(R.TresholdDepthGlobalGreaterMax)
            if depth < cfg.treshold_depth_min:
                return -1.0, int(R.TresholdDepthGlobalSmallerMin)
        else:
            depth = min(max(depth, cfg.treshold_depth_min),
                        cfg.treshold_depth_max)
    if cfg.treshold_depth_local_enabled and len(seg_z) > 0:
        lo_z, hi_z = min(seg_z), max(seg_z)
        if cfg.treshold_depth_local_valuetype == 1:
            tol = (hi_z - lo_z) * cfg.treshold_depth_local_value
        else:
            tol = cfg.treshold_depth_local_value
        lo, hi = lo_z - tol, hi_z + tol
        if cfg.treshold_depth_local_mode == 0:
            if depth < lo:
                return -1.0, int(R.TresholdDepthLocalSmallerMin)
            if depth > hi:
                return -1.0, int(R.TresholdDepthLocalGreaterMax)
        else:
            depth = min(max(depth, lo), hi)
    if depth < 0 and cfg.do_use_cut_behind_camera:
        return -1.0, int(R.CornerBehindCamera)
    return depth, None


def _pca_classify(cfg, pts):
    pts = np.asarray(pts, np.float64)
    mean = pts.mean(axis=0)
    centered = pts - mean
    cov = centered.T @ centered  # raw scatter, PCA.cpp
    evals, evecs = np.linalg.eigh(cov)
    e1, e2, e3 = evals
    safe_e3 = e3 if e3 != 0 else 1.0
    planarity = (e2 - e1) / safe_e3
    linearity = (e3 - e2) / safe_e3
    if planarity < cfg.pca_treshold_2_1_rel_min:
        return "cubic", None, None
    if linearity > cfg.pca_treshold_3_2_rel_max:
        return "linear", None, None
    if e3 < cfg.pca_treshold_3_abs_min:
        return "point", None, None
    return "plane", evecs[:, 0], mean


def _segment_depth(cfg, cam, pts, fu, fv, check_planar):
    """CalculateDepthSegmented (DepthEstimator.cpp:903-1037)."""
    if not cfg.do_use_PCA and cfg.do_use_triangle_size_maximation:
        tri = _max_spanning_triangle(pts)
        if tri is None:
            return -1.0, int(R.TriangleNotPlanarInsufficientPoints)
        c1, c2, c3 = tri
    else:
        if len(pts) < 3:
            return -1.0, int(R.HistogramNoLocalMax)
        c1, c2, c3 = (np.asarray(pts[0]), np.asarray(pts[1]),
                      np.asarray(pts[2]))
    if not cfg.do_use_PCA and check_planar:
        if not _check_planar(c1, c2, c3,
                             cfg.triangleplanar_crossnorm_treshold):
            return -1.0, int(R.TriangleNotPlanar)
    ray = _ray(cam, fu, fv)
    if cfg.do_use_PCA:
        kind, normal, anchor = _pca_classify(cfg, pts)
        if kind == "point":
            return -1.0, int(R.PcaIsPoint)
        if kind == "linear":
            return -1.0, int(R.PcaIsLine)
        if kind == "cubic":
            return -1.0, int(R.PcaIsCubic)
        offset = -float(np.dot(normal, anchor))
    else:
        n = np.cross(c2 - c1, c3 - c1)
        nv = np.linalg.norm(n)
        normal = n / (nv if nv else 1.0)
        offset = -float(np.dot(normal, c1))
    # orthogonality gate (LinePlaneIntersectionOrthogonalTreshold)
    if cfg.viewray_plane_orthoganality_treshold > 0:
        if abs(float(np.dot(normal, ray))) < \
                cfg.viewray_plane_orthoganality_treshold:
            return -1.0, int(R.PlaneViewrayNotOrthogonal)
    depth = _intersect(normal, offset, ray)
    seg_z = [float(p[2]) for p in pts]
    depth, code = _gates(cfg, depth, seg_z)
    if code is not None:
        return -1.0, code
    return depth, int(R.Success)


def oracle_feature(cfg, cam, grid, pts_dec, gp_coeffs_cam, gp_inlier,
                   gp_ok, fu, fv):
    """The per-feature state machine (DepthEstimator.cpp:491-600)."""
    idxs, pts = _neighbors(cfg, cam, grid, pts_dec, fu, fv)
    if len(pts) < cfg.radiusSearch_count_min:
        return -1.0, int(R.RadiusSearchInsufficientPoints)

    if cfg.do_use_histogram_segmentation:
        found, sel = _histogram_select(
            [p[2] for p in pts], cfg.histogram_segmentation_bin_witdh,
            cfg.histogram_segmentation_min_pointcount)
        seg = [pts[k] for k in sel]
    else:
        found, seg = True, pts

    if not found:
        depth, code = -1.0, int(R.HistogramNoLocalMax)
    else:
        depth, code = _segment_depth(
            cfg, cam, seg, fu, fv,
            check_planar=cfg.do_check_triangleplanar_condition)
        if code == int(R.Success):
            return depth, code

    # road fallback
    if not (cfg.do_use_ransac_plane and gp_ok):
        return -1.0, code
    result_old = code
    idxs2, pts2 = _neighbors(cfg, cam, grid, pts_dec, fu, fv,
                             cfg.road_search_scale_x, cfg.road_search_scale_y)
    if len(pts2) < cfg.radiusSearch_count_min:
        return -1.0, int(R.RadiusSearchInsufficientPoints)
    # plane-inlier segmentation (CalculateDepthSegmentationPlane)
    n_c, d_c = gp_coeffs_cam[:3], gp_coeffs_cam[3]
    road_pts, gp_dists = [], []
    for i, p in zip(idxs2, pts2):
        dist = abs(float(np.dot(n_c, p) + d_c))
        gp_dists.append(dist)
        if dist > cfg.ransac_plane_point_distance_treshold:
            return -1.0, result_old
        if gp_inlier[i]:
            road_pts.append((p, dist))
    if len(road_pts) < 3:
        return -1.0, result_old

    # road depth strategy (RoadDepthEstimator*.cpp)
    ray = _ray(cam, fu, fv)
    pmat = np.asarray([p for p, _ in road_pts], np.float64)
    if cfg.plane_estimator_use_mestimator:
        w = np.asarray([1.0 / max(d, 1e-9) for _, d in road_pts])
        c = (pmat * w[:, None]).sum(axis=0) / w.sum()
        centered = (pmat - c) * np.sqrt(w)[:, None]
        _, _, vt = np.linalg.svd(centered, full_matrices=True)
        normal = vt[-1]
        anchor = c
    elif cfg.plane_estimator_use_leastsquares:
        c = pmat.mean(axis=0)
        centered = pmat - c
        _, _, vt = np.linalg.svd(centered, full_matrices=True)
        normal = vt[-1]
        anchor = c
    else:  # triangle + XZ flatness
        tri = _max_spanning_triangle([p for p, _ in road_pts])
        xs = pmat[:, 0]
        zs = pmat[:, 2]
        size_x = xs.max() - xs.min()
        size_z = zs.max() - zs.min()
        flat_ok = (size_z / (size_x if size_x else 1e-30)
                   >= cfg.plane_estimator_z_x_min_relation)
        if tri is None:
            return -1.0, int(R.RadiusSearchInsufficientPoints)
        if not flat_ok:
            return -1.0, int(R.InsufficientRoadPoints)
        c1, c2, c3 = tri
        n = np.cross(c2 - c1, c3 - c1)
        nv = np.linalg.norm(n)
        normal = n / (nv if nv else 1.0)
        anchor = c1
    offset = -float(np.dot(normal, anchor))
    depth = _intersect(normal, offset, ray)
    depth, gate = _gates(cfg, depth, [float(p[2]) for p, _ in road_pts])
    if gate is not None:
        return -1.0, gate
    return depth, int(R.SuccessRoad)


def oracle_estimate(cfg, cam, T_R, T_t, cloud, valid, feats, fvalid, gp):
    grid, pts_dec, _, _ = _project(cfg, cam, T_R, T_t, cloud, valid)
    n_c = T_R @ np.asarray(gp.coeffs)[:3]
    d_c = float(np.asarray(gp.coeffs)[3] - np.dot(n_c, T_t))
    gp_cam = np.concatenate([n_c, [d_c]])
    gp_inlier = np.asarray(gp.inlier_mask)
    gp_ok = bool(gp.ok)
    codes = np.full(len(feats), int(R.Unspecified), np.int32)
    depths = np.full(len(feats), -1.0, np.float64)
    for n in range(len(feats)):
        if not fvalid[n]:
            continue
        d, c = oracle_feature(cfg, cam, grid, pts_dec, gp_cam, gp_inlier,
                              gp_ok, float(feats[n, 0]), float(feats[n, 1]))
        codes[n] = c
        depths[n] = d
    return codes, depths


# ---------------------------------------------------------------------------
# Margin-respecting scene generation
# ---------------------------------------------------------------------------


def _make_scene(rng, cfg, cam):
    """Random scene whose discretized quantities sit away from their
    quantization boundaries: points are placed by back-projecting
    (pixel + subpixel in [0.25, 0.75], depth at histogram-bin centers
    +- 0.25 width), so XLA-vs-numpy f32 rounding cannot flip a cell or
    bin assignment."""
    bw = cfg.histogram_segmentation_bin_witdh
    pts_cam = []

    def backproject(px, py, z):
        u = px + rng.uniform(0.25, 0.75)
        v = py + rng.uniform(0.25, 0.75)
        x = (u - cam.cx) / cam.focal_length * z
        y = (v - cam.cy) / cam.focal_length * z
        return [x, y, z]

    def bin_center_depth(lo=2.0, hi=80.0):
        b = rng.integers(int(lo / bw) + 1, int(hi / bw))
        return (b + rng.uniform(0.25, 0.75)) * bw

    # clustered surface patches (walls at constant-ish depth)
    for _ in range(rng.integers(6, 14)):
        cx0 = rng.integers(2, cam.width - 14)
        cy0 = rng.integers(2, cam.height - 14)
        z0 = bin_center_depth()
        for _ in range(rng.integers(6, 40)):
            px = cx0 + rng.integers(0, 12)
            py = cy0 + rng.integers(0, 12)
            # jitter stays inside the bin (margin 0.25*bw)
            z = z0 + rng.uniform(-0.2, 0.2) * bw
            pts_cam.append(backproject(px, py, z))
    # ground strip: y = ground_y plane, sampled by pixel in the lower
    # image half (depth from the plane equation — NOT bin-centered, the
    # histogram rarely matters for sparse ground hits)
    ground_y = 1.4
    for _ in range(rng.integers(60, 200)):
        px = rng.integers(1, cam.width - 1)
        py = rng.integers(int(cam.cy) + 8, cam.height - 1)
        u = px + rng.uniform(0.25, 0.75)
        v = py + rng.uniform(0.25, 0.75)
        ydir = (v - cam.cy) / cam.focal_length
        if ydir < 0.05:
            continue
        z = ground_y / ydir
        if z < 1.0 or z > 90.0:
            continue
        x = (u - cam.cx) / cam.focal_length * z
        pts_cam.append([x, ground_y, z])
    # scattered outliers
    for _ in range(rng.integers(20, 80)):
        px = rng.integers(1, cam.width - 1)
        py = rng.integers(1, cam.height - 1)
        pts_cam.append(backproject(px, py, bin_center_depth(2.0, 120.0)))

    pts_cam = np.asarray(pts_cam, np.float64)
    rng.shuffle(pts_cam, axis=0)
    # lidar frame: x fwd, y left, z up; cam: x right, y down, z fwd
    R_lc = np.array([[0, -1, 0], [0, 0, -1], [1, 0, 0]], np.float64)
    t_lc = np.array([0.02, -0.05, 0.1], np.float64)
    # cloud_lidar with R_lc @ p_lidar + t_lc = p_cam
    pts_lidar = (pts_cam - t_lc) @ R_lc
    P = len(pts_lidar)
    cloud = np.zeros((P_MAX, 3), np.float32)
    cloud[:P] = pts_lidar.astype(np.float32)
    valid = np.arange(P_MAX) < P

    # analytic ground plane in the lidar frame (z up): z = -(ground_y - t?)
    # derive from the camera-frame plane y = ground_y:
    # p_cam.y = ground_y  ->  (R_lc p_l + t_lc).y = ground_y
    n_l = R_lc.T @ np.array([0.0, 1.0, 0.0])
    d_l = float(t_lc[1] - ground_y)
    # orient z-up (normal z >= 0) like _orient_up
    if n_l[2] < 0:
        n_l, d_l = -n_l, -d_l
    dist = np.abs(cloud @ n_l + d_l)
    inlier = valid & (dist < 0.08)
    gp = GroundPlane(coeffs=jnp.asarray(np.concatenate([n_l, [d_l]]),
                                        dtype=jnp.float32),
                     inlier_mask=jnp.asarray(inlier),
                     ok=jnp.asarray(True))

    # features: half at surface points, half random
    feats = np.zeros((N_FEAT, 2), np.float32)
    for k in range(N_FEAT):
        if k % 2 == 0 and P > 0:
            p = pts_cam[rng.integers(0, P)]
            feats[k, 0] = np.clip(
                p[0] / p[2] * cam.focal_length + cam.cx
                + rng.uniform(-2, 2), 1, cam.width - 1)
            feats[k, 1] = np.clip(
                p[1] / p[2] * cam.focal_length + cam.cy
                + rng.uniform(-2, 2), 1, cam.height - 1)
        else:
            feats[k] = [rng.uniform(1, cam.width - 1),
                        rng.uniform(1, cam.height - 1)]
        # keep feature fracs away from integers too (rect borders)
        feats[k] = np.floor(feats[k]) + np.clip(
            feats[k] - np.floor(feats[k]), 0.25, 0.75)
    fvalid = rng.random(N_FEAT) > 0.05
    T = SE3(jnp.asarray(R_lc, dtype=jnp.float32),
            jnp.asarray(t_lc, dtype=jnp.float32))
    return cloud, valid, feats, fvalid, gp, T, R_lc, t_lc


BASE = dict(max_points=P_MAX, max_features=N_FEAT,
            image_width=W_IMG, image_height=H_IMG)

CONFIGS = {
    "default": DepthEstimatorConfig(**BASE),
    "pca": DepthEstimatorConfig(**BASE, do_use_PCA=True),
    "adjust": DepthEstimatorConfig(
        **BASE, treshold_depth_mode=1, treshold_depth_local_mode=1),
    "local_abs": DepthEstimatorConfig(
        **BASE, treshold_depth_local_valuetype=0,
        treshold_depth_local_value=0.6),
    "road_ls": DepthEstimatorConfig(
        **BASE, plane_estimator_use_mestimator=False,
        plane_estimator_use_leastsquares=True),
    "road_triangle": DepthEstimatorConfig(
        **BASE, plane_estimator_use_mestimator=False,
        plane_estimator_use_triangle_maximation=True,
        plane_estimator_z_x_min_relation=0.3),
    "no_histogram": DepthEstimatorConfig(
        **BASE, do_use_histogram_segmentation=False),
    "no_planar_check": DepthEstimatorConfig(
        **BASE, do_check_triangleplanar_condition=False,
        viewray_plane_orthoganality_treshold=0.0),
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_pipeline_matches_literal_oracle(name):
    cfg = CONFIGS[name]
    # zlib.crc32, NOT hash(): str hashes are salted per Python process
    # (PYTHONHASHSEED), which made the fuzz scenes irreproducible
    # across processes — found when pytest-xdist gave each worker a
    # fresh hash salt and an unlucky scene tripped the old max-error
    # bound.
    import zlib
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    n_scenes = 4
    total = 0
    mismatched = 0
    rels = []
    for s in range(n_scenes):
        cloud, valid, feats, fvalid, gp, T, T_R, T_t = _make_scene(
            rng, cfg, CAM)
        out = estimate_depths(cfg, CAM, T, jnp.asarray(cloud),
                              jnp.asarray(valid), jnp.asarray(feats),
                              jnp.asarray(fvalid), gp)
        got_codes = np.asarray(out.codes)
        got_depths = np.asarray(out.depths)
        want_codes, want_depths = oracle_estimate(
            cfg, CAM, T_R, T_t, cloud, valid, feats, fvalid, gp)
        agree = got_codes == want_codes
        total += int(fvalid.sum())
        mismatched += int((~agree & fvalid).sum())
        both_ok = agree & fvalid & (want_depths > 0) & (got_depths > 0)
        if both_ok.any():
            err = np.abs(got_depths[both_ok] - want_depths[both_ok])
            rel = err / np.maximum(want_depths[both_ok], 1.0)
            rels.append(rel)
    # mismatch budget: f32 argmax near-ties in the triangle search /
    # borderline gate values (XLA fma vs numpy rounding)
    assert mismatched <= max(2, int(0.01 * total)), (
        name, mismatched, total)
    rels = np.concatenate(rels) if rels else np.zeros(1)
    # Depth agreement is a DISTRIBUTION bound: a same-code feature can
    # legally pick a different (equally-maximal, f32 near-tie)
    # spanning triangle and land percent-level away — cap how many,
    # not the worst lane.  The bf16-regression class this test guards
    # moved the MEDIAN orders of magnitude past these bounds.
    assert float(np.median(rels)) < 1e-5, (name, float(np.median(rels)))
    n_big = int((rels > 5e-3).sum())
    assert n_big <= max(1, int(0.005 * len(rels))), (
        name, n_big, len(rels), float(rels.max()))
    # ... but the tolerated near-tie lanes still have to be the
    # "different equally-maximal triangle" class (percent-level), not
    # arbitrarily wrong: keep a loose absolute cap on the worst lane
    # so a gross per-feature regression confined to a few lanes cannot
    # hide inside the count budget.
    assert float(rels.max()) < 0.1, (name, float(rels.max()))
