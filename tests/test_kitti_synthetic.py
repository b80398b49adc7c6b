"""End-to-end integration over a synthetic KITTI-format dataset:
io loader → tracker on images → depth association → VO → metrics,
through the exact code paths real KITTI data takes."""

import numpy as np
import pytest

from mono_lidar_depth_tpu import DepthEstimatorConfig
from mono_lidar_depth_tpu.io.kitti import KittiSequence
from mono_lidar_depth_tpu.io.synthetic_dataset import (
    SyntheticSpec, generate_kitti_sequence)

W, H = 384, 128


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("kitti"))
    generate_kitti_sequence(
        root, "99",
        SyntheticSpec(frames=7, image_width=W, image_height=H,
                      focal=240.0, lidar_rows=20, lidar_cols=500,
                      step=0.7))
    return root


@pytest.fixture(scope="module")
def cfg():
    return DepthEstimatorConfig(
        max_points=16384, max_features=256, image_width=W, image_height=H,
        radiusSearch_count_min=1,
        ransac_num_hypotheses=256, ransac_subsample_points=1024)


def test_loader_roundtrip(dataset):
    seq = KittiSequence(dataset, "99", image_width=W, image_height=H)
    assert len(seq) == 7
    assert seq.gt_poses.shape == (7, 4, 4)
    assert seq.calib.camera.focal_length == 240.0
    img = seq.image(0)
    assert img.shape == (H, W)
    assert img.std() > 20  # textured
    scan, n = next(iter(seq.scans(16384)))
    assert 1000 < n < 16384
    # azimuth scan order: within-row image-x decreasing overall
    assert seq.times is not None and len(seq.times) == 7


def test_depth_eval_end_to_end(dataset, cfg):
    from mono_lidar_depth_tpu.eval import eval_depth_sequence

    seq = KittiSequence(dataset, "99", image_width=W, image_height=H)
    out = eval_depth_sequence(seq, cfg, max_tracks=512, max_length=8,
                              verbose=False)
    assert out["frames"] == 6  # first frame initializes the tracker
    assert out["total_points"] > 300
    # on clean planar synthetic surfaces the lidar-covered success rate
    # must be substantial (measured 0.49 on this 7-frame scene, 0.52 on
    # the 220-frame loop of scripts/make_parity_record.py — bound with
    # ~10% margin)
    assert out["success_rate_lidar_covered"] > 0.45, out


def test_vo_eval_end_to_end(dataset, cfg):
    from mono_lidar_depth_tpu.eval import eval_vo_sequence

    seq = KittiSequence(dataset, "99", image_width=W, image_height=H)
    vo = eval_vo_sequence(seq, cfg, max_tracks=256, max_length=8,
                          verbose=False)
    gt = seq.gt_poses[vo["frame_ids"]]
    est_len = np.linalg.norm(
        np.diff(vo["poses"][:, :3, 3], axis=0), axis=1).sum()
    gt_len = np.linalg.norm(np.diff(gt[:, :3, 3], axis=0), axis=1).sum()
    # metric scale from lidar depth priors; frame-0 priming makes even
    # the first motion observable
    assert abs(est_len - gt_len) / gt_len < 0.06, (est_len, gt_len)
    assert vo["ate_rmse"] < 0.12, vo["ate_rmse"]
    assert vo["rpe_rot_rmse_deg"] < 0.5


def test_posegraph_loop_closure_end_to_end(tmp_path_factory):
    """Config 4: VO over a loop trajectory, proximity+heading closure
    proposal, KLT+depth+GN verification, pose-graph optimization — the
    optimized trajectory must beat raw VO."""
    from mono_lidar_depth_tpu.eval import (
        eval_vo_sequence, propose_loop_closures, run_pose_graph_backend)
    from mono_lidar_depth_tpu.eval.kitti_eval import (
        closure_constraint_from_frames)
    from mono_lidar_depth_tpu.vo.metrics import ate_rmse

    root = str(tmp_path_factory.mktemp("kitti_loop"))
    generate_kitti_sequence(
        root, "98",
        SyntheticSpec(frames=84, image_width=W, image_height=H,
                      focal=240.0, lidar_rows=20, lidar_cols=500,
                      step=0.55, loop=True))
    cfg = DepthEstimatorConfig(
        max_points=16384, max_features=384, image_width=W, image_height=H,
        radiusSearch_count_min=1,
        ransac_num_hypotheses=256, ransac_subsample_points=1024)
    seq = KittiSequence(root, "98", image_width=W, image_height=H)
    vo = eval_vo_sequence(seq, cfg, max_tracks=384, max_length=8,
                          verbose=False)
    poses = vo["poses"]
    cands = propose_loop_closures(poses, min_gap=30, radius=8.0, stride=2,
                                  max_candidates=8)
    closures = []
    for (i, j) in cands:
        z = closure_constraint_from_frames(
            seq, cfg, vo["frame_ids"][i], vo["frame_ids"][j],
            max_features=cfg.max_features)
        if z is not None:
            closures.append((i, j, *z))
    assert len(closures) >= 1, (cands, "no closure verified")
    opt = run_pose_graph_backend(poses, closures)
    gt = seq.gt_poses[vo["frame_ids"]]
    ate_vo = ate_rmse(poses[:, :3, 3], gt[:, :3, 3])
    ate_pg = ate_rmse(opt[:, :3, 3], gt[:, :3, 3])
    assert np.isfinite(ate_pg)
    assert ate_pg < ate_vo, (ate_vo, ate_pg)


def test_posegraph_closure_under_high_drift(tmp_path_factory):
    """Loop closure must still work when VO drift DOMINATES (the regime
    config 4 exists for): inject heavy synthetic drift into a clean
    loop trajectory, and assert the drift-aware proposal still finds
    candidates, verification confirms >= 1, and the pose graph improves
    ATE.  A fixed proposal radius fails open here (r2 record: 0 of 0
    proposed at 222 m ATE)."""
    from mono_lidar_depth_tpu.eval import (
        eval_vo_sequence, propose_loop_closures, run_pose_graph_backend)
    from mono_lidar_depth_tpu.eval.kitti_eval import (
        closure_constraint_from_frames)
    from mono_lidar_depth_tpu.vo.metrics import ate_rmse

    root = str(tmp_path_factory.mktemp("kitti_drift"))
    generate_kitti_sequence(
        root, "96",
        SyntheticSpec(frames=84, image_width=W, image_height=H,
                      focal=240.0, lidar_rows=20, lidar_cols=500,
                      step=0.55, loop=True))
    cfg = DepthEstimatorConfig(
        max_points=16384, max_features=384, image_width=W, image_height=H,
        radiusSearch_count_min=1,
        ransac_num_hypotheses=256, ransac_subsample_points=1024)
    seq = KittiSequence(root, "96", image_width=W, image_height=H)
    vo = eval_vo_sequence(seq, cfg, max_tracks=384, max_length=8,
                          verbose=False)

    # Inject drift: recompose the trajectory from its relative motions
    # with a constant yaw bias + scale error per frame (the classic VO
    # error model).  The images/clouds are untouched, so closure
    # VERIFICATION still measures true relative poses.
    poses = vo["poses"]
    F = len(poses)
    yaw = np.radians(1.5)  # per frame (ate_rmse rigid-aligns, which
    #                        absorbs much of a progressive yaw — inject
    #                        enough that the residual still dominates)
    dR = np.array([[np.cos(yaw), 0, np.sin(yaw)], [0, 1, 0],
                   [-np.sin(yaw), 0, np.cos(yaw)]])
    drifted = [poses[0]]
    for k in range(F - 1):
        rel = np.linalg.inv(poses[k]) @ poses[k + 1]
        rel[:3, :3] = rel[:3, :3] @ dR
        rel[:3, 3] *= 1.12
        drifted.append(drifted[-1] @ rel)
    drifted = np.stack(drifted)

    gt = seq.gt_poses[vo["frame_ids"]]
    ate_drift = ate_rmse(drifted[:, :3, 3], gt[:, :3, 3])
    # ~2.7 m on a ~15 m-extent loop (≈18% of extent) — drift dominates
    assert ate_drift > 2.0, f"drift injection too weak ({ate_drift:.2f} m)"
    cands = propose_loop_closures(drifted, min_gap=30, radius=2.0,
                                  stride=2, max_candidates=8)
    assert cands, "drift-aware proposal found nothing"
    closures = []
    for (i, j) in cands:
        z = closure_constraint_from_frames(
            seq, cfg, vo["frame_ids"][i], vo["frame_ids"][j],
            max_features=cfg.max_features)
        if z is not None:
            closures.append((i, j, *z))
    assert len(closures) >= 1, (cands, "no closure verified")

    # A lone verified closure is only trusted with peer support — the
    # filter re-measures a shifted-endpoint constraint through this
    # callback (drift-independent cycle check).
    def remeasure(a, b):
        return closure_constraint_from_frames(
            seq, cfg, vo["frame_ids"][a], vo["frame_ids"][b],
            max_features=cfg.max_features)

    opt = run_pose_graph_backend(drifted, closures, remeasure=remeasure)
    ate_pg = ate_rmse(opt[:, :3, 3], gt[:, :3, 3])
    assert np.isfinite(ate_pg)
    assert ate_pg < 0.7 * ate_drift, (ate_drift, ate_pg)


def test_appearance_closure_proposal(tmp_path_factory):
    """Pose-estimate-free appearance proposal must rank TRUE revisits
    first: on a closed loop, candidates from image similarity alone
    (no trajectory input) must overwhelmingly be pairs that ground
    truth places within a few metres of each other.  This is the
    proposal source that cannot be corrupted by VO drift — the metric
    proposer's committed failure mode (PARITY r4/r5 4b legs: junk
    pairs where the DRIFTED path curls near itself fill the budget
    and 0 of 12 verify)."""
    from mono_lidar_depth_tpu.eval import propose_loop_closures_appearance

    root = str(tmp_path_factory.mktemp("kitti_app"))
    generate_kitti_sequence(
        root, "95",
        SyntheticSpec(frames=84, image_width=W, image_height=H,
                      focal=240.0, lidar_rows=20, lidar_cols=500,
                      step=0.55, loop=True))
    seq = KittiSequence(root, "95", image_width=W, image_height=H)
    cands = propose_loop_closures_appearance(
        seq, list(range(84)), min_gap=30, stride=2, max_candidates=10)
    assert len(cands) >= 3, cands
    gt = seq.gt_poses
    d = [float(np.linalg.norm(gt[i][:3, 3] - gt[j][:3, 3]))
         for i, j in cands]
    # loop diameter ~15 m; a random gap>=30 pair averages ~9-10 m
    true_rate = np.mean([x < 4.0 for x in d])
    assert true_rate >= 0.7, (cands, d)
    # the suppression must spread candidates over revisit events, and
    # at least one must span the full loop (the closure class proper)
    assert max(j - i for i, j in cands) >= 50, cands


def test_depth_eval_semantic_plane_mode(dataset, cfg):
    """The semantic (4-way-sync) path end-to-end: ground plane from the
    rendered semantic label images instead of RANSAC; results must be
    comparable to the RANSAC mode on the clean synthetic scene."""
    from mono_lidar_depth_tpu.eval import eval_depth_sequence

    seq = KittiSequence(dataset, "99", image_width=W, image_height=H)
    sem = seq.semantic(0)
    assert sem is not None and sem.shape == (H, W)
    from mono_lidar_depth_tpu.io.synthetic_dataset import (LABEL_ROAD,
                                                           LABEL_WALL)
    labs = set(np.unique(sem).tolist())
    assert LABEL_ROAD in labs and LABEL_WALL in labs

    # The reference's default refinement threshold (10.2 m,
    # parameters.yaml:137) makes the semantic REFIT span the whole
    # scene (walls included) — faithfully replicated; use a physically
    # sensible threshold for the quality comparison.
    cfg_t = cfg.replace(ransac_plane_refinement_treshold=0.3)
    out_sem = eval_depth_sequence(seq, cfg_t, max_tracks=512, max_length=8,
                                  verbose=False, plane_mode="semantic")
    out_ran = eval_depth_sequence(seq, cfg_t, max_tracks=512, max_length=8,
                                  verbose=False, plane_mode="ransac")
    assert out_sem["frames"] == 6
    assert out_sem["success_rate_lidar_covered"] > 0.35, out_sem
    # the two plane sources agree on this scene to within a loose band
    assert abs(out_sem["success_rate_lidar_covered"]
               - out_ran["success_rate_lidar_covered"]) < 0.15, (
        out_sem, out_ran)


def test_semantic_plane_recovers_ground(dataset, cfg):
    """fit_ground_plane_semantic on a rendered frame recovers the true
    ground plane (lidar frame: z up at sensor height)."""
    import jax.numpy as jnp
    from mono_lidar_depth_tpu import fit_ground_plane_semantic
    from mono_lidar_depth_tpu.io.kitti import pad_cloud

    seq = KittiSequence(dataset, "99", image_width=W, image_height=H)
    xyzi, n = next(iter(seq.scans(cfg.max_points)))
    cloud, valid = pad_cloud(xyzi, n, cfg.max_points)
    sem = jnp.asarray(seq.semantic(0).astype(np.int32))
    T = seq.calib.lidar_to_cam
    gp = fit_ground_plane_semantic(
        jnp.asarray(cloud), jnp.asarray(valid), sem,
        T.rotation, T.translation, seq.calib.camera.intrinsics(),
        inlier_threshold=0.3)
    assert bool(gp.ok)
    coeffs = np.asarray(gp.coeffs)
    # ground is z = -(1.5 - lidar height offset) in the lidar frame;
    # normal must be ~(0, 0, 1)
    assert abs(coeffs[2]) > 0.99, coeffs
    assert int(np.asarray(gp.inlier_mask).sum()) > 100
