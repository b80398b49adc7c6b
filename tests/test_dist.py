"""Distribution tests on the 8-device virtual CPU mesh."""

import numpy as np
import jax
import jax.numpy as jnp

from mono_lidar_depth_tpu import DepthEstimatorConfig, PinholeCamera, SE3
from mono_lidar_depth_tpu.dist import (
    distributed_ba, frame_sharding, make_mesh, sharded_depth_association)
from mono_lidar_depth_tpu.vo.ba import run_ba

CAM = PinholeCamera(width=640, height=480, focal_length=500.0,
                    cx=320.0, cy=240.0)


def test_mesh_shapes():
    mesh = make_mesh(8)
    assert mesh.shape == {"frame": 8, "landmark": 1}
    mesh2 = make_mesh(8, landmark_parallel=4)
    assert mesh2.shape == {"frame": 2, "landmark": 4}


def test_sharded_depth_association_matches_single():
    cfg = DepthEstimatorConfig(
        max_points=2048, max_features=64, image_width=256, image_height=128,
        ransac_num_hypotheses=128, ransac_subsample_points=512)
    cam = PinholeCamera(256, 128, 200.0, 128.0, 64.0)
    T = SE3.identity()
    mesh = make_mesh(8)
    B = 8
    rng = np.random.default_rng(0)
    clouds = jnp.asarray(rng.uniform(
        [-10, -5, 2], [10, 5, 50], (B, 2048, 3)).astype(np.float32))
    cvalids = jnp.ones((B, 2048), bool)
    feats = jnp.asarray(rng.uniform(
        [2, 2], [254, 126], (B, 64, 2)).astype(np.float32))
    fvalids = jnp.ones((B, 64), bool)
    keys = jax.random.split(jax.random.PRNGKey(0), B)

    step = sharded_depth_association(cfg, cam, T, mesh)
    clouds_s = jax.device_put(clouds, frame_sharding(mesh))
    depths, codes, counters = step(clouds_s, cvalids, feats, fvalids, keys)
    assert depths.shape == (B, 64)
    assert int(counters.sum()) == B * 64

    # single-device reference result must match exactly
    from mono_lidar_depth_tpu import estimate_depths, fit_ground_plane_ransac
    for b in (0, 3, 7):
        gp = fit_ground_plane_ransac(
            clouds[b], cvalids[b], keys[b],
            distance_threshold=cfg.ransac_plane_distance_treshold,
            num_hypotheses=cfg.ransac_num_hypotheses,
            subsample=cfg.ransac_subsample_points,
            use_refinement=cfg.ransac_plane_use_refinement,
            refinement_threshold=cfg.ransac_plane_refinement_treshold)
        ref = estimate_depths(cfg, cam, T, clouds[b], cvalids[b],
                              feats[b], fvalids[b], gp)
        np.testing.assert_array_equal(np.asarray(codes[b]),
                                      np.asarray(ref.codes))
        np.testing.assert_allclose(np.asarray(depths[b]),
                                   np.asarray(ref.depths), atol=1e-5)


def test_distributed_ba_matches_single(rng):
    from test_vo import _ba_problem as make_problem

    problem, R_gt, t_gt, X_gt = make_problem(rng, K=4, L=128)
    single = run_ba(CAM, problem, iters=6)

    mesh = make_mesh(8, landmark_parallel=8)
    solver = distributed_ba(CAM, mesh, iters=6)
    dist = solver(problem)

    np.testing.assert_allclose(float(dist.final_cost),
                               float(single.final_cost), rtol=1e-3)
    np.testing.assert_allclose(np.asarray(dist.problem.R),
                               np.asarray(single.problem.R), atol=1e-4)
    np.testing.assert_allclose(np.asarray(dist.problem.t),
                               np.asarray(single.problem.t), atol=1e-3)
    np.testing.assert_allclose(np.asarray(dist.problem.landmarks),
                               np.asarray(single.problem.landmarks),
                               atol=1e-2)


def test_distributed_ba_converges(rng):
    from test_vo import _ba_problem as make_problem

    problem, R_gt, t_gt, X_gt = make_problem(rng, K=4, L=128)
    mesh = make_mesh(4, landmark_parallel=4)
    solver = distributed_ba(CAM, mesh, iters=10)
    res = solver(problem)
    assert float(res.final_cost) < 0.1 * float(res.initial_cost)
    for k in range(1, 4):
        dR = np.asarray(res.problem.R[k]) @ R_gt[k].T
        ang = np.degrees(np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1)))
        assert ang < 0.3


def test_distributed_pose_graph_matches_single():
    """Edge-sharded pose-graph GN/CG == single-device at KITTI scale
    (N≈4500 poses, odometry chain + loop closures) on the 8-mesh."""
    from mono_lidar_depth_tpu.dist import distributed_pose_graph
    from mono_lidar_depth_tpu.vo.lie import so3_exp
    from mono_lidar_depth_tpu.vo.pose_graph import (PoseGraph, graph_cost,
                                                    optimize_pose_graph,
                                                    sequential_edges)

    rng = np.random.default_rng(11)
    N = 4500
    # ground-truth circular trajectory
    ang = np.linspace(0, 2 * np.pi, N)
    radius = 150.0
    t_gt = np.stack([radius * np.cos(ang), np.zeros(N),
                     radius * np.sin(ang)], 1).astype(np.float32)
    R_gt = np.zeros((N, 3, 3), np.float32)
    for k in range(N):
        y = ang[k]
        R_gt[k] = [[np.cos(y), 0, np.sin(y)], [0, 1, 0],
                   [-np.sin(y), 0, np.cos(y)]]
    Rj, tj = jnp.asarray(R_gt), jnp.asarray(t_gt)
    i, j, Z_R, Z_t = sequential_edges(Rj, tj)
    # drifted initialization: accumulate noisy odometry
    R_init = [R_gt[0]]
    t_init = [t_gt[0]]
    for k in range(N - 1):
        dR = np.asarray(so3_exp(jnp.asarray(
            rng.normal(0, 2e-4, 3).astype(np.float32))))
        Rrel = np.asarray(Z_R[k])
        trel = np.asarray(Z_t[k]) + rng.normal(0, 2e-3, 3)
        R_init.append(R_init[-1] @ Rrel @ dR)
        t_init.append(R_init[-1 - 1] @ trel + t_init[-1])
    R_init = np.stack(R_init).astype(np.float32)
    t_init = np.stack(t_init).astype(np.float32)
    # loop closures: 21 ground-truth relative constraints
    ci = np.linspace(0, N - 300, 21).astype(np.int32)
    cj = ci + 299
    cZ_R = np.einsum("nij,nik->njk", R_gt[ci], R_gt[cj])
    cZ_t = np.einsum("nij,ni->nj", R_gt[ci], t_gt[cj] - t_gt[ci])
    E = (N - 1) + 21
    assert E % 8 == 0, E  # shard-friendly edge count
    graph = PoseGraph(
        R=jnp.asarray(R_init), t=jnp.asarray(t_init),
        edge_i=jnp.concatenate([i, jnp.asarray(ci)]),
        edge_j=jnp.concatenate([j, jnp.asarray(cj)]),
        Z_R=jnp.concatenate([Z_R, jnp.asarray(cZ_R, dtype=jnp.float32)]),
        Z_t=jnp.concatenate([Z_t, jnp.asarray(cZ_t, dtype=jnp.float32)]),
        edge_weight=jnp.ones((E,), jnp.float32),
        edge_valid=jnp.ones((E,), bool),
        fixed=jnp.arange(N) == 0)

    # cg cap generous enough for FULL inner convergence on both paths
    # (the 1e-4 relative-residual early exit keeps it cheap): at a
    # truncating cap the two paths would diverge by their different
    # f32 truncation points rather than meet at the optimum.
    kw = dict(gn_iters=3, cg_iters=400)
    single = optimize_pose_graph(graph, **kw)
    mesh = make_mesh(8, landmark_parallel=1)
    solve = distributed_pose_graph(mesh, **kw)
    dist = solve(graph)

    # atol: the sharded path psums its scatter-adds in a different
    # order than the single-device path, so the two converge to the
    # same optimum along slightly different f32 iterate sequences —
    # 5e-2 on a 150 m-scale trajectory is ~3e-4 relative.
    np.testing.assert_allclose(np.asarray(dist.t), np.asarray(single.t),
                               rtol=0, atol=5e-2)
    np.testing.assert_allclose(np.asarray(dist.R), np.asarray(single.R),
                               rtol=0, atol=3e-4)
    # and it actually optimized: cost strictly decreases
    assert float(graph_cost(single)) < 0.5 * float(graph_cost(graph))
    assert float(graph_cost(dist)) < 0.5 * float(graph_cost(graph))


def _graft():
    import sys
    from pathlib import Path

    repo = Path(__file__).resolve().parents[1]
    if str(repo) not in sys.path:
        sys.path.insert(0, str(repo))
    import __graft_entry__ as graft

    return graft


def test_graft_dryrun_multichip_kitti_shapes():
    """CI coverage for the multichip dryrun: the FULL deployment-shape
    path — 131k-point scans, 2048 features, 1226x370 grid, 8192
    landmarks, 4541-pose graph — over the virtual 8-device mesh.
    Shard-remainder or per-shard-memory regressions in the sharded
    programs fail here, not on a multi-card host."""
    out = _graft().dryrun_multichip(8)
    assert out["codes"].shape == (8, 2048)
    assert np.isfinite(out["pg_t"]).all()


def test_graft_multichip_matches_single_device():
    """The four-card path of chip_smoke.py (`--four-cards`), rehearsed on
    four virtual CPU devices: sharded outputs == single-device ones."""
    graft = _graft()
    diff = graft.compare_multichip(graft.dryrun_multichip(4),
                                   graft.multichip_reference(4))
    assert diff["code_agreement"] == 1.0
