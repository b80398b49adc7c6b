#!/usr/bin/env python
"""KITTI odometry evaluation CLI (BASELINE.json configs 2-4).

Usage:
  python scripts/run_kitti.py depth --root /data/kitti --seq 04
  python scripts/run_kitti.py vo --root /data/kitti --seq 00 [--frames N]
  python scripts/run_kitti.py posegraph --root /data/kitti --seq 00
  python scripts/run_kitti.py selftest          # synthetic end-to-end check

Results print as one JSON line per run (plus verbose progress on
stderr-like stdout).
"""

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("mode", choices=["depth", "vo", "posegraph", "selftest"])
    ap.add_argument("--root", default="/data/kitti")
    ap.add_argument("--seq", default="04")
    ap.add_argument("--frames", type=int, default=None)
    ap.add_argument("--config", default=None, help="parameters yaml path")
    ap.add_argument("--checkpoint", default=None,
                    help="npz checkpoint path to save/restore VO state")
    ap.add_argument("--platform", default=None,
                    help="JAX platform to run on, e.g. 'cpu' on a GPU host "
                         "(default: JAX's choice)")
    args = ap.parse_args()

    if args.platform:
        import jax
        jax.config.update("jax_platforms", args.platform)

    from mono_lidar_depth_tpu import DepthEstimatorConfig
    from mono_lidar_depth_tpu.compile_cache import use_compile_cache

    use_compile_cache()

    if args.config:
        cfg = DepthEstimatorConfig.from_yaml(args.config)
    else:
        cfg = DepthEstimatorConfig()

    if args.mode == "selftest":
        _selftest(cfg)
        return

    from mono_lidar_depth_tpu.io.kitti import KittiSequence

    root = Path(args.root)
    if not (root / "sequences" / args.seq).exists() and args.seq == "99":
        # sequence 99 is the built-in synthetic sequence: generate on
        # demand so every stage runs without the real dataset
        from mono_lidar_depth_tpu.io.synthetic_dataset import (
            SyntheticSpec, generate_kitti_sequence)
        print(f"generating synthetic sequence 99 under {root} ...")
        generate_kitti_sequence(str(root), "99",
                                SyntheticSpec(frames=args.frames or 30))
    seq = KittiSequence(args.root, args.seq)

    if args.mode == "depth":
        from mono_lidar_depth_tpu.eval import eval_depth_sequence

        out = eval_depth_sequence(seq, cfg, max_frames=args.frames)
        print(json.dumps({k: v for k, v in out.items()
                          if isinstance(v, (int, float))}))
    elif args.mode == "vo":
        from mono_lidar_depth_tpu.eval import eval_vo_sequence

        out = eval_vo_sequence(seq, cfg, max_frames=args.frames)
        print(json.dumps({k: v for k, v in out.items()
                          if isinstance(v, (int, float))}))
    elif args.mode == "posegraph":
        from mono_lidar_depth_tpu.eval import eval_vo_sequence

        vo = eval_vo_sequence(seq, cfg, max_frames=args.frames)
        out = posegraph(seq, cfg, vo)
        print(json.dumps({k: v for k, v in out.items() if k != "poses"}))


def posegraph(seq, cfg, vo: dict, min_gap: int = 100,
              max_verify: int | None = None) -> dict:
    """Loop-closure backend over a VO run: propose closures at least
    `min_gap` frames apart, verify each by KLT + depth + pose GN between
    the two frames, then optimize the pose graph.  `max_verify` caps the
    candidates verified (thinned uniformly).  Returns frame/closure counts, ATE before and after
    when the sequence has ground truth, and the optimized poses."""
    import numpy as np

    from mono_lidar_depth_tpu.eval import (
        propose_loop_closures, propose_loop_closures_appearance,
        run_pose_graph_backend, union_closure_candidates)
    from mono_lidar_depth_tpu.eval.kitti_eval import (
        closure_constraint_from_frames)
    from mono_lidar_depth_tpu.vo.metrics import ate_rmse

    poses = vo["poses"]
    # budget scales with sequence length (~1 candidate / 25 frames,
    # thinned uniformly over the drive) so long multi-revisit
    # sequences constrain their tail, not just the earliest loops.
    # Union of the metric (estimate-based) and appearance
    # (estimate-free) sources — the committed production chain;
    # appearance keeps proposing true revisits when drift corrupts
    # the estimate's ranking.
    budget = int(np.clip(len(poses) // 25, 20, 200))
    cands = union_closure_candidates(
        propose_loop_closures(poses, min_gap=min_gap,
                              max_candidates=budget),
        propose_loop_closures_appearance(
            seq, [int(f) for f in vo["frame_ids"]], min_gap=min_gap,
            max_candidates=budget // 2))
    if max_verify is not None and len(cands) > max_verify:
        keep = np.linspace(0, len(cands) - 1, max_verify).round()
        cands = [cands[int(k)] for k in keep]
    closures = []
    for (i, j) in cands:
        z = closure_constraint_from_frames(
            seq, cfg, vo["frame_ids"][i], vo["frame_ids"][j])
        if z is not None:
            closures.append((i, j, *z))
    print(f"loop closures: {len(closures)}/{len(cands)} verified")

    def _remeasure(a, b):
        return closure_constraint_from_frames(
            seq, cfg, vo["frame_ids"][a], vo["frame_ids"][b])

    opt = run_pose_graph_backend(poses, closures, remeasure=_remeasure)
    result = {"frames": len(poses), "candidates": len(cands),
              "closures": len(closures)}
    if seq.gt_poses is not None:
        gt = seq.gt_poses[vo["frame_ids"]]
        result["ate_vo"] = ate_rmse(poses[:, :3, 3], gt[:, :3, 3])
        result["ate_posegraph"] = ate_rmse(opt[:, :3, 3], gt[:, :3, 3])
    return {**result, "poses": opt}


def _selftest(cfg) -> None:
    """Synthetic end-to-end check of all three harness stages."""
    import numpy as np
    import jax

    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tests"))
    print("building synthetic odometry scene...")
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "t", Path(__file__).resolve().parents[1] / "tests" / "test_odometry.py")
    t = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(t)
    from mono_lidar_depth_tpu.eval import (propose_loop_closures,
                                           run_pose_graph_backend)
    from mono_lidar_depth_tpu.vo.metrics import ate_rmse
    from mono_lidar_depth_tpu.vo.pipeline import OdometryConfig, run_odometry

    rng = np.random.default_rng(7)
    frames, gt_centers = t._make_frames(rng, F=12)
    ocfg = OdometryConfig(ba_window=5, ba_iters=5)
    poses, diags = run_odometry(t.CFG, ocfg, t.CAM, t.T_LC, frames,
                                max_tracks=t.M, max_length=8)
    est = poses[:, :3, 3]
    rmse = ate_rmse(est[3:] - est[3], gt_centers[3:] - gt_centers[3])
    print(f"VO ATE (steady-state): {rmse:.3f} m")
    opt = run_pose_graph_backend(poses, [])
    print(f"pose-graph (odometry-only) finite: "
          f"{bool(np.isfinite(opt).all())}")
    print(json.dumps({"selftest_ate": rmse, "ok": rmse < 0.2}))


if __name__ == "__main__":
    main()
