#!/usr/bin/env python
"""Regenerate the committed evaluation record (PARITY_r<N>.md / .json).

One script, all numbers:
  * config 2 — depth-association success rates on a 220-frame synthetic
    loop sequence, in three modes: RANSAC plane (3-way sync path),
    semantic plane (4-way path), and region growing enabled (the
    capability the reference only stubbed);
  * config 3 — full VO + sliding-window BA: ATE / RPE, with the
    landmark re-init vs persist ablation, repeated 3× to expose
    run-to-run variance on the recording backend;
  * config 4 — pose-graph backend with drift-aware proposal and
    verified loop closures: ATE before/after;
  * config 4b — the same full closure chain under INJECTED dominant
    drift (yaw bias + scale error): recovery percentage;
  * success-rate vs lidar-density sweep (the reconciliation experiment
    against the reference's 82.7% covered-success figure);
  * scaling table — frame-parallel depth association + landmark-sharded
    BA at 1/2/4/8 virtual CPU devices (child process on the CPU:
    scripts/bench_scaling.py) and the 2-process jax.distributed demo
    (CPU children).  Only this process touches the accelerator.

The record header captures backend + commit so every number is
reproducible; the prose is generated CONDITIONALLY from the numbers
(a failing configuration reads as a failure).

Usage:  python scripts/make_parity_record.py [--frames 220] [--quick]
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

W, H = 384, 128


def _git_commit() -> str:
    try:
        return subprocess.run(["git", "rev-parse", "--short", "HEAD"],
                              capture_output=True, text=True,
                              cwd=str(REPO)).stdout.strip()
    except Exception:
        return "unknown"


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=220)
    ap.add_argument("--quick", action="store_true",
                    help="small run for smoke-testing the script")
    ap.add_argument("--out", default=str(REPO))
    ap.add_argument("--tag", default="r5", help="record suffix")
    args = ap.parse_args()
    frames = 60 if args.quick else args.frames

    import jax
    import numpy as np

    from mono_lidar_depth_tpu import DepthEstimatorConfig
    from mono_lidar_depth_tpu.eval import (eval_depth_sequence,
                                           eval_vo_sequence,
                                           propose_loop_closures,
                                           propose_loop_closures_appearance,
                                           run_pose_graph_backend,
                                           union_closure_candidates)
    from mono_lidar_depth_tpu.eval.kitti_eval import (
        closure_constraint_from_frames, filter_consistent_closures)
    from mono_lidar_depth_tpu.io.kitti import KittiSequence
    from mono_lidar_depth_tpu.io.synthetic_dataset import (
        SyntheticSpec, generate_kitti_sequence)
    from mono_lidar_depth_tpu.vo.metrics import ate_rmse
    from mono_lidar_depth_tpu.vo.pipeline import OdometryConfig

    backend = jax.default_backend()
    rec: dict = {"backend": backend, "frames": frames,
                 "commit": _git_commit()}

    tmp = tempfile.mkdtemp(prefix="parity_")
    print(f"[1/8] generating {frames}-frame synthetic loop sequence...",
          flush=True)
    generate_kitti_sequence(
        tmp, "98", SyntheticSpec(frames=frames, image_width=W,
                                 image_height=H, focal=240.0,
                                 lidar_rows=20, lidar_cols=500,
                                 step=0.55, loop=True))
    seq = KittiSequence(tmp, "98", image_width=W, image_height=H)
    cfg = DepthEstimatorConfig(
        max_points=16384, max_features=384, image_width=W, image_height=H,
        radiusSearch_count_min=1,
        ransac_num_hypotheses=256, ransac_subsample_points=1024)

    # ---- config 2: depth association ---------------------------------
    print("[2/8] depth association (ransac / semantic / region growing)",
          flush=True)
    depth = {}
    for name, kw in (
            ("ransac", dict()),
            ("semantic", dict(plane_mode="semantic")),
            ("region_growing", dict()),
            ("road_veto_off", dict()),
            ("production", dict())):
        c = cfg
        if name == "semantic":
            c = cfg.replace(ransac_plane_refinement_treshold=0.3)
        elif name == "region_growing":
            c = cfg.replace(do_use_depth_segmentation=True)
        elif name == "road_veto_off":
            # Improved mode: drop the reference's own any-far road veto
            # (DepthEstimator.cpp:815-816 kills the whole road pass
            # when ONE widened-window neighbor is off-plane, even
            # though the fit only uses inlier-flagged points).
            c = cfg.replace(road_any_far_veto=False)
        elif name == "production":
            # The recommended operating point: fast single-scatter
            # rasterization + the road-veto fix.  README's headline
            # numbers trace to this row.
            c = cfg.replace(road_any_far_veto=False,
                            fast_rasterization=True)
        t0 = time.perf_counter()
        out = eval_depth_sequence(seq, c, max_tracks=512, max_length=8,
                                  verbose=False, **kw)
        cold_s = time.perf_counter() - t0
        # Second identical call reuses the jitted executable: wall_s is
        # the steady-state sequence time (what per-frame throughput
        # means), wall_cold_s additionally carries the one-time
        # trace+compile.
        t0 = time.perf_counter()
        out = eval_depth_sequence(seq, c, max_tracks=512, max_length=8,
                                  verbose=False, **kw)
        warm_s = time.perf_counter() - t0
        depth[name] = {
            "success_rate_all": round(out["success_rate_all"], 4),
            "success_rate_lidar_covered":
                round(out["success_rate_lidar_covered"], 4),
            "wall_s": round(warm_s, 1),
            "wall_cold_s": round(cold_s, 1)}
    # Fast-rasterization quality row (same eval, fast_rasterization=True)
    # + the device-only split for the ransac config: steady wall =
    # device compute + host loading and transfer (see
    # measure_depth_device_time).
    from mono_lidar_depth_tpu.eval.kitti_eval import (
        measure_depth_device_time)
    t0 = time.perf_counter()
    out = eval_depth_sequence(seq, cfg.replace(fast_rasterization=True),
                              max_tracks=512, max_length=8, verbose=False)
    depth["fast_rasterization"] = {
        "success_rate_all": round(out["success_rate_all"], 4),
        "success_rate_lidar_covered":
            round(out["success_rate_lidar_covered"], 4),
        "wall_s": None,
        "wall_cold_s": round(time.perf_counter() - t0, 1)}
    dev = measure_depth_device_time(seq, cfg, max_tracks=512,
                                    max_length=8)
    depth["ransac"]["device_s"] = round(dev["device_s"], 2)
    depth["ransac"]["device_ms_per_frame"] = round(
        dev["device_ms_per_frame"], 1)
    rec["depth"] = depth
    print("   ", json.dumps(depth), flush=True)

    # ---- config 3: VO + BA, landmark ablation + variance ---------------
    print("[3/8] VO + window BA (re-init x3 runs, persisted landmarks)",
          flush=True)
    vo_rec = {}
    vo_runs = {}

    def vo_metrics(vo):
        return {
            "ate_rmse_m": round(float(vo["ate_rmse"]), 3),
            "rpe_trans_rmse_m": round(float(vo["rpe_trans_rmse"]), 4),
            "rpe_rot_rmse_deg": round(float(vo["rpe_rot_rmse_deg"]), 4)}

    reinit_ates = []
    for run in range(3):
        vo = eval_vo_sequence(seq, cfg, OdometryConfig(), max_tracks=384,
                              max_length=8, verbose=False)
        reinit_ates.append(round(float(vo["ate_rmse"]), 3))
        if run == 0:
            vo_runs["reinit"] = vo
            vo_rec["reinit"] = vo_metrics(vo)
    vo_rec["reinit"]["ate_runs_m"] = reinit_ates
    vo = eval_vo_sequence(seq, cfg, OdometryConfig(persist_landmarks=True),
                          max_tracks=384, max_length=8, verbose=False)
    vo_runs["persist"] = vo
    vo_rec["persist"] = vo_metrics(vo)
    rec["vo"] = vo_rec
    print("   ", json.dumps(vo_rec), flush=True)

    # ---- config 4: pose-graph backend ---------------------------------
    print("[4/8] pose-graph backend with verified loop closures",
          flush=True)
    vo = vo_runs["reinit"]
    poses = vo["poses"]
    # Production proposal = union of metric (estimate-based) and
    # appearance (estimate-free) sources — identical chain in the
    # nominal and high-drift legs.
    cands = union_closure_candidates(
        propose_loop_closures(poses, min_gap=30, radius=8.0, stride=2,
                              max_candidates=12),
        propose_loop_closures_appearance(
            seq, [int(f) for f in vo["frame_ids"]], min_gap=30,
            stride=2, max_candidates=12))
    closures = []
    for (i, j) in cands:
        z = closure_constraint_from_frames(
            seq, cfg, vo["frame_ids"][i], vo["frame_ids"][j],
            max_features=cfg.max_features)
        if z is not None:
            closures.append((i, j, *z))
    gt = seq.gt_poses[vo["frame_ids"]]
    ate_vo = float(ate_rmse(poses[:, :3, 3], gt[:, :3, 3]))
    # Apply the consistency filter HERE so the record reports the
    # count of closures the backend actually used — the backend's
    # internal filtering would otherwise silently shrink the set after
    # `closures_verified` was recorded.
    def _remeasure(a, b):
        return closure_constraint_from_frames(
            seq, cfg, vo["frame_ids"][a], vo["frame_ids"][b],
            max_features=cfg.max_features)

    used = filter_consistent_closures(poses, closures,
                                      remeasure=_remeasure)
    if used:
        opt = run_pose_graph_backend(poses, used,
                                     consistency_filter=False)
        ate_pg = float(ate_rmse(opt[:, :3, 3], gt[:, :3, 3]))
    else:
        ate_pg = float("nan")
    rec["pose_graph"] = {
        "closures_proposed": len(cands),
        "closures_verified": len(closures),
        "closures_used": len(used),
        "ate_vo_m": round(ate_vo, 3),
        "ate_posegraph_m": round(ate_pg, 3)}
    print("   ", json.dumps(rec["pose_graph"]), flush=True)

    # ---- config 4b: pose-graph backend under DOMINANT drift ----------
    # The backend's raison d'etre (SURVEY §0): recover a trajectory
    # whose drift dwarfs the closure noise.  Inject a systematic
    # yaw-bias + scale error into the VO output (the classic VO error
    # model; images/clouds untouched so verification still measures
    # TRUE relative poses), then run the FULL chain — drift-aware
    # proposal on the DRIFTED estimate, KLT+depth+GN verification,
    # consistency filter, calibrated backend.
    print("[4b/8] pose-graph backend under injected heavy drift",
          flush=True)
    yaw = np.radians(0.5)  # per frame
    dR = np.array([[np.cos(yaw), 0, np.sin(yaw)], [0, 1, 0],
                   [-np.sin(yaw), 0, np.cos(yaw)]])
    drifted = [poses[0]]
    for k in range(len(poses) - 1):
        rel = np.linalg.inv(poses[k]) @ poses[k + 1]
        rel[:3, :3] = rel[:3, :3] @ dR
        rel[:3, 3] *= 1.08
        drifted.append(drifted[-1] @ rel)
    drifted = np.stack(drifted)
    ate_drift = float(ate_rmse(drifted[:, :3, 3], gt[:, :3, 3]))
    # Two proposal sources, unioned: the escalating drift-aware metric
    # proposal (min_candidates keeps it widening until it covers the
    # loop) AND the pose-estimate-free appearance proposal.  The metric
    # proposal alone fails here BY RANKING, not by radius: under a
    # dominant yaw/scale bias the drifted path curls near itself at
    # non-revisits, those junk pairs sort first (smallest estimated
    # distance) and fill the budget, and all 12 verifications
    # correctly fail — the r4/early-r5 recorded failures.  Appearance
    # similarity never consults the corrupted estimate, so its
    # candidates stay true revisits in every drift regime.
    cands_d = union_closure_candidates(
        propose_loop_closures(drifted, min_gap=30, radius=8.0,
                              stride=2, max_candidates=12,
                              min_candidates=6),
        propose_loop_closures_appearance(
            seq, [int(f) for f in vo["frame_ids"]], min_gap=30,
            stride=2, max_candidates=12))
    closures_d = []
    for (i, j) in cands_d:
        z = closure_constraint_from_frames(
            seq, cfg, vo["frame_ids"][i], vo["frame_ids"][j],
            max_features=cfg.max_features)
        if z is not None:
            closures_d.append((i, j, *z))
    used_d = filter_consistent_closures(drifted, closures_d,
                                        remeasure=_remeasure)
    if used_d:
        opt_d = run_pose_graph_backend(drifted, used_d,
                                       consistency_filter=False)
        ate_pg_d = float(ate_rmse(opt_d[:, :3, 3], gt[:, :3, 3]))
    else:
        ate_pg_d = float("nan")
    rec["pose_graph_high_drift"] = {
        "injected": "0.5 deg/frame yaw bias + 8% scale error",
        "closures_proposed": len(cands_d),
        "closures_verified": len(closures_d),
        "closures_used": len(used_d),
        "ate_drifted_m": round(ate_drift, 3),
        "ate_posegraph_m": round(ate_pg_d, 3),
        "recovered_pct": round(100.0 * (1.0 - ate_pg_d / ate_drift), 1)
        if np.isfinite(ate_pg_d) else None}
    print("   ", json.dumps(rec["pose_graph_high_drift"]), flush=True)

    # ---- success-rate vs lidar density (reconciliation) ---------------
    print("[5/8] success-rate vs lidar-density sweep", flush=True)
    sys.path.insert(0, str(REPO / "scripts"))
    from exp_success_rate import sweep

    rec["density_sweep"] = sweep(60, [10, 20, 40, 64])
    # Improved-road-mode leg at reference-like 64-beam density: the
    # row the 81.6%-class claims trace to (any-far veto is the
    # reference's own defect, DepthEstimator.cpp:815-816).
    rec["density_sweep_veto_off"] = sweep(60, [20, 64], far_veto=False)
    print("   ", json.dumps(rec["density_sweep"]), flush=True)
    print("   ", json.dumps(rec["density_sweep_veto_off"]), flush=True)

    # ---- scaling table (virtual mesh, CPU child process) -------------
    # The children run on the CPU (JAX_PLATFORMS=cpu), so this process
    # stays the only one on the accelerator.  A failed child fails the
    # record (check=True).
    cpu_env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    print("[6/8] scaling table (CPU child, virtual 8-device mesh)",
          flush=True)
    out = subprocess.run(
        [sys.executable, str(REPO / "scripts" / "bench_scaling.py"),
         "--devices", "1", "2", "4", "8"],
        capture_output=True, text=True, timeout=1800, check=True,
        cwd=str(REPO), env=cpu_env)
    rec["scaling"] = [json.loads(ln) for ln in out.stdout.splitlines()
                      if ln.startswith("{")]
    print("   ", json.dumps(rec["scaling"]), flush=True)

    print("[7/8] 2-process jax.distributed demo (CPU children)", flush=True)
    out = subprocess.run(
        [sys.executable, str(REPO / "scripts" / "multihost_demo.py")],
        capture_output=True, text=True, timeout=900, check=True,
        cwd=str(REPO), env=cpu_env)
    rec["multihost_demo"] = {
        "ok": True, "tail": out.stdout.strip().splitlines()[-2:]}
    print("   ", json.dumps(rec["multihost_demo"]), flush=True)

    tag = args.tag
    out_json = Path(args.out) / f"PARITY_{tag}.json"
    out_json.write_text(json.dumps(rec, indent=1) + "\n")
    md = _render_md(rec, tag)
    (Path(args.out) / f"PARITY_{tag}.md").write_text(md)
    print(f"wrote {out_json} and PARITY_{tag}.md")


def _render_md(rec: dict, tag: str) -> str:
    d = rec["depth"]
    v = rec["vo"]
    pg = rec["pose_graph"]
    lines = [
        f"# PARITY_{tag} — committed evaluation record",
        "",
        f"Regenerated by `python scripts/make_parity_record.py` "
        f"(backend: **{rec['backend']}**, commit `{rec['commit']}`, "
        f"{rec['frames']}-frame synthetic loop sequence, 384x128 images, "
        "20x500 lidar).",
        "",
        "## Config 2 — depth association success rates",
        "",
        "| mode | success (all) | success (lidar-covered) | "
        "steady wall s | cold wall s (incl. compile) |",
        "|---|---|---|---|---|",
    ]
    for k in ("ransac", "semantic", "region_growing",
              "fast_rasterization", "road_veto_off", "production"):
        r = d.get(k)
        if r is None:
            continue
        lines.append(
            f"| {k} | {100*r['success_rate_all']:.1f}% | "
            f"{100*r['success_rate_lidar_covered']:.1f}% | "
            f"{r['wall_s'] if r['wall_s'] is not None else '—'} | "
            f"{r.get('wall_cold_s') or '—'} |")
    if "production" in d:
        lines += [
            "",
            "`ransac` is strict reference parity (exact rasterization, "
            "the reference's any-far road veto replicated).  "
            "`road_veto_off` drops that veto (a documented reference "
            "defect, DepthEstimator.cpp:815-816).  `production` = "
            "road_veto_off + fast_rasterization — the recommended "
            "operating point; README headline numbers trace to it.",
        ]
    dev_s = d["ransac"].get("device_s")
    if dev_s is not None:
        wall = d["ransac"]["wall_s"]
        lines += [
            "",
            f"Device/host split (ransac row): device-only compute "
            f"{dev_s} s ({d['ransac']['device_ms_per_frame']} ms/frame, "
            "all chunks pre-staged on device) vs steady wall "
            f"{wall} s — the gap is host loading and host->device "
            "transfer.",
        ]
    lines += [
        "",
        "## Config 3 — VO + sliding-window BA (landmark ablation)",
        "",
        "| landmarks | ATE RMSE | RPE trans | RPE rot |",
        "|---|---|---|---|",
    ]
    for k in ("reinit", "persist"):
        r = v[k]
        lines.append(
            f"| {k} | {r['ate_rmse_m']} m | {r['rpe_trans_rmse_m']} m | "
            f"{r['rpe_rot_rmse_deg']} deg |")
    runs = v["reinit"].get("ate_runs_m", [])
    if runs:
        spread = max(runs) - min(runs)
        lines += ["",
                  f"Run-to-run (3× reinit, same inputs): ATE = {runs} m "
                  f"(spread {spread:.3f} m)."]
    # conditional drift commentary — the note must match the numbers
    path_len = rec["frames"] * 0.55
    ate = v["reinit"]["ate_rmse_m"]
    frac = ate / path_len
    if frac < 0.05:
        lines += ["",
                  f"VO drift is {100*frac:.1f}% of the {path_len:.0f} m "
                  "path — small; the pose-graph backend's effect at this "
                  "drift level is neutral-to-noise (its benefit regime is "
                  "high drift, covered by "
                  "tests/test_kitti_synthetic.py::"
                  "test_posegraph_closure_under_high_drift)."]
    else:
        lines += ["",
                  f"NOTE: VO drift is {100*frac:.1f}% of the "
                  f"{path_len:.0f} m path — LARGE.  This run records a "
                  "failure mode; see the config-4 numbers for whether the "
                  "backend recovered it."]
    lines += [
        "",
        "## Config 4 — pose-graph backend",
        "",
        f"Loop closures: {pg['closures_verified']} verified of "
        f"{pg['closures_proposed']} proposed (drift-aware radius); "
        f"{pg.get('closures_used', pg['closures_verified'])} survived "
        "consistency filtering and reached the backend.  "
        f"ATE RMSE: **{pg['ate_vo_m']} m (VO) → {pg['ate_posegraph_m']} m "
        "(pose graph)**.",
    ]
    if pg.get("closures_used", pg["closures_verified"]) == 0:
        lines += ["",
                  "NOTE: zero closures reached the backend — the "
                  "pose-graph column is not evaluable on this run "
                  "(recorded as such, not wallpapered)."]
    hd = rec.get("pose_graph_high_drift")
    if hd:
        lines += [
            "",
            "## Config 4b — pose-graph backend under dominant drift",
            "",
            f"Injected {hd['injected']} into the VO trajectory "
            "(images/clouds untouched — verification measures true "
            f"relative poses).  Drifted ATE {hd['ate_drifted_m']} m; "
            f"{hd['closures_verified']} closures verified of "
            f"{hd['closures_proposed']} proposed on the DRIFTED "
            f"estimate, {hd['closures_used']} used.  "
            f"ATE after backend: **{hd['ate_posegraph_m']} m "
            f"({hd['recovered_pct']}% of the drift recovered)**."
            if hd.get("recovered_pct") is not None else
            f"Injected {hd['injected']}; drifted ATE "
            f"{hd['ate_drifted_m']} m; ZERO closures survived — "
            "recorded as a failure.",
        ]
    sweep = rec.get("density_sweep", [])
    if sweep and "lidar_rows" in sweep[0]:
        lines += [
            "",
            "## Success rate vs lidar density (reconciliation vs the "
            "reference's 82.7%)",
            "",
            "| lidar rows | success (all) | success (lidar-covered) |",
            "|---|---|---|",
        ]
        for row in sweep:
            lines.append(
                f"| {row['lidar_rows']} | {100*row['success_all']:.1f}% | "
                f"{100*row['success_covered']:.1f}% |")
        lines += [
            "",
            "The reference's 82.7% covered-success figure "
            "(monolidar_fusion/Logs/log_depth_calc_stats.txt:4-5) was "
            "logged on 64-beam KITTI scans; the synthetic record uses "
            "20 rows.  The sweep above holds scene/trajectory/config "
            "fixed and varies only vertical lidar density — see "
            "DESIGN.md for the conclusion drawn from it.",
        ]
    sweep_off = rec.get("density_sweep_veto_off", [])
    if sweep_off and "lidar_rows" in sweep_off[0]:
        lines += [
            "",
            "Same sweep with the improved road mode "
            "(`road_any_far_veto=False` — drops the reference's own "
            "any-far defect):",
            "",
            "| lidar rows | success (all) | success (lidar-covered) |",
            "|---|---|---|",
        ]
        for row in sweep_off:
            lines.append(
                f"| {row['lidar_rows']} | {100*row['success_all']:.1f}% "
                f"| {100*row['success_covered']:.1f}% |")
    lines += [
        "",
        "## Scaling (virtual 8-device mesh)",
        "",
    ]
    for row in rec.get("scaling", []):
        lines.append(f"- `{json.dumps(row)}`")
    mh = rec.get("multihost_demo", {})
    lines += [
        "",
        f"2-process `jax.distributed` demo: "
        f"{'ok' if mh.get('ok') else 'FAILED'} "
        f"({'; '.join(mh.get('tail', []))})",
        "",
    ]
    return "\n".join(lines)


if __name__ == "__main__":
    main()
