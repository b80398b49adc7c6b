#!/usr/bin/env python
"""Benchmark: per-frame throughput on one chip.

Prints ONE JSON line:
  {"metric": "...", "value": N, "unit": "...", "vs_baseline": N, ...}

Baseline: the reference claims real-time operation on KITTI ("can be
called once per frame in real time", monolidar_fusion/README.md:33) —
KITTI frames arrive at 10 Hz, so the reference CPU baseline is 10
frames/s.  vs_baseline = measured frames/s / 10.

Two legs, matching BASELINE.json's metric "frames/s/chip (depth assoc
+ BA)":
  * headline `value`: the FULL odometry step (tracklet-depth
    association with both estimator passes + RANSAC ground plane +
    frame-to-frame pose Gauss-Newton + sliding-window bundle
    adjustment) per frame;
  * `depth_assoc_fps`: the depth-association pipeline alone
    (projection/rasterization + RANSAC + both window scales +
    histogram + plane fits + gates + road fallback + statistics).

Timing integrity: every measured region is a `lax.scan` inside ONE
jitted program whose per-frame outputs are all folded into a carried
checksum (and the state threads through the carry), so XLA cannot elide
any frame's work; each region ends in `block_until_ready`.
"""

import json
import sys
import time

import numpy as np

# Timed repetitions per leg.  The committed artifact must be robust to
# host contention on the shared dev machine: the r4 driver recorded a
# single-shot depth-assoc 127.9 fps that a rerun minutes later measured
# at 163.6 fps (~22% swing, pure contention) — indistinguishable from a
# real regression in a 1-rep protocol.  Every leg now reports the
# MEDIAN of N_REPS timed runs plus min/max spread; `timing_spread_ok`
# flags (not fails) any leg whose (max-min)/median exceeds 10% so a
# contended artifact is impossible to misread as a regression.
N_REPS = 3


def _timed_reps(fn, n: int = N_REPS) -> dict:
    """Run fn() n times (already warmed/compiled); seconds per rep."""
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    ts.sort()
    med = ts[len(ts) // 2] if n % 2 else 0.5 * (
        ts[n // 2 - 1] + ts[n // 2])
    return {"median_s": med, "min_s": ts[0], "max_s": ts[-1],
            "spread_frac": (ts[-1] - ts[0]) / med if med > 0 else 0.0}


def main() -> None:
    import jax
    import jax.numpy as jnp

    from mono_lidar_depth_tpu import (
        DepthEstimatorConfig, PinholeCamera, SE3, estimate_depths,
        fit_ground_plane_ransac)
    from mono_lidar_depth_tpu.compile_cache import use_compile_cache
    from mono_lidar_depth_tpu.io.kitti import make_synthetic_scan, pad_cloud
    from mono_lidar_depth_tpu.tracks.pipeline import FrameInput
    from mono_lidar_depth_tpu.vo.pipeline import (OdometryConfig,
                                                  OdometryState,
                                                  odometry_step)

    use_compile_cache()
    # The reference cannot actually run with region growing enabled
    # (its code path throws, DepthEstimator.cpp:608), so the 10 Hz
    # baseline excludes it — benchmark the comparable configuration.
    cfg = DepthEstimatorConfig().replace(do_use_depth_segmentation=False)
    cam = PinholeCamera(width=1226, height=370, focal_length=707.0,
                        cx=601.8, cy=183.1)
    R_lc = np.array([[0, -1, 0], [0, 0, -1], [1, 0, 0]], dtype=np.float32)
    t_lc = np.array([0.0, -0.08, 0.27], dtype=np.float32)
    T = SE3(jnp.asarray(R_lc), jnp.asarray(t_lc))

    rng = np.random.default_rng(0)
    # All frames in one scanned batch are DISTINCT (fresh cloud, fresh
    # features, fresh RNG key) — identical repeated computations would
    # be CSE'd by XLA and overstate throughput.  96 frames amortize the
    # per-dispatch overhead of one jitted call.
    n_frames = 96
    reps = 1
    M = cfg.max_features

    clouds, valids = [], []
    for _ in range(n_frames):
        scan = make_synthetic_scan(rng, 120000)
        c, v = pad_cloud(scan, len(scan), cfg.max_points)
        clouds.append(c)
        valids.append(v)
    clouds = jnp.asarray(np.stack(clouds))
    valids = jnp.asarray(np.stack(valids))
    # Persistent track ids with drifting features — a realistic steady
    # state for the tracklet table (all slots live, most with depth).
    base_uv = rng.uniform([8, 8], [1218, 362], (M, 2))
    drift = rng.normal(0.0, 1.5, (n_frames, M, 2))
    uv_new = np.clip(base_uv[None] + np.cumsum(drift, axis=0),
                     [1, 1], [1225, 369]).astype(np.float32)
    uv_prev = np.concatenate([uv_new[:1], uv_new[:-1]], axis=0)
    ids = jnp.broadcast_to(jnp.arange(M, dtype=jnp.int32), (n_frames, M))
    ids_valid = jnp.ones((n_frames, M), dtype=bool)
    keys = jax.random.split(jax.random.PRNGKey(0), n_frames)
    frames = FrameInput(
        cloud=clouds, cloud_valid=valids,
        ids=ids, ids_valid=ids_valid,
        uv_new=jnp.asarray(uv_new), uv_prev=jnp.asarray(uv_prev),
        stamp=jnp.arange(n_frames, dtype=jnp.float32) * 0.1,
        rng=keys)

    # ---- leg 1: depth association only ---------------------------------
    feats = jnp.asarray(uv_new)
    fvalid = jnp.ones((n_frames, M), dtype=bool)

    def depth_frame(cloud, cvalid, uv, uvv, key, c=None):
        c = c or cfg
        gp = fit_ground_plane_ransac(
            cloud, cvalid, key,
            distance_threshold=c.ransac_plane_distance_treshold,
            num_hypotheses=c.ransac_num_hypotheses,
            subsample=c.ransac_subsample_points,
            use_refinement=c.ransac_plane_use_refinement,
            refinement_threshold=c.ransac_plane_refinement_treshold)
        return estimate_depths(c, cam, T, cloud, cvalid, uv, uvv, gp)

    # Every measured region folds all per-frame outputs into a scalar
    # checksum carried through the scan (nothing can be elided) and
    # ends in block_until_ready.
    @jax.jit
    def run_depth():
        def step(acc, inp):
            c, v, f, fv, k = inp
            out = depth_frame(c, v, f, fv, k)
            s = (jnp.sum(out.depths) + jnp.sum(out.codes)
                 + jnp.sum(out.counters)).astype(jnp.float32)
            return acc + s, None
        acc = jnp.float32(0)
        for _ in range(reps):
            acc, _ = jax.lax.scan(step, acc,
                                  (clouds, valids, feats, fvalid, keys))
        return acc

    run_depth().block_until_ready()  # compile + first run
    r_depth = _timed_reps(lambda: run_depth().block_until_ready())
    depth_fps = n_frames * reps / r_depth["median_s"]

    # ---- leg 1b: depth association, fast rasterization -----------------
    # config.fast_rasterization: single-scatter frame ingest, <= 1 cm
    # depth quantization; accuracy-neutral end-to-end (DESIGN.md).
    # The default (exact) path stays
    # the headline; this key records the production-mode throughput.
    cfg_fast = cfg.replace(fast_rasterization=True)

    @jax.jit
    def run_depth_fast():
        def step(acc, inp):
            c, v, f, fv, k = inp
            out = depth_frame(c, v, f, fv, k, cfg_fast)
            s = (jnp.sum(out.depths) + jnp.sum(out.codes)
                 + jnp.sum(out.counters)).astype(jnp.float32)
            return acc + s, None
        acc, _ = jax.lax.scan(step, jnp.float32(0),
                              (clouds, valids, feats, fvalid, keys))
        return acc

    run_depth_fast().block_until_ready()
    r_depth_fast = _timed_reps(lambda: run_depth_fast().block_until_ready())
    depth_fast_fps = n_frames / r_depth_fast["median_s"]

    # ---- leg 2: full odometry step (depth assoc + pose GN + BA) --------
    ocfg = OdometryConfig()
    state0 = OdometryState.create(cfg, ocfg, max_tracks=M, max_length=12)

    @jax.jit
    def run_odo(state):
        def step(carry, frame):
            st, acc = carry
            st, R_cw, t_cw, diag = odometry_step(
                cfg, ocfg, cam, T, st, frame)
            acc = acc + (jnp.sum(R_cw) + jnp.sum(t_cw)
                         + jnp.sum(diag)).astype(jnp.float32)
            return (st, acc), None
        carry = (state, jnp.float32(0))
        for _ in range(reps):
            carry, _ = jax.lax.scan(step, carry, frames)
        return carry

    state_warm, acc = run_odo(state0)
    acc.block_until_ready()  # compile + first run

    def _odo_once():
        run_odo(state_warm)[1].block_until_ready()

    r_odo = _timed_reps(_odo_once)
    odo_fps = n_frames * reps / r_odo["median_s"]

    # ---- leg 2b: full odometry with fast rasterization ------------------
    state0_fast = OdometryState.create(cfg_fast, ocfg, max_tracks=M,
                                       max_length=12)

    @jax.jit
    def run_odo_fast(state):
        def step(carry, frame):
            st, acc = carry
            st, R_cw, t_cw, diag = odometry_step(
                cfg_fast, ocfg, cam, T, st, frame)
            acc = acc + (jnp.sum(R_cw) + jnp.sum(t_cw)
                         + jnp.sum(diag)).astype(jnp.float32)
            return (st, acc), None
        carry, _ = jax.lax.scan(step, (state, jnp.float32(0)), frames)
        return carry

    sw, acc = run_odo_fast(state0_fast)
    acc.block_until_ready()

    def _odo_fast_once():
        run_odo_fast(sw)[1].block_until_ready()

    r_odo_fast = _timed_reps(_odo_fast_once)
    odo_fast_fps = n_frames / r_odo_fast["median_s"]

    # Dispatch-inclusive single-frame figure: ONE odometry step per
    # jitted call, so the per-dispatch overhead is IN the number.
    # Reported alongside the amortized scan throughput so both are
    # visible (steady-state streaming amortizes the dispatch; a strict
    # 1-frame-in/1-pose-out serving loop pays it every frame).
    one_frame = jax.tree.map(lambda a: a[0], frames)

    @jax.jit
    def run_one(state, frame):
        return odometry_step(cfg, ocfg, cam, T, state, frame)

    _, R1, t1, d1 = run_one(state_warm, one_frame)
    np.asarray(t1)  # compile + first run
    n_single = 10
    singles = []
    st = state_warm
    for k in range(n_single * N_REPS):
        t0 = time.perf_counter()
        st, R1, t1, d1 = run_one(st, jax.tree.map(
            lambda a, _k=(k % n_frames): a[_k], frames))
        # A strict serving loop reads the pose back before the next
        # frame arrives — fetch INSIDE the loop, else async dispatch
        # pipelines the steps and the figure undercounts exactly the
        # latency it exists to capture.
        np.asarray(t1)
        singles.append(time.perf_counter() - t0)
    single_ms = float(np.median(singles)) * 1e3

    # ---- stage breakdown (regression canary) ---------------------------
    # Same scan protocol, one leg per stage, so a stage-level perf
    # regression shows up in the committed bench line (the r2 -> r3
    # -6% combined drift was invisible in the two totals; see PERF.md
    # for the per-round history).
    from mono_lidar_depth_tpu.vo.ba import BAProblem, run_ba
    from mono_lidar_depth_tpu.vo.pose import estimate_pose_gn

    lm = jnp.asarray(rng.uniform([-20, -5, 5], [20, 5, 60],
                                 (M, 3)).astype(np.float32))
    usable = jnp.ones((n_frames, M), bool)

    @jax.jit
    def run_gn():
        def step(acc, inp):
            uv, us = inp
            est = estimate_pose_gn(cam, lm, uv, us,
                                   R_init=jnp.eye(3), t_init=jnp.zeros(3))
            return acc + est.translation.sum() + est.rotation.sum(), None
        acc, _ = jax.lax.scan(step, jnp.float32(0),
                              (jnp.asarray(uv_new), usable))
        return acc

    run_gn().block_until_ready()
    r_gn = _timed_reps(lambda: run_gn().block_until_ready())
    gn_ms = r_gn["median_s"] / n_frames * 1e3

    Wb = ocfg.ba_window
    obs_uv = jnp.asarray(np.stack(
        [uv_new[k:k + Wb] for k in range(n_frames - Wb)]))
    nF = obs_uv.shape[0]
    eyeW = jnp.broadcast_to(jnp.eye(3, dtype=jnp.float32), (Wb, 3, 3))

    @jax.jit
    def run_ba_scan():
        def step(acc, ouv):
            pb = BAProblem(
                R=eyeW, t=jnp.zeros((Wb, 3), jnp.float32) + acc * 0,
                landmarks=lm, obs_uv=ouv,
                obs_mask=jnp.ones((Wb, M), bool),
                depth_prior=jnp.full((Wb, M), 12.0),
                depth_mask=jnp.ones((Wb, M), bool),
                fixed=jnp.arange(Wb) == Wb - 1,
                lm_valid=jnp.ones((M,), bool))
            res = run_ba(cam, pb, iters=ocfg.ba_iters,
                         depth_weight=ocfg.depth_weight)
            return acc + res.problem.t.sum(), None
        acc, _ = jax.lax.scan(step, jnp.float32(0), obs_uv)
        return acc

    run_ba_scan().block_until_ready()
    r_ba = _timed_reps(lambda: run_ba_scan().block_until_ready())
    ba_ms = r_ba["median_s"] / nF * 1e3

    legs = {"combined": r_odo, "depth_assoc": r_depth,
            "depth_assoc_fast": r_depth_fast, "combined_fast": r_odo_fast,
            "pose_gn": r_gn, "window_ba": r_ba}
    spreads = {f"spread_pct_{k}": round(100.0 * r["spread_frac"], 1)
               for k, r in legs.items()}
    worst = max(r["spread_frac"] for r in legs.values())
    print(json.dumps({
        "metric": "frames_per_s_per_chip_depth_assoc_plus_ba",
        "value": round(odo_fps, 2),
        "unit": "frames/s",
        "vs_baseline": round(odo_fps / 10.0, 2),
        "depth_assoc_fps": round(depth_fps, 2),
        "depth_assoc_vs_baseline": round(depth_fps / 10.0, 2),
        "depth_assoc_fast_fps": round(depth_fast_fps, 2),
        "combined_fast_fps": round(odo_fast_fps, 2),
        "single_dispatch_frame_ms": round(single_ms, 2),
        "stage_ms_depth_assoc": round(1e3 / depth_fps, 2),
        "stage_ms_odometry_full": round(1e3 / odo_fps, 2),
        "stage_ms_pose_gn": round(gn_ms, 2),
        "stage_ms_window_ba": round(ba_ms, 2),
        # dispersion protocol: medians of N_REPS timed reps; spread =
        # (max-min)/median per leg.  A leg spread > 10% means host
        # contention polluted this artifact — compare medians across
        # rounds, and rerun before calling a regression.
        "timing_reps": N_REPS,
        "timing_spread_ok": bool(worst <= 0.10),
        **spreads,
    }))


if __name__ == "__main__":
    sys.path.insert(0, ".")
    main()
