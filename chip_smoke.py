#!/usr/bin/env python
"""Smoke run of the odometry engine on one NVIDIA GPU, at KITTI width.

    python chip_smoke.py               # one GPU: phases 1-6 below
    python chip_smoke.py --four-cards  # four GPUs: the sharded path only

Phases, in one process that owns the card:

  1. device    — fail unless JAX's first device is a GPU; print the card.
  2. gpu tier  — run tests_gpu/ in-process: GPU vs CPU parity, with
                 the depth cascade on a sparse and a KITTI-width frame.
  3. windows   — device time of the per-feature window gather at real
                 widths, bit-exact against a numpy oracle.
  4. depth     — the tier's KITTI-width frame, exact and fast
                 rasterization: GPU twice (identical codes), and the
                 device time of one frame from a trace.
  5. odometry  — eval_vo_sequence + the loop-closure backend on a
                 96-frame 1226x370 synthetic loop; then the 220-frame
                 accuracy configuration against its CPU envelope.
  6. memory    — compiled memory analysis of one odometry step, and the
                 device's peak bytes in use.

`--four-cards` runs only the multichip path of `__graft_entry__`
(sharded depth association, distributed BA, distributed pose graph) on
four GPUs and compares it with the single-device solvers.

Any failed phase raises, so the script exits non-zero and never prints
its last line, which on success is one JSON object:
    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}
Times printed here are set-up observations of this run, each beside the
card's name and power limit.
"""

import argparse
import glob
import importlib.util
import json
import subprocess
import sys
import tempfile
import time
from collections import Counter
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent

# Device-memory bandwidth of the H100 SXM (NVIDIA data sheet, bytes/s).
PEAK_BYTES_PER_S = {"NVIDIA H100 80GB HBM3": 3.35e12}

# KITTI widths of the run.
IMAGE = (1226, 370)  # camera width, height
FOCAL = 707.0
ODO_FRAMES = 96
LIDAR = (64, 1800)  # synthetic lidar rows, columns
MIN_GAP = 30  # frames between loop-closure candidates
MAX_VERIFY = 8  # loop-closure candidates verified
ACC_FRAMES = 220  # accuracy configuration 3

CARD = "unknown card"


def log(msg: str) -> None:
    print(msg, flush=True)


def log_time(label: str, seconds: float) -> None:
    log(f"  {label}: {seconds:.6f} s  [{CARD}]")


def depth_parity():
    """tests/depth_parity.py: the GPU tier's depth scenes."""
    spec = importlib.util.spec_from_file_location(
        "depth_parity", REPO / "tests" / "depth_parity.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


# ---- phase 1 ---------------------------------------------------------


def phase_device(count: int):
    global CARD
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"no GPU: JAX's first device is {devs[0].platform}")
    if len(devs) < count:
        raise SystemExit(f"needs {count} GPUs, JAX sees {len(devs)}")
    from mono_lidar_depth_tpu.compile_cache import use_compile_cache
    from mono_lidar_depth_tpu.io import native

    cache = use_compile_cache()
    CARD = card_line().splitlines()[0]
    log(f"[device] {devs[0].device_kind} x{len(devs)}; jax {jax.__version__}")
    log(f"[device] nvidia-smi: {card_line()}")
    log(f"[device] compile cache: {cache}")
    log(f"[device] native scan reader loaded: {native.native_available()}")
    return devs[0]


# ---- phase 2 ---------------------------------------------------------


class _Outcomes:
    """pytest plugin: count test outcomes of the in-process run, and
    print the readings the tests record."""

    def __init__(self):
        self.counts = Counter()

    def pytest_runtest_logreport(self, report):
        if report.when == "call" or report.outcome != "passed":
            self.counts[report.outcome] += 1
        if report.when == "call":
            for key, value in report.user_properties:
                log(f"[gpu tier] {report.nodeid.split('::')[-1]} {key}: "
                    f"{json.dumps(value)}  [{CARD}]")


def phase_gpu_tier():
    import pytest

    t0 = time.perf_counter()
    outcomes = _Outcomes()
    rc = pytest.main([str(REPO / "tests_gpu"), "-q", "-p", "no:xdist",
                      "-p", "no:cacheprovider"], plugins=[outcomes])
    log(f"[gpu tier] rc={rc} outcomes={dict(outcomes.counts)}")
    log_time("gpu tier wall", time.perf_counter() - t0)
    if rc != 0 or outcomes.counts["skipped"] or not outcomes.counts["passed"]:
        raise SystemExit(f"GPU tier failed: rc={rc} {dict(outcomes.counts)}")


# ---- trace reduction -------------------------------------------------


def _union_ns(intervals) -> int:
    total, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def device_time_per_call(fn, args, calls: int = 20):
    """(device busy seconds per call, Counter of kernel name -> ns) for
    `fn(*args)`, from a profiler trace of `calls` warm calls: the union
    of the intervals of every event on the GPU's stream lines."""
    import jax

    jax.block_until_ready(fn(*args))
    with tempfile.TemporaryDirectory() as d:
        jax.profiler.start_trace(d)
        for _ in range(calls):
            out = fn(*args)
        jax.block_until_ready(out)
        jax.profiler.stop_trace()
        (pb,) = glob.glob(f"{d}/plugins/profile/*/*.xplane.pb")
        prof = jax.profiler.ProfileData.from_file(pb)
    intervals, kernels, seen = [], Counter(), []
    for plane in prof.planes:
        if not plane.name.startswith("/device:GPU:0"):
            continue
        for line in plane.lines:
            events = list(line.events)
            seen.append((plane.name, line.name, len(events)))
            if "stream" not in line.name.lower():
                continue
            for ev in events:
                intervals.append((ev.start_ns, ev.end_ns))
                kernels[ev.name] += ev.duration_ns
    if not intervals:
        raise SystemExit(f"no GPU stream events in the trace: {seen}")
    return _union_ns(intervals) / calls * 1e-9, kernels


# ---- phase 3 ---------------------------------------------------------


def phase_windows(device, cfg):
    import jax
    import jax.numpy as jnp

    from mono_lidar_depth_tpu.core.neighbors import slice_windows

    peak = PEAK_BYTES_PER_S.get(device.device_kind)
    rng = np.random.default_rng(0)
    results = {}

    C = 3 if cfg.do_use_depth_segmentation else 2
    N = cfg.max_features
    cases = [(f"depth primary {cfg.primary_window}",
              (C, cfg.image_height, cfg.image_width), cfg.primary_window),
             (f"depth road {cfg.road_window}",
              (C, cfg.image_height, cfg.image_width), cfg.road_window)]
    # KLT: 9x9 patches sample 10x10 and 12x12 integer windows on each
    # edge-padded level of a 4-level pyramid of the camera image.
    w, h = IMAGE
    for lvl in range(4):
        for k in (10, 12):
            cases.append((f"klt level {lvl} {k}x{k}",
                          (1, h + 22, w + 22), (k, k)))
        h, w = h // 2, w // 2

    for name, (c, hh, ww), (ky, kx) in cases:
        stack = rng.normal(size=(c, hh, ww)).astype(np.float32)
        sy = rng.integers(0, hh - ky + 1, N).astype(np.int32)
        sx = rng.integers(0, ww - kx + 1, N).astype(np.int32)
        fn = jax.jit(lambda s, y, x, ky=ky, kx=kx: slice_windows(s, y, x,
                                                                 ky, kx))
        args = (jnp.asarray(stack), jnp.asarray(sy), jnp.asarray(sx))
        got = np.asarray(fn(*args))
        want = np.stack([stack[:, y:y + ky, x:x + kx]
                         for y, x in zip(sy, sx)])
        if not np.array_equal(got, want):
            raise SystemExit(f"window mismatch in {name}")
        t, kernels = device_time_per_call(fn, args)
        nbytes = 2 * got.nbytes  # read + write of the windows, at least
        share = f"{nbytes / peak / t:.3f}" if peak else "unknown share"
        results[name] = t
        log(f"[windows] {name}: N={N} C={c} grid {hh}x{ww}: "
            f"{t * 1e6:.2f} us/call, {nbytes / t / 1e9:.1f} GB/s, "
            f"{share} of the bytes bound; kernels "
            f"{[k for k, _ in kernels.most_common(3)]}  [{CARD}]")
    return results


# ---- phase 4 ---------------------------------------------------------


def phase_depth(device, window_times):
    """GPU vs CPU at KITTI width is the tier's (phase 2); here the same
    frame runs twice on the GPU, and once under the profiler."""
    import jax
    import jax.numpy as jnp

    from mono_lidar_depth_tpu import estimate_depths, fit_ground_plane_ransac

    parity = depth_parity()
    for fast in (False, True):
        name = "fast" if fast else "exact"
        cfg, cam, T, cloud, valid, feats, ransac = parity.scene("kitti", fast)
        if not fast:
            log(f"[depth] {cfg.max_points} padded points "
                f"({int(valid.sum())} real), {cfg.max_features} features, "
                f"camera {cam.width}x{cam.height}, grid {cfg.image_height}x"
                f"{cfg.image_width}, RANSAC {cfg.ransac_num_hypotheses} "
                "hypotheses")
        inputs = (cfg, cam, T, cloud, valid, feats, ransac)
        d1, c1 = parity.run_depths(device, *inputs)
        d2, c2 = parity.run_depths(device, *inputs)
        rerun_codes = int(np.sum(c1 != c2))
        log(f"[depth] {name}: success {np.mean(d1 > 0):.4f}; GPU rerun: "
            f"{rerun_codes} codes differ, max |depth diff| "
            f"{float(np.abs(d1 - d2).max()):.3e}")
        if rerun_codes:
            raise SystemExit(f"depth {name}: two GPU runs differ")
        if fast:
            continue
        c, v = jnp.asarray(cloud), jnp.asarray(valid)
        gp = fit_ground_plane_ransac(c, v, jax.random.PRNGKey(3), **ransac)
        args = (c, v, jnp.asarray(feats), jnp.ones(cfg.max_features, bool),
                gp)
        fn = jax.jit(lambda *a: estimate_depths(cfg, cam, T, *a))
        t, kernels = device_time_per_call(fn, args, 10)
        win = (window_times[f"depth primary {cfg.primary_window}"]
               + window_times[f"depth road {cfg.road_window}"])
        log(f"[depth] estimate_depths device time {t * 1e3:.3f} ms/frame;"
            f" the two window gathers {win * 1e6:.2f} us = "
            f"{win / t:.4f} of it  [{CARD}]")
        top = [(k, round(v / 10 / 1e3, 1)) for k, v in
               kernels.most_common(8)]
        log(f"[depth] top kernels (us/frame): {top}")


# ---- phase 5 ---------------------------------------------------------


def phase_odometry(cfg):
    from mono_lidar_depth_tpu import DepthEstimatorConfig
    from mono_lidar_depth_tpu.eval import eval_vo_sequence
    from mono_lidar_depth_tpu.io.kitti import KittiSequence
    from mono_lidar_depth_tpu.io.synthetic_dataset import (
        SyntheticSpec, generate_kitti_sequence)

    sys.path.insert(0, str(REPO / "scripts"))
    from run_kitti import posegraph

    w, h = IMAGE
    n = ODO_FRAMES
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        generate_kitti_sequence(root, "90", SyntheticSpec(
            frames=n, image_width=w, image_height=h, focal=FOCAL,
            lidar_rows=LIDAR[0], lidar_cols=LIDAR[1],
            loop=True))
        seq = KittiSequence(root, "90", image_width=w, image_height=h)
        log_time(f"[odometry] generate {n} frames (host)",
                 time.perf_counter() - t0)
        t0 = time.perf_counter()
        vo = eval_vo_sequence(seq, cfg, verbose=False)
        log_time("[odometry] eval_vo_sequence incl. compile",
                 time.perf_counter() - t0)
        if not np.isfinite(vo["poses"]).all():
            raise SystemExit("VO produced non-finite poses")
        t0 = time.perf_counter()
        pg = posegraph(seq, cfg, vo, min_gap=MIN_GAP, max_verify=MAX_VERIFY)
        log_time("[odometry] closure verification + pose graph",
                 time.perf_counter() - t0)
        if not np.isfinite(pg["poses"]).all():
            raise SystemExit("pose graph produced non-finite poses")
        if not pg["candidates"]:
            raise SystemExit("no loop-closure candidate was proposed")
        log(f"[odometry] {n} frames {w}x{h}: ATE VO {pg['ate_vo']:.3f} m -> "
            f"pose graph {pg['ate_posegraph']:.3f} m; closures "
            f"{pg['closures']}/{pg['candidates']} verified; RPE trans "
            f"{vo['rpe_trans_rmse']:.4f} m")

    # accuracy configuration 3 (tests/test_accuracy_envelope.py)
    W, H = 384, 128
    cfg3 = DepthEstimatorConfig(
        max_points=16384, max_features=384, image_width=W, image_height=H,
        radiusSearch_count_min=1,
        ransac_num_hypotheses=256, ransac_subsample_points=1024)
    with tempfile.TemporaryDirectory() as root:
        generate_kitti_sequence(root, "98", SyntheticSpec(
            frames=ACC_FRAMES, image_width=W, image_height=H,
            focal=240.0,
            lidar_rows=20, lidar_cols=500, step=0.55, loop=True))
        seq = KittiSequence(root, "98", image_width=W, image_height=H)
        vo = eval_vo_sequence(seq, cfg3, max_tracks=384, max_length=8,
                              verbose=False)
    ate, rpe_t = float(vo["ate_rmse"]), float(vo["rpe_trans_rmse"])
    log(f"[odometry] config 3 ({ACC_FRAMES} frames 384x128): ATE "
        f"{ate:.3f} m, RPE "
        f"trans {rpe_t:.4f} m, rot {float(vo['rpe_rot_rmse_deg']):.3f} deg")
    if not (ate < 2.45 and rpe_t < 0.075):
        raise SystemExit("config 3 outside the ATE/RPE envelope")


# ---- phase 6 ---------------------------------------------------------


def phase_memory(device):
    import jax
    import jax.numpy as jnp

    from mono_lidar_depth_tpu.tracks.pipeline import FrameInput
    from mono_lidar_depth_tpu.vo.pipeline import (OdometryConfig,
                                                  OdometryState,
                                                  odometry_step)

    cfg, cam, T, cloud, valid, feats, _ = depth_parity().scene("kitti")
    M = cfg.max_features
    ocfg = OdometryConfig()
    state = OdometryState.create(cfg, ocfg, max_tracks=M, max_length=12)
    frame = FrameInput(
        cloud=jnp.asarray(cloud), cloud_valid=jnp.asarray(valid),
        ids=jnp.arange(M, dtype=jnp.int32), ids_valid=jnp.ones(M, bool),
        uv_new=jnp.asarray(feats), uv_prev=jnp.asarray(feats),
        stamp=jnp.float32(0.1), rng=jax.random.PRNGKey(0))
    compiled = odometry_step.lower(cfg, ocfg, cam, T, state,
                                   frame).compile()
    log(f"[memory] odometry_step memory_analysis: "
        f"{compiled.memory_analysis()}")
    log(f"[memory] peak_bytes_in_use: "
        f"{device.memory_stats()['peak_bytes_in_use']}  [{CARD}]")


# ---- four cards ------------------------------------------------------


def phase_four_cards():
    import __graft_entry__ as graft

    t0 = time.perf_counter()
    got = graft.dryrun_multichip(4)
    log_time("[four cards] sharded step incl. compile",
             time.perf_counter() - t0)
    ref = graft.multichip_reference(4)
    diff = graft.compare_multichip(got, ref)
    log(f"[four cards] sharded vs one device: {json.dumps(diff)}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded path on four GPUs")
    args = ap.parse_args()
    count = 4 if args.four_cards else 1
    sys.path.insert(0, str(REPO))

    import jax

    t_start = time.perf_counter()
    device = phase_device(count)
    if args.four_cards:
        phase_four_cards()
    else:
        from mono_lidar_depth_tpu import DepthEstimatorConfig

        cfg = DepthEstimatorConfig()
        phase_gpu_tier()
        window_times = phase_windows(device, cfg)
        phase_depth(device, window_times)
        phase_odometry(cfg)
        phase_memory(device)
    log_time("total", time.perf_counter() - t_start)
    log(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": device.platform, "kind": device.device_kind,
        "count": len(jax.devices())}}), flush=True)


if __name__ == "__main__":
    main()
