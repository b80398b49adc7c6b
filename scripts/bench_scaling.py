#!/usr/bin/env python
"""Scaling-efficiency harness: frame-parallel depth association and
landmark-sharded distributed BA at 1..N devices.

`--platform gpu` runs on the host's GPUs (NVLink collectives);
the default `--platform cpu` runs on a virtual CPU mesh (one thread per
device), which validates the sharding/collective structure only.

Prints one JSON line per workload:
  {"workload": ..., "devices": [...], "frames_per_s": [...],
   "efficiency_at_max": ...}
"""

import argparse
import json
import os
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, nargs="+", default=[1, 2, 4, 8])
    ap.add_argument("--platform", choices=["cpu", "gpu"], default="cpu",
                    help="gpu: the host's GPUs; cpu: a virtual mesh")
    args = ap.parse_args()

    if args.platform == "cpu":
        # the virtual mesh must exist before the backend initializes
        os.environ.setdefault("XLA_FLAGS", "")
        if "host_platform_device_count" not in os.environ["XLA_FLAGS"]:
            os.environ["XLA_FLAGS"] += (
                " --xla_force_host_platform_device_count="
                f"{max(args.devices)}")
    import jax

    jax.config.update("jax_platforms", args.platform)
    if len(jax.devices()) < max(args.devices):
        raise SystemExit(f"{max(args.devices)} {args.platform} devices "
                         f"needed, {len(jax.devices())} visible")

    import numpy as np
    import jax.numpy as jnp

    from mono_lidar_depth_tpu import DepthEstimatorConfig, PinholeCamera, SE3
    from mono_lidar_depth_tpu.dist import (
        distributed_ba, frame_sharding, make_mesh, sharded_depth_association)

    cfg = DepthEstimatorConfig(
        max_points=16384, max_features=512, image_width=640,
        image_height=192, ransac_num_hypotheses=256,
        ransac_subsample_points=2048)
    cam = PinholeCamera(640, 192, 350.0, 320.0, 96.0)
    R_lc = np.array([[0, -1, 0], [0, 0, -1], [1, 0, 0]], dtype=np.float32)
    T = SE3(jnp.asarray(R_lc), jnp.zeros(3, dtype=jnp.float32))
    rng = np.random.default_rng(0)

    # ---- workload 1: frame-parallel depth association ---------------
    B = max(args.devices) * 2
    clouds = jnp.asarray(rng.uniform(
        [2, -15, -2], [60, 15, 3], (B, cfg.max_points, 3)).astype(np.float32))
    cvalids = jnp.ones((B, cfg.max_points), bool)
    feats = jnp.asarray(rng.uniform(
        [2, 2], [638, 190], (B, cfg.max_features, 2)).astype(np.float32))
    fvalids = jnp.ones((B, cfg.max_features), bool)
    keys = jax.random.split(jax.random.PRNGKey(0), B)

    fps = []
    for nd in args.devices:
        mesh = make_mesh(nd)
        step = sharded_depth_association(cfg, cam, T, mesh)
        cs = jax.device_put(clouds, frame_sharding(mesh))
        out = step(cs, cvalids, feats, fvalids, keys)
        jax.block_until_ready(out)
        t0 = time.perf_counter()
        reps = 5
        for _ in range(reps):
            out = step(cs, cvalids, feats, fvalids, keys)
            s = jnp.sum(out[0]).block_until_ready()  # force execution
        dt = (time.perf_counter() - t0) / (reps * B)
        fps.append(1.0 / dt)
    eff = (fps[-1] / fps[0]) / (args.devices[-1] / args.devices[0])
    print(json.dumps({
        "workload": "depth_association_frame_parallel",
        "devices": args.devices,
        "frames_per_s": [round(f, 1) for f in fps],
        "efficiency_at_max": round(eff, 3),
        "platform": args.platform,
        "note": ("a virtual CPU mesh shares physical cores - efficiency "
                 "is only meaningful on GPUs")}))

    # ---- workload 2: landmark-sharded distributed BA ----------------
    from mono_lidar_depth_tpu.vo.ba import BAProblem

    K, L = 8, 512 * max(args.devices)
    X = np.stack([rng.uniform(-15, 15, L), rng.uniform(-5, 5, L),
                  rng.uniform(5, 60, L)], 1).astype(np.float32)
    Rs = np.tile(np.eye(3, dtype=np.float32), (K, 1, 1))
    ts = np.stack([np.array([0.5 * k, 0, 0.2 * k], np.float32)
                   for k in range(K)])
    obs, masks, dpri = [], [], []
    for k in range(K):
        p = X @ Rs[k].T + ts[k]
        uv = np.stack([350.0 * p[:, 0] / p[:, 2] + 320.0,
                       350.0 * p[:, 1] / p[:, 2] + 96.0], 1)
        uv += rng.normal(size=uv.shape) * 0.5
        obs.append(uv.astype(np.float32))
        masks.append(p[:, 2] > 1)
        dpri.append(p[:, 2].astype(np.float32))
    problem = BAProblem(
        R=jnp.asarray(Rs), t=jnp.asarray(ts),
        landmarks=jnp.asarray(
            X + rng.normal(size=X.shape).astype(np.float32) * 0.2),
        obs_uv=jnp.asarray(np.stack(obs)),
        obs_mask=jnp.asarray(np.stack(masks)),
        depth_prior=jnp.asarray(np.stack(dpri)),
        depth_mask=jnp.asarray(np.stack(masks)),
        fixed=jnp.asarray(np.arange(K) == 0),
        lm_valid=jnp.ones(L, bool))

    solves = []
    for nd in args.devices:
        mesh = make_mesh(nd, landmark_parallel=nd)
        solver = distributed_ba(cam, mesh, iters=8)
        res = solver(problem)
        jax.block_until_ready(res)
        t0 = time.perf_counter()
        reps = 5
        for _ in range(reps):
            res = solver(problem)
            _ = res.final_cost.block_until_ready()
        solves.append(reps / (time.perf_counter() - t0))
    eff = (solves[-1] / solves[0]) / (args.devices[-1] / args.devices[0])
    print(json.dumps({
        "workload": "distributed_schur_ba",
        "devices": args.devices,
        "solves_per_s": [round(s, 2) for s in solves],
        "efficiency_at_max": round(eff, 3),
        "platform": args.platform,
        "note": ("per-device landmark shard is L/D - work scales down "
                 "1/D per device; wall-clock efficiency is only "
                 "meaningful on GPUs")}))


if __name__ == "__main__":
    main()
