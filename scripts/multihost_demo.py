#!/usr/bin/env python
"""Multi-host (multi-process) distributed-BA demonstration.

BASELINE config 5 exercises keyframes/map blocks partitioned ACROSS
HOSTS.  This demo runs the landmark-sharded Schur BA over a
`jax.distributed` mesh spanning SEPARATE PROCESSES (the multi-host
topology: on GPU hosts the same code rides the network between hosts
and NVLink within one), and checks the result against the
single-process solver.

Run:  python scripts/multihost_demo.py            # spawns 2 processes
      python scripts/multihost_demo.py --worker N # internal
"""

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

PORT = 12355
NPROC = 2
LOCAL_DEVICES = 2  # virtual CPU devices per process


def worker(process_id: int) -> None:
    os.environ["XLA_FLAGS"] = (
        f"--xla_force_host_platform_device_count={LOCAL_DEVICES}")
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(
        coordinator_address=f"localhost:{PORT}",
        num_processes=NPROC, process_id=process_id)

    import numpy as np
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from mono_lidar_depth_tpu import PinholeCamera
    from mono_lidar_depth_tpu.dist.mesh import FRAME_AXIS, LANDMARK_AXIS
    from mono_lidar_depth_tpu.dist.sharded import distributed_ba
    from mono_lidar_depth_tpu.vo.ba import BAProblem, run_ba

    n_global = NPROC * LOCAL_DEVICES
    devices = np.asarray(jax.devices()).reshape(1, n_global)
    mesh = Mesh(devices, axis_names=(FRAME_AXIS, LANDMARK_AXIS))

    cam = PinholeCamera(640, 480, 500.0, 320.0, 240.0)
    rng = np.random.default_rng(0)  # identical data in every process
    K, L = 4, 64 * n_global
    X = np.stack([rng.uniform(-10, 10, L), rng.uniform(-4, 4, L),
                  rng.uniform(8, 40, L)], 1).astype(np.float32)
    Rs = np.tile(np.eye(3, dtype=np.float32), (K, 1, 1))
    ts = np.stack([np.array([0.5 * k, 0, 0.2 * k], np.float32)
                   for k in range(K)])
    obs, masks, dpri = [], [], []
    for k in range(K):
        p = X @ Rs[k].T + ts[k]
        uv = np.stack([500.0 * p[:, 0] / p[:, 2] + 320.0,
                       500.0 * p[:, 1] / p[:, 2] + 240.0], 1)
        uv += rng.normal(size=uv.shape).astype(np.float32) * 0.5
        obs.append(uv.astype(np.float32))
        masks.append(p[:, 2] > 1)
        dpri.append(p[:, 2].astype(np.float32))
    X0 = X + rng.normal(size=X.shape).astype(np.float32) * 0.2
    host_problem = BAProblem(
        R=jnp.asarray(Rs), t=jnp.asarray(ts), landmarks=jnp.asarray(X0),
        obs_uv=jnp.asarray(np.stack(obs)),
        obs_mask=jnp.asarray(np.stack(masks)),
        depth_prior=jnp.asarray(np.stack(dpri)),
        depth_mask=jnp.asarray(np.stack(masks)),
        fixed=jnp.asarray(np.arange(K) == 0),
        lm_valid=jnp.ones(L, bool))

    # Place the problem on the GLOBAL mesh (landmark leaves sharded
    # across both processes; pose leaves replicated).
    lm = NamedSharding(mesh, P(LANDMARK_AXIS))
    lm2 = NamedSharding(mesh, P(None, LANDMARK_AXIS))
    rep = NamedSharding(mesh, P())

    def put(x, sh):
        return jax.make_array_from_callback(
            x.shape, sh, lambda idx: np.asarray(x)[idx])

    problem = BAProblem(
        R=put(host_problem.R, rep), t=put(host_problem.t, rep),
        landmarks=put(host_problem.landmarks, lm),
        obs_uv=put(host_problem.obs_uv, lm2),
        obs_mask=put(host_problem.obs_mask, lm2),
        depth_prior=put(host_problem.depth_prior, lm2),
        depth_mask=put(host_problem.depth_mask, lm2),
        fixed=put(host_problem.fixed, rep),
        lm_valid=put(host_problem.lm_valid, lm))

    solver = distributed_ba(cam, mesh, iters=6)
    res = solver(problem)
    final_cost = float(res.final_cost)

    # single-process reference (local arrays only)
    ref = run_ba(cam, host_problem, iters=6)
    ref_cost = float(ref.initial_cost), float(ref.final_cost)

    if process_id == 0:
        ok = abs(final_cost - ref_cost[1]) <= 1e-3 * max(1.0, ref_cost[1])
        print(json.dumps({
            "multihost_processes": NPROC,
            "global_devices": n_global,
            "distributed_final_cost": round(final_cost, 4),
            "single_process_final_cost": round(ref_cost[1], 4),
            "match": bool(ok)}), flush=True)
    jax.distributed.shutdown()


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--worker", type=int, default=None)
    args = ap.parse_args()
    if args.worker is not None:
        worker(args.worker)
        return
    procs = []
    env = dict(os.environ)
    for pid in range(NPROC):
        procs.append(subprocess.Popen(
            [sys.executable, __file__, "--worker", str(pid)],
            env=env, stdout=None if pid == 0 else subprocess.DEVNULL))
    codes = [p.wait(timeout=600) for p in procs]
    if any(codes):
        raise SystemExit(f"worker exit codes: {codes}")


if __name__ == "__main__":
    main()
