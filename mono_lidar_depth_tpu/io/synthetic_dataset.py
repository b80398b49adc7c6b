"""Synthetic KITTI-odometry-format dataset generator.

Writes a fully KITTI-shaped sequence (velodyne .bin scans in azimuth
scan order, grayscale image_0 PNGs, calib.txt, times.txt, poses) from
an ANALYTIC scene — ground plane + wall faces ray-cast exactly, with a
world-anchored procedural texture — so that:

  * camera images are perfectly 3D-consistent across frames (KLT
    tracks correspond to real surface points);
  * lidar scans are azimuth-ordered (the scan-row segmenter sees real
    Velodyne-like row structure);
  * ground-truth poses are exact.

This makes the full evaluation stack (io → tracker → depth association
→ VO → metrics) executable end-to-end in an image with no dataset
(zero egress), through the same code paths real KITTI data takes.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from .png import write_png

# Scene layout (world frame == frame-0 camera frame: x right, y down,
# z forward).  Camera height 1.5 m above ground.
GROUND_Y = 1.5
WALL_X = 9.0
FRONT_Z_OFFSET = 90.0  # front wall placed this far past the trajectory end
WALL_Y_TOP = -4.5  # walls span y in [WALL_Y_TOP, GROUND_Y]


def _hash2(ix: np.ndarray, iy: np.ndarray) -> np.ndarray:
    """Deterministic pseudo-random value in [0,1) per integer cell."""
    h = (ix.astype(np.int64) * 374761393 + iy.astype(np.int64) * 668265263)
    h = (h ^ (h >> 13)) * 1274126177
    h = h ^ (h >> 16)
    return ((h & 0xFFFF).astype(np.float64)) / 65536.0


def _texture(u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """World-anchored 2-octave blocky value texture in [0,1]."""
    t = 0.55 * _hash2(np.floor(u * 2.0), np.floor(v * 2.0))
    t += 0.3 * _hash2(np.floor(u * 0.5) + 1000, np.floor(v * 0.5))
    t += 0.15 * _hash2(np.floor(u * 8.0) + 7000, np.floor(v * 8.0))
    return t


# Semantic label ids (matching the reference's road-class convention:
# ground-plane labels are {6, 7, 8, 9}, RansacPlane.h:217 /
# tracklet_depth_module.cpp:280).
LABEL_ROAD = 7
LABEL_WALL = 11  # "building" — not a ground class
LABEL_SKY = 23


def _cast(origins: np.ndarray, dirs: np.ndarray, z_end: float,
          road_texture: float = 1.0
          ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Ray-cast the analytic scene.

    Args: origins [R, 3], dirs [R, 3] (world frame, not necessarily unit).
    Returns (t_hit [R] — inf where no hit, shade [R] in [0,1],
             label [R] uint8 semantic class — LABEL_SKY where no hit).
    """
    R = origins.shape[0]
    best_t = np.full(R, np.inf)
    shade = np.zeros(R)
    label = np.full(R, LABEL_SKY, dtype=np.uint8)

    def consider(t, cond, u, v, salt, lab):
        nonlocal best_t, shade, label
        ok = cond & (t > 0.25) & (t < best_t)
        if ok.any():
            best_t = np.where(ok, t, best_t)
            s = _texture(u + salt, v)
            if lab == LABEL_ROAD and road_texture < 1.0:
                s = 0.5 + road_texture * (s - 0.5)
            shade = np.where(ok, s, shade)
            label = np.where(ok, np.uint8(lab), label)

    o, d = origins, dirs
    front_z = z_end + FRONT_Z_OFFSET
    with np.errstate(divide="ignore", invalid="ignore"):
        # ground: y = GROUND_Y
        t = (GROUND_Y - o[:, 1]) / d[:, 1]
        p = o + t[:, None] * d
        consider(t, (d[:, 1] != 0) & (np.abs(p[:, 0]) <= WALL_X)
                 & (p[:, 2] < front_z), p[:, 0], p[:, 2], 0.0, LABEL_ROAD)
        # side walls: x = ±WALL_X
        for sx, salt in ((-WALL_X, 300.0), (WALL_X, 600.0)):
            t = (sx - o[:, 0]) / d[:, 0]
            p = o + t[:, None] * d
            consider(t, (d[:, 0] != 0) & (p[:, 1] >= WALL_Y_TOP)
                     & (p[:, 1] <= GROUND_Y) & (p[:, 2] < front_z),
                     p[:, 2], p[:, 1], salt, LABEL_WALL)
        # front wall: z = front_z; back wall: z = -20 (for loop
        # trajectories looking backward down the corridor)
        for fz, salt in ((front_z, 900.0), (-20.0, 1200.0)):
            t = (fz - o[:, 2]) / d[:, 2]
            p = o + t[:, None] * d
            consider(t, (d[:, 2] != 0) & (np.abs(p[:, 0]) <= WALL_X)
                     & (p[:, 1] >= WALL_Y_TOP) & (p[:, 1] <= GROUND_Y),
                     p[:, 0], p[:, 1], salt, LABEL_WALL)
    return best_t, shade, label


@dataclass
class SyntheticSpec:
    frames: int = 10
    image_width: int = 1226
    image_height: int = 370
    focal: float = 707.0
    step: float = 0.8  # metres per frame
    yaw_rate: float = 0.004  # rad per frame
    lidar_rows: int = 32
    lidar_cols: int = 900
    elev_min: float = np.radians(-18.0)
    elev_max: float = np.radians(3.0)
    azim_half: float = np.radians(42.0)
    # "loop" trajectory: drive forward, U-turn, drive back, U-turn —
    # ends revisiting the start with the same heading (closure-able).
    loop: bool = False
    # Multi-lap: build the loop for `lap_frames` and TILE it to
    # `frames` — the 4-segment cycle (straight, U-turn, straight,
    # U-turn) closes exactly, so the trajectory retraces the same
    # circuit every lap (a revisit per lap, bounded extent).  Without
    # this, the single-lap geometry SCALES with `frames`: at 2000+
    # frames the U-turn radius grows to ~90 m and the trajectory
    # leaves the corridor scene entirely (measured: VO ATE 155 m on a
    # 2048-frame single lap vs 2-3 m at the 220-frame scale).
    lap_frames: int | None = None
    # Road texture contrast in [0, 1].  1.0 = fully textured ground
    # (trackable everywhere — the DEFAULT scene, which plants features
    # on far oblique ground and drives the TriangleNotPlanar residual,
    # DESIGN.md success-rate reconciliation).  Small values render the
    # road near-uniform,like real asphalt: the tracker then avoids it and
    # the feature distribution matches the reference's real-KITTI runs.
    road_texture: float = 1.0


# KITTI-style cam←lidar: lidar x forward, y left, z up.
R_CL = np.array([[0, -1, 0], [0, 0, -1], [1, 0, 0]], dtype=np.float64)
T_CL = np.array([0.0, 0.08, 0.27], dtype=np.float64)


def generate_kitti_sequence(root: str, sequence: str = "99",
                            spec: SyntheticSpec = SyntheticSpec(),
                            seed: int = 0) -> None:
    """Write a synthetic KITTI-format sequence under `root`."""
    rng = np.random.default_rng(seed)
    seq_dir = Path(root) / "sequences" / sequence
    (seq_dir / "velodyne").mkdir(parents=True, exist_ok=True)
    (seq_dir / "image_0").mkdir(parents=True, exist_ok=True)
    (seq_dir / "semantic_0").mkdir(parents=True, exist_ok=True)
    (Path(root) / "poses").mkdir(parents=True, exist_ok=True)

    W, H, f = spec.image_width, spec.image_height, spec.focal
    cx, cy = W / 2.0, H / 2.0
    lap = spec.lap_frames or spec.frames
    z_end = lap * spec.step

    # trajectory: world←cam poses
    poses = []
    R_wc = np.eye(3)
    c = np.zeros(3)
    if spec.loop and spec.lap_frames is not None:
        # multi-lap circuit: the 4-segment cycle closes exactly, so
        # tiling retraces the same positions with the same heading
        # every `lap` frames.
        turn = max(10, lap // 4)
        straight = max(1, (lap - 2 * turn) // 2)
        cycle = ([0.0] * straight + [np.pi / turn] * turn
                 + [0.0] * straight + [np.pi / turn] * turn)
        reps = spec.frames // len(cycle) + 1
        yaw_plan = (cycle * reps)[:spec.frames]
    elif spec.loop:
        # out-and-back: straight, U-turn, straight back (offset one
        # lane), U-turn, then a straight TAIL retracing the first leg
        # with the same heading — same-viewpoint revisits for loop
        # closure.
        turn = max(10, spec.frames // 4)
        tail = max(6, spec.frames // 6)
        straight = max(1, (spec.frames - 2 * turn - tail) // 2)
        yaw_plan = ([0.0] * straight + [np.pi / turn] * turn
                    + [0.0] * straight + [np.pi / turn] * turn)
        yaw_plan += [0.0] * (spec.frames - len(yaw_plan))
    else:
        yaw_plan = [spec.yaw_rate] * spec.frames
    for k in range(spec.frames):
        poses.append((R_wc.copy(), c.copy()))
        yaw = yaw_plan[k]
        dR = np.array([[np.cos(yaw), 0, np.sin(yaw)], [0, 1, 0],
                       [-np.sin(yaw), 0, np.cos(yaw)]])
        R_wc = R_wc @ dR
        c = c + R_wc @ np.array([0.0, 0.0, spec.step])

    # pixel rays (camera frame), unit-free
    uu, vv = np.meshgrid(np.arange(W) + 0.5, np.arange(H) + 0.5)
    d_cam = np.stack([(uu.ravel() - cx) / f, (vv.ravel() - cy) / f,
                      np.ones(W * H)], axis=1)

    # lidar ray grid in lidar frame (x fwd, y left, z up), azimuth
    # sweeping left→right per row so image-x DECREASES within a row
    # (Velodyne convention the row segmenter expects).
    elev = np.linspace(spec.elev_max, spec.elev_min, spec.lidar_rows)
    azim = np.linspace(spec.azim_half, -spec.azim_half, spec.lidar_cols)
    E, A = np.meshgrid(elev, azim, indexing="ij")
    d_lid = np.stack([np.cos(E) * np.cos(A), np.cos(E) * np.sin(A),
                      np.sin(E)], axis=-1).reshape(-1, 3)

    times = []
    gt_lines = []
    for k, (R_wc_k, c_k) in enumerate(poses):
        # ---- image + ground-truth semantics ---------------------------
        d_world = d_cam @ R_wc_k.T
        o = np.broadcast_to(c_k, d_world.shape)
        t, shade, label = _cast(o, d_world, z_end,
                                spec.road_texture)
        img = np.where(np.isfinite(t), shade, 0.08)
        img = (np.clip(img, 0, 1) * 255).astype(np.uint8).reshape(H, W)
        write_png(seq_dir / "image_0" / f"{k:06d}.png", img)
        write_png(seq_dir / "semantic_0" / f"{k:06d}.png",
                  label.reshape(H, W))

        # ---- lidar scan ---------------------------------------------
        # lidar pose: world←lidar = world←cam ∘ cam←lidar
        R_wl = R_wc_k @ R_CL
        o_l = c_k + R_wc_k @ T_CL
        d_world_l = d_lid @ R_wl.T
        o2 = np.broadcast_to(o_l, d_world_l.shape)
        t_l, _, _ = _cast(o2, d_world_l, z_end, spec.road_texture)
        hit = np.isfinite(t_l) & (t_l < 120.0)
        with np.errstate(invalid="ignore"):  # inf * 0 on missed rays
            pts_l = d_lid * t_l[:, None]  # lidar-frame (rays are unit)
        noise = rng.normal(size=pts_l.shape) * 0.006
        pts_l = (pts_l + noise)[hit].astype(np.float32)
        intens = rng.uniform(0, 1, (len(pts_l), 1)).astype(np.float32)
        np.concatenate([pts_l, intens], axis=1).tofile(
            seq_dir / "velodyne" / f"{k:06d}.bin")

        times.append(k * 0.1)
        P = np.concatenate([R_wc_k, c_k[:, None]], axis=1)
        gt_lines.append(" ".join(f"{x:.9e}" for x in P.ravel()))

    np.savetxt(seq_dir / "times.txt", np.asarray(times), fmt="%.6f")
    with open(Path(root) / "poses" / f"{sequence}.txt", "w") as fh:
        fh.write("\n".join(gt_lines) + "\n")

    # calib.txt: P0..P3 + Tr (lidar→cam0)
    P0 = np.zeros((3, 4))
    P0[0, 0] = P0[1, 1] = f
    P0[0, 2] = cx
    P0[1, 2] = cy
    P0[2, 2] = 1.0
    Tr = np.concatenate([R_CL, T_CL[:, None]], axis=1)
    with open(seq_dir / "calib.txt", "w") as fh:
        for name in ("P0", "P1", "P2", "P3"):
            fh.write(f"{name}: " + " ".join(
                f"{x:.12e}" for x in P0.ravel()) + "\n")
        fh.write("Tr: " + " ".join(f"{x:.12e}" for x in Tr.ravel()) + "\n")
