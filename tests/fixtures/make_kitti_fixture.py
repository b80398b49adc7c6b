#!/usr/bin/env python
"""Generate tests/fixtures/kitti_mini — a 2-frame KITTI-odometry-layout
fixture in the REAL dataset's file formats.

The synthetic dataset generator (io/synthetic_dataset.py) writes a
simplified calib (P0-P3 all identical, Tr an exact axis permutation,
times.txt in decimal).  Real KITTI odometry differs in exactly the ways
that break naive parsers, and this fixture pins each one:

  * calib.txt: P1 carries the stereo baseline term P1[0,3] = -fx*b;
    P2/P3 (color pair) additionally carry small y/z terms; every value
    is %.12e with the dataset's `key: v v v ...` line format.
  * Tr (velodyne -> cam0) is NOT an axis permutation: the real mount has
    ~0.5 deg rotation offsets and a centimeter-scale translation
    (cf. the published seq 00-10 calibrations).
  * times.txt / poses/<seq>.txt are in scientific notation (%.6e), one
    12-value row-major 3x4 pose per line.
  * velodyne/*.bin are float32 (x, y, z, intensity) quadruples covering
    the FULL 360 deg azimuth sweep in scan order — most points are
    behind or beside the camera, exercising visibility culling exactly
    like a real HDL-64 scan does (the reference ingests the full cloud
    too: Transform_Cloud_LidarToCamera, DepthEstimator.cpp:156-217).
  * image_0/*.png are 1226x370 grayscale (the seq 04+ size).

Scene: textured ground plane + frontal wall + two box obstacles,
rendered consistently into both the scans and the images from a
vehicle translating 0.8 m/frame along +x (velodyne convention: x
forward, y left, z up).  Deterministic — regenerating the fixture gives
identical scans and pixels.  (The committed PNGs were written with
adaptive row filters, which the image-decode test relies on.)

Usage: python tests/fixtures/make_kitti_fixture.py [outdir]
"""

import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

SEQ = "04"
FRAMES = 2
STEP = 0.8  # m per frame along +x (velodyne frame)

# Camera intrinsics: the real seq 04-10 grayscale-left values.
FX = 707.0912
CX = 601.8873
CY = 183.1104
W, H = 1226, 370
BASELINE = 0.5371  # m, grayscale stereo baseline

# Scene (frame-0 velodyne coords; z up, sensor at z=0, ground below)
GROUND_Z = -1.73
WALL_X = 18.0
BOXES = [  # (cx, cy, half_x, half_y, top_z)
    (9.0, -2.5, 0.6, 0.6, -0.2),
    (13.0, 3.0, 0.8, 0.8, 0.4),
]


def lidar_to_cam0() -> np.ndarray:
    """[3,4] Tr: velodyne -> cam0 with realistic non-ideal rotation."""
    # ideal mount: cam x = -velo y, cam y = -velo z, cam z = velo x
    P = np.array([[0.0, -1.0, 0.0],
                  [0.0, 0.0, -1.0],
                  [1.0, 0.0, 0.0]])
    # small mount misalignment (~0.4 deg about each axis)
    ax, ay, az = 0.007, -0.005, 0.004

    def rot(axis, a):
        c, s = np.cos(a), np.sin(a)
        i, j = [(1, 2), (0, 2), (0, 1)][axis]
        R = np.eye(3)
        R[i, i] = R[j, j] = c
        R[i, j], R[j, i] = -s, s
        return R

    R = rot(0, ax) @ rot(1, ay) @ rot(2, az) @ P
    t = np.array([-0.012, -0.054, -0.292])  # cm-scale, real-world-like
    return np.concatenate([R, t[:, None]], axis=1)


def _texture(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Procedural trackable texture in [0, 1] from two world coords."""
    return (0.5
            + 0.18 * np.sin(2.1 * a) * np.cos(1.7 * b)
            + 0.12 * np.sin(5.3 * a + 1.0) * np.sin(4.1 * b + 2.0)
            + 0.08 * np.sign(np.sin(0.9 * a) * np.sin(1.1 * b)))


def _ray_hits(origins: np.ndarray, dirs: np.ndarray):
    """Nearest scene hit per ray -> (t, albedo); t=inf on miss.
    origins/dirs: [N, 3] in world (frame-0 velodyne) coords."""
    n = len(dirs)
    best_t = np.full(n, np.inf)
    albedo = np.zeros(n)
    # inf-t rays produce NaN texture coords that the masks discard —
    # silence the spurious warnings
    err = np.errstate(invalid="ignore")
    err.__enter__()

    def consider(t, mask, alb):
        m = mask & (t > 0.1) & (t < best_t)
        best_t[m] = t[m]
        albedo[m] = alb[m] if isinstance(alb, np.ndarray) else alb

    # ground z = GROUND_Z
    dz = dirs[:, 2]
    t = np.where(np.abs(dz) > 1e-9,
                 (GROUND_Z - origins[:, 2]) / np.where(
                     np.abs(dz) > 1e-9, dz, 1.0), np.inf)
    p = origins + t[:, None] * dirs
    consider(t, np.isfinite(t), _texture(p[:, 0], p[:, 1]) * 0.8)
    # wall x = WALL_X (finite extent)
    dx = dirs[:, 0]
    t = np.where(np.abs(dx) > 1e-9,
                 (WALL_X - origins[:, 0]) / np.where(
                     np.abs(dx) > 1e-9, dx, 1.0), np.inf)
    p = origins + t[:, None] * dirs
    hit = (np.isfinite(t) & (np.abs(p[:, 1]) < 14.0)
           & (p[:, 2] > GROUND_Z) & (p[:, 2] < 4.0))
    consider(t, hit, _texture(p[:, 1], p[:, 2]))
    # boxes: front face (x = cx - hx) + top face (z = top)
    for (bx, by, hx, hy, top) in BOXES:
        t = np.where(np.abs(dx) > 1e-9,
                     (bx - hx - origins[:, 0]) / np.where(
                         np.abs(dx) > 1e-9, dx, 1.0), np.inf)
        p = origins + t[:, None] * dirs
        hit = (np.isfinite(t) & (np.abs(p[:, 1] - by) < hy)
               & (p[:, 2] > GROUND_Z) & (p[:, 2] < top))
        consider(t, hit, _texture(p[:, 1] * 3.0, p[:, 2] * 3.0))
    err.__exit__(None, None, None)
    return best_t, albedo


def make_scan(frame: int, rows: int = 64, cols: int = 2000) -> np.ndarray:
    """[N, 4] float32 (x, y, z, intensity) in the frame's velodyne
    coords, full 360 deg azimuth, scan-ordered (row-major, azimuth
    decreasing like a clockwise-spinning HDL)."""
    origin = np.array([STEP * frame, 0.0, 0.0])
    elev = np.radians(np.linspace(2.0, -24.8, rows))  # HDL-64-like span
    azim = np.linspace(np.pi, -np.pi, cols, endpoint=False)
    el, az = np.meshgrid(elev, azim, indexing="ij")
    dirs = np.stack([np.cos(el) * np.cos(az),
                     np.cos(el) * np.sin(az),
                     np.sin(el)], axis=-1).reshape(-1, 3)
    origins = np.broadcast_to(origin, dirs.shape)
    t, alb = _ray_hits(origins, dirs)
    hit = np.isfinite(t) & (t < 80.0)
    pts_world = origins[hit] + t[hit, None] * dirs[hit]
    pts = pts_world - origin  # into this frame's sensor coords
    inten = np.clip(alb[hit], 0.0, 1.0)
    return np.concatenate([pts, inten[:, None]], axis=1).astype("<f4")


def make_image(frame: int) -> np.ndarray:
    """[H, W] uint8 grayscale rendered through cam0."""
    Tr = lidar_to_cam0()
    R_cl, t_cl = Tr[:, :3], Tr[:, 3]
    # cam->velo (one frame's own coords), then to world by +origin
    R_lc = R_cl.T
    t_lc = -R_cl.T @ t_cl
    origin = np.array([STEP * frame, 0.0, 0.0])
    u, v = np.meshgrid(np.arange(W), np.arange(H))
    rays_cam = np.stack([(u.ravel() - CX) / FX,
                         (v.ravel() - CY) / FX,
                         np.ones(W * H)], axis=-1)
    dirs = rays_cam @ R_lc.T
    origins = np.broadcast_to(origin + t_lc, dirs.shape)
    t, alb = _ray_hits(origins, dirs)
    sky = ~np.isfinite(t)
    alb[sky] = 0.92  # bright sky
    img = np.clip(alb.reshape(H, W) * 255.0, 0, 255).astype(np.uint8)
    return img


def main(outdir: str) -> None:
    root = Path(outdir)
    seq_dir = root / "sequences" / SEQ
    (seq_dir / "velodyne").mkdir(parents=True, exist_ok=True)
    (seq_dir / "image_0").mkdir(parents=True, exist_ok=True)
    (root / "poses").mkdir(parents=True, exist_ok=True)

    # ---- calib.txt (authentic line formats) -------------------------
    def P(fx, cx, cy, tx, ty=0.0, tz=0.0):
        m = np.zeros((3, 4))
        m[0, 0] = m[1, 1] = fx
        m[0, 2], m[1, 2], m[2, 2] = cx, cy, 1.0
        m[0, 3], m[1, 3], m[2, 3] = tx, ty, tz
        return m

    P0 = P(FX, CX, CY, 0.0)
    P1 = P(FX, CX, CY, -FX * BASELINE)         # grayscale right
    P2 = P(FX, CX, CY, 4.538225e+01, -1.130887e-01, 3.779761e-03)
    P3 = P(FX, CX, CY, -3.372877e+02, 2.369057e+00, 4.915215e-03)
    Tr = lidar_to_cam0()
    with open(seq_dir / "calib.txt", "w") as fh:
        for name, m in (("P0", P0), ("P1", P1), ("P2", P2), ("P3", P3),
                        ("Tr", Tr)):
            fh.write(f"{name}: "
                     + " ".join(f"{x:.12e}" for x in m.ravel()) + "\n")

    # ---- times.txt (scientific notation like the real dataset) ------
    with open(seq_dir / "times.txt", "w") as fh:
        for k in range(FRAMES):
            fh.write(f"{k * 0.103858:.6e}\n")

    # ---- ground-truth poses (cam0, world <- cam, 12 values %e) ------
    R_cl, t_cl = Tr[:, :3], Tr[:, 3]
    with open(root / "poses" / f"{SEQ}.txt", "w") as fh:
        for k in range(FRAMES):
            # T_w_velo = [I | (STEP*k,0,0)];  T_w_cam = T_w_velo @ Tr^-1
            Rwc = R_cl.T
            twc = -R_cl.T @ t_cl + np.array([STEP * k, 0.0, 0.0])
            m = np.concatenate([Rwc, twc[:, None]], axis=1)
            fh.write(" ".join(f"{x:.6e}" for x in m.ravel()) + "\n")

    # ---- scans + images ---------------------------------------------
    from mono_lidar_depth_tpu.io.png import write_png

    for k in range(FRAMES):
        scan = make_scan(k)
        scan.tofile(seq_dir / "velodyne" / f"{k:06d}.bin")
        img = make_image(k)
        write_png(seq_dir / "image_0" / f"{k:06d}.png", img)
        print(f"frame {k}: {len(scan)} points, image {img.shape}")
    print(f"fixture written to {root}")


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1
         else str(Path(__file__).parent / "kitti_mini"))
