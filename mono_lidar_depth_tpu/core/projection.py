"""Cloud transform, projection, and pixel-grid construction (per frame).

Batched redesign of the reference's frame-ingest path
(`Transform_Cloud_LidarToCamera`, DepthEstimator.cpp:156-217, and
`NeighborFinderPixel::InitializeLidarProjection`,
NeighborFinderPixel.cpp:29-58):

  * The reference compacts the cloud to the visible subset and keeps a
    cut→raw index map (`PointcloudData._pointIndex`).  Stream compaction
    is a scalar loop hostile to XLA; here everything stays a dense
    [P]-shaped array with a validity mask, and the pixel grid stores RAW
    point indices directly — no index indirection anywhere downstream.
  * The reference's grid collision rule is "first projected point wins"
    (scan-order dependent).  Default here is "nearest point (smallest
    camera-z) wins" — deterministic, order-independent, and physically
    the right occlusion rule; `grid_collision_rule="first"` reproduces
    the reference rule exactly (lowest raw index wins, which equals
    first-in-scan-order for a contiguously stored cloud).
  * Besides the index grid, the frame carries dense per-pixel ATTRIBUTE
    PLANES [2, H, W] describing the winning point.  Downstream neighbor
    search then reads each feature's rectangle as a contiguous
    dynamic-slice window instead of 2 chained random-access gathers
    (grid → index → point table) per cell — random gathers at
    N·K ≈ 430k offsets are the single most expensive op class on this
    chip (~9 ns/offset).

    Plane encoding (scatter cost is per-offset AND per-channel, so the
    channel count is kept minimal):
      planes[0] = z_enc: camera-frame z, sign-flipped when the point's
                  flag (ground-plane inlier) is set — winners always
                  have z > 0, so the sign bit is free storage.
      planes[1] = packed subpixel offsets: floor(fu·4096)·4096 +
                  floor(fv·4096) where (fu, fv) are the fractional
                  pixel coordinates — integers < 2^24, exact in f32.
    The winner's camera-frame x, y are reconstructed from the pinhole
    relation x = (u − cx)·z/f with u = cell_column + (qu + 0.5)/4096,
    which is how u was produced from x/z in the first place; the ±2^-13
    px quantization bounds the coordinate error by z/(f·2^13) — ~7 µm
    at 20 m, below the f32 roundoff of the reference's own math.

All rules are implemented with O(P) scatter ops — no atomics, no data
races by construction (cf. the reference's OpenMP criticals).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from .geometry import SE3, PinholeCamera

POINT_NOT_DEFINED = -1  # NeighborFinderPixel.h grid sentinel

# Packed nearest-wins scatter key layout: quantized depth in the high
# bits, raw index in the low 17 — usable while max_points <= 2^17.
# _ZQ_MAX is one LESS than the bitfield maximum so the largest possible
# key (zq = _ZQ_MAX, idx = 2^17 - 1) stays strictly below the int32
# 'empty' sentinel — otherwise a far point in the last cloud slot would
# collide with the sentinel and silently vanish from the grid.
_IDX_BITS = 17
_ZQ_MAX = (1 << (31 - _IDX_BITS)) - 2  # 16382
_ZQ_RANGE = 160.0  # metres covered by the quantized depth key

# Fast-path key layout: zq(13) | flag(1) | idx(17).  The depth that
# downstream consumes is DECODED FROM THE KEY (cell-center of a ~2 cm
# bin), so the winner gather and both attribute scatters disappear —
# one O(P)-offset stream total.  Tie order within a cell: smallest
# quantized depth, then flag=0 before flag=1, then lowest raw index.
_FAST_ZQ_MAX = (1 << 13) - 2  # 8190
_FAST_STEP = _ZQ_RANGE / (_FAST_ZQ_MAX + 1)  # 1.95 cm -> |dz| <= 0.98 cm


class FrameCloud(NamedTuple):
    """Per-frame point-cloud state (replaces `PointcloudData`,
    PointcloudData.h:14-68, without the visible-subset compaction)."""

    points_lidar: jnp.ndarray  # [P, 3] lidar-frame coordinates
    points_cam: jnp.ndarray  # [P, 3] camera-frame coordinates
    uv: jnp.ndarray  # [P, 2] image coordinates (undefined where ~visible)
    valid: jnp.ndarray  # [P]   input padding mask
    visible: jnp.ndarray  # [P] strictly inside the image && z > 0 && valid
    grid: jnp.ndarray  # [H, W] int32: raw point index per pixel or -1
    planes: jnp.ndarray  # [2, H, W] f32: winner z_enc + packed subpixel
    #                      uv (see module docstring); 0 where empty
    winner_flat: jnp.ndarray  # [P] int32: flat cell this point won, else H*W


def rasterize_point_channel(frame: FrameCloud,
                            values: jnp.ndarray) -> jnp.ndarray:
    """Scatter a per-point value onto the pixel grid ([H, W] f32).

    Each cell receives the value of its winning point (0 where empty).
    Used to push per-point annotations (e.g. the ground-plane inlier
    mask) into image space, so per-feature lookups become contiguous
    window slices instead of random gathers.
    """
    H, W = frame.grid.shape
    ncells = H * W
    img = jnp.zeros((ncells + 1,), jnp.float32)
    img = img.at[frame.winner_flat].add(values.astype(jnp.float32))
    return img[:ncells].reshape(H, W)


def build_frame_cloud(
    points_lidar: jnp.ndarray,
    valid: jnp.ndarray,
    lidar_to_cam: SE3,
    camera: PinholeCamera,
    grid_height: int,
    grid_width: int,
    collision_rule: str = "nearest",
    point_flags: jnp.ndarray | None = None,
    fast: bool = False,
) -> FrameCloud:
    """Transform, project, and rasterize one lidar cloud.

    Args:
      points_lidar: [P, 3] padded cloud, lidar frame.
      valid: [P] bool padding mask.
      lidar_to_cam: extrinsic transform.
      camera: pinhole intrinsics.
      grid_height/grid_width: static grid size (>= camera.height/width).
      collision_rule: "nearest" (default) or "first" (reference parity).
      point_flags: optional [P] bool per-point flag (the ground-plane
        inlier mask), carried in the sign bit of the z plane — free.
      fast: single-scatter rasterization — winner depth decoded from
        the scatter key (<= 1 cm quantization error) and winner u, v
        reconstructed at cell centers (+-0.5 px); the flag rides its
        own key bit.  See config.fast_rasterization.

    Visibility matches the reference's strict test
    (DepthEstimator.cpp:184-207): 0 < u < W and 0 < v < H; grid entries
    additionally require camera-z > 0 (NeighborFinderPixel.cpp:51-54).
    """
    points_cam = lidar_to_cam.apply(points_lidar)
    z = points_cam[..., 2]
    safe_z = jnp.where(z == 0, 1.0, z)
    u = camera.focal_length * points_cam[..., 0] / safe_z + camera.cx
    v = camera.focal_length * points_cam[..., 1] / safe_z + camera.cy
    uv = jnp.stack([u, v], axis=-1)

    strict_in = (
        (u > 0.0) & (u < float(camera.width))
        & (v > 0.0) & (v < float(camera.height))
        & (z != 0)
    )
    visible = strict_in & valid & (z > 0.0)

    P = points_lidar.shape[0]
    x_pix = jnp.clip(u.astype(jnp.int32), 0, grid_width - 1)
    y_pix = jnp.clip(v.astype(jnp.int32), 0, grid_height - 1)
    flat = y_pix * grid_width + x_pix
    # Route invisible points to a trash cell one past the end.
    ncells = grid_height * grid_width
    flat = jnp.where(visible, flat, ncells)

    idx = jnp.arange(P, dtype=jnp.int32)
    big = jnp.int32(2**31 - 1)

    if fast:
        if collision_rule != "nearest":
            raise ValueError("fast rasterization implements 'nearest' only")
        if P > (1 << _IDX_BITS):
            raise ValueError(
                f"fast rasterization supports up to {1 << _IDX_BITS} points")
        zq = jnp.clip((z * (1.0 / _FAST_STEP)).astype(jnp.int32),
                      0, _FAST_ZQ_MAX)
        flag_bit = (point_flags.astype(jnp.int32)
                    if point_flags is not None else jnp.int32(0))
        key = (zq << (_IDX_BITS + 1)) | (flag_bit << _IDX_BITS) | idx
        grid_flat = jnp.full((ncells + 1,), big, dtype=jnp.int32)
        grid_flat = grid_flat.at[flat].min(jnp.where(visible, key, big))
        occupied = grid_flat[:ncells] != big
        raw = grid_flat[:ncells]
        grid = jnp.where(occupied, raw & ((1 << _IDX_BITS) - 1),
                         POINT_NOT_DEFINED).reshape(grid_height, grid_width)
        # Decode the winner's depth + flag straight from the key —
        # elementwise over cells, zero extra offset streams.
        z_dec = ((raw >> (_IDX_BITS + 1)).astype(jnp.float32) + 0.5) \
            * _FAST_STEP
        f_dec = ((raw >> _IDX_BITS) & 1).astype(jnp.bool_)
        z_enc_plane = jnp.where(occupied,
                                jnp.where(f_dec, -z_dec, z_dec), 0.0)
        # Winner subpixel position: cell center (qu = qv = 2048).
        center = jnp.float32(2048.0 * 4096.0 + 2048.0)
        uv_plane = jnp.where(occupied, center, 0.0)
        planes = jnp.stack([z_enc_plane, uv_plane]).reshape(
            2, grid_height, grid_width)
        # winner_flat via one gather — consumed only by
        # rasterize_point_channel; XLA dead-code-eliminates it from
        # programs that never read it (the depth pipeline doesn't).
        won = visible & (jnp.take(grid_flat, flat, axis=0) == key)
        winner_flat = jnp.where(won, flat, ncells).astype(jnp.int32)
        return FrameCloud(
            points_lidar=points_lidar, points_cam=points_cam, uv=uv,
            valid=valid, visible=visible, grid=grid, planes=planes,
            winner_flat=winner_flat)

    if collision_rule == "first":
        # Lowest raw index per pixel == first point in cloud scan order,
        # reproducing NeighborFinderPixel.cpp:51-54 for contiguous clouds.
        grid_flat = jnp.full((ncells + 1,), big, dtype=jnp.int32)
        grid_flat = grid_flat.at[flat].min(jnp.where(visible, idx, big))
        grid_flat = jnp.where(grid_flat == big, POINT_NOT_DEFINED, grid_flat)
    elif P <= (1 << _IDX_BITS):
        # Nearest-wins in ONE scatter-min: pack (quantized z, raw index)
        # into an int32 key — depth in the high bits (5 mm steps up to
        # _ZQ_RANGE m; beyond that the global depth gate disposes of the
        # point anyway), index in the low 17 bits.  Ties in quantized
        # depth resolve to the lowest index — deterministic.
        zq = jnp.clip((z * (float(_ZQ_MAX) / _ZQ_RANGE)).astype(jnp.int32),
                      0, _ZQ_MAX)
        key = (zq << _IDX_BITS) | idx
        grid_flat = jnp.full((ncells + 1,), big, dtype=jnp.int32)
        grid_flat = grid_flat.at[flat].min(jnp.where(visible, key, big))
        grid_flat = jnp.where(grid_flat == big, POINT_NOT_DEFINED,
                              grid_flat & ((1 << _IDX_BITS) - 1))
    else:
        # Nearest-wins fallback for huge clouds: two scatter-min passes —
        # depth keys, then the lowest index among the depth winners.
        zkey = jnp.where(visible, z.astype(jnp.float32), jnp.inf)
        grid_z = jnp.full((ncells + 1,), jnp.inf, dtype=jnp.float32)
        grid_z = grid_z.at[flat].min(zkey)
        is_winner = visible & (zkey == grid_z[flat])
        grid_flat = jnp.full((ncells + 1,), big, dtype=jnp.int32)
        grid_flat = grid_flat.at[flat].min(jnp.where(is_winner, idx, big))
        grid_flat = jnp.where(grid_flat == big, POINT_NOT_DEFINED, grid_flat)

    grid = grid_flat[:ncells].reshape(grid_height, grid_width)

    # Winner mask: a point won its cell iff its raw index is stored
    # there (raw indices are unique, so this is exact for every
    # collision rule).  One P-offset gather + one scatter per channel —
    # O(P), versus O(N*K) random gathers downstream without the planes.
    won = visible & (jnp.take(grid_flat, flat, axis=0) == idx)
    winner_flat = jnp.where(won, flat, ncells).astype(jnp.int32)

    # Per-channel scatters into [H*W] planes.  (A single [H*W, C]
    # row-scatter would halve the offset count, but a C-wide minor dim
    # tile-pads to 128 lanes — 16x the memory traffic; measured slower.)
    def _plane(vals: jnp.ndarray) -> jnp.ndarray:
        img = jnp.zeros((ncells + 1,), jnp.float32)
        img = img.at[winner_flat].add(vals.astype(jnp.float32))
        return img[:ncells]

    if point_flags is None:
        z_enc = z
    else:
        z_enc = jnp.where(point_flags, -z, z)
    qu = jnp.clip((u - x_pix) * 4096.0, 0.0, 4095.0).astype(jnp.int32)
    qv = jnp.clip((v - y_pix) * 4096.0, 0.0, 4095.0).astype(jnp.int32)
    packed_uv = (qu * 4096 + qv).astype(jnp.float32)
    planes = jnp.stack([_plane(z_enc), _plane(packed_uv)]).reshape(
        2, grid_height, grid_width)

    return FrameCloud(
        points_lidar=points_lidar,
        points_cam=points_cam,
        uv=uv,
        valid=valid,
        visible=visible,
        grid=grid,
        planes=planes,
        winner_flat=winner_flat,
    )
