"""Rectangular-window neighbor gather around feature points.

Batched replacement for `NeighborFinderPixel::getNeighbors`
(NeighborFinderPixel.cpp:60-95).  The reference scans a dynamic w×h
pixel rectangle per feature and push_backs hits; here every feature
reads a STATIC [Ky, Kx] window (upper bound of the dynamic rectangle)
as ONE contiguous dynamic-slice of the frame's rasterized index grid
and attribute planes, with a per-cell validity mask replicating the
exact dynamic bounds:

    left  = max(u - hx, 0)        right  = min(u + hx, W-1)
    top   = max(v - hy, 0)        bottom = min(v + hy, H-1)
    cells = int(top)..int(bottom) × int(left)..int(right)   (inclusive)

Window slices are clamped to stay inside the image (start shifts up to
Ky-1 / Kx-1 cells near the bottom/right borders); the validity mask is
computed against the TRUE rectangle, so only which *masked-off* slots
pad the window changes — the valid cells and their row-major relative
order (the reference's scan order, which matters for argmax
tie-breaking parity in the max-spanning-triangle stage) are identical.

Why slices instead of gathers: a per-cell gather formulation costs
N·K ≈ 430k random offsets through two chained index hops
(grid → raw index → point table).  One dynamic-slice per feature over
the winner-attribute planes (projection.py) reads the same data as ~N
contiguous row runs and removes the second hop entirely.

Neighbor camera-frame coordinates are DECODED from the planes: z (and
the ground-inlier flag) from the sign-encoded z plane, x and y from the
pinhole relation over the cell coordinate + stored subpixel offsets
(see projection.py docstring for the exactness argument).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from .geometry import PinholeCamera
from .projection import POINT_NOT_DEFINED, FrameCloud


def slice_windows(stack: jnp.ndarray, sy: jnp.ndarray, sx: jnp.ndarray,
                  Ky: int, Kx: int) -> jnp.ndarray:
    """[N, C, Ky, Kx] windows of `stack` [C, H, W] at per-feature
    starts (sy, sx), which must be pre-clamped to [0, H-Ky] x [0, W-Kx].
    XLA lowers the vmapped slice to one gather over the whole batch."""
    C = stack.shape[0]

    def one(sy_i, sx_i):
        return jax.lax.dynamic_slice(stack, (0, sy_i, sx_i), (C, Ky, Kx))

    return jax.vmap(one)(sy, sx)


class NeighborSet(NamedTuple):
    indices: Optional[jnp.ndarray]  # [N, K] int32 raw point indices
    #                                 (-1 where ~mask); None unless
    #                                 requested (with_indices)
    mask: jnp.ndarray  # [N, K] bool: cell in rect && holds a point
    points_cam: jnp.ndarray  # [N, K, 3] camera-frame points (0 where ~mask)
    count: jnp.ndarray  # [N] int32 number of neighbors
    z: jnp.ndarray  # [N, K] camera-frame depth (0 where ~mask)
    flags: Optional[jnp.ndarray] = None  # [N, K] bool point flags (inlier)


def gather_neighbors(
    frame: FrameCloud,
    camera: PinholeCamera,
    features_uv: jnp.ndarray,
    half_size_x: float,
    half_size_y: float,
    window: tuple[int, int],
    with_indices: bool = True,
) -> NeighborSet:
    """Slice grid windows for all features at once.

    Args:
      frame: rasterized cloud.
      camera: pinhole intrinsics (for coordinate reconstruction).
      features_uv: [N, 2] feature pixel coordinates.
      half_size_x/y: rectangle half extents in pixels (already scaled;
        the reference computes w*0.5*scale, NeighborFinderPixel.cpp:67-68).
      window: static (Ky, Kx) cell counts (config.window_cells upper bound).
      with_indices: include the raw-point-index channel in the slice.
        Only the region-growing path consumes indices; skipping the
        third channel cuts the window-kernel work by ~1/3 (occupancy is
        derived from the z plane instead: winners always have z > 0, so
        z_enc == 0 ⇔ empty cell).
    """
    H, W = frame.grid.shape
    if with_indices:
        stack = jnp.concatenate(
            [frame.planes, frame.grid.astype(jnp.float32)[None]], axis=0)
    else:
        stack = frame.planes
    return _gather_from_stack(stack, camera, features_uv, half_size_x,
                              half_size_y, window, with_indices, H, W)


def _gather_from_stack(
    stack: jnp.ndarray,
    camera: PinholeCamera,
    features_uv: jnp.ndarray,
    half_size_x: float,
    half_size_y: float,
    window: tuple[int, int],
    with_indices: bool,
    H: int,
    W: int,
) -> NeighborSet:
    """Window slice + decode against a prebuilt plane stack."""
    Ky, Kx = window
    if Ky > H or Kx > W:
        raise ValueError(f"window {window} exceeds grid {H}x{W}")
    u = features_uv[..., 0]
    v = features_uv[..., 1]

    left = jnp.maximum(u - half_size_x, 0.0)
    right = jnp.minimum(u + half_size_x, float(W - 1))
    top = jnp.maximum(v - half_size_y, 0.0)
    bottom = jnp.minimum(v + half_size_y, float(H - 1))

    x0 = left.astype(jnp.int32)  # all values >= 0: trunc == floor
    x1 = right.astype(jnp.int32)
    y0 = top.astype(jnp.int32)
    y1 = bottom.astype(jnp.int32)

    # Clamped slice starts: the [Ky, Kx] window always fits the image
    # and always covers [y0..y1] x [x0..x1] (window ≥ span by config).
    sy = jnp.minimum(y0, H - Ky)
    sx = jnp.minimum(x0, W - Kx)

    win = slice_windows(stack, sy, sx, Ky, Kx)  # [N, C, Ky, Kx]

    dy = jnp.arange(Ky, dtype=jnp.int32)
    dx = jnp.arange(Kx, dtype=jnp.int32)
    cy = sy[..., None] + dy  # [N, Ky] actual cell rows
    cx = sx[..., None] + dx  # [N, Kx]
    in_y = (cy >= y0[..., None]) & (cy <= y1[..., None])
    in_x = (cx >= x0[..., None]) & (cx <= x1[..., None])
    cell_ok = in_y[..., :, None] & in_x[..., None, :]  # [N, Ky, Kx]

    N = features_uv.shape[0]
    K = Ky * Kx
    winf = win.reshape(N, -1, K)
    z_enc = winf[:, 0]
    if with_indices:
        idx = winf[:, 2].astype(jnp.int32)
        mask = cell_ok.reshape(N, K) & (idx != POINT_NOT_DEFINED)
    else:
        idx = None
        # winners always have camera-z > 0, so z_enc == 0 ⇔ empty cell
        mask = cell_ok.reshape(N, K) & (z_enc != 0.0)

    flags = mask & (z_enc < 0)
    zs = jnp.where(mask, jnp.abs(z_enc), 0.0)

    # Decode subpixel offsets and reconstruct x, y (projection.py).
    packed = winf[:, 1]
    qu = jnp.floor(packed * (1.0 / 4096.0))
    qv = packed - qu * 4096.0
    cell_col = (cx[..., None, :] + jnp.zeros((Ky, 1), jnp.int32)
                ).reshape(N, K).astype(jnp.float32)
    cell_row = (cy[..., :, None] + jnp.zeros((1, Kx), jnp.int32)
                ).reshape(N, K).astype(jnp.float32)
    uu = cell_col + (qu + 0.5) * (1.0 / 4096.0)
    vv = cell_row + (qv + 0.5) * (1.0 / 4096.0)
    inv_f = 1.0 / camera.focal_length
    xs = (uu - camera.cx) * inv_f * zs
    ys = (vv - camera.cy) * inv_f * zs
    pts = jnp.where(mask[..., None], jnp.stack([xs, ys, zs], axis=-1), 0.0)

    return NeighborSet(
        indices=(jnp.where(mask, idx, POINT_NOT_DEFINED)
                 if with_indices else None),
        mask=mask,
        points_cam=pts,
        count=jnp.sum(mask, axis=-1).astype(jnp.int32),
        z=zs,
        flags=flags,
    )


def gather_neighbors_two_scales(
    frame: FrameCloud,
    camera: PinholeCamera,
    features_uv: jnp.ndarray,
    half_x: float,
    half_y: float,
    scale_x: float,
    scale_y: float,
    window_small: tuple[int, int],
    window_large: tuple[int, int],
    with_indices: bool = True,
) -> tuple[NeighborSet, NeighborSet]:
    """Both search scales (primary + road retry, DepthEstimator.cpp:585).

    Two independent slice passes.  (Extracting the small window from the
    large one with take_along_axis was measured SLOWER than a second
    slice pass — the axis-1 shuffles lower to [N, K] gathers.)  Cell
    order of both outputs is row-major, preserving scan-order parity.
    """
    small = gather_neighbors(frame, camera, features_uv, half_x, half_y,
                             window_small, with_indices=with_indices)
    big = gather_neighbors(frame, camera, features_uv,
                           half_x * scale_x, half_y * scale_y, window_large,
                           with_indices=with_indices)
    return small, big
