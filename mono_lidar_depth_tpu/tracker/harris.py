"""Shi-Tomasi corner detection, grid-bucketed for static shapes.

Device-resident design: the image never leaves the device; gradients and the
structure tensor are depthwise convolutions (XLA fuses them), and
non-max suppression is a grid reduction — one corner per spatial cell,
top-N cells by response — which yields a STATIC [N, 2] feature tensor
with a validity mask instead of a dynamic keypoint list.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def _conv2d_same(img: jnp.ndarray, kernel: jnp.ndarray) -> jnp.ndarray:
    """2-D 'same' convolution of [H, W] with [kh, kw]."""
    return jax.lax.conv_general_dilated(
        img[None, None], kernel[None, None],
        window_strides=(1, 1), padding="SAME",
        dimension_numbers=("NCHW", "OIHW", "NCHW"))[0, 0]


def sobel_gradients(img: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """(Ix, Iy) Sobel gradients of [H, W] float image (1/8 scale)."""
    kx = jnp.array([[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]], jnp.float32) / 8.0
    ky = kx.T
    return _conv2d_same(img, kx), _conv2d_same(img, ky)


def shi_tomasi_response(img: jnp.ndarray, window: int = 5) -> jnp.ndarray:
    """Min-eigenvalue corner response of the structure tensor.

    lambda_min = (Sxx + Syy - sqrt((Sxx - Syy)^2 + 4 Sxy^2)) / 2
    with S* = box-filtered gradient products over `window`.
    """
    ix, iy = sobel_gradients(img.astype(jnp.float32))
    box = jnp.ones((window, window), jnp.float32) / (window * window)
    sxx = _conv2d_same(ix * ix, box)
    syy = _conv2d_same(iy * iy, box)
    sxy = _conv2d_same(ix * iy, box)
    disc = jnp.sqrt(jnp.maximum((sxx - syy) ** 2 + 4.0 * sxy * sxy, 0.0))
    return 0.5 * (sxx + syy - disc)


def detect_features(
    img: jnp.ndarray,
    max_features: int,
    cell_size: int = 16,
    min_response: float = 1e-4,
    border: int = 8,
    occupied_uv: jnp.ndarray | None = None,
    occupied_valid: jnp.ndarray | None = None,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Detect up to `max_features` corners, at most one per cell.

    Args:
      img: [H, W] grayscale (any real dtype).
      max_features: static N of the output tensor.
      cell_size: spatial bucketing (also the enforced min distance
        between detections and to `occupied_uv` features).
      min_response: response floor.
      border: suppress detections within `border` px of the image edge.
      occupied_uv/[valid]: existing feature positions; their cells are
        masked out so detection only REPLENISHES free cells.

    Returns (uv [N, 2] float32, valid [N] bool), best-response-first.
    """
    H, W = img.shape
    resp = shi_tomasi_response(img)
    yy = jax.lax.broadcasted_iota(jnp.int32, (H, W), 0)
    xx = jax.lax.broadcasted_iota(jnp.int32, (H, W), 1)
    in_border = ((xx >= border) & (xx < W - border)
                 & (yy >= border) & (yy < H - border))
    resp = jnp.where(in_border, resp, -jnp.inf)

    gh = (H + cell_size - 1) // cell_size
    gw = (W + cell_size - 1) // cell_size
    ph, pw = gh * cell_size, gw * cell_size
    resp_p = jnp.full((ph, pw), -jnp.inf, resp.dtype).at[:H, :W].set(resp)
    cells = resp_p.reshape(gh, cell_size, gw, cell_size).transpose(0, 2, 1, 3)
    cells = cells.reshape(gh * gw, cell_size * cell_size)
    best_in_cell = jnp.argmax(cells, axis=1)
    best_resp = jnp.take_along_axis(cells, best_in_cell[:, None], axis=1)[:, 0]

    if occupied_uv is not None:
        occ_x = (occupied_uv[:, 0] / cell_size).astype(jnp.int32)
        occ_y = (occupied_uv[:, 1] / cell_size).astype(jnp.int32)
        occ_cell = jnp.clip(occ_y, 0, gh - 1) * gw + jnp.clip(occ_x, 0, gw - 1)
        if occupied_valid is None:
            occupied_valid = jnp.ones(occupied_uv.shape[0], bool)
        occupied_mask = jnp.zeros((gh * gw,), bool).at[
            jnp.where(occupied_valid, occ_cell, gh * gw)].max(
            occupied_valid, mode="drop")
        best_resp = jnp.where(occupied_mask, -jnp.inf, best_resp)

    # top-N cells by response (fewer cells than lanes → pad invalid)
    k = min(max_features, gh * gw)
    top_resp, top_cell = jax.lax.top_k(best_resp, k)
    if k < max_features:
        pad = max_features - k
        top_resp = jnp.concatenate(
            [top_resp, jnp.full((pad,), -jnp.inf, top_resp.dtype)])
        top_cell = jnp.concatenate(
            [top_cell, jnp.zeros((pad,), top_cell.dtype)])
    flat = best_in_cell[top_cell]
    cy = top_cell // gw
    cx = top_cell % gw
    py = cy * cell_size + flat // cell_size
    px = cx * cell_size + flat % cell_size
    uv = jnp.stack([px, py], axis=1).astype(jnp.float32)
    valid = top_resp > min_response
    return uv, valid
