"""Per-feature window extraction (`core.neighbors.slice_windows`) against
a numpy oracle, over the grid shape classes the pipeline uses and the
edge starts of every axis."""

import numpy as np
import pytest

from mono_lidar_depth_tpu.core.neighbors import slice_windows

# (C, H, W, Ky, Kx)
WINDOW_CASES = [
    (2, 128, 384, 9, 11),     # synthetic-eval-sized grid
    (2, 376, 1241, 9, 11),    # KITTI-sized grid, W not a power of two
    (2, 64, 256, 7, 7),       # W a power of two
    (3, 96, 512, 15, 21),     # 3 attribute planes, wide window
]


def window_inputs(C, H, W, Ky, Kx, n_rand=192, seed=0):
    """(stack [C, H, W] f32, sy [N], sx [N]): random interior starts
    plus forced edge starts — 0, the last valid start, and offsets 0, 1
    and 127 from every multiple of 128 that fits."""
    rng = np.random.default_rng(seed)
    stack = rng.normal(size=(C, H, W)).astype(np.float32)
    sy = list(rng.integers(0, H - Ky + 1, n_rand))
    sx = list(rng.integers(0, W - Kx + 1, n_rand))
    for base in range(0, W - Kx + 1, 128):
        for off in (0, 1, 127):
            if base + off <= W - Kx:
                sx.append(base + off)
                sy.append(int(rng.integers(0, H - Ky + 1)))
    sx += [0, W - Kx, 0, W - Kx]
    sy += [0, H - Ky, H - Ky, 0]
    return stack, np.asarray(sy, np.int32), np.asarray(sx, np.int32)


def numpy_windows(stack, sy, sx, Ky, Kx):
    return np.stack([stack[:, y:y + Ky, x:x + Kx] for y, x in zip(sy, sx)])


@pytest.mark.parametrize("C,H,W,Ky,Kx", WINDOW_CASES)
def test_slice_windows_matches_numpy(C, H, W, Ky, Kx):
    stack, sy, sx = window_inputs(C, H, W, Ky, Kx)
    got = np.asarray(slice_windows(stack, sy, sx, Ky, Kx))
    want = numpy_windows(stack, sy, sx, Ky, Kx)
    assert got.shape == (len(sy), C, Ky, Kx)
    np.testing.assert_array_equal(got, want)
