"""The program on the GPU against the same program on the host CPU.

(a) slice_windows on the GPU == the numpy oracle, bit-exact (the
    windows are a copy), over the CPU tier's shape classes and edge
    starts (tests/test_windows.py).
(b) depth cascade on a sparse and a KITTI-width scene: GPU and CPU
    agree on >= 99.9% of result codes, and agreeing successes match
    depth to the bounds of tests/depth_parity.py.
(c) 60-frame VO: GPU ATE within 2x CPU ATE (plus a small absolute
    floor) — the net for reduced-precision contractions corrupting
    the GN/Schur solves.
(d) fast rasterization on the GPU lands in the exact path's envelope,
    on both scenes.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]


def _load(name):
    """A helper module of the CPU tier, tests/<name>.py."""
    spec = importlib.util.spec_from_file_location(
        f"cpu_tier_{name}", REPO / "tests" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


windows = _load("test_windows")
parity = _load("depth_parity")

pytestmark = pytest.mark.gpu


@pytest.mark.parametrize("C,H,W,Ky,Kx", windows.WINDOW_CASES)
def test_slice_windows_bitexact(gpu, C, H, W, Ky, Kx):
    from mono_lidar_depth_tpu.core.neighbors import slice_windows

    stack, sy, sx = windows.window_inputs(C, H, W, Ky, Kx)
    with jax.default_device(gpu):
        got = slice_windows(jnp.asarray(stack), jnp.asarray(sy),
                            jnp.asarray(sx), Ky, Kx)
    assert got.devices() == {gpu}
    want = windows.numpy_windows(stack, sy, sx, Ky, Kx)
    bad = np.asarray(got) != want
    assert not bad.any(), (f"{bad.sum()} element mismatches; first bad "
                           f"feature {np.argwhere(bad)[:1]}")


@pytest.mark.parametrize("scene", parity.SCENES)
def test_depth_codes_gpu_vs_cpu(gpu, cpu, scene, record_property):
    inputs = parity.scene(scene)
    d_gpu, c_gpu = parity.run_depths(gpu, *inputs)
    d_cpu, c_cpu = parity.run_depths(cpu, *inputs)
    readings, broken = parity.parity(d_gpu, c_gpu, d_cpu, c_cpu, fast=False)
    record_property("parity", readings)
    assert not broken, f"{broken}; {readings}"


def test_vo_short_horizon_gpu_vs_cpu(gpu, cpu, tmp_path):
    from mono_lidar_depth_tpu import DepthEstimatorConfig
    from mono_lidar_depth_tpu.eval import eval_vo_sequence
    from mono_lidar_depth_tpu.io.kitti import KittiSequence
    from mono_lidar_depth_tpu.io.synthetic_dataset import (
        SyntheticSpec, generate_kitti_sequence)
    from mono_lidar_depth_tpu.vo.metrics import ate_rmse

    W, H = 384, 128
    generate_kitti_sequence(
        str(tmp_path), "97",
        SyntheticSpec(frames=60, image_width=W, image_height=H,
                      focal=240.0, lidar_rows=20, lidar_cols=500,
                      step=0.55, loop=True))
    seq = KittiSequence(str(tmp_path), "97", image_width=W, image_height=H)
    cfg = DepthEstimatorConfig(
        max_points=16384, max_features=384, image_width=W, image_height=H,
        radiusSearch_count_min=1,
        ransac_num_hypotheses=256, ransac_subsample_points=1024)

    ates = {}
    for name, dev in (("gpu", gpu), ("cpu", cpu)):
        with jax.default_device(dev):
            vo = eval_vo_sequence(seq, cfg, max_tracks=384, max_length=8,
                                  verbose=False)
        gt = seq.gt_poses[vo["frame_ids"]]
        ates[name] = float(ate_rmse(vo["poses"][:, :3, 3], gt[:, :3, 3]))
    ate_g, ate_c = ates["gpu"], ates["cpu"]
    assert np.isfinite(ate_g) and np.isfinite(ate_c)
    assert ate_c < 2.0, f"CPU VO regressed: ATE {ate_c:.3f} m on 60 frames"
    assert ate_g <= max(2.0 * ate_c, ate_c + 0.25), (
        f"GPU ATE {ate_g:.3f} m vs CPU {ate_c:.3f} m — backend divergence")


@pytest.mark.parametrize("scene", parity.SCENES)
def test_fast_rasterization_gpu_matches_exact_envelope(gpu, cpu, scene,
                                                       record_property):
    """Fast rasterization on the GPU: identical occupancy to the exact
    rasterization, decoded depth within one quantization step, and the
    depth cascade's outcomes near-identical to the CPU (the packed-int32
    scatter-min and bit-shift decode are the op class where a backend
    could diverge from CPU semantics)."""
    from mono_lidar_depth_tpu.core.projection import (_FAST_STEP,
                                                      build_frame_cloud)

    cfg, cam, T, cloud, valid, feats, ransac = parity.scene(scene, fast=True)
    with jax.default_device(gpu):
        cloudj, validj = jnp.asarray(cloud), jnp.asarray(valid)
        exact = build_frame_cloud(cloudj, validj, T, cam, cfg.image_height,
                                  cfg.image_width, "nearest")
        fast = build_frame_cloud(cloudj, validj, T, cam, cfg.image_height,
                                 cfg.image_width, "nearest", fast=True)
        ze, zf = np.asarray(exact.planes[0]), np.asarray(fast.planes[0])
        np.testing.assert_array_equal(zf != 0, ze != 0)
        occ = ze != 0
        assert np.abs(np.abs(zf[occ]) - np.abs(ze[occ])).max() \
            <= _FAST_STEP + 1e-5
        gi = np.asarray(fast.grid)[occ]
        assert (gi >= 0).all() and np.asarray(exact.visible)[gi].all()

    inputs = (cfg, cam, T, cloud, valid, feats, ransac)
    d_gpu, c_gpu = parity.run_depths(gpu, *inputs)
    d_cpu, c_cpu = parity.run_depths(cpu, *inputs)
    readings, broken = parity.parity(d_gpu, c_gpu, d_cpu, c_cpu, fast=True)
    record_property("parity", readings)
    assert not broken, f"{broken}; {readings}"
