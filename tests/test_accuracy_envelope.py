"""Round-over-round VO accuracy gate.

The r3 -> r4 KLT window-sampler rewrite silently cost 10% of config-3
ATE (2.27 -> 2.50 m: its zero-slack center clamp froze patches whose
LK iterate transiently crossed the border, dropping ~1% of tracks —
the near-border high-parallax ones) because nothing gated accuracy
the way PERF.md gates speed.  This test runs the EXACT committed
parity-record configuration (scripts/make_parity_record.py config 3:
220-frame synthetic loop, 384x128, 20x500 lidar, same DepthEstimator
config) on the CPU backend and asserts the ATE/RPE envelope.

Envelope: measured 2.073 m ATE / 0.0574 m RPE-trans at the r5 fix
(CPU).  The bounds leave ~15% headroom for cross-backend and chaotic
run-to-run variation — a regression of the r4 class
(+0.23 m systematic) fails loudly.  ACCURACY.md carries the per-round
history.
"""

import numpy as np
import pytest

from mono_lidar_depth_tpu import DepthEstimatorConfig
from mono_lidar_depth_tpu.eval import eval_vo_sequence
from mono_lidar_depth_tpu.io.kitti import KittiSequence
from mono_lidar_depth_tpu.io.synthetic_dataset import (SyntheticSpec,
                                                       generate_kitti_sequence)

W, H = 384, 128


@pytest.fixture(scope="module")
def parity_seq(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("parity220"))
    generate_kitti_sequence(
        root, "98", SyntheticSpec(frames=220, image_width=W, image_height=H,
                                  focal=240.0, lidar_rows=20, lidar_cols=500,
                                  step=0.55, loop=True))
    return KittiSequence(root, "98", image_width=W, image_height=H)


def test_vo_accuracy_envelope_220(parity_seq):
    cfg = DepthEstimatorConfig(
        max_points=16384, max_features=384, image_width=W, image_height=H,
        radiusSearch_count_min=1,
        ransac_num_hypotheses=256, ransac_subsample_points=1024)
    vo = eval_vo_sequence(parity_seq, cfg, max_tracks=384, max_length=8,
                          verbose=False)
    ate = float(vo["ate_rmse"])
    rpe_t = float(vo["rpe_trans_rmse"])
    rpe_r = float(vo["rpe_rot_rmse_deg"])
    assert np.isfinite(ate)
    # measured r5: ATE 2.073 m, RPE 0.0574 m / 1.573 deg (CPU)
    assert ate < 2.45, f"config-3 ATE regressed: {ate:.3f} m (gate 2.45)"
    assert rpe_t < 0.075, f"RPE trans regressed: {rpe_t:.4f} m"
    assert rpe_r < 2.0, f"RPE rot regressed: {rpe_r:.3f} deg"
