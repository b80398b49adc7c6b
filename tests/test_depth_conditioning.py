"""The depth cascade against itself on the CPU, with every lidar
coordinate moved one float32 ulp: the floor under any two backends'
agreement.  It must meet the same bounds as the GPU tier's GPU-vs-CPU
comparison (tests/depth_parity.py), on the sparse scene where the road
pass's plane fit is ill-conditioned."""

import jax
import numpy as np
import pytest

import depth_parity as parity


@pytest.mark.parametrize("fast", [False, True], ids=["exact", "fast"])
def test_one_ulp_input_perturbation_within_parity_bounds(fast):
    cfg, cam, T, cloud, valid, feats, ransac = parity.scene("sparse", fast)
    cpu = jax.devices("cpu")[0]
    d0, c0 = parity.run_depths(cpu, cfg, cam, T, cloud, valid, feats, ransac)
    assert np.sum(c0 == parity.ROAD) >= 20, "scene lost its road features"
    for seed in range(3):
        moved = parity.one_ulp(cloud, seed)
        assert (moved != cloud).all()
        d1, c1 = parity.run_depths(cpu, cfg, cam, T, moved, valid, feats,
                                   ransac)
        readings, broken = parity.parity(d1, c1, d0, c0, fast)
        assert not broken, f"seed {seed}: {broken}; {readings}"
