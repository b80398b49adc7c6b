"""Parity fuzz: the L-minor (lane-layout) BA iteration must compute the
same Gauss-Newton step as a literal einsum-built oracle.

The oracle below is the direct [K, L, 2, 6]-layout formulation (Jp @
[I | -hat(p)] built as explicit small-matrix products) — numerically
the same math, organized the naive way.  The production code in
vo/ba.py restructures every per-landmark tensor to keep L the minor
(contiguous) dimension; this fuzz pins the two to each other.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from mono_lidar_depth_tpu import PinholeCamera
from mono_lidar_depth_tpu.vo.ba import (BAProblem, ba_cost, ba_iteration,
                                        run_ba)
from mono_lidar_depth_tpu.vo.lie import se3_exp, so3_exp


def _huber_w(err, delta):
    return jnp.where(err <= delta, 1.0, delta / jnp.maximum(err, 1e-9))


def _oracle_blocks(camera, pb: BAProblem, huber_px, depth_weight,
                   huber_depth, min_depth=0.25):
    """Hessian blocks in the naive layout (the pre-restructure
    formulation, kept verbatim as the parity oracle)."""
    R, t, X = pb.R, pb.t, pb.landmarks
    p = jnp.einsum("kij,lj->kli", R, X) + t[:, None, :]  # [K, L, 3]
    z = p[..., 2]
    behind = z <= min_depth
    zs = jnp.maximum(z, min_depth)
    inv_z = 1.0 / zs
    f = camera.focal_length
    u = f * p[..., 0] * inv_z + camera.cx
    v = f * p[..., 1] * inv_z + camera.cy
    r = jnp.stack([u, v], axis=-1) - pb.obs_uv
    zero = jnp.zeros_like(inv_z)
    Jp = jnp.stack([
        jnp.stack([f * inv_z, zero, -f * p[..., 0] * inv_z * inv_z], -1),
        jnp.stack([zero, f * inv_z, -f * p[..., 1] * inv_z * inv_z], -1),
    ], axis=-2)
    px, py, pz = p[..., 0], p[..., 1], p[..., 2]
    zeros = jnp.zeros_like(px)
    hat_p = jnp.stack([
        jnp.stack([zeros, -pz, py], -1),
        jnp.stack([pz, zeros, -px], -1),
        jnp.stack([-py, px, zeros], -1),
    ], axis=-2)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=p.dtype), hat_p.shape)
    Jx = jnp.concatenate([eye, -hat_p], axis=-1)
    Jpose = Jp @ Jx  # [K, L, 2, 6]
    Jlm = jnp.einsum("klri,kij->klrj", Jp, R)
    active = pb.obs_mask & pb.lm_valid[None, :] & ~behind

    r_d = p[..., 2] - pb.depth_prior
    Jpose_d = jnp.stack([zeros, zeros, jnp.ones_like(px), py, -px, zeros], -1)
    Jlm_d = pb.R[:, None, 2, :] * jnp.ones_like(px)[..., None]
    active_d = (pb.depth_mask & pb.obs_mask & pb.lm_valid[None, :]
                & (p[..., 2] > min_depth) & (pb.depth_prior > 0))

    err = jnp.linalg.norm(r, axis=-1)
    w = jnp.where(active, _huber_w(err, huber_px), 0.0)
    w_d = jnp.where(active_d,
                    depth_weight * _huber_w(jnp.abs(r_d), huber_depth), 0.0)

    Hpp = (jnp.einsum("kl,klri,klrj->kij", w, Jpose, Jpose)
           + jnp.einsum("kl,kli,klj->kij", w_d, Jpose_d, Jpose_d))
    Hll = (jnp.einsum("kl,klri,klrj->lij", w, Jlm, Jlm)
           + jnp.einsum("kl,kli,klj->lij", w_d, Jlm_d, Jlm_d))
    Hpl = (jnp.einsum("kl,klri,klrj->klij", w, Jpose, Jlm)
           + jnp.einsum("kl,kli,klj->klij", w_d, Jpose_d, Jlm_d))
    bp = (jnp.einsum("kl,klri,klr->ki", w, Jpose, r)
          + jnp.einsum("kl,kli,kl->ki", w_d, Jpose_d, r_d))
    bl = (jnp.einsum("kl,klri,klr->li", w, Jlm, r)
          + jnp.einsum("kl,kli,kl->li", w_d, Jlm_d, r_d))
    return Hpp, Hll, Hpl, bp, bl, w, w_d


def _oracle_iteration(camera, pb: BAProblem, huber_px, depth_weight,
                      huber_depth, damping):
    K = pb.R.shape[0]
    Hpp, Hll, Hpl, bp, bl, w, w_d = _oracle_blocks(
        camera, pb, huber_px, depth_weight, huber_depth)

    obs_cnt = jnp.sum(w, axis=0) + jnp.sum(w_d, axis=0)
    lm_free = (obs_cnt > 0) & pb.lm_valid
    tr_l = jnp.trace(Hll, axis1=-2, axis2=-1) / 3.0
    Hll = Hll + (damping * jnp.maximum(tr_l, 1.0) + 1e-8)[:, None, None] \
        * jnp.eye(3, dtype=Hll.dtype)
    Hll = jnp.where(lm_free[:, None, None], Hll, jnp.eye(3, dtype=Hll.dtype))
    bl = jnp.where(lm_free[:, None], bl, 0.0)

    Hll_inv = jnp.linalg.inv(Hll)
    W = jnp.einsum("klij,ljm->klim", Hpl, Hll_inv)
    S_cross = jnp.einsum("klim,qljm->kqij", W, Hpl)
    b_red_lm = jnp.einsum("klim,lm->ki", W, bl)

    tr_p = jnp.trace(Hpp, axis1=-2, axis2=-1) / 6.0
    Hpp = Hpp + (damping * jnp.maximum(tr_p, 1.0))[:, None, None] \
        * jnp.eye(6, dtype=Hpp.dtype)
    S = -S_cross
    S = S.at[jnp.arange(K), jnp.arange(K)].add(Hpp)
    b_red = bp - b_red_lm

    fix = pb.fixed
    S = jnp.where(fix[:, None, None, None] | fix[None, :, None, None], 0.0, S)
    S = S.at[jnp.arange(K), jnp.arange(K)].add(
        jnp.where(fix[:, None, None], jnp.eye(6, dtype=S.dtype), 0.0))
    b_red = jnp.where(fix[:, None], 0.0, b_red)

    Sd = S.transpose(0, 2, 1, 3).reshape(6 * K, 6 * K)
    dxi = -jnp.linalg.solve(Sd, b_red.reshape(-1)).reshape(K, 6)
    dxi = jnp.where(fix[:, None], 0.0, dxi)

    rhs = -bl - jnp.einsum("klij,ki->lj", Hpl, dxi)
    dl = jnp.einsum("lij,lj->li", Hll_inv, rhs)
    dl = jnp.where(lm_free[:, None], dl, 0.0)

    dR, dt = se3_exp(dxi)
    R_new = dR @ pb.R
    t_new = jnp.einsum("kij,kj->ki", dR, pb.t) + dt
    return pb._replace(R=R_new, t=t_new, landmarks=pb.landmarks + dl)


def _random_problem(rng, K=4, L=96):
    cam = PinholeCamera(width=640, height=480, focal_length=500.0,
                        cx=320.0, cy=240.0)
    X = rng.uniform([-10, -4, 4], [10, 4, 40], (L, 3)).astype(np.float32)
    Rs, ts, obs = [], [], []
    for k in range(K):
        w = rng.normal(0, 0.02, 3).astype(np.float32)
        R = np.asarray(so3_exp(jnp.asarray(w)))
        t = np.array([0.1 * k, 0, 0.3 * k], np.float32) \
            + rng.normal(0, 0.05, 3).astype(np.float32)
        p = X @ R.T + t
        u = 500.0 * p[:, 0] / p[:, 2] + 320.0
        v = 500.0 * p[:, 1] / p[:, 2] + 240.0
        obs.append(np.stack([u, v], -1) + rng.normal(0, 1.0, (L, 2)))
        Rs.append(R)
        ts.append(t)
    obs = np.stack(obs).astype(np.float32)
    depth_prior = np.stack([(X @ R.T + t)[:, 2] for R, t in zip(Rs, ts)])
    depth_prior = (depth_prior + rng.normal(0, 0.1, (K, L))).astype(np.float32)
    # perturb the initial poses so the step is non-trivial
    Rs = [np.asarray(so3_exp(jnp.asarray(
        rng.normal(0, 0.01, 3).astype(np.float32)))) @ R for R in Rs]
    return cam, BAProblem(
        R=jnp.asarray(np.stack(Rs)), t=jnp.asarray(np.stack(ts)),
        landmarks=jnp.asarray(X),
        obs_uv=jnp.asarray(obs),
        obs_mask=jnp.asarray(rng.random((K, L)) > 0.2),
        depth_prior=jnp.asarray(depth_prior),
        depth_mask=jnp.asarray(rng.random((K, L)) > 0.5),
        fixed=jnp.asarray(np.arange(K) == 0),
        lm_valid=jnp.asarray(rng.random(L) > 0.1))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_ba_iteration_matches_naive_oracle(seed):
    rng = np.random.default_rng(seed)
    cam, pb = _random_problem(rng)
    kw = dict(huber_px=2.0, depth_weight=1.5, huber_depth=0.5, damping=1e-3)
    new = ba_iteration(cam, pb, **kw)
    ref = _oracle_iteration(cam, pb, **kw)
    np.testing.assert_allclose(np.asarray(new.R), np.asarray(ref.R),
                               rtol=0, atol=5e-5)
    np.testing.assert_allclose(np.asarray(new.t), np.asarray(ref.t),
                               rtol=0, atol=5e-4)
    np.testing.assert_allclose(np.asarray(new.landmarks),
                               np.asarray(ref.landmarks), rtol=0, atol=5e-3)


def test_ba_cost_decreases():
    rng = np.random.default_rng(7)
    cam, pb = _random_problem(rng, K=5, L=128)
    res = run_ba(cam, pb, iters=6, depth_weight=1.0)
    assert float(res.final_cost) < float(res.initial_cost)


def test_solve6_spd_matches_linalg():
    """Closed-form 3x3-block Schur solve vs LAPACK (f32: tolerance is
    set by the conditioning, checked via the relative residual)."""
    from mono_lidar_depth_tpu.vo.linalg6 import solve6_spd
    rng = np.random.default_rng(3)
    for _ in range(20):
        A = rng.standard_normal((6, 6))
        H = (A @ A.T + 1e-2 * np.eye(6)).astype(np.float32)
        g = rng.standard_normal(6).astype(np.float32)
        x = np.asarray(solve6_spd(jnp.asarray(H), jnp.asarray(g)))
        np.testing.assert_allclose(x, np.linalg.solve(
            H.astype(np.float64), g.astype(np.float64)), rtol=5e-3)
        resid = np.linalg.norm(H @ x - g) / np.linalg.norm(g)
        assert resid < 1e-3, resid
