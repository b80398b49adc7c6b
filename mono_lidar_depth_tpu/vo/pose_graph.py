"""Pose-graph optimization (the loop-closure backend).

Graph of absolute poses T_i (world←cam) with relative SE(3)
measurements Z_ij ≈ T_i⁻¹ T_j.  Gauss-Newton on the manifold with
right-perturbations T_i ← T_i exp(xi_i):

  r_e(xi) = log( Z_e⁻¹ · (T_i exp(xi_i))⁻¹ · (T_j exp(xi_j)) )

Edge Jacobians come from forward-mode autodiff of the residual at
xi = 0 (vmapped over edges — no hand-derived adjoints to get wrong),
and the sparse normal equations are solved with conjugate gradients
whose matvec is two gathers + two scatter-adds over the edge list —
O(E) per CG step, fully jittable, and the same structure shards over
devices by edge range (psum on the scatter result).

KITTI-scale: N ≈ 4500 poses, E ≈ N + loop closures; a dense 6N system
would be ~0.7 GB — the CG form never materializes it.

**Chain preconditioner (the convergence fix).**  Plain CG moves
information one edge per iteration, so a loop-closure correction needs
O(N) iterations to propagate along the odometry chain — at the r3
defaults (cg_iters = 80 < N = 220) the solver left the graph in a
HALF-corrected state that measured WORSE than raw VO (ATE 2.52 →
2.70 m) while full convergence (cg ≈ 3N) reaches 0.71 m.  The fix is
structural, not more iterations: precondition with M = the
block-tridiagonal odometry-chain Hessian (+ all edges' diagonal
blocks).  Then M⁻¹H = I + R where rank(R) ≤ 12·C for C closure edges,
so PCG converges in O(C) iterations INDEPENDENT of trajectory length
— the 6×6-block Thomas factorization of M is one O(N) scan per GN
step, and each application is two log-depth `associative_scan`s
(affine recurrences), all device-resident.  In the edge-sharded
distributed form the chain blocks are psum'd once per GN step and the
(cheap) preconditioner application is replicated, so distributed and
single-device solves stay numerically identical.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from .lie import se3_exp, se3_log
from .linalg6 import inv6_spd
from ..precision import f32_matmuls

_HI = jax.lax.Precision.HIGHEST


class PoseGraph(NamedTuple):
    R: jnp.ndarray  # [N, 3, 3] world←cam rotations
    t: jnp.ndarray  # [N, 3]
    edge_i: jnp.ndarray  # [E] int32 source pose index
    edge_j: jnp.ndarray  # [E] int32 target pose index
    Z_R: jnp.ndarray  # [E, 3, 3] measured relative rotation (i→j)
    Z_t: jnp.ndarray  # [E, 3]
    # [E] scalar information scale (1 = unit), OR [E, 6] per-residual-
    # component weights in the se3_log ordering [rho (3), phi (3)] —
    # closure measurements often carry strong rotation but weak
    # translation information (far-landmark geometry), and a scalar
    # weight cannot express that.
    edge_weight: jnp.ndarray
    edge_valid: jnp.ndarray  # [E]
    fixed: jnp.ndarray  # [N] gauge-fixed poses


def _weight6(g: "PoseGraph") -> jnp.ndarray:
    """Canonicalize edge_weight to [E, 6] per-residual-component form."""
    w = g.edge_weight
    if w.ndim == 2:
        return w
    return jnp.broadcast_to(w[:, None], (w.shape[0], 6))


def _edge_residual(Ri, ti, Rj, tj, ZR, Zt, xi_i, xi_j):
    dRi, dti = se3_exp(xi_i)
    dRj, dtj = se3_exp(xi_j)
    Ri2 = Ri @ dRi
    ti2 = (Ri @ dti) + ti
    Rj2 = Rj @ dRj
    tj2 = (Rj @ dtj) + tj
    # rel = T_i^{-1} T_j
    R_rel = Ri2.T @ Rj2
    t_rel = Ri2.T @ (tj2 - ti2)
    # err = Z^{-1} rel
    R_err = ZR.T @ R_rel
    t_err = ZR.T @ (t_rel - Zt)
    return se3_log(R_err, t_err)


def _edge_lin(Ri, ti, Rj, tj, ZR, Zt):
    """Residual at xi=0 and Jacobians wrt xi_i, xi_j ([6,6] each)."""
    zero = jnp.zeros(6, dtype=ti.dtype)
    r0 = _edge_residual(Ri, ti, Rj, tj, ZR, Zt, zero, zero)
    Ji = jax.jacfwd(
        lambda xi: _edge_residual(Ri, ti, Rj, tj, ZR, Zt, xi, zero))(zero)
    Jj = jax.jacfwd(
        lambda xj: _edge_residual(Ri, ti, Rj, tj, ZR, Zt, zero, xj))(zero)
    return r0, Ji, Jj


def _affine_combine(e1, e2):
    """Associative combine for affine recurrences c_k = A_k c_{k-1} + b_k
    (element 2 composed AFTER element 1)."""
    A1, b1 = e1
    A2, b2 = e2
    return (jnp.matmul(A2, A1, precision=_HI),
            jnp.einsum("...ij,...j->...i", A2, b1, precision=_HI) + b2)


_SCAN_BLOCK = 256


def _affine_scan(A: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """c_k = A_k c_{k-1} + b_k with c_{-1} = 0 (A [N,6,6], b [N,6] ->
    c [N,6]); A[0] is ignored (no predecessor).

    Blocked: log-depth `associative_scan` WITHIN fixed 256-element
    blocks, carried across blocks by an outer `lax.scan`.  A
    whole-trajectory associative scan at N ≈ 4500 unrolls into a very
    large HLO graph; bounding the unrolled portion keeps compile
    memory flat in N (an unbounded variant was also implicated in
    intermittent XLA-CPU compiler crashes in long test processes) at
    the cost of N/256 sequential block steps per application —
    negligible against the per-GN-step factorization scan."""
    N = A.shape[0]
    A = A.at[0].set(0.0)
    if N <= _SCAN_BLOCK:
        _, c = jax.lax.associative_scan(_affine_combine, (A, b))
        return c
    pad = (-N) % _SCAN_BLOCK
    Ap = jnp.concatenate([A, jnp.zeros((pad, 6, 6), A.dtype)])
    bp = jnp.concatenate([b, jnp.zeros((pad, 6), b.dtype)])
    nb = Ap.shape[0] // _SCAN_BLOCK
    Ab = Ap.reshape(nb, _SCAN_BLOCK, 6, 6)
    bb = bp.reshape(nb, _SCAN_BLOCK, 6)

    def block(carry, inp):
        Ak, bk = inp
        b0 = jnp.einsum("ij,j->i", Ak[0], carry, precision=_HI) + bk[0]
        bk = bk.at[0].set(b0)
        _, c = jax.lax.associative_scan(_affine_combine, (Ak, bk))
        return c[-1], c

    _, cb = jax.lax.scan(block, jnp.zeros((6,), b.dtype), (Ab, bb))
    return cb.reshape(-1, 6)[:N]


def _chain_preconditioner(D: jnp.ndarray, B: jnp.ndarray):
    """Block-Thomas factorization of the SPD block-tridiagonal matrix
    with diagonal blocks D [N,6,6] and super-diagonal blocks B[k] =
    block (k, k+1) ([N,6,6]; the last entry unused).  Returns an
    `apply(r)` closure computing M^-1 r via two associative scans.

    Forward elimination (the one inherently sequential O(N) scan, run
    ONCE per GN step):  S_0 = D_0,  S_k = D_k - B_{k-1}^T S_{k-1}^-1
    B_{k-1}; stores U_k = S_k^-1 (closed-form 6x6 SPD inverse, Jacobi-
    scaled: rotation and translation rows differ by ~1e4 in magnitude
    — meters vs radians at multi-meter lever arms — and the raw 3x3
    adjugate chain loses f32 accuracy on that spread; normalizing each
    S by its diagonal before inverting keeps the recurrence accurate
    to ~1e-4 over hundreds of blocks).  Solving M x = r then reduces
    to two AFFINE recurrences — forward substitution c_k = U_k (r_k -
    B_{k-1}^T c_{k-1}) and back substitution x_k = c_k - U_k B_k
    x_{k+1} — each a log-depth `associative_scan` over [N,6,6]
    transfer matrices, fully batched."""
    N = D.shape[0]

    def inv6_scaled(S):
        # Symmetrize in AND out: inv6_spd's block-Schur form never
        # reads the lower-left block, so any asymmetry in its input is
        # silently dropped while its OUTPUT picks up new roundoff
        # asymmetry — unsymmetrized, that error feeds back through the
        # Riccati recurrence and grows ~10x per step (measured: U
        # asymmetry 1.6 by k=22, indefinite S by k=39 on a 40-pose
        # chain; symmetrized, the full solve stays at ~3e-5).
        S = 0.5 * (S + S.T)
        d = jnp.sqrt(jnp.clip(jnp.diagonal(S), 1e-20, None))
        Sn = S / d[:, None] / d[None, :]
        U = inv6_spd(Sn) / d[:, None] / d[None, :]
        return 0.5 * (U + U.T)

    def fact_step(U_prev, inp):
        Dk, Bkm1 = inp
        S = Dk - jnp.matmul(
            Bkm1.T, jnp.matmul(U_prev, Bkm1, precision=_HI),
            precision=_HI)
        U = inv6_scaled(S)
        return U, U

    U0 = inv6_scaled(D[0])
    _, Us = jax.lax.scan(fact_step, U0, (D[1:], B[:-1]))
    U = jnp.concatenate([U0[None], Us])  # [N,6,6]
    # forward transfer A_k = -U_k B_{k-1}^T (k >= 1)
    A_fwd = -jnp.matmul(U[1:], jnp.swapaxes(B[:-1], -1, -2),
                        precision=_HI)
    A_fwd = jnp.concatenate([jnp.zeros((1, 6, 6), D.dtype), A_fwd])
    # backward transfer A'_k = -U_k B_k (k <= N-2)
    A_bwd = -jnp.matmul(U[:-1], B[:-1], precision=_HI)
    A_bwd = jnp.concatenate([A_bwd, jnp.zeros((1, 6, 6), D.dtype)])
    A_bwd_flip = A_bwd[::-1]

    def apply(r):  # [N, 6] -> M^-1 r
        b_fwd = jnp.einsum("kij,kj->ki", U, r, precision=_HI)
        c = _affine_scan(A_fwd, b_fwd)
        x_flip = _affine_scan(A_bwd_flip, c[::-1])
        return x_flip[::-1]

    return apply


@partial(jax.jit, static_argnames=("gn_iters", "cg_iters", "huber",
                                   "axis_name", "precondition"))
@f32_matmuls
def optimize_pose_graph(graph: PoseGraph, gn_iters: int = 8,
                        cg_iters: int = 200, huber: float = 0.5,
                        damping: float = 1e-6,
                        axis_name: str | None = None,
                        precondition: bool = True) -> PoseGraph:
    """Run Gauss-Newton with (preconditioned) CG inner solves; returns
    the updated graph.

    With `precondition` (default) the CG is preconditioned with the
    block-tridiagonal chain Hessian (see module docstring): convergence
    takes O(closure-count) iterations independent of N, and the solve
    early-exits on a 1e-4 relative-residual tolerance, so the
    `cg_iters` default is a CAP, not a cost.  `precondition=False`
    falls back to plain CG (the r3 behavior) for A/B and tests.

    With `axis_name` the EDGE arrays are assumed sharded over that mesh
    axis (poses replicated): each device linearizes its edge shard and
    the per-pose scatter-adds (gradient b, the CG matvec result, and
    the preconditioner's chain blocks) are psum'd — the distributed
    form of the north star's "map blocks over hosts" (BASELINE.json
    config 4).  The CG state and the preconditioner application stay
    replicated, so every device computes identical alpha/beta and the
    iterates never diverge.  See dist.sharded.distributed_pose_graph."""
    N = graph.R.shape[0]
    eye6 = jnp.eye(6, dtype=graph.t.dtype)

    def gn_step(it, g: PoseGraph) -> PoseGraph:
        Ri = g.R[g.edge_i]
        ti = g.t[g.edge_i]
        Rj = g.R[g.edge_j]
        tj = g.t[g.edge_j]
        r0, Ji, Jj = jax.vmap(_edge_lin)(Ri, ti, Rj, tj, g.Z_R, g.Z_t)

        err = jnp.linalg.norm(r0, axis=-1)
        # Graduated robustness (GNC-style annealing): a TRUE closure on
        # a heavily drifted trajectory starts with a residual far above
        # the huber point, so a fixed threshold crushes exactly the
        # edges that carry the correction (measured: 10% ATE recovery
        # at 124 deg accumulated yaw vs 80% with annealing).  Early GN
        # iterations run quasi-quadratic (threshold 2^k x huber,
        # halving each iteration); the schedule reaches the base
        # threshold HALFWAY through the run — tied to gn_iters, so the
        # second half always enforces the true robust objective and a
        # genuinely wrong closure ends downweighted at convergence
        # regardless of the caller's iteration budget (a fixed k = 8
        # left gn_iters <= 8 runs quasi-least-squares forever).
        anneal_end = max(1, gn_iters // 2)
        huber_k = huber * jnp.maximum(
            1.0, 2.0 ** (anneal_end - it.astype(graph.t.dtype)))
        w_h = jnp.where(err <= huber_k, 1.0,
                        huber_k / jnp.maximum(err, 1e-12))
        w6 = _weight6(g)  # [E, 6]
        w = jnp.where(g.edge_valid[:, None], w6 * w_h[:, None], 0.0)

        free_i = ~g.fixed[g.edge_i]
        free_j = ~g.fixed[g.edge_j]
        Ji_m = Ji * free_i[:, None, None]
        Jj_m = Jj * free_j[:, None, None]

        # gradient b = J^T W r (W diagonal per residual component),
        # scattered per pose
        wr = w * r0  # [E, 6]
        bi = jnp.einsum("eri,er->ei", Ji_m, wr)
        bj = jnp.einsum("eri,er->ei", Jj_m, wr)
        b = (jnp.zeros((N, 6), r0.dtype)
             .at[g.edge_i].add(bi).at[g.edge_j].add(bj))
        if axis_name is not None:
            b = jax.lax.psum(b, axis_name)

        def matvec(x):  # H x with H = J^T w J + damping I
            xi = x[g.edge_i]
            xj = x[g.edge_j]
            Ax = (jnp.einsum("erc,ec->er", Ji_m, xi)
                  + jnp.einsum("erc,ec->er", Jj_m, xj))  # [E, 6]
            wAx = w * Ax
            yi = jnp.einsum("eri,er->ei", Ji_m, wAx)
            yj = jnp.einsum("eri,er->ei", Jj_m, wAx)
            y = (jnp.zeros((N, 6), x.dtype)
                 .at[g.edge_i].add(yi).at[g.edge_j].add(yj))
            if axis_name is not None:
                y = jax.lax.psum(y, axis_name)
            return y + damping * x

        if precondition:
            # M = the CHAIN-edge Hessian only (consecutive-pose edges).
            # Including closure blocks in M widens its spectrum by the
            # closure/odometry weight ratio (measured: condition 6.5e6
            # vs 3.4e3 chain-only on the circle test graph) and sinks
            # the f32 factorization; chain-only keeps M uniformly
            # scaled while M^-1 H stays I + rank<=24C.
            chain = (g.edge_j == g.edge_i + 1)[:, None]
            wc = jnp.where(chain, w, 0.0)
            Hii = jnp.einsum("eri,er,erj->eij", Ji_m, wc, Ji_m,
                             precision=_HI)
            Hjj = jnp.einsum("eri,er,erj->eij", Jj_m, wc, Jj_m,
                             precision=_HI)
            Hij = jnp.einsum("eri,er,erj->eij", Ji_m, wc, Jj_m,
                             precision=_HI)
            D = (jnp.zeros((N, 6, 6), r0.dtype)
                 .at[g.edge_i].add(Hii).at[g.edge_j].add(Hjj))
            B = (jnp.zeros((N, 6, 6), r0.dtype).at[g.edge_i].add(Hij))
            if axis_name is not None:
                D = jax.lax.psum(D, axis_name)
                B = jax.lax.psum(B, axis_name)
            # Fixed/empty poses: keep S_k safely positive definite.
            # The RELATIVE floor only shapes the PRECONDITIONER — the
            # solution is unchanged; the raw 1e-6 damping would
            # underflow the f32 3x3 adjugate determinants.
            diag_scale = jnp.mean(jnp.trace(D, axis1=1, axis2=2)) / 6.0
            floor = 1e-3 * diag_scale + 1e-6
            D = jnp.where(graph.fixed[:, None, None], eye6,
                          D + floor * eye6)
            apply_Minv = _chain_preconditioner(D, B)
        else:
            def apply_Minv(r):
                return r

        # PCG for H dx = -b, early exit at 1e-4 relative residual
        res0 = -b
        z0 = apply_Minv(res0)
        rr0 = jnp.sum(res0 * res0)
        tol = (1e-4 ** 2) * rr0

        def cond(st):
            k, x, r, p, rz, rr = st
            return (k < cg_iters) & (rr > tol)

        def body(st):
            k, x, r, p, rz, rr = st
            Ap = matvec(p)
            denom = jnp.sum(p * Ap)
            alpha = rz / jnp.where(denom == 0, 1.0, denom)
            x = x + alpha * p
            r = r - alpha * Ap
            z = apply_Minv(r)
            rz_new = jnp.sum(r * z)
            beta = rz_new / jnp.where(rz == 0, 1.0, rz)
            return (k + 1, x, r, z + beta * p, rz_new, jnp.sum(r * r))

        st = (jnp.int32(0), jnp.zeros((N, 6), r0.dtype), res0, z0,
              jnp.sum(res0 * z0), rr0)
        _, dx, *_ = jax.lax.while_loop(cond, body, st)
        dx = jnp.where(g.fixed[:, None], 0.0, dx)

        dR, dt = se3_exp(dx)
        R_new = g.R @ dR  # right perturbation
        t_new = (g.R @ dt[..., None])[..., 0] + g.t
        return g._replace(R=R_new, t=t_new)

    return jax.lax.fori_loop(0, gn_iters, gn_step, graph)


@f32_matmuls
def graph_cost(graph: PoseGraph) -> jnp.ndarray:
    Ri = graph.R[graph.edge_i]
    ti = graph.t[graph.edge_i]
    Rj = graph.R[graph.edge_j]
    tj = graph.t[graph.edge_j]
    zero = jnp.zeros(6, dtype=graph.t.dtype)
    r = jax.vmap(lambda a, b, c, d, e, f: _edge_residual(
        a, b, c, d, e, f, zero, zero))(Ri, ti, Rj, tj, graph.Z_R, graph.Z_t)
    return jnp.sum(jnp.where(graph.edge_valid,
                             jnp.sum(r * r * _weight6(graph), axis=-1), 0.0))


@f32_matmuls
def sequential_edges(R: jnp.ndarray, t: jnp.ndarray,
                     noise_free: bool = True):
    """Build odometry-chain measurements from a pose sequence (helper
    for constructing graphs from VO output)."""
    N = R.shape[0]
    i = jnp.arange(N - 1, dtype=jnp.int32)
    j = i + 1
    Ri, Rj = R[:-1], R[1:]
    ti, tj = t[:-1], t[1:]
    Z_R = jnp.einsum("nij,nik->njk", Ri, Rj)  # Ri^T Rj
    Z_t = jnp.einsum("nij,ni->nj", Ri, tj - ti)  # Ri^T (tj - ti)
    return i, j, Z_R, Z_t
