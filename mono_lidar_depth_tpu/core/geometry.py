"""Batched geometry primitives (L0 of the reference stack).

Batched replacements for the reference's Eigen-based primitives:
  * pinhole camera        (reference `camera_pinhole.h:20-114`)
  * ray-plane intersection (reference `LinePlaneIntersection*.cpp`)
  * plane through 3 points (Eigen `Hyperplane::Through`)
  * analytic symmetric 3x3 eigendecomposition — replaces every
    JacobiSVD / SelfAdjointEigenSolver call in the reference
    (`PlaneEstimationMEstimator.cpp:44-49`, `PCA.cpp:42-62`) with a
    closed-form, fully vectorized elementwise solver with no iterative
    loops.

All functions are shape-polymorphic over leading batch dimensions and
pure jnp — safe under jit/vmap/shard_map.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp


class PinholeCamera(NamedTuple):
    """Single-focal-length pinhole camera, fx == fy (the reference asserts
    this, tracklets_depth/src/tracklet_depth_module.cpp:11)."""

    width: int
    height: int
    focal_length: float
    cx: float
    cy: float

    def intrinsics(self, dtype=jnp.float32) -> jnp.ndarray:
        f = self.focal_length
        return jnp.array(
            [[f, 0.0, self.cx], [0.0, f, self.cy], [0.0, 0.0, 1.0]], dtype=dtype)

    def project(self, points_cam: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
        """Project camera-frame points to pixel coordinates.

        Mirrors `CameraPinhole::getImagePoints` (camera_pinhole.h:84-97):
        hnormalize then in-bounds test 0 <= u <= W, 0 <= v <= H.

        Args:  points_cam [..., 3]
        Returns: (uv [..., 2], in_bounds [...])  — points with z == 0 are
        marked out of bounds instead of producing inf.
        """
        z = points_cam[..., 2]
        safe_z = jnp.where(z == 0, 1.0, z)
        u = self.focal_length * points_cam[..., 0] / safe_z + self.cx
        v = self.focal_length * points_cam[..., 1] / safe_z + self.cy
        uv = jnp.stack([u, v], axis=-1)
        in_bounds = (
            (z != 0)
            & (u >= 0.0) & (u <= float(self.width))
            & (v >= 0.0) & (v <= float(self.height))
        )
        return uv, in_bounds

    def viewing_rays(self, uv: jnp.ndarray) -> jnp.ndarray:
        """Normalized viewing-ray directions through pixels.

        Mirrors `CameraPinhole::getViewingRays` (camera_pinhole.h:52-69):
        K^-1 [u,v,1], normalized; support point is the origin (SVP model).

        Args: uv [..., 2].  Returns directions [..., 3].
        """
        f = self.focal_length
        x = (uv[..., 0] - self.cx) / f
        y = (uv[..., 1] - self.cy) / f
        d = jnp.stack([x, y, jnp.ones_like(x)], axis=-1)
        return d / jnp.linalg.norm(d, axis=-1, keepdims=True)


class SE3(NamedTuple):
    """Rigid transform: x' = R @ x + t (replaces Eigen::Affine3d)."""

    rotation: jnp.ndarray  # [..., 3, 3]
    translation: jnp.ndarray  # [..., 3]

    @classmethod
    def identity(cls, dtype=jnp.float32) -> "SE3":
        return cls(jnp.eye(3, dtype=dtype), jnp.zeros(3, dtype=dtype))

    @classmethod
    def from_matrix(cls, mat: jnp.ndarray) -> "SE3":
        return cls(mat[..., :3, :3], mat[..., :3, 3])

    def as_matrix(self) -> jnp.ndarray:
        batch = self.translation.shape[:-1]
        bottom = jnp.broadcast_to(
            jnp.array([0.0, 0.0, 0.0, 1.0], dtype=self.translation.dtype),
            batch + (1, 4))
        top = jnp.concatenate(
            [self.rotation, self.translation[..., None]], axis=-1)
        return jnp.concatenate([top, bottom], axis=-2)

    def apply(self, points: jnp.ndarray) -> jnp.ndarray:
        """Transform points [..., 3] (batched over leading dims)."""
        return points @ jnp.swapaxes(self.rotation, -1, -2) + self.translation

    def inverse(self) -> "SE3":
        rt = jnp.swapaxes(self.rotation, -1, -2)
        return SE3(rt, -(rt @ self.translation[..., None])[..., 0])

    def compose(self, other: "SE3") -> "SE3":
        """self ∘ other: apply `other` first."""
        return SE3(self.rotation @ other.rotation,
                   (self.rotation @ other.translation[..., None])[..., 0]
                   + self.translation)


# ---------------------------------------------------------------------------
# Planes and rays
# ---------------------------------------------------------------------------


def plane_from_points(p1: jnp.ndarray, p2: jnp.ndarray, p3: jnp.ndarray
                      ) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Hyperplane through three points (Eigen `Hyperplane::Through`).

    Returns (normal [...,3] unit, offset [...]) with n·x + offset == 0.
    Degenerate triangles yield a zero normal (callers gate on planarity
    checks first, as the reference does).
    """
    n = jnp.cross(p2 - p1, p3 - p1)
    norm = jnp.linalg.norm(n, axis=-1, keepdims=True)
    n = n / jnp.where(norm == 0, 1.0, norm)
    offset = -jnp.sum(n * p1, axis=-1)
    return n, offset


def ray_plane_intersection(normal: jnp.ndarray, offset: jnp.ndarray,
                           origin: jnp.ndarray, direction: jnp.ndarray
                           ) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Intersect ray origin + t*direction with plane n·x + offset = 0.

    Mirrors Eigen `ParametrizedLine::intersectionPoint` as used in
    `LinePlaneIntersectionNormal.cpp:11-31`: the returned depth is the
    z-coordinate of the intersection point (line :28), NOT the ray
    parameter t.  A zero denominator (ray parallel to plane) yields a
    non-finite-free result with depth forced to -inf so downstream gates
    dispose of it.
    """
    denom = jnp.sum(normal * direction, axis=-1)
    num = -(jnp.sum(normal * origin, axis=-1) + offset)
    safe = jnp.where(denom == 0, 1.0, denom)
    t = num / safe
    point = origin + t[..., None] * direction
    depth = jnp.where(denom == 0, -jnp.inf, point[..., 2])
    point = jnp.where(denom[..., None] == 0, 0.0, point)
    return point, depth


def point_plane_distance(points: jnp.ndarray, coeffs: jnp.ndarray) -> jnp.ndarray:
    """|a x + b y + c z + d| / ||(a,b,c)|| for coeffs [..., 4]
    (pcl::pointToPlaneDistance as used in DepthEstimator.cpp:812)."""
    n = coeffs[..., :3]
    d = coeffs[..., 3]
    norm = jnp.linalg.norm(n, axis=-1)
    return jnp.abs(jnp.sum(points * n, axis=-1) + d) / jnp.where(norm == 0, 1.0, norm)


# ---------------------------------------------------------------------------
# Analytic symmetric 3x3 eigendecomposition
# ---------------------------------------------------------------------------


def sym3x3_eigenvalues(A: jnp.ndarray) -> jnp.ndarray:
    """Eigenvalues of symmetric [..., 3, 3] matrices, ascending.

    Closed-form trigonometric method (Smith 1961): no iteration, no host
    fallback — pure elementwise arithmetic, batches arbitrarily.
    """
    q = jnp.trace(A, axis1=-2, axis2=-1) / 3.0
    eye = jnp.eye(3, dtype=A.dtype)
    B = A - q[..., None, None] * eye
    p2 = jnp.sum(B * B, axis=(-2, -1)) / 6.0
    p = jnp.sqrt(jnp.maximum(p2, 0.0))
    safe_p = jnp.where(p == 0, 1.0, p)
    detB = jnp.linalg.det(B)
    r = detB / (2.0 * safe_p**3)
    r = jnp.clip(r, -1.0, 1.0)
    phi = jnp.arccos(r) / 3.0
    two_pi_3 = 2.0 * jnp.pi / 3.0
    e_hi = q + 2.0 * p * jnp.cos(phi)
    e_lo = q + 2.0 * p * jnp.cos(phi + two_pi_3)
    e_mid = 3.0 * q - e_hi - e_lo
    evals = jnp.stack([e_lo, e_mid, e_hi], axis=-1)
    # p == 0 → A is q*I, all eigenvalues q.
    return jnp.where(p[..., None] == 0, q[..., None], evals)


def _eigenvector_for(A: jnp.ndarray, lam: jnp.ndarray) -> jnp.ndarray:
    """Unit eigenvector of symmetric A for eigenvalue lam via the
    largest cross product of rows of (A - lam I).  Robust to one
    repeated eigenvalue; for fully degenerate input returns e_z."""
    M = A - lam[..., None, None] * jnp.eye(3, dtype=A.dtype)
    r0, r1, r2 = M[..., 0, :], M[..., 1, :], M[..., 2, :]
    c01 = jnp.cross(r0, r1)
    c02 = jnp.cross(r0, r2)
    c12 = jnp.cross(r1, r2)
    cands = jnp.stack([c01, c02, c12], axis=-2)  # [..., 3, 3]
    norms = jnp.linalg.norm(cands, axis=-1)
    best = jnp.argmax(norms, axis=-1)
    v = jnp.take_along_axis(cands, best[..., None, None], axis=-2)[..., 0, :]
    n = jnp.linalg.norm(v, axis=-1, keepdims=True)
    fallback = jnp.broadcast_to(
        jnp.array([0.0, 0.0, 1.0], dtype=A.dtype), v.shape)
    return jnp.where(n > 1e-20, v / jnp.where(n == 0, 1.0, n), fallback)


def sym3x3_eigh(A: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Full eigendecomposition of symmetric [..., 3, 3] matrices.

    Returns (eigenvalues [..., 3] ascending, eigenvectors [..., 3, 3]
    with eigenvectors[..., i, :] the unit vector for eigenvalue i).
    The middle eigenvector is rebuilt as cross(v_hi, v_lo) for exact
    orthogonality.
    """
    evals = sym3x3_eigenvalues(A)
    v_lo = _eigenvector_for(A, evals[..., 0])
    v_hi = _eigenvector_for(A, evals[..., 2])
    # If lo/hi picked (near-)parallel vectors (repeated eigenvalues),
    # re-orthogonalize hi against lo.
    dot = jnp.sum(v_lo * v_hi, axis=-1, keepdims=True)
    v_hi_orth = v_hi - dot * v_lo
    n = jnp.linalg.norm(v_hi_orth, axis=-1, keepdims=True)
    alt = _any_orthogonal(v_lo)
    v_hi = jnp.where(n > 1e-8, v_hi_orth / jnp.where(n == 0, 1.0, n), alt)
    v_mid = jnp.cross(v_hi, v_lo)
    return evals, jnp.stack([v_lo, v_mid, v_hi], axis=-2)


def _any_orthogonal(v: jnp.ndarray) -> jnp.ndarray:
    """A unit vector orthogonal to unit v."""
    ex = jnp.broadcast_to(jnp.array([1.0, 0.0, 0.0], dtype=v.dtype), v.shape)
    ey = jnp.broadcast_to(jnp.array([0.0, 1.0, 0.0], dtype=v.dtype), v.shape)
    pick = jnp.abs(v[..., 0:1]) < 0.9
    base = jnp.where(pick, ex, ey)
    w = jnp.cross(v, base)
    return w / jnp.linalg.norm(w, axis=-1, keepdims=True)


def smallest_eigenvector_sym3x3(A: jnp.ndarray) -> jnp.ndarray:
    """Unit eigenvector for the smallest eigenvalue of symmetric A
    [..., 3, 3] — the best-fit plane normal of a scatter matrix.
    Replaces `svd.matrixU().rightCols<1>()` in
    PlaneEstimationMEstimator.cpp:48."""
    evals = sym3x3_eigenvalues(A)
    return _eigenvector_for(A, evals[..., 0])
