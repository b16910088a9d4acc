"""Unit quaternions (wxyz) as flat arrays — the rotation storage format.

All ops broadcast over leading dims; this is the SoA-friendly replacement for
the reference's nalgebra UnitQuaternion (src/geometry/se3.rs:5-82).
"""
from __future__ import annotations

import jax.numpy as jnp

from orbslam3_tpu.geometry import so3

_EPS = 1e-8


def identity(shape=(), dtype=jnp.float32):
    q = jnp.zeros(shape + (4,), dtype)
    return q.at[..., 0].set(1.0)


def normalize(q):
    return q / jnp.linalg.norm(q, axis=-1, keepdims=True).clip(_EPS)


def mul(q1, q2):
    """Hamilton product (wxyz)."""
    w1, x1, y1, z1 = q1[..., 0], q1[..., 1], q1[..., 2], q1[..., 3]
    w2, x2, y2, z2 = q2[..., 0], q2[..., 1], q2[..., 2], q2[..., 3]
    return jnp.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ],
        axis=-1,
    )


def conj(q):
    return q * jnp.asarray([1.0, -1.0, -1.0, -1.0], dtype=q.dtype)


def rotate(q, v):
    """Rotate vectors v (..., 3) by quaternions q (..., 4)."""
    qv = q[..., 1:]
    w = q[..., :1]
    t = 2.0 * jnp.cross(qv, v)
    return v + w * t + jnp.cross(qv, t)


def from_axis_angle(w):
    """Rotation vector (..., 3) -> quaternion (..., 4)."""
    theta_sq = jnp.sum(w * w, axis=-1, keepdims=True)
    is_small = theta_sq < 1e-12
    theta = jnp.sqrt(jnp.where(is_small, 1.0, theta_sq))
    theta = jnp.where(is_small, 0.0, theta)
    half = 0.5 * theta
    k = jnp.where(is_small, 0.5 - theta_sq / 48.0, jnp.sin(half) / jnp.where(is_small, 1.0, theta))
    return jnp.concatenate([jnp.cos(half), k * w], axis=-1)


def to_axis_angle(q):
    """Quaternion (..., 4) -> rotation vector (..., 3)."""
    q = jnp.where(q[..., :1] < 0, -q, q)  # shortest arc
    w = jnp.clip(q[..., 0], -1.0, 1.0)
    vn_sq = jnp.sum(q[..., 1:] ** 2, axis=-1)
    is_small = vn_sq < 1e-14
    vn = jnp.sqrt(jnp.where(is_small, 1.0, vn_sq))
    vn = jnp.where(is_small, 0.0, vn)
    theta = 2.0 * jnp.arctan2(vn, w)
    k = jnp.where(is_small, 2.0 / jnp.where(w == 0, 1.0, w), theta / jnp.where(is_small, 1.0, vn))
    return k[..., None] * q[..., 1:]


def to_matrix(q):
    """Quaternion (..., 4) -> rotation matrix (..., 3, 3)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r00 = 1 - 2 * (y * y + z * z)
    r01 = 2 * (x * y - w * z)
    r02 = 2 * (x * z + w * y)
    r10 = 2 * (x * y + w * z)
    r11 = 1 - 2 * (x * x + z * z)
    r12 = 2 * (y * z - w * x)
    r20 = 2 * (x * z - w * y)
    r21 = 2 * (y * z + w * x)
    r22 = 1 - 2 * (x * x + y * y)
    return jnp.stack(
        [
            jnp.stack([r00, r01, r02], axis=-1),
            jnp.stack([r10, r11, r12], axis=-1),
            jnp.stack([r20, r21, r22], axis=-1),
        ],
        axis=-2,
    )


def from_matrix(R):
    """Rotation matrix (..., 3, 3) -> quaternion (..., 4) via Shepperd."""
    return so3.matrix_to_quat(R)


# ---------------------------------------------------------------------------
# Pure-numpy host-side variants: calibration parsing (io/rectify.py,
# io/synthetic.py) and evaluation (eval/metrics.py) run on host in float64
# and must not trigger device dispatches.


def to_matrix_np(q):
    """(..., 4) wxyz -> (..., 3, 3) rotation matrices, pure numpy."""
    import numpy as np

    q = np.asarray(q)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    R = np.empty(q.shape[:-1] + (3, 3), q.dtype)
    R[..., 0, 0] = 1 - 2 * (y * y + z * z)
    R[..., 0, 1] = 2 * (x * y - w * z)
    R[..., 0, 2] = 2 * (x * z + w * y)
    R[..., 1, 0] = 2 * (x * y + w * z)
    R[..., 1, 1] = 1 - 2 * (x * x + z * z)
    R[..., 1, 2] = 2 * (y * z - w * x)
    R[..., 2, 0] = 2 * (x * z - w * y)
    R[..., 2, 1] = 2 * (y * z + w * x)
    R[..., 2, 2] = 1 - 2 * (x * x + y * y)
    return R


def from_matrix_np(R):
    """Single (3, 3) rotation matrix -> unit quaternion (4,) wxyz.

    Shepperd's method (largest-pivot branch), robust for any rotation
    including trace near -1 — the one matrix->quat implementation every
    host-side calibration path shares."""
    import numpy as np

    R = np.asarray(R, np.float64)
    w2 = 1.0 + R[0, 0] + R[1, 1] + R[2, 2]
    x2 = 1.0 + R[0, 0] - R[1, 1] - R[2, 2]
    y2 = 1.0 - R[0, 0] + R[1, 1] - R[2, 2]
    z2 = 1.0 - R[0, 0] - R[1, 1] + R[2, 2]
    m = max(w2, x2, y2, z2)
    if m == w2:
        w = 0.5 * np.sqrt(w2)
        q = [w, (R[2, 1] - R[1, 2]) / (4 * w), (R[0, 2] - R[2, 0]) / (4 * w),
             (R[1, 0] - R[0, 1]) / (4 * w)]
    elif m == x2:
        x = 0.5 * np.sqrt(x2)
        q = [(R[2, 1] - R[1, 2]) / (4 * x), x, (R[0, 1] + R[1, 0]) / (4 * x),
             (R[0, 2] + R[2, 0]) / (4 * x)]
    elif m == y2:
        y = 0.5 * np.sqrt(y2)
        q = [(R[0, 2] - R[2, 0]) / (4 * y), (R[0, 1] + R[1, 0]) / (4 * y), y,
             (R[1, 2] + R[2, 1]) / (4 * y)]
    else:
        z = 0.5 * np.sqrt(z2)
        q = [(R[1, 0] - R[0, 1]) / (4 * z), (R[0, 2] + R[2, 0]) / (4 * z),
             (R[1, 2] + R[2, 1]) / (4 * z), z]
    q = np.asarray(q, np.float64)
    return q / np.linalg.norm(q)
