"""No-prior robust pose estimation: batched 3D-3D RANSAC.

Plays the role of the reference's PnP-RANSAC
(/root/reference/src/geometry/pnp.rs:29-137 — sequential hypothesis loop,
EPnP minimal solves, early exit) for recovery when the motion prior is
wrong and projection matching has nothing to anchor on.

A redesign rather than a port: the stereo frontend backprojects
hundreds of features to body-frame 3D, so the minimal problem becomes
3-point RIGID ALIGNMENT (Horn 1987, closed-form quaternion from a 4x4
eigendecomposition) instead of P3P's quartic. All H hypotheses solve as ONE
vmapped eigh of (H, 4, 4) matrices and score as one (H, N) distance matrix
— no data-dependent loop, no early exit, fixed shapes.

Inlier thresholds are depth-aware: stereo depth error grows ~ z^2/(fx*b),
so a fixed metric radius would reject everything far and accept everything
near.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from orbslam3_tpu.geometry import quat
from orbslam3_tpu.utils.precision import einsum_hp


def _horn_quat(a, b, w):
    """Rotation quaternion q (b ~= R(q) a) from weighted correspondences.

    a, b: (K, 3) centered point sets; w: (K,) weights.
    Returns the unit quaternion maximizing sum_i w_i b_i . (R a_i).
    """
    M = einsum_hp("k,ki,kj->ij", w, a, b)  # (3, 3)
    # Horn's N matrix; its top eigenvector is the optimal quaternion
    # rotating a into b (for M = sum a b^T).
    N = jnp.array(
        [
            [M[0, 0] + M[1, 1] + M[2, 2], M[1, 2] - M[2, 1],
             M[2, 0] - M[0, 2], M[0, 1] - M[1, 0]],
            [M[1, 2] - M[2, 1], M[0, 0] - M[1, 1] - M[2, 2],
             M[0, 1] + M[1, 0], M[2, 0] + M[0, 2]],
            [M[2, 0] - M[0, 2], M[0, 1] + M[1, 0],
             -M[0, 0] + M[1, 1] - M[2, 2], M[1, 2] + M[2, 1]],
            [M[0, 1] - M[1, 0], M[2, 0] + M[0, 2],
             M[1, 2] + M[2, 1], -M[0, 0] - M[1, 1] + M[2, 2]],
        ]
    )
    _, vecs = jnp.linalg.eigh(N)  # ascending eigenvalues
    q = vecs[:, -1]
    return quat.normalize(q * jnp.where(q[0] < 0, -1.0, 1.0))


def _weighted_horn(Xw, Xb, w):
    """Full weighted rigid fit: (q_bw, t) with Xb ~= R(q_bw) Xw + t."""
    wsum = jnp.maximum(jnp.sum(w), 1e-6)
    cw = einsum_hp("k,ki->i", w, Xw) / wsum
    cb = einsum_hp("k,ki->i", w, Xb) / wsum
    q_bw = _horn_quat(Xw - cw, Xb - cb, w)
    t = cb - quat.rotate(q_bw, cw)
    return q_bw, t


def robust_pose_3d3d(
    Xw,
    Xb,
    valid,
    key,
    cam_bf,
    cam_fx,
    n_hyp: int = 128,
    px_tol: float = 4.0,
):
    """Batched-RANSAC body pose from 3D-3D correspondences.

    Args:
      Xw: (N, 3) matched map-point world positions
      Xb: (N, 3) stereo-backprojected body-frame positions of the features
      valid: (N,) bool — correspondence usable (matched AND has depth)
      key: PRNG key (fold in the frame id for per-frame diversity)
      cam_bf: fx * baseline [px*m]; cam_fx: focal length [px]
      n_hyp: hypotheses (all solved in one vmapped eigh)
      px_tol: pixel-equivalent tolerance. Stereo 3D noise is ANISOTROPIC:
        along the viewing ray it grows as z^2/(fx*b) per disparity pixel,
        laterally only as z/fx per image pixel — so the inlier gate splits
        the residual into ray-parallel and ray-perpendicular components
        with separate radii (an isotropic metric radius either rejects
        every far point or accepts gross lateral error).
    Returns:
      q_wb (4,), p_wb (3,), inlier_mask (N,), n_inliers () — identity pose
      with 0 inliers when fewer than 3 valid correspondences exist.
    """
    N = Xw.shape[0]
    nv = jnp.sum(valid.astype(jnp.int32))

    # valid-first index order so uniform draws in [0, nv) hit real rows
    _, order = jax.lax.top_k(valid.astype(jnp.float32), N)
    draws = jax.random.randint(key, (n_hyp, 3), 0, jnp.maximum(nv, 1))
    idx = order[draws]  # (H, 3)
    aw = Xw[idx]  # (H, 3, 3)
    ab = Xb[idx]

    # degenerate triples (collinear / duplicate draws) are solved anyway
    # and simply score badly; duplicates within a triple are rejected
    distinct = (
        (draws[:, 0] != draws[:, 1])
        & (draws[:, 1] != draws[:, 2])
        & (draws[:, 0] != draws[:, 2])
    )
    area = jnp.linalg.norm(
        jnp.cross(aw[:, 1] - aw[:, 0], aw[:, 2] - aw[:, 0]), axis=-1
    )
    hyp_ok = distinct & (area > 1e-4) & (nv >= 3)

    cw = jnp.mean(aw, axis=1, keepdims=True)
    cb = jnp.mean(ab, axis=1, keepdims=True)
    ones3 = jnp.ones((3,), jnp.float32)
    q_h = jax.vmap(_horn_quat)(aw - cw, ab - cb, jnp.tile(ones3, (n_hyp, 1)))
    t_h = cb[:, 0] - jax.vmap(quat.rotate)(q_h, cw[:, 0])  # (H, 3)

    # dense scoring: (H, N) anisotropic residuals
    z = jnp.maximum(Xb[..., 2], 0.3)
    thr_par = jnp.maximum(px_tol * z * z / cam_bf, 0.02)  # along-ray (N,)
    thr_perp = jnp.maximum(px_tol * z / cam_fx, 0.01)  # lateral (N,)
    u = Xb / jnp.maximum(jnp.linalg.norm(Xb, axis=-1, keepdims=True), 1e-6)

    def gate(d):  # d: (N, 3) residuals in the body frame
        e_par = jnp.sum(d * u, axis=-1)
        e_perp = jnp.linalg.norm(d - e_par[:, None] * u, axis=-1)
        return (jnp.abs(e_par) <= thr_par) & (e_perp <= thr_perp)

    pred = (
        jax.vmap(lambda q, t: quat.rotate(q[None], Xw) + t[None])(q_h, t_h)
    )  # (H, N, 3)
    inl = jax.vmap(gate)(pred - Xb[None]) & valid[None]  # (H, N)
    scores = jnp.where(hyp_ok, jnp.sum(inl.astype(jnp.int32), axis=1), 0)

    best = jnp.argmax(scores)
    # refine: one weighted Horn over the best hypothesis's inliers
    w_in = inl[best].astype(jnp.float32)
    q_ref, t_ref = _weighted_horn(Xw, Xb, w_in)
    inl_r = gate(quat.rotate(q_ref[None], Xw) + t_ref[None] - Xb) & valid
    n_r = jnp.sum(inl_r.astype(jnp.int32))
    # keep the refinement only if it didn't lose inliers
    use_ref = n_r >= scores[best]
    q_bw = jnp.where(use_ref, q_ref, q_h[best])
    t = jnp.where(use_ref, t_ref, t_h[best])
    inliers = jnp.where(use_ref, inl_r, inl[best])
    n_inl = jnp.where(use_ref, n_r, scores[best])

    # body pose from the (b <- w) alignment: p_wb = -R^T t, q_wb = q^-1
    q_wb = quat.normalize(quat.conj(q_bw))
    p_wb = -quat.rotate(q_wb, t)
    found = scores[best] >= 3
    q_wb = jnp.where(found, q_wb, quat.identity())
    p_wb = jnp.where(found, p_wb, jnp.zeros(3))
    return q_wb, p_wb, inliers & found, jnp.where(found, n_inl, 0)
