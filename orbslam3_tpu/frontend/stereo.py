"""Epipolar-constrained stereo matching + disparity depth, one XLA program.

Capability parity with /root/reference/src/tracking/frame/stereo.rs:84-216
(row-constrained L<->R ORB matching with disparity bounds, z = fx*b/d),
re-designed as a dense masked cost matrix + mutual argmin — no per-feature
loops, matmul Hamming distances (ops/hamming.py).
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from orbslam3_tpu.frontend.camera import Camera
from orbslam3_tpu.frontend.orb import Features, OrbConfig, detect_orb_pair
from orbslam3_tpu.ops.hamming import hamming_matrix


class StereoConfig(NamedTuple):
    max_hamming: int = 80  # absolute descriptor gate (ref TH_HIGH=100)
    ratio: float = 0.9  # best/second-best gate
    row_margin: float = 2.0  # vertical epipolar tolerance [px] (ref ±2)
    min_depth: float = 0.3  # [m]
    max_depth: float = 60.0  # [m]
    octave_tol: int = 1


class StereoFrame(NamedTuple):
    """Stereo-processed frame: left features + right matches + depth."""

    feat: Features  # left-image features
    u_right: jnp.ndarray  # (N,) right-image u coord, -1 if unmatched
    depth: jnp.ndarray  # (N,) metric depth, -1 if unmatched
    points_cam: jnp.ndarray  # (N, 3) camera-frame 3D points (garbage if no depth)
    has_depth: jnp.ndarray  # (N,) bool


@partial(jax.jit, static_argnames=("cfg",))
def match_stereo(left: Features, right: Features, cam: Camera, cfg: StereoConfig = StereoConfig()):
    """Match left->right with epipolar/disparity gates.

    Returns (u_right, depth, has_depth) each (N,) aligned with left features.
    """
    D = hamming_matrix(left.desc, right.desc).astype(jnp.float32)  # (N, M)

    du = left.uv[:, 0:1] - right.uv[None, :, 0]  # disparity candidates
    dv = jnp.abs(left.uv[:, 1:2] - right.uv[None, :, 1])
    oct_ok = jnp.abs(left.octave[:, None] - right.octave[None, :]) <= cfg.octave_tol
    min_disp = cam.bf / cfg.max_depth
    max_disp = cam.bf / cfg.min_depth
    # scale row tolerance with octave (coarser levels are less precise)
    tol = cfg.row_margin * (1.2 ** left.octave.astype(jnp.float32))[:, None]
    mask = (
        left.valid[:, None]
        & right.valid[None, :]
        & oct_ok
        & (dv <= tol)
        & (du >= min_disp)
        & (du <= max_disp)
    )
    BIG = 1e6
    cost = jnp.where(mask, D, BIG)

    # best + second-best along rows
    neg = -cost
    top2, idx2 = jax.lax.top_k(neg, 2)
    best = -top2[:, 0]
    second = -top2[:, 1]
    j_best = idx2[:, 0]

    # mutual consistency: left i's best right j must prefer i among lefts
    i_best_of_j = jnp.argmin(cost, axis=0)  # (M,)
    mutual = i_best_of_j[j_best] == jnp.arange(cost.shape[0])

    ok = (
        (best <= cfg.max_hamming)
        & (best <= cfg.ratio * jnp.minimum(second, BIG - 1.0))
        & mutual
        & (best < BIG)
    )

    u_r = right.uv[j_best, 0]
    disp = jnp.clip(left.uv[:, 0] - u_r, 1e-3, None)
    depth = cam.bf / disp
    u_r = jnp.where(ok, u_r, -1.0)
    depth = jnp.where(ok, depth, -1.0)
    return u_r, depth, ok


def process_stereo(
    img_left,
    img_right,
    cam: Camera,
    orb_cfg: OrbConfig = OrbConfig(),
    stereo_cfg: StereoConfig = StereoConfig(),
) -> StereoFrame:
    """Full stereo front-end: detect both images, match, triangulate.

    (reference: StereoProcessor::process, stereo.rs:52)
    """
    left, right = detect_orb_pair(img_left, img_right, orb_cfg)
    u_r, depth, has_depth = match_stereo(left, right, cam, stereo_cfg)
    pts = cam.unproject(left.uv, jnp.where(has_depth, depth, 1.0))
    return StereoFrame(feat=left, u_right=u_r, depth=depth, points_cam=pts, has_depth=has_depth)
