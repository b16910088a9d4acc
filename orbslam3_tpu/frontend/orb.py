"""ORB detection over the pyramid -> fixed-size Features struct.

Capability parity with OpenCV ORB as configured by the reference
(stereo.rs:37-49: 1200 features, scale 1.2, 8 levels, FAST threshold 20),
re-designed for XLA: per-level static quotas (area-proportional, replacing
OpenCV's per-level distribution), grid top-k selection (replacing quadtree
NMS), and one jitted program for the whole extraction.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from orbslam3_tpu.ops import fast as fast_ops
from orbslam3_tpu.ops import brief as brief_ops
from orbslam3_tpu.ops import pyramid as pyr_ops

BORDER = brief_ops.GHALF + 2  # keep full descriptor gather in-bounds


class OrbConfig(NamedTuple):
    n_features: int = 1024
    n_levels: int = 8
    scale_factor: float = 1.2
    fast_threshold: float = 20.0
    fast_threshold_min: float = 7.0
    cell: int = 32
    k_cell: int = 6


class Features(NamedTuple):
    """Fixed-capacity feature set for one image (padded, mask-validated)."""

    uv: jnp.ndarray  # (N, 2) level-0 pixel coords (u=x, v=y)
    response: jnp.ndarray  # (N,)
    octave: jnp.ndarray  # (N,) int32 pyramid level
    angle: jnp.ndarray  # (N,) radians
    desc: jnp.ndarray  # (N, 32) uint8 packed BRIEF
    valid: jnp.ndarray  # (N,) bool

    @property
    def n(self):
        return self.uv.shape[0]


def level_quotas(cfg: OrbConfig):
    """Static per-level feature quotas, area-proportional (sums to n_features)."""
    inv = [1.0 / (cfg.scale_factor ** (2 * lv)) for lv in range(cfg.n_levels)]
    total = sum(inv)
    quotas = [max(8, int(round(cfg.n_features * w / total))) for w in inv]
    # fix rounding drift on level 0
    quotas[0] += cfg.n_features - sum(quotas)
    return quotas


@partial(jax.jit, static_argnames=("cfg",))
def detect_orb(img, cfg: OrbConfig = OrbConfig()) -> Features:
    """(H, W) f32 grayscale -> Features with n_features slots."""
    levels = pyr_ops.build_pyramid(img, cfg.n_levels, cfg.scale_factor)
    scores = [s[0] for s in _score_maps_batched([lv[None] for lv in levels], cfg)]
    return _select_impl(levels, scores, cfg)


def detect_orb_batch(imgs, cfg: OrbConfig = OrbConfig()) -> Features:
    """(B, H, W) f32 -> Features with a leading batch axis B.

    The per-level kernels are small, so batching B same-shape images
    divides the kernel launches per image by B with no padding (batching
    pyramid LEVELS instead would pad every level to level 0's shape).
    """
    levels_b = jax.vmap(
        lambda im: pyr_ops.build_pyramid(im, cfg.n_levels, cfg.scale_factor)
    )(imgs)
    scores_b = _score_maps_batched(levels_b, cfg)
    return jax.vmap(lambda lvls, scs: _select_impl(list(lvls), list(scs), cfg))(
        tuple(levels_b), tuple(scores_b)
    )


@partial(jax.jit, static_argnames=("cfg",))
def detect_orb_pair(left, right, cfg: OrbConfig = OrbConfig()):
    """Detect on BOTH stereo images in one batched program.

    Returns (Features_left, Features_right).
    """
    f = detect_orb_batch(jnp.stack([left, right]), cfg)
    featL = jax.tree.map(lambda a: a[0], f)
    featR = jax.tree.map(lambda a: a[1], f)
    return featL, featR


def _score_maps_batched(levels_b, cfg: OrbConfig):
    """Per-level NMS'd dual-threshold FAST scores for a batch of pyramids.

    levels_b: list over pyramid levels of (B, h_lv, w_lv) images.
    """

    def one(im):
        score = fast_ops.fast_score(im, cfg.fast_threshold)
        # low-threshold fallback where the strict map is empty-ish:
        # attenuated low-threshold max, so weak corners only win
        # where no strong corner exists in the cell.
        score_lo = fast_ops.fast_score(im, cfg.fast_threshold_min) * 1e-3
        return fast_ops.nms3x3(jnp.maximum(score, score_lo))

    return [jax.vmap(one)(lv_imgs) for lv_imgs in levels_b]


def _select_impl(levels, scores, cfg: OrbConfig) -> Features:
    quotas = level_quotas(cfg)

    parts = []
    for lv, (lv_img, score) in enumerate(zip(levels, scores)):
        scale = cfg.scale_factor**lv
        score = fast_ops.mask_border(score, BORDER)
        ys, xs, resp = fast_ops.select_keypoints(
            score, cell=max(8, int(cfg.cell / scale ** 0.5)), k_cell=cfg.k_cell, n_out=quotas[lv]
        )
        dy, dx = fast_ops.corner_subpix(lv_img, ys, xs)
        blurred = pyr_ops.blur(lv_img)
        # ONE patch gather serves both orientation and descriptor; the
        # intensity-centroid moments are insensitive to the sigma~2 blur
        patches_blur = brief_ops.gather_patches(blurred, ys, xs, brief_ops.GATHER)
        ang = brief_ops.orientations_from_patches(patches_blur)
        desc = brief_ops.descriptors_from_patches(patches_blur, ang)
        uv = (
            jnp.stack([xs.astype(jnp.float32) + dx, ys.astype(jnp.float32) + dy], -1)
            * scale
        )
        parts.append(
            Features(
                uv=uv,
                response=resp,
                octave=jnp.full(quotas[lv], lv, jnp.int32),
                angle=ang,
                desc=desc,
                valid=resp > 0,
            )
        )
    return Features(*[jnp.concatenate([getattr(p, f) for p in parts]) for f in Features._fields])
