"""FAST-16 corner detection + grid-constrained keypoint selection, pure XLA.

Replacement for OpenCV's FAST inside ORB (reference: stereo.rs:38-49).
Data-parallel formulation:

  * the 16-pixel Bresenham circle becomes 16 shifted copies of the image
    (elementwise, fused by XLA);
  * segment-of-9 contiguity is a 16-bit rotate/AND bit-trick instead of a
    per-pixel loop;
  * quadtree distribution (OpenCV) becomes per-cell top-k + per-level quota
    (fixed shapes, no data-dependent control flow) — SURVEY.md §7.3 item 4.

Score is the sum-of-absolute-differences over the circle (the standard GPU
formulation), used for NMS ranking and Harris-free selection.
"""
from __future__ import annotations

from functools import partial, reduce

import jax
import jax.numpy as jnp
import numpy as np

# 16-pixel Bresenham circle of radius 3, clockwise from 12 o'clock.
# (dy, dx) offsets — same circle as every FAST implementation.
CIRCLE = np.array(
    [
        (-3, 0), (-3, 1), (-2, 2), (-1, 3),
        (0, 3), (1, 3), (2, 2), (3, 1),
        (3, 0), (3, -1), (2, -2), (1, -3),
        (0, -3), (-1, -3), (-2, -2), (-3, -3 + 2),  # placeholder fixed below
    ],
    dtype=np.int32,
)
# correct last entry: (-3, -1)
CIRCLE[15] = (-3, -1)


def _shift2d(img, dy, dx):
    """Shift image so out[y, x] = img[y + dy, x + dx]; edges replicate.

    Static shifts — XLA lowers these to cheap slices + pads.
    """
    h, w = img.shape
    ys = jnp.clip(jnp.arange(h) + dy, 0, h - 1)
    xs = jnp.clip(jnp.arange(w) + dx, 0, w - 1)
    return img[ys][:, xs]


def fast_score(img, threshold: float):
    """FAST-16-9 corner response.

    Args:
      img: (H, W) float32 grayscale
      threshold: intensity difference threshold
    Returns:
      (H, W) float32 score map; 0 where not a corner.
    """
    center = img
    ring = jnp.stack([_shift2d(img, int(dy), int(dx)) for dy, dx in CIRCLE])  # (16,H,W)
    diff = ring - center[None]
    brighter = diff > threshold
    darker = diff < -threshold

    def seg9(mask16):
        """Any run of >=9 consecutive set bits on the 16-bit circle."""
        bits = jnp.zeros(img.shape, jnp.int32)
        for i in range(16):
            bits = bits | (mask16[i].astype(jnp.int32) << i)
        acc = bits
        for k in range(1, 9):
            rot = ((bits << k) | (bits >> (16 - k))) & 0xFFFF
            acc = acc & rot
        return acc != 0

    is_corner = seg9(brighter) | seg9(darker)

    # SAD score over the qualifying polarity, summed in a fixed left-to-
    # right order so every backend produces the same bits
    sad_b = reduce(jnp.add, list(jnp.maximum(diff - threshold, 0.0)))
    sad_d = reduce(jnp.add, list(jnp.maximum(-diff - threshold, 0.0)))
    score = jnp.maximum(sad_b, sad_d)
    return jnp.where(is_corner, score, 0.0)


def nms3x3(score):
    """3x3 non-maximum suppression: keep strict local maxima."""
    mx = jax.lax.reduce_window(
        score, -jnp.inf, jax.lax.max, (3, 3), (1, 1), "SAME"
    )
    return jnp.where(score >= mx, score, 0.0)


def mask_border(score, border: int, valid_h: int | None = None, valid_w: int | None = None):
    """Zero scores within `border` px of the (valid) image edge.

    valid_h/valid_w let padded images exclude the padding region too.
    """
    h, w = score.shape
    vh = valid_h if valid_h is not None else h
    vw = valid_w if valid_w is not None else w
    ys = jnp.arange(h)
    xs = jnp.arange(w)
    my = (ys >= border) & (ys < vh - border)
    mx = (xs >= border) & (xs < vw - border)
    return score * (my[:, None] & mx[None, :])


def corner_subpix(img, ys, xs, win: int = 4):
    """Gradient-based corner localization (cornerSubPix-style), batched.

    Solves sum_i w_i (grad I_i grad I_i^T)(x_i - p) = 0 over a (2win+1)^2
    window: the stationary point of the local gradient field, which is the
    exact saddle/corner location — unlike the FAST score peak, which sits
    1-2 px inside a quadrant. Returns (dy, dx) offsets from the integer
    keypoint, clamped to +-win.
    """
    from orbslam3_tpu.ops.brief import gather_patches

    size = 2 * win + 3  # +1 px margin each side for central differences
    P = gather_patches(img, ys, xs, size)  # (N, S, S)
    gx = 0.5 * (P[:, 1:-1, 2:] - P[:, 1:-1, :-2])  # (N, 2w+1, 2w+1)
    gy = 0.5 * (P[:, 2:, 1:-1] - P[:, :-2, 1:-1])
    r = jnp.arange(-win, win + 1, dtype=jnp.float32)
    Y, X = jnp.meshgrid(r, r, indexing="ij")
    w = jnp.exp(-(X**2 + Y**2) / (2.0 * (win / 1.5) ** 2))

    gxx = jnp.sum(w * gx * gx, axis=(1, 2))
    gxy = jnp.sum(w * gx * gy, axis=(1, 2))
    gyy = jnp.sum(w * gy * gy, axis=(1, 2))
    bx = jnp.sum(w * (gx * gx * X + gx * gy * Y), axis=(1, 2))
    by = jnp.sum(w * (gx * gy * X + gy * gy * Y), axis=(1, 2))
    det = gxx * gyy - gxy * gxy
    det_safe = jnp.where(jnp.abs(det) > 1e-6, det, 1e-6)
    dx = (gyy * bx - gxy * by) / det_safe
    dy = (gxx * by - gxy * bx) / det_safe
    ok = jnp.abs(det) > 1e-6
    dx = jnp.where(ok, jnp.clip(dx, -win, win), 0.0)
    dy = jnp.where(ok, jnp.clip(dy, -win, win), 0.0)
    return dy, dx


def subpixel_refine(score, ys, xs):
    """Quadratic (parabola) sub-pixel peak refinement on the score map.

    Returns (dy, dx) offsets in [-0.5, 0.5] for each integer peak. Integer
    FAST peaks carry ~0.5-2 px quantization error which, through stereo
    disparity, becomes meter-level depth error at range — this recovers
    most of it for ~free (two gathers + a few elementwise ops).
    """
    h, w = score.shape
    y0 = jnp.clip(ys, 1, h - 2)
    x0 = jnp.clip(xs, 1, w - 2)
    c = score[y0, x0]
    l = score[y0, x0 - 1]
    r = score[y0, x0 + 1]
    u = score[y0 - 1, x0]
    d = score[y0 + 1, x0]

    def para(m, c_, p):
        denom = m - 2.0 * c_ + p
        off = 0.5 * (m - p) / jnp.where(jnp.abs(denom) > 1e-6, denom, 1e-6)
        return jnp.clip(off, -0.5, 0.5)

    return para(u, c, d), para(l, c, r)


@partial(jax.jit, static_argnames=("cell", "k_cell", "n_out"))
def select_keypoints(score, cell: int = 32, k_cell: int = 4, n_out: int = 256):
    """Spatially-distributed top-k selection with fixed output shape.

    Per cell of `cell`x`cell` px keep the k_cell best responses, then take
    the global top n_out among those candidates. Returns (ys, xs, scores)
    each (n_out,); invalid slots have score 0.
    """
    h, w = score.shape
    ph = (-h) % cell
    pw = (-w) % cell
    s = jnp.pad(score, ((0, ph), (0, pw)))
    hh, ww = h + ph, w + pw
    gy, gx = hh // cell, ww // cell
    cells = s.reshape(gy, cell, gx, cell).transpose(0, 2, 1, 3).reshape(gy * gx, cell * cell)
    cv, ci = jax.lax.top_k(cells, k_cell)  # (ncells, k_cell)
    # cell-local index -> global pixel coords
    cyx = jnp.stack(jnp.meshgrid(jnp.arange(gy), jnp.arange(gx), indexing="ij"), -1).reshape(-1, 2)
    ys = cyx[:, 0:1] * cell + ci // cell
    xs = cyx[:, 1:2] * cell + ci % cell
    flat_v = cv.reshape(-1)
    flat_y = ys.reshape(-1)
    flat_x = xs.reshape(-1)
    n_cand = flat_v.shape[0]
    k = min(n_out, n_cand)
    top_v, top_i = jax.lax.top_k(flat_v, k)
    out_y = flat_y[top_i]
    out_x = flat_x[top_i]
    if k < n_out:
        pad = n_out - k
        top_v = jnp.concatenate([top_v, jnp.zeros(pad, top_v.dtype)])
        out_y = jnp.concatenate([out_y, jnp.zeros(pad, out_y.dtype)])
        out_x = jnp.concatenate([out_x, jnp.zeros(pad, out_x.dtype)])
    return out_y, out_x, top_v
