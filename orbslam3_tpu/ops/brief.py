"""Oriented BRIEF descriptors + intensity-centroid orientation, batched.

Replacement for OpenCV ORB's steered-BRIEF stage (reference calls
it via stereo.rs:68-78). Differences by design:

  * the 256-pair sampling pattern is our own deterministic Gaussian BRIEF
    pattern (seeded, module constant) — NOT OpenCV's learned table. The whole
    engine (matching, vocabulary, loop closing) is self-consistent with it.
  * per-keypoint work is a vmapped patch gather + bilinear sampling —
    thousands of keypoints process as one fused program.

Descriptors are bit-packed to (N, 32) uint8, plus an "unpacked" ±1 bf16 view
(N, 256) used by the Hamming matmul (ops/hamming.py).
"""
from __future__ import annotations


import jax
import jax.numpy as jnp
import numpy as np

from orbslam3_tpu.utils.precision import matmul_hp

PATCH = 31  # descriptor patch diameter (level pixels)
HALF = PATCH // 2
ORI_RADIUS = 15  # intensity-centroid radius
# gather radius: descriptor points can rotate up to sqrt(2)*HALF from center
GATHER = 37
GHALF = GATHER // 2

# Module constants are numpy: importing the package allocates nothing on a
# device (render workers import it too).
_rng = np.random.default_rng(42)
# BRIEF pattern: 256 (p, q) pairs ~ N(0, (PATCH/5)^2), clipped to the patch.
_pat = np.clip(_rng.normal(0.0, PATCH / 5.0, size=(256, 2, 2)), -HALF, HALF)
BRIEF_PATTERN = _pat.astype(np.float32)  # (256, 2 points, (x,y))

# circular mask offsets for orientation moments
_yy, _xx = np.mgrid[-ORI_RADIUS : ORI_RADIUS + 1, -ORI_RADIUS : ORI_RADIUS + 1]
_circ = (_yy**2 + _xx**2) <= ORI_RADIUS**2
ORI_MASK = _circ.astype(np.float32)  # (31, 31)
ORI_X = (_xx * _circ).astype(np.float32)
ORI_Y = (_yy * _circ).astype(np.float32)


def gather_patches(img, ys, xs, size: int):
    """Extract size x size patches centered at integer (ys, xs).

    Coordinates are clamped so border keypoints stay in-bounds (callers mask
    border keypoints out at detection time anyway).
    """
    h, w = img.shape
    half = size // 2
    y0 = jnp.clip(ys - half, 0, h - size)
    x0 = jnp.clip(xs - half, 0, w - size)

    def one(y, x):
        return jax.lax.dynamic_slice(img, (y, x), (size, size))

    return jax.vmap(one)(y0.astype(jnp.int32), x0.astype(jnp.int32))


def orientations(img, ys, xs):
    """Intensity-centroid angle per keypoint: atan2(m01, m10). (N,) radians."""
    patches = gather_patches(img, ys, xs, 2 * ORI_RADIUS + 1)  # (N, 31, 31)
    return orientations_from_patches(patches)


def _moment_weights(S):
    """(S*S, 2) moment weight matrix embedding the 31x31 circular mask.

    Returns NUMPY (cached as numpy): caching a jnp array created inside a
    jit trace leaks a tracer into later traces."""
    off = (S - (2 * ORI_RADIUS + 1)) // 2
    W = np.zeros((S, S, 2), np.float32)
    W[off : off + 31, off : off + 31, 0] = np.asarray(ORI_X)
    W[off : off + 31, off : off + 31, 1] = np.asarray(ORI_Y)
    return W.reshape(S * S, 2)


_MOMENT_W = {}


def orientations_from_patches(patches):
    """Intensity-centroid angles from pre-gathered square patches.

    Accepts (N, S, S) with S >= 31 (central 31x31 window used). Formulated
    as ONE (N, S^2) x (S^2, 2) matmul. The moments sum ~700 products of
    0..255 intensities and offsets up to 15, so a TF32 product (10-bit
    mantissa) would move the angle by up to ~1e-2 rad near symmetric
    patches: full f32.
    """
    N, S, _ = patches.shape
    if S not in _MOMENT_W:
        _MOMENT_W[S] = _moment_weights(S)
    m = matmul_hp(patches.reshape(N, S * S), jnp.asarray(_MOMENT_W[S]))
    return jnp.arctan2(m[:, 1], m[:, 0])


def _bilinear(patch, y, x):
    """Sample (GATHER, GATHER) patch at float coords (center-origin)."""
    fy = y + GHALF
    fx = x + GHALF
    y0 = jnp.clip(jnp.floor(fy).astype(jnp.int32), 0, GATHER - 2)
    x0 = jnp.clip(jnp.floor(fx).astype(jnp.int32), 0, GATHER - 2)
    wy = fy - y0
    wx = fx - x0
    v00 = patch[y0, x0]
    v01 = patch[y0, x0 + 1]
    v10 = patch[y0 + 1, x0]
    v11 = patch[y0 + 1, x0 + 1]
    return (
        v00 * (1 - wy) * (1 - wx)
        + v01 * (1 - wy) * wx
        + v10 * wy * (1 - wx)
        + v11 * wy * wx
    )


def descriptors(img, ys, xs, angles):
    """Steered-BRIEF: (N, 32) uint8 packed descriptors.

    img should be pre-blurred (sigma~2) for noise robustness, like OpenCV.
    """
    patches = gather_patches(img, ys, xs, GATHER)  # (N, G, G)
    return descriptors_from_patches(patches, angles)


def descriptors_from_patches(patches, angles):
    """Steered-BRIEF from pre-gathered (N, G, G) patches.

    Rotated pattern points are sampled nearest-neighbor (what OpenCV ORB's
    integer lookup does). The sampling "gather" is formulated as two
    one-hot contractions — a row-selection batched bf16 matmul followed by
    a masked column reduction. Each output sums exactly one nonzero
    product, so the result is the bf16-rounded sample on every backend.
    """
    N = patches.shape[0]
    ca = jnp.cos(angles)
    sa = jnp.sin(angles)

    px = BRIEF_PATTERN[..., 0]  # (256, 2)
    py = BRIEF_PATTERN[..., 1]
    rx = ca[:, None, None] * px[None] - sa[:, None, None] * py[None]  # (N, 256, 2)
    ry = sa[:, None, None] * px[None] + ca[:, None, None] * py[None]

    ix = jnp.clip(jnp.round(rx).astype(jnp.int32) + GHALF, 0, GATHER - 1).reshape(N, 512)
    iy = jnp.clip(jnp.round(ry).astype(jnp.int32) + GHALF, 0, GATHER - 1).reshape(N, 512)
    oy = jax.nn.one_hot(iy, GATHER, dtype=jnp.bfloat16)  # (N, 512, G)
    ox = jax.nn.one_hot(ix, GATHER, dtype=jnp.bfloat16)
    rows = jnp.einsum(
        "nsy,nyx->nsx", oy, patches.astype(jnp.bfloat16),
        preferred_element_type=jnp.float32,
    )  # (N, 512, G): the sampled row per pattern point
    vals = jnp.sum(rows * ox.astype(jnp.float32), axis=-1).reshape(N, 256, 2)
    bits = (vals[..., 0] < vals[..., 1]).astype(jnp.uint8)  # (N, 256)
    return pack_bits(bits)


def pack_bits(bits):
    """(N, 256) {0,1} -> (N, 32) uint8, LSB-first within each byte."""
    n = bits.shape[0]
    b = bits.reshape(n, 32, 8)
    weights = (1 << jnp.arange(8, dtype=jnp.uint32)).astype(jnp.uint32)
    return jnp.sum(b.astype(jnp.uint32) * weights[None, None], axis=-1).astype(jnp.uint8)


def unpack_bits(desc):
    """(N, 32) uint8 -> (N, 256) {0,1} uint8, LSB-first."""
    n = desc.shape[0]
    shifts = jnp.arange(8, dtype=jnp.uint8)
    b = (desc[..., None] >> shifts[None, None]) & 1
    return b.reshape(n, 256)


def unpack_pm1(desc):
    """(N, 32) uint8 -> (N, 256) ±1 bfloat16 for the Hamming matmul."""
    return (unpack_bits(desc).astype(jnp.bfloat16) * 2.0 - 1.0)
