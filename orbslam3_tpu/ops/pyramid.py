"""Image pyramid + separable Gaussian blur (XLA convs).

Replaces OpenCV ORB's internal pyramid (reference: stereo.rs:37-49 config —
8 levels, scale 1.2). Every level has a static, padded shape so the whole
front-end compiles once.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


def level_shapes(h, w, n_levels, scale):
    """Static per-level (h, w) sizes."""
    out = []
    for lv in range(n_levels):
        s = scale**lv
        out.append((int(round(h / s)), int(round(w / s))))
    return out


def gaussian_kernel_1d(sigma, radius):
    x = np.arange(-radius, radius + 1, dtype=np.float32)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return jnp.asarray(k / k.sum())


def blur(img, sigma=2.0, radius=3):
    """Separable Gaussian blur of (H, W) image; zero-padded.

    Full f32: a TF32 convolution would perturb the 0..255 intensities by
    ~0.1, enough to flip BRIEF comparisons between near-equal samples.
    """
    k = gaussian_kernel_1d(sigma, radius)
    x = img[None, None]  # NCHW
    kh = k.reshape(1, 1, -1, 1)
    kw = k.reshape(1, 1, 1, -1)
    conv = partial(jax.lax.conv_general_dilated, window_strides=(1, 1),
                   precision="highest")
    x = conv(x, kh, padding=[(radius, radius), (0, 0)])
    x = conv(x, kw, padding=[(0, 0), (radius, radius)])
    return x[0, 0]


def resize_bilinear(img, out_hw):
    return jax.image.resize(img, out_hw, method="bilinear")


@partial(jax.jit, static_argnames=("n_levels", "scale"))
def build_pyramid(img, n_levels=8, scale=1.2):
    """(H, W) f32 image -> tuple of per-level images (static shapes).

    Successive resize from the previous level (like OpenCV) rather than from
    level 0 — cheaper and slightly smoother at high levels.
    """
    h, w = img.shape
    shapes = level_shapes(h, w, n_levels, scale)
    levels = [img]
    for lv in range(1, n_levels):
        levels.append(resize_bilinear(levels[-1], shapes[lv]))
    return tuple(levels)
