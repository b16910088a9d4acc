"""Hamming distance between binary descriptors — as a matmul.

Replaces the reference's per-byte popcount loop (stereo.rs:166-175, called
O(N*k) per frame) and OpenCV BFMatcher (tracker.rs:1001-1010) with one batched
distance *matrix*:

    d(i, j) = (256 - <u_i, v_j>) / 2,  u, v ∈ {-1, +1}^256

Sums of ±1 over 256 dims are exactly representable in bf16×bf16→f32
accumulation, so this is exact, and a (1024, 256) x (256, 1024) matmul is
~0.54 GFLOP. A lax.population_count path is kept as the reference
implementation for tests.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from orbslam3_tpu.ops.brief import unpack_pm1


def hamming_matrix(desc_a, desc_b):
    """(Na, 32) u8 x (Nb, 32) u8 -> (Na, Nb) int32 Hamming distances."""
    ua = unpack_pm1(desc_a)
    ub = unpack_pm1(desc_b)
    dot = jnp.dot(ua, ub.T, preferred_element_type=jnp.float32)
    return ((256.0 - dot) * 0.5).astype(jnp.int32)


def hamming_matrix_popcount(desc_a, desc_b):
    """Exact reference path via lax.population_count."""
    a = desc_a[:, None, :].astype(jnp.uint8)
    b = desc_b[None, :, :].astype(jnp.uint8)
    x = jax.lax.population_count(a ^ b)
    return jnp.sum(x.astype(jnp.int32), axis=-1)


def hamming_pairs(desc_a, desc_b):
    """Row-wise distance between aligned descriptor arrays: (N, 32)x2 -> (N,)."""
    x = jax.lax.population_count(desc_a ^ desc_b)
    return jnp.sum(x.astype(jnp.int32), axis=-1)
