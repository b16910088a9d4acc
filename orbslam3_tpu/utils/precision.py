"""Precision control for small-matrix geometry math.

On an H100, an f32 matmul or convolution at default precision may run on
the tensor cores in TF32 (10-bit mantissa, ~1e-3 relative error). That is
fine for products whose operands are exact in fewer bits (the bf16 +-1
Hamming matmul), but fatal for 3x3 rotation algebra, Jacobians,
normal-equation assembly and pixel-scale geometry. Every such product in
geometry/imu/optim/map goes through `matmul_hp`, which pins
`precision='highest'` (full f32).
"""
from functools import partial

import jax.numpy as jnp

matmul_hp = partial(jnp.matmul, precision="highest")


def einsum_hp(subscripts, *operands):
    return jnp.einsum(subscripts, *operands, precision="highest")
