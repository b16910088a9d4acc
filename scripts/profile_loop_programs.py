"""Time the loop-closer keyframe program on the default backend."""
import sys, os, time; sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np
import jax, jax.numpy as jnp
from orbslam3_tpu.utils import compile_cache
compile_cache.enable()

from orbslam3_tpu.loop import vocab as vb
from orbslam3_tpu.loop.closer import LoopCloser, LoopConfig

rng = np.random.default_rng(0)
corpus = rng.integers(0, 256, (20000, 32)).astype(np.uint8)
voc = vb.train_vocabulary(corpus, k=10, levels=4)
lc = LoopCloser(voc, LoopConfig())

K, N, L = 256, 1024, 1024
kf_valid = jnp.ones((K,), bool)
kf_map = jnp.zeros((K,), jnp.int32)
covis = jnp.zeros((K, K), jnp.int32)
kf_desc = jnp.asarray(rng.integers(0, 256, (K, N, 32)).astype(np.uint8))
kf_fv = jnp.ones((K, N), bool)
bow_ids = jnp.full((K, N), -1, jnp.int32)
bow_w = jnp.zeros((K, N), jnp.float32)


def call(bi, bw, Kb):
    return lc._kf_program(
        bi, bw, kf_desc, kf_fv, kf_valid, kf_map, covis,
        jnp.int32(200), jnp.int32(15), jnp.int32(50), jnp.int32(1), Kb=Kb,
    )


for Kb in (64, 128, 256):
    bi, bw = bow_ids + 0, bow_w + 0.0
    bi, bw, packet, group = call(bi, bw, Kb)
    jax.block_until_ready(packet)
    t0 = time.perf_counter()
    M = 20
    for _ in range(M):
        bi, bw, packet, group = call(bi, bw, Kb)
    jax.block_until_ready(packet)
    dt = (time.perf_counter() - t0) / M * 1e3
    print(f"kf_program (Kb={Kb}, N={N}): {dt:.1f} ms/call (pipelined)")

    # fetch cost on top
    t0 = time.perf_counter()
    for _ in range(M):
        bi, bw, packet, group = call(bi, bw, Kb)
        _ = jax.device_get((packet, group))
    dt = (time.perf_counter() - t0) / M * 1e3
    print(f"kf_program + sync fetch (Kb={Kb}): {dt:.1f} ms/call")
