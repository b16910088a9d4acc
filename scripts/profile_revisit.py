"""Per-frame wall-time series of the revisit bench run.

Buckets frame latency by sequence time so loop-closing service spikes
(detection, Sim3 verify, pose graph + GBA) are visible against the
steady-state tracking rate. Used to find the first-compile stalls that
motivated LoopCloser.warmup()."""
import sys, os, time
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np
import jax
from orbslam3_tpu.utils import compile_cache
compile_cache.enable()

from bench import build_revisit_world, train_world_vocab, build_world, run_pipeline
from orbslam3_tpu.models.slam import SlamConfig
from orbslam3_tpu.models.fused import FusedSlam

slam_cfg = SlamConfig(use_imu=True, kf_max_frames=4, lost_timeout=5.0)

# warmup on the short world exactly as bench.py does
world, times, frames, imu = build_world(8.0)
vocab = train_world_vocab(world, frames)
run_pipeline(world, times, frames, imu, slam_cfg, vocab=vocab)
print("warmup done", flush=True)

rw, rtimes, rframes, rimu = build_revisit_world()
r_vocab = train_world_vocab(rw, rframes)
print("vocab leaves:", r_vocab.leaf_desc.shape if hasattr(r_vocab, 'leaf_desc') else type(r_vocab),
      flush=True)

slam = FusedSlam(rw.cam, slam_cfg, service_every=8, chunk=4, vocabulary=r_vocab,
                 warmup=True)
t_prev = time.perf_counter()
stamps = []
for i in range(len(rtimes)):
    g, a, d = rimu[i]
    slam.process_frame(rframes[i][0], rframes[i][1], g, a, d, float(rtimes[i]))
    now = time.perf_counter()
    stamps.append(now - t_prev)
    t_prev = now
slam.finalize()
jax.block_until_ready(slam.ts.q)

a = np.array(stamps)
print(f"total {a.sum():.1f}s  n={len(a)}  mean {a.mean()*1e3:.0f}ms  median {np.median(a)*1e3:.0f}ms")
idx = np.argsort(a)[-25:][::-1]
for i in idx:
    print(f"  frame {i:3d} t={rtimes[i]:6.2f}s : {a[i]*1e3:8.0f} ms")
# bucket by 1s of sequence time
print("per-second buckets (ms/frame):")
for s in range(0, 24, 2):
    m = (np.asarray(rtimes) >= s) & (np.asarray(rtimes) < s + 2)
    if m.any():
        print(f"  t[{s:2d},{s+2:2d}) : {a[m].mean()*1e3:7.0f} ms/frame")
