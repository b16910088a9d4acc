"""Per-stage timing of the SLAM pipeline on the default backend."""
import sys, os; sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import time
import numpy as np
import jax, jax.numpy as jnp
from orbslam3_tpu.utils import compile_cache
compile_cache.enable()

from orbslam3_tpu.io.synthetic import SyntheticConfig, SyntheticWorld
from orbslam3_tpu.models.slam import SlamConfig, SlamSystem
from orbslam3_tpu.frontend.stereo import process_stereo
from orbslam3_tpu.frontend.orb import detect_orb

cfg = SyntheticConfig(duration=2.0, n_landmarks=1500)
world = SyntheticWorld(cfg)
slam_cfg = SlamConfig(use_imu=False, kf_max_frames=4)
slam = SlamSystem(world.cam, slam_cfg)
frames = [world.render_frame(t) for t in world.frame_times()[:30]]

def timeit(name, fn, n=10):
    fn()  # warm
    t0 = time.perf_counter()
    for _ in range(n):
        out = fn()
    jax.block_until_ready(out)
    print(f"{name}: {(time.perf_counter()-t0)/n*1e3:.1f} ms")

l, r = frames[0]
lj, rj = jnp.asarray(l), jnp.asarray(r)
timeit("detect_orb(left)", lambda: detect_orb(lj, slam_cfg.orb))
timeit("process_stereo", lambda: process_stereo(lj, rj, world.cam, slam_cfg.orb, slam_cfg.stereo))

# build some map state first
for i in range(12):
    li, ri = frames[i]
    slam.process_frame(li, ri, np.zeros((0,3)), np.zeros((0,3)), np.zeros(0), float(i)*0.05)

from orbslam3_tpu.models.tracker import match_local_map
from orbslam3_tpu.optim.pose_only import pose_optimize
sf = process_stereo(lj, rj, world.cam, slam_cfg.orb, slam_cfg.stereo)
timeit("match_local_map", lambda: match_local_map(slam.map, world.cam, sf.feat.uv, sf.feat.desc, sf.feat.octave, sf.feat.valid, slam.q, slam.p, slam_cfg.track))
matched, mp_w, vi, vo = match_local_map(slam.map, world.cam, sf.feat.uv, sf.feat.desc, sf.feat.octave, sf.feat.valid, slam.q, slam.p, slam_cfg.track)
timeit("pose_optimize", lambda: pose_optimize(slam.q, slam.p, world.cam, mp_w, sf.feat.uv, jnp.where(matched>=0, sf.u_right, -1.0), sf.feat.octave, matched>=0))

from orbslam3_tpu.models.local_mapper import local_ba_step
timeit("local_ba_step(w8,p2048)", lambda: local_ba_step(slam.map, world.cam, jnp.int32(slam.last_kf_id), window=8, max_points=2048, iters=8)[1], n=3)

from orbslam3_tpu.map.slam_map import cull_map_points
timeit("cull_map_points", lambda: cull_map_points(slam.map), n=3)

# full frame
t0 = time.perf_counter()
n = 10
for i in range(12, 12+n):
    li, ri = frames[i]
    slam.process_frame(li, ri, np.zeros((0,3)), np.zeros((0,3)), np.zeros(0), float(i)*0.05)
print(f"full process_frame: {(time.perf_counter()-t0)/n*1e3:.1f} ms")

# dispatch RTT estimate
x = jnp.ones((8,8))
f = jax.jit(lambda a: a+1)
f(x).block_until_ready()
t0=time.perf_counter()
for _ in range(20): f(x).block_until_ready()
print(f"tiny dispatch+sync RTT: {(time.perf_counter()-t0)/20*1e3:.2f} ms")
