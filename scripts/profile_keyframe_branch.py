"""Time the keyframe-branch components on the default backend."""
import sys, os, time; sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np
import jax, jax.numpy as jnp
from orbslam3_tpu.utils import compile_cache
compile_cache.enable()

from orbslam3_tpu.io.synthetic import SyntheticConfig, SyntheticWorld
from orbslam3_tpu.models.slam import SlamConfig
from orbslam3_tpu.models.fused import FusedSlam
from orbslam3_tpu.models.local_mapper import build_vi_ba_problem, build_ba_problem
from orbslam3_tpu.optim.vi_ba import solve_vi_ba
from orbslam3_tpu.optim.local_ba import solve_local_ba
from orbslam3_tpu.map.triangulation import triangulate_with_neighbor
from orbslam3_tpu.map.mapping_ops import fuse_map_points, update_point_stats, keyframe_redundancy
from orbslam3_tpu.map import slam_map as sm

cfg = SyntheticConfig(duration=3.0, n_landmarks=1500)
world = SyntheticWorld(cfg)
times_ = world.frame_times()
N = 48
frames = [tuple(x.astype(np.uint8) for x in world.render_frame(t)) for t in times_[:N]]
imu = []
for i in range(N):
    t_prev = times_[i-1] if i > 0 else times_[i]
    imu.append(world.imu_window(t_prev, times_[i]))

slam_cfg = SlamConfig(use_imu=True, kf_max_frames=4)
slam = FusedSlam(world.cam, slam_cfg, service_every=8, chunk=1)
for i in range(N):
    g, a, d = imu[i]
    slam.process_frame(frames[i][0], frames[i][1], g, a, d, float(times_[i]))
jax.block_until_ready(slam.ts.q)
st, ts, cam = slam.map, slam.ts, slam.cam
kf = jnp.int32(int(st.n_kf) - 1)
print("kfs:", int(st.n_kf), "mps:", int(st.n_mp))

def t(name, fn, n=10):
    out = fn(); jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(n):
        out = fn()
    jax.block_until_ready(out)
    print(f"{name}: {(time.perf_counter()-t0)/n*1e3:.1f} ms")

vi = jax.jit(lambda s: solve_vi_ba(build_vi_ba_problem(s, kf, slam_cfg.ba_window, slam_cfg.ba_points, ts.gravity_w)[0], cam, iters=slam_cfg.ba_iters).q)
t("build+solve_vi_ba", lambda: vi(st))
tri = jax.jit(lambda s: triangulate_with_neighbor(s, kf, cam)[0].n_mp)
t("triangulate_with_neighbor", lambda: tri(st))
fu = jax.jit(lambda s: fuse_map_points(s, kf, cam).n_mp)
t("fuse_map_points", lambda: fu(st))
ups = jax.jit(lambda s: update_point_stats(s, kf).mp_pos)
t("update_point_stats", lambda: ups(st))
cull = jax.jit(lambda s: sm.cull_map_points(s).n_mp)
t("cull_map_points", lambda: cull(st))
red = jax.jit(lambda s: keyframe_redundancy(s, kf - 4))
t("keyframe_redundancy", lambda: red(st))

# insert_keyframe with synthetic frame inputs
n_feat = st.kf_uv.shape[1]
rng = np.random.default_rng(0)
ins = jax.jit(lambda s: sm.insert_keyframe(
    s, jnp.float32(99.0), ts.q, ts.p, ts.v, ts.bg, ts.ba,
    jnp.zeros((n_feat, 2)), jnp.full((n_feat,), -1.0), jnp.full((n_feat,), 2.0),
    jnp.zeros((n_feat,), jnp.int32), jnp.zeros((n_feat, 32), jnp.uint8),
    jnp.zeros((n_feat, 3)), jnp.ones((n_feat,), bool),
    jnp.full((n_feat,), -1, jnp.int32), ts.kf_preint, ts.last_kf,
    new_mp_budget=slam_cfg.new_mp_budget)[0].n_mp)
t("insert_keyframe", lambda: ins(st))
