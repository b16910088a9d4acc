"""End-to-end stereo odometry on a synthetic sequence (driver config #1:
'Stereo-only tracking + motion-only BA'). Small world for CPU test speed —
the full-size run happens in bench.py and chip_smoke.py on the GPU.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from orbslam3_tpu.eval.metrics import ate_rmse
from orbslam3_tpu.frontend.orb import OrbConfig
from orbslam3_tpu.io.synthetic import SyntheticConfig, SyntheticWorld
from orbslam3_tpu.map.slam_map import MapCapacity
from orbslam3_tpu.models.slam import SlamConfig, SlamSystem
from orbslam3_tpu.models.tracker import TrackConfig


@pytest.mark.slow
def test_stereo_odometry_ate():
    cfg = SyntheticConfig(
        width=384, height=256, fx=240.0, fy=240.0, n_landmarks=600,
        duration=4.0, cam_hz=10.0,
        pos_amp=(1.2, 0.8, 0.3),
    )
    world = SyntheticWorld(cfg)
    slam_cfg = SlamConfig(
        orb=OrbConfig(n_features=384, n_levels=4),
        cap=MapCapacity(max_kf=64, n_feat=384, max_mp=8192, max_obs=8),
        track=TrackConfig(p_local=2048),
        ba_points=1024,
        use_imu=False,
        kf_max_frames=2,
    )
    slam = SlamSystem(world.cam, slam_cfg)

    times = world.frame_times()
    for i, t in enumerate(times):
        left, right = world.render_frame(t)
        t_next = times[i + 1] if i + 1 < len(times) else t + 1.0 / cfg.cam_hz
        g, a, d = world.imu_window(t, t_next)
        slam.process_frame(left, right, g, a, d, float(t))

    ts, ps, qs = slam.trajectory_arrays()
    gt_p, gt_q = world.gt_trajectory()
    gt_p = gt_p[: len(ps)]

    states = [r.state for r in slam.trajectory]
    ok_frac = sum(s == "Ok" for s in states) / len(states)
    assert ok_frac > 0.9, f"tracking Ok fraction {ok_frac}, states {states[:20]}"

    ate = ate_rmse(ps, gt_p)
    # small world, short track: sub-5cm is a sane first bar
    assert ate < 0.05, f"ATE {ate:.3f} m"
