"""chip_smoke.py --multi rehearsed on 4 virtual CPU devices at tiny size:
fleet mapping against single-device FusedSlam, and the sharded global BA on
a 4-device mesh against a 1-device mesh."""
import jax
import numpy as np

import chip_smoke as cs
from orbslam3_tpu.frontend.camera import Camera
from orbslam3_tpu.frontend.orb import OrbConfig
from orbslam3_tpu.io.synthetic import SyntheticConfig, SyntheticWorld
from orbslam3_tpu.map.slam_map import MapCapacity
from orbslam3_tpu.models.slam import SlamConfig
from orbslam3_tpu.models.tracker import TrackConfig


def test_phase_fleet_four_devices():
    devs = jax.devices()[:4]
    assert len(devs) == 4
    cfg = SlamConfig(
        orb=OrbConfig(n_features=128, n_levels=3),
        cap=MapCapacity(max_kf=16, n_feat=128, max_mp=1024, max_obs=8),
        track=TrackConfig(p_local=512), ba_points=256, ba_window=4,
        use_imu=False, kf_max_frames=3, new_mp_budget=64,
    )
    streams = []
    for s in range(4):
        w = SyntheticWorld(SyntheticConfig(
            width=192, height=128, fx=120.0, fy=120.0, n_landmarks=300,
            duration=1.2, cam_hz=10.0, seed=s, pos_amp=(1.0, 0.7, 0.25)))
        times = w.frame_times()
        if s == 3:  # a ragged stream: the mesh must not stall on it
            times = times[:-3]
        imu = [w.imu_window(times[i - 1] if i else t, t)
               for i, t in enumerate(times)]
        streams.append((times, w.render_sequence(times, workers=1), imu))
    out = cs.phase_fleet(devs, streams, w.cam, cfg, chunk=4, atol=1e-4)
    assert out["ok"], out
    assert out["sessions"] == 4
    assert out["frames_per_session"][3] == out["frames_per_session"][0] - 3


def test_phase_gba_four_devices():
    cam = Camera.create(458.0, 458.0, 376.0, 240.0, 0.11)
    out = cs.phase_gba(jax.devices()[:4], cam, K=8, P=512, O=4, iters=3,
                       cfg_tile=64)
    assert out["ok"], out
    assert out["tiles"] == {4: 64, 1: 64}


def test_gba_problem_shapes():
    pts, q, p0, opt = cs.gba_problem(K=8, P=100, O=4)
    assert pts.Xw.shape == (100, 3) and pts.obs_kf.shape == (100, 4)
    assert q.shape == (8, 4) and p0.shape == (8, 3)
    assert not opt[0] and opt[1:].all()
    kf = pts.obs_kf[pts.obs_kf >= 0]
    assert kf.max() < 8
    # no keyframe seen twice by one point
    for row in pts.obs_kf:
        r = row[row >= 0]
        assert len(set(r.tolist())) == len(r)
    assert np.isfinite(pts.obs_uv).all()
