"""chip_smoke.py's main-path (P3) and loop-repair (P4) phases at tiny size on
the CPU backend: the same entry points (bench.run_pipeline -> FusedSlam +
LoopCloser) that the card runs at 752x480."""
import jax.numpy as jnp
import numpy as np
import pytest

import chip_smoke as cs
from orbslam3_tpu.frontend.orb import OrbConfig, detect_orb
from orbslam3_tpu.io.synthetic import SyntheticConfig, SyntheticWorld
from orbslam3_tpu.loop import vocab as vb
from orbslam3_tpu.map.slam_map import MapCapacity
from orbslam3_tpu.models.slam import SlamConfig
from orbslam3_tpu.models.tracker import TrackConfig

ORB = OrbConfig(n_features=128, n_levels=3)
CFG = SlamConfig(
    orb=ORB,
    # max_mp >= LoopConfig.vi_refine_points: the closer's warmup builds
    # the post-correction VI refine at full point budget
    cap=MapCapacity(max_kf=16, n_feat=128, max_mp=4096, max_obs=8),
    track=TrackConfig(p_local=512), ba_points=256, ba_window=4,
    use_imu=True, kf_max_frames=3, new_mp_budget=64,
)


@pytest.fixture(scope="module")
def tiny():
    w = SyntheticWorld(SyntheticConfig(
        width=192, height=128, fx=120.0, fy=120.0, n_landmarks=300,
        duration=1.6, cam_hz=10.0, pos_amp=(1.0, 0.7, 0.25)))
    times = w.frame_times()
    frames = w.render_sequence(times, workers=1)
    imu = [w.imu_window(times[i - 1] if i else t, t)
           for i, t in enumerate(times)]
    descs = [np.asarray(detect_orb(jnp.asarray(frames[i][0], jnp.float32),
                                   ORB).desc) for i in range(0, len(frames), 4)]
    voc = vb.train_vocabulary(np.concatenate(descs), k=4, levels=2)
    return w, times, frames, imu, voc


def test_phase_main_path_tiny(tiny):
    w, times, frames, imu, voc = tiny
    out = cs.phase_main_path(w, times, frames, imu, CFG, voc, chunk=4,
                             ate_bar=0.25)
    assert out["ok"], out
    assert out["finite"] and out["frames"] == len(times)
    assert out["compiles"] > 0 and out["compile_s"] > 0
    assert out["n_keyframes"] >= 2


def test_phase_loop_repair_tiny(tiny):
    """Too short for a revisit: runs the loop-closing and odometry passes
    with no correction required."""
    w, times, frames, imu, voc = tiny
    out = cs.phase_loop_repair(w, times, frames, imu, CFG, voc, chunk=4,
                               min_corrections=0)
    assert out["ok"], out
    assert out["loop_corrections"] >= 0 and out["frames"] == len(times)
    assert np.isfinite(out["ate_loop_m"]) and np.isfinite(out["ate_odometry_m"])
    assert "host_services" in out["service_s"]
