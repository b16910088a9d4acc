"""Run the SLAM pipeline on an EuRoC-format sequence.

Usage: python scripts/run_euroc.py /path/to/MH_01_easy [outdir] [--profile small]

Works on real EuRoC data or on the bit-faithful generated fixture
(scripts/make_euroc_fixture.py). Uses the native C++ prefetcher when built
(make -C native), PIL otherwise. Prints ATE vs the sequence ground truth
(one JSON line) and exports a TUM trajectory.

Frames are undistorted + stereo-rectified (io/rectify.py) before the SLAM
pipeline — unlike the reference, which feeds raw distorted EuRoC frames
(euroc.rs loads images as-is).
"""
import sys, os; sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse
import json

import numpy as np


def run(seq_dir: str, outdir: str = "/tmp/orbslam3_tpu_euroc",
        profile: str = "full", max_frames: int = 0,
        vocab_path: str = None, loop_cfg=None):
    import jax

    from orbslam3_tpu.eval.metrics import ate_rmse
    from orbslam3_tpu.frontend.camera import Camera
    from orbslam3_tpu.frontend.orb import OrbConfig
    from orbslam3_tpu.io import native
    from orbslam3_tpu.io.euroc import EurocDataset
    from orbslam3_tpu.map.slam_map import MapCapacity
    from orbslam3_tpu.models.fused import FusedSlam
    from orbslam3_tpu.models.slam import SlamConfig
    from orbslam3_tpu.models.tracker import TrackConfig
    from orbslam3_tpu.viz.export import save_trajectory_tum

    ds = EurocDataset(seq_dir)
    os.makedirs(outdir, exist_ok=True)

    import jax.numpy as jnp

    from orbslam3_tpu.io.rectify import (
        body_from_rect_cam,
        remap_bilinear,
        stereo_rectify_maps,
    )

    w, h = ds.cam0.resolution
    maps = stereo_rectify_maps(
        ds.cam0.K, ds.cam0.dist, ds.cam0.T_BS,
        ds.cam1.K, ds.cam1.dist, ds.cam1.T_BS, (w, h),
    )
    Kn = maps.K_new
    # body-IMU extrinsics for the rectified camera: states stay body-frame,
    # raw body-frame IMU feeds the pipeline directly
    q_bc, p_bc = body_from_rect_cam(ds.cam0.T_BS, maps.R_rect0)
    cam = Camera.create(Kn[0, 0], Kn[1, 1], Kn[0, 2], Kn[1, 2], maps.baseline, w, h,
                        q_bc=q_bc, p_bc=p_bc)
    if profile == "small":
        # CPU-testable footprint (compile time, not accuracy, is the
        # constraint — the e2e fixture test uses this profile)
        slam_cfg = SlamConfig(
            orb=OrbConfig(n_features=384, n_levels=4),
            cap=MapCapacity(max_kf=64, n_feat=384, max_mp=8192, max_obs=8),
            track=TrackConfig(p_local=2048),
            ba_points=1024,
            kf_max_frames=4,
            imu_init_kfs=8,
        )
    else:
        slam_cfg = SlamConfig(kf_max_frames=6)
    if ds.imu_calib is not None:
        # per-rig noise densities from imu0/sensor.yaml (the reference
        # hard-codes the EuRoC MH values, sample.rs:24-33)
        slam_cfg = slam_cfg._replace(imu_noise=ds.imu_calib.noise)
    vocab = None
    if vocab_path:
        # the production ORBvoc.txt path (reference: vocabulary/mod.rs:94-206
        # loads the same text format) — enables loop closing
        from orbslam3_tpu.loop.vocab import load_dbow2_text

        vocab = load_dbow2_text(vocab_path)
    slam = FusedSlam(cam, slam_cfg, vocabulary=vocab,
                     warmup=vocab is not None, loop_cfg=loop_cfg)
    mx0, my0 = jnp.asarray(maps.map_x0), jnp.asarray(maps.map_y0)
    mx1, my1 = jnp.asarray(maps.map_x1), jnp.asarray(maps.map_y1)

    prefetch = None
    if native.available():
        paths = [
            os.path.join(ds.root, "cam0", "data", f) for f in ds.image_files
        ]
        prefetch = native.ImagePrefetcher(paths, w, h, threads=3)

    n = len(ds)
    if max_frames:
        n = min(n, max_frames)
    for i in range(n):
        t = ds.frame_time(i)
        t_prev = ds.frame_time(i - 1) if i > 0 else t
        if prefetch is not None:
            left = prefetch.get(i)
            _, right = ds.stereo_pair(i)
        else:
            left, right = ds.stereo_pair(i)
        g, a, d = ds.imu_between(t_prev, t)
        left_r = np.asarray(remap_bilinear(jnp.asarray(left, jnp.float32), mx0, my0), np.uint8)
        right_r = np.asarray(remap_bilinear(jnp.asarray(right, jnp.float32), mx1, my1), np.uint8)
        slam.process_frame(left_r, right_r, g, a, d, t)
        if i % 100 == 0:
            print(f"frame {i}/{n}", file=sys.stderr)
    slam.finalize()

    ts, ps, qs = slam.trajectory_arrays()
    save_trajectory_tum(os.path.join(outdir, "trajectory.tum"), ts, ps, qs)
    gt = ds.groundtruth_at_frames()
    result = {
        "frames": n,
        "keyframes": int(slam.map.n_kf),
        "imu_initialized": slam.imu_initialized,
        "native_loader": prefetch is not None,
        "outdir": outdir,
    }
    if slam.loop_closer is not None:
        result["loop_corrections"] = int(slam.loop_closer.stats.corrected)
        result["loop_candidates_checked"] = int(
            slam.loop_closer.stats.candidates_checked)
    if gt is not None:
        result["ate_m"] = round(ate_rmse(ps - ps[0], gt[: len(ps)]), 4)
    return result


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("sequence")
    ap.add_argument("outdir", nargs="?", default="/tmp/orbslam3_tpu_euroc")
    ap.add_argument("--profile", choices=["full", "small"], default="full")
    ap.add_argument("--max-frames", type=int, default=0)
    ap.add_argument("--vocab", default=None,
                    help="DBoW2 ORBvoc.txt vocabulary; enables loop closing")
    a = ap.parse_args()
    from orbslam3_tpu.utils import compile_cache

    compile_cache.enable()
    result = run(a.sequence, a.outdir, a.profile, a.max_frames,
                 vocab_path=a.vocab)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
