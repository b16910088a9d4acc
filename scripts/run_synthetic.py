"""Run the full SLAM pipeline on a synthetic sequence and export artifacts.

Usage: python scripts/run_synthetic.py [seconds] [outdir] [--live[=PORT]]
Exports TUM trajectory, ground truth, and a PLY map; prints ATE/RPE.
With --live, serves a browser view of the growing map while tracking runs
(reference analog: the live Rerun stream).
"""
import sys, os; sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import json

import numpy as np


def main():
    import jax

    from orbslam3_tpu.utils import compile_cache
    compile_cache.enable()

    from orbslam3_tpu.eval.metrics import ate_rmse, rpe_rmse
    from orbslam3_tpu.io.synthetic import SyntheticConfig, SyntheticWorld
    from orbslam3_tpu.map.checkpoint import save_map
    from orbslam3_tpu.models.fused import FusedSlam
    from orbslam3_tpu.models.slam import SlamConfig
    from orbslam3_tpu.viz.export import save_map_ply, save_trajectory_tum

    args = [a for a in sys.argv[1:] if not a.startswith("--live")]
    live_args = [a for a in sys.argv[1:] if a.startswith("--live")]
    seconds = float(args[0]) if len(args) > 0 else 6.0
    outdir = args[1] if len(args) > 1 else "/tmp/orbslam3_tpu_run"
    os.makedirs(outdir, exist_ok=True)

    viewer = None
    if live_args:
        from orbslam3_tpu.viz.live import LiveViewer

        port = int(live_args[0].split("=")[1]) if "=" in live_args[0] else 0
        viewer = LiveViewer(port=port)
        print(f"live viewer: {viewer.url}", flush=True)

    world = SyntheticWorld(SyntheticConfig(duration=seconds))
    slam = FusedSlam(world.cam, SlamConfig(kf_max_frames=4))
    times = world.frame_times()
    gt_p, _ = world.gt_trajectory()
    for i, t in enumerate(times):
        left, right = world.render_frame(t)
        t_prev = times[i - 1] if i > 0 else t
        g, a, d = world.imu_window(t_prev, t)
        slam.process_frame(left.astype(np.uint8), right.astype(np.uint8), g, a, d, float(t))
        if viewer is not None and i % 20 == 19:
            # throttled snapshot: ~one device fetch per second of sequence
            _, ps_live, _ = slam.trajectory_arrays()
            viewer.publish(slam.map, ps_live, gt_p[: len(ps_live)])

    ts, ps, qs = slam.trajectory_arrays()
    _, gt_q = world.gt_trajectory()
    save_trajectory_tum(os.path.join(outdir, "trajectory.tum"), ts, ps, qs)
    save_trajectory_tum(os.path.join(outdir, "groundtruth.tum"), times, gt_p, gt_q)
    save_map_ply(os.path.join(outdir, "map.ply"), slam.map)
    save_map(os.path.join(outdir, "checkpoint.npz"), slam.map, slam.ts)
    from orbslam3_tpu.viz.html_view import save_html_view

    save_html_view(os.path.join(outdir, "map.html"), slam.map, ps,
                   gt_p[: len(ps)])
    if viewer is not None:
        viewer.publish(slam.map, ps, gt_p[: len(ps)], force=True)
        viewer.close()

    print(json.dumps({
        "frames": len(times),
        "keyframes": int(slam.map.n_kf),
        "map_points": int(np.asarray(slam.map.mp_valid).sum()),
        "imu_initialized": slam.imu_initialized,
        "ate_m": round(ate_rmse(ps, gt_p[: len(ps)]), 4),
        "rpe_m": round(
            rpe_rmse(ps, gt_p[: len(ps)], qs, gt_q[: len(ps)])[0], 4
        ),
        "outdir": outdir,
    }))


if __name__ == "__main__":
    main()
