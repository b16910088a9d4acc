"""Long-sequence soak at capacity (VERDICT r3 weak #5 / next #4).

A EuRoC-MH-length (default 160 s, 3200 frames) adversarial textured
sequence with continuous revisits (full pan every 16 s), noisy+biased
IMU, and loop closing ON, through FusedSlam at the production config and
FULL capacities (256 KF / 32k MP). The run crosses the keyframe-capacity
ceiling repeatedly, so compaction, detection row-bucket growth (Kb ->
256), in-flight loop state remaps, and `outs` host growth all get
exercised together — the interplay the unit tests cover only piecewise.

Reports per-window fps (flatness is the signal), keyframe/point counts
(boundedness under culling+compaction), compaction & loop counters, host
RSS, and end ATE, then a markdown summary.

Usage: python scripts/soak.py [--duration 160] [--cpu]
"""
import sys, os; sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse
import json
import resource
import time

import numpy as np



def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--duration", type=float, default=160.0)
    ap.add_argument("--window", type=float, default=16.0)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()

    if args.cpu:
        os.environ.pop("JAX_PLATFORMS", None)
    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    else:
        from orbslam3_tpu.utils import compile_cache
        compile_cache.enable()

    from bench import HARD_WORLD, train_world_vocab
    from orbslam3_tpu.eval.metrics import ate_rmse
    from orbslam3_tpu.io.synthetic import SyntheticConfig, SyntheticWorld
    from orbslam3_tpu.models.fused import FusedSlam
    from orbslam3_tpu.models.slam import SlamConfig

    cfg = SyntheticConfig(
        duration=args.duration, n_landmarks=1500, seed=7,
        yaw_amp=0.0, yaw_rate=2 * np.pi / 16.0,  # one revisit lap per 16 s
        pos_freq=(0.125, 0.1875, 0.25),
        imu_noise=True,
        gyro_bias=(0.003, -0.002, 0.004), accel_bias=(0.03, 0.02, -0.04),
        **HARD_WORLD,
    )
    world = SyntheticWorld(cfg)
    times = world.frame_times()
    t0 = time.perf_counter()
    frames = world.render_sequence(times)
    print(f"# rendered {len(frames)} frames in "
          f"{time.perf_counter() - t0:.0f} s", flush=True)
    imu = []
    for i, t in enumerate(times):
        tp = times[i - 1] if i > 0 else t
        imu.append(world.imu_window(tp, t))

    slam_cfg = SlamConfig(use_imu=True, kf_max_frames=6, ba_iters=3,
                          ba_window=6, lost_timeout=5.0)
    vocab = train_world_vocab(world, frames)
    slam = FusedSlam(world.cam, slam_cfg, service_every=8, chunk=8,
                     vocabulary=vocab, warmup=True)

    win_frames = int(args.window * cfg.cam_hz)
    rows = []
    t_start = time.perf_counter()
    t_win = t_start
    for i, t in enumerate(times):
        g, a, d = imu[i]
        slam.process_frame(frames[i][0], frames[i][1], g, a, d, float(t))
        if (i + 1) % win_frames == 0:
            slam.flush()
            jax.block_until_ready(slam.ts.q)  # soak instrumentation sync
            now = time.perf_counter()
            rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss // 1024
            modes_w = slam.modes()[-win_frames:]
            row = dict(
                t=float(t), fps=round(win_frames / (now - t_win), 1),
                n_kf=int(slam.map.n_kf), n_mp=int(slam.map.n_mp),
                ok_frac=round(float((modes_w == 1).mean()), 2),
                compactions=slam.compactions,
                loops=int(slam.loop_closer.stats.corrected),
                relocs=int(slam.loop_closer.stats.relocalized),
                kf_evict=getattr(slam, "kf_evictions", 0),
                mp_evict=getattr(slam, "mp_evictions", 0),
                maps=int(slam.map.next_map_id),
                outs_len=len(slam.outs), rss_mb=rss,
            )
            rows.append(row)
            print(json.dumps(row), flush=True)
            t_win = time.perf_counter()
    slam.finalize()
    jax.block_until_ready(slam.ts.q)
    total_s = time.perf_counter() - t_start

    t0 = time.perf_counter()
    ts_, ps, qs = slam.trajectory_arrays()
    traj_s = time.perf_counter() - t0
    gt_p, _ = world.gt_trajectory()
    ate = ate_rmse(ps, gt_p[: len(ps)])

    fps_all = [r["fps"] for r in rows]
    summary = dict(
        metric="soak",
        duration_s=args.duration,
        frames=len(times),
        fps_mean=round(float(np.mean(fps_all)), 1),
        fps_first_window=fps_all[0],
        fps_last_window=fps_all[-1],
        fps_min=min(fps_all),
        ate_m=round(float(ate), 4),
        n_kf_final=int(slam.map.n_kf),
        n_mp_final=int(slam.map.n_mp),
        ok_frac=round(float((slam.modes() == 1).mean()), 3),
        compactions=slam.compactions,
        loop_corrections=int(slam.loop_closer.stats.corrected),
        relocalizations=int(slam.loop_closer.stats.relocalized),
        kf_evictions=getattr(slam, "kf_evictions", 0),
        mp_evictions=getattr(slam, "mp_evictions", 0),
        maps_spawned=int(slam.map.next_map_id),
        candidates_checked=int(slam.loop_closer.stats.candidates_checked),
        outs_len_final=len(slam.outs),
        trajectory_export_s=round(traj_s, 2),
        rss_mb_final=rows[-1]["rss_mb"],
        total_s=round(total_s, 1),
        backend=jax.default_backend(),
    )
    print(json.dumps(summary), flush=True)

    lines = [
        f"## Soak: {args.duration:.0f} s at capacity "
        f"(`scripts/soak.py`, backend {jax.default_backend()})",
        "",
        "Adversarial textured world, continuous revisit laps, noisy "
        "IMU, loop closing ON, production config, full 256-KF/32k-MP "
        "capacities.",
        "",
        "| t [s] | fps | keyframes | map points | compactions | loops "
        "| RSS [MB] |",
        "|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        lines.append(
            f"| {r['t']:.0f} | {r['fps']} | {r['n_kf']} | {r['n_mp']} "
            f"| {r['compactions']} | {r['loops']} | {r['rss_mb']} |"
        )
    lines += [
        "",
        f"End: ATE {summary['ate_m']} m over {summary['frames']} "
        f"frames; fps first->last window "
        f"{summary['fps_first_window']} -> {summary['fps_last_window']} "
        f"(min {summary['fps_min']}); trajectory export of "
        f"{summary['outs_len_final']} out-chunks took "
        f"{summary['trajectory_export_s']} s; "
        f"{summary['loop_corrections']} loop corrections, "
        f"{summary['candidates_checked']} candidates checked.",
    ]
    print("\n".join(lines))


if __name__ == "__main__":
    main()
