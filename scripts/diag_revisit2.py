"""Correction-level instrumentation of the revisit run (round-5 diags).

Adds to diag_revisit: pose-graph convergence (per-iter costs), per-
correction keyframe displacement (did the seam actually close?), implied
seam delta from the verified Sim3, retarget deltas applied to the live
tracker, and GT-aligned per-bucket errors (aligned on the pre-blackout
segment, where tracking is healthy — the raw world frame differs from
GT's by the initial pose, so unaligned errors are dominated by that
offset).

Caches the rendered world under /tmp so re-runs skip the 68 s render.
"""
import sys, os, time
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np
import jax

from orbslam3_tpu.utils import compile_cache
compile_cache.enable()

from orbslam3_tpu.eval.metrics import ate_rmse, umeyama_align
from orbslam3_tpu.models.slam import SlamConfig
from orbslam3_tpu.models import fused as fused_mod
from orbslam3_tpu.loop import closer as closer_mod
from orbslam3_tpu.geometry.sim3 import Sim3

CACHE = "/tmp/revisit_world.npz"


def cached_revisit_world():
    from bench import build_revisit_world

    rw, rtimes, rframes, rimu = None, None, None, None
    if os.path.exists(CACHE):
        d = np.load(CACHE, allow_pickle=True)
        rtimes = d["times"]
        lefts, rights = d["lefts"], d["rights"]
        rframes = [(lefts[i], rights[i]) for i in range(len(rtimes))]
        rimu = [(d[f"g{i}"], d[f"a{i}"], d[f"d{i}"]) for i in range(len(rtimes))]
        # world object still needed for cam + gt
        from orbslam3_tpu.io.synthetic import SyntheticConfig, SyntheticWorld
        from bench import HARD_WORLD
        cfg = SyntheticConfig(
            duration=24.0, n_landmarks=1500, seed=7,
            yaw_amp=0.0, yaw_rate=2 * np.pi / 16.0,
            pos_freq=(0.125, 0.1875, 0.25), imu_noise=True,
            gyro_bias=(0.003, -0.002, 0.004), accel_bias=(0.03, 0.02, -0.04),
            bias_step_t=10.0, gyro_bias_step=(0.004, 0.003, -0.005),
            accel_bias_step=(0.15, -0.10, 0.10), **HARD_WORLD)
        rw = SyntheticWorld(cfg)
        print("# world loaded from cache", flush=True)
        return rw, rtimes, rframes, rimu
    t0 = time.perf_counter()
    rw, rtimes, rframes, rimu = build_revisit_world()
    print(f"# world rendered in {time.perf_counter()-t0:.0f}s", flush=True)
    save = dict(times=np.asarray(rtimes),
                lefts=np.stack([f[0] for f in rframes]),
                rights=np.stack([f[1] for f in rframes]))
    for i, (g, a, d) in enumerate(rimu):
        save[f"g{i}"], save[f"a{i}"], save[f"d{i}"] = g, a, d
    np.savez(CACHE, **save)
    return rw, rtimes, rframes, rimu


def main():
    from bench import train_world_vocab
    from orbslam3_tpu.models.fused import FusedSlam

    slam_cfg = SlamConfig(use_imu=True, kf_max_frames=6, ba_iters=3,
                          ba_window=6, lost_timeout=5.0)
    rw, rtimes, rframes, rimu = cached_revisit_world()
    r_vocab = train_world_vocab(rw, rframes)
    print("# vocab trained", flush=True)

    slam = FusedSlam(rw.cam, slam_cfg, service_every=8, chunk=8,
                     vocabulary=r_vocab, warmup=True)
    lc = slam.loop_closer

    # ---- instrumentation -------------------------------------------------
    orig_solve_pg = closer_mod.solve_pose_graph
    pg_costs = []

    def solve_pg_logged(prob, iters=10):
        nodes, costs = orig_solve_pg(prob, iters=iters)
        pg_costs.append(np.asarray(jax.device_get(costs)))
        return nodes, costs

    closer_mod.solve_pose_graph = solve_pg_logged

    orig_correct = lc._correct
    corr_log = []

    def correct_logged(st, kf_id, cand, S_rel, cam, record=True):
        p_before = np.asarray(st.kf_p)
        valid = np.asarray(st.kf_valid)
        # implied seam delta: where should kf_id go under rigid correction
        T_cand = Sim3(st.kf_q[cand], st.kf_p[cand], jax.numpy.ones(()))
        T_cur = Sim3(st.kf_q[kf_id], st.kf_p[kf_id], jax.numpy.ones(()))
        T_corr = T_cand.compose(S_rel).compose(T_cur.inverse())
        p_rigid = np.asarray(jax.device_get(T_corr.apply(st.kf_p[kf_id])))
        st2 = orig_correct(st, kf_id, cand, S_rel, cam, record=record)
        p_after = np.asarray(st2.kf_p)
        d = np.linalg.norm(p_after - p_before, axis=1)
        seam = np.linalg.norm(p_rigid - p_before[kf_id])
        moved = np.linalg.norm(p_after[kf_id] - p_before[kf_id])
        corr_log.append(dict(
            kf=int(kf_id), cand=int(cand),
            t_kf=float(st.kf_time[kf_id]), t_cand=float(st.kf_time[cand]),
            seam_m=float(seam), kf_moved_m=float(moved),
            mean_moved=float(d[valid].mean()), max_moved=float(d[valid].max()),
            pg_cost_first=float(pg_costs[-0-1][0]) if pg_costs else -1,
        ))
        print(f"# CORRECT kf={kf_id} cand={cand} seam={seam:.2f}m "
              f"kf_moved={moved:.2f}m mean={d[valid].mean():.2f} "
              f"max={d[valid].max():.2f}", flush=True)
        if pg_costs:
            print(f"#   pg costs: {pg_costs[-1]}", flush=True)
        return st2

    lc._correct = correct_logged

    orig_retarget = fused_mod._retarget_tracker
    retargets = []

    def retarget_logged(ts, q_old, p_old, q_new, p_new, rotate_gravity=False):
        d = float(np.linalg.norm(np.asarray(p_new) - np.asarray(p_old)))
        retargets.append(d)
        print(f"# RETARGET delta={d:.3f}m (rot_grav={rotate_gravity})",
              flush=True)
        return orig_retarget(ts, q_old, p_old, q_new, p_new,
                             rotate_gravity=rotate_gravity)

    fused_mod._retarget_tracker = retarget_logged

    # ---- run -------------------------------------------------------------
    t0 = time.perf_counter()
    for i in range(len(rtimes)):
        g, a, d = rimu[i]
        slam.process_frame(rframes[i][0], rframes[i][1], g, a, d,
                           float(rtimes[i]))
    slam.finalize()
    jax.block_until_ready(slam.ts.q)
    print(f"# run took {time.perf_counter()-t0:.0f}s", flush=True)

    ts_, outs, _ = slam._flat_outs()
    gt_p, gt_q = rw.gt_trajectory()
    _, ps_raw, _ = slam.trajectory_arrays(corrected=False)
    _, ps_cor, _ = slam.trajectory_arrays(corrected=True)
    n = len(outs)
    tarr = np.asarray(ts_)

    # align on the healthy pre-blackout segment, apply to everything
    m_pre = tarr < 9.5
    R, t, s = umeyama_align(ps_raw[m_pre], gt_p[:n][m_pre])
    raw_al = (R @ ps_raw.T).T + t
    cor_al = (R @ ps_cor.T).T + t
    err_raw = np.linalg.norm(raw_al - gt_p[:n], axis=1)
    err_cor = np.linalg.norm(cor_al - gt_p[:n], axis=1)

    print("\n# per-0.5s buckets (pre-blackout-aligned): mode | raw cor [m]")
    for sb in np.arange(0, 24, 0.5):
        m = (tarr >= sb) & (tarr < sb + 0.5)
        if not m.any():
            continue
        idx = np.nonzero(m)[0]
        modes = "".join(str(int(outs[i].mode)) for i in idx)
        ni = np.mean([int(outs[i].n_inliers) for i in idx])
        kfs = sum(int(outs[i].is_kf) for i in idx)
        print(f"t[{sb:5.1f}) mode={modes} in={ni:4.0f} kf={kfs} | "
              f"raw={err_raw[m].mean():7.3f} cor={err_cor[m].mean():7.3f}")

    # gravity-direction + bias error vs ground truth (est frame differs
    # from GT's by the pre-blackout alignment R: aligned = R @ est + t, so
    # the TRUE gravity expressed in the est frame is R^T @ g_gt)
    g_true_est = R.T @ np.array([0.0, 0.0, -9.81])
    g_est = np.asarray(jax.device_get(slam.ts.gravity_w))
    cosang = np.dot(g_true_est, g_est) / (
        np.linalg.norm(g_true_est) * np.linalg.norm(g_est))
    print(f"\n# gravity: est={g_est.round(3)} true(est-frame)="
          f"{g_true_est.round(3)} angle={np.degrees(np.arccos(np.clip(cosang, -1, 1))):.2f} deg "
          f"|g|={np.linalg.norm(g_est):.3f}")
    cfgw = rw.cfg
    bg_true = np.asarray(cfgw.gyro_bias) + np.asarray(cfgw.gyro_bias_step)
    ba_true = np.asarray(cfgw.accel_bias) + np.asarray(cfgw.accel_bias_step)
    print(f"# bias err: bg={np.asarray(jax.device_get(slam.ts.bg)) - bg_true} "
          f"ba={np.asarray(jax.device_get(slam.ts.ba)) - ba_true}")
    print(f"\n# stats: {lc.stats}")
    print(f"# retarget deltas: {[round(r,3) for r in retargets]}")
    print(f"# ATE raw={ate_rmse(ps_raw, gt_p[:n]):.4f} "
          f"cor={ate_rmse(ps_cor, gt_p[:n]):.4f}")
    print(f"# n_kf={int(slam.map.n_kf)} n_mp={int(slam.map.n_mp)} "
          f"maps={int(slam.map.next_map_id)}")


if __name__ == "__main__":
    main()
