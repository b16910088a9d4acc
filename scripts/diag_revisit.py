"""Deep diagnostic of the adversarial revisit run (VERDICT r4 next #1).

Runs the exact bench revisit world WITH loop closing and reports, per
half-second bucket: tracking mode, match/inlier counts, raw and
corrected-export position error vs ground truth — plus every loop event
(correction keyframes and times, map spawns, relocalizations) — so the
5 m ATE can be localized to tracking collapse vs late/wrong corrections
vs broken corrected export.

Usage: python scripts/diag_revisit.py [--service-every 8] [--chunk 8]
"""
import sys, os, time
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import argparse
import numpy as np
import jax

from orbslam3_tpu.utils import compile_cache
compile_cache.enable()

from bench import build_revisit_world, train_world_vocab
from orbslam3_tpu.eval.metrics import ate_rmse
from orbslam3_tpu.models.slam import SlamConfig
from orbslam3_tpu.models.fused import FusedSlam

ap = argparse.ArgumentParser()
ap.add_argument("--service-every", type=int, default=8)
ap.add_argument("--chunk", type=int, default=8)
ap.add_argument("--no-loop", action="store_true")
args = ap.parse_args()

slam_cfg = SlamConfig(use_imu=True, kf_max_frames=6, ba_iters=3,
                      ba_window=6, lost_timeout=5.0)

t0 = time.perf_counter()
rw, rtimes, rframes, rimu = build_revisit_world()
print(f"# world rendered in {time.perf_counter()-t0:.0f}s", flush=True)
r_vocab = None if args.no_loop else train_world_vocab(rw, rframes)

slam = FusedSlam(rw.cam, slam_cfg, service_every=args.service_every,
                 chunk=args.chunk, vocabulary=r_vocab,
                 warmup=r_vocab is not None)

# instrument loop corrections: wrap _correct/_merge_maps to log kf/cand
events = []
if slam.loop_closer is not None:
    lc = slam.loop_closer
    orig_correct = lc._correct
    orig_merge = lc._merge_maps

    def log_correct(st, kf_id, cand, S_rel, cam, record=True):
        s = jax.device_get(S_rel.s)
        events.append(("correct", int(kf_id), int(cand), float(s),
                       float(st.kf_time[kf_id]), float(st.kf_time[cand])))
        return orig_correct(st, kf_id, cand, S_rel, cam, record=record)

    def log_merge(st, kf_id, cand, S_rel):
        events.append(("merge", int(kf_id), int(cand), 1.0,
                       float(st.kf_time[kf_id]), float(st.kf_time[cand])))
        return orig_merge(st, kf_id, cand, S_rel)

    lc._correct = log_correct
    lc._merge_maps = log_merge

t0 = time.perf_counter()
for i in range(len(rtimes)):
    g, a, d = rimu[i]
    slam.process_frame(rframes[i][0], rframes[i][1], g, a, d, float(rtimes[i]))
slam.finalize()
jax.block_until_ready(slam.ts.q)
print(f"# run took {time.perf_counter()-t0:.0f}s", flush=True)

ts_, outs, _ = slam._flat_outs()
gt_p, gt_q = rw.gt_trajectory()
_, ps_raw, _ = slam.trajectory_arrays(corrected=False)
_, ps_cor, _ = slam.trajectory_arrays(corrected=True)

n = len(outs)
err_raw = np.linalg.norm(ps_raw - gt_p[:n], axis=1)
err_cor = np.linalg.norm(ps_cor - gt_p[:n], axis=1)

print("\n# per-0.5s buckets: mode(0=init,1=ok,2=lost) matches inliers "
      "feats stereo | raw_err cor_err [m]")
tarr = np.asarray(ts_)
for s in np.arange(0, 24, 0.5):
    m = (tarr >= s) & (tarr < s + 0.5)
    if not m.any():
        continue
    idx = np.nonzero(m)[0]
    modes = [int(outs[i].mode) for i in idx]
    nm = np.mean([int(outs[i].n_matches) for i in idx])
    ni = np.mean([int(outs[i].n_inliers) for i in idx])
    nf = np.mean([int(outs[i].n_features) for i in idx])
    nst = np.mean([int(outs[i].n_stereo) for i in idx])
    kfs = sum(int(outs[i].is_kf) for i in idx)
    print(f"t[{s:5.1f},{s+0.5:5.1f}) mode={''.join(str(x) for x in modes)} "
          f"m={nm:5.0f} in={ni:5.0f} f={nf:4.0f} st={nst:4.0f} kf={kfs} | "
          f"raw={err_raw[m].mean():7.3f} cor={err_cor[m].mean():7.3f}")

print("\n# loop events (type, kf, cand, scale, t_kf, t_cand):")
for e in events:
    print(" ", e)

lc = slam.loop_closer
if lc is not None:
    print(f"\n# stats: {lc.stats}")
print(f"# maps spawned: {int(slam.map.next_map_id)}, active "
      f"{int(slam.map.active_map)}, compactions {slam.compactions}")
kf_map = np.asarray(slam.map.kf_map_id)
kf_valid = np.asarray(slam.map.kf_valid)
print(f"# kf per map: {np.bincount(kf_map[kf_valid] + 1)}")
print(f"# n_kf={int(slam.map.n_kf)} n_mp={int(slam.map.n_mp)}")
print(f"# ATE raw={ate_rmse(ps_raw, gt_p[:n]):.4f} "
      f"cor={ate_rmse(ps_cor, gt_p[:n]):.4f}")
# ATE over the post-blackout segment only
m2 = tarr >= 13.0
print(f"# post-blackout ATE raw={ate_rmse(ps_raw[m2], gt_p[:n][m2]):.4f} "
      f"cor={ate_rmse(ps_cor[m2], gt_p[:n][m2]):.4f}")
# also a no-alignment absolute error profile summary
for lo, hi in [(0, 10), (10, 13), (13, 16), (16, 24)]:
    m3 = (tarr >= lo) & (tarr < hi)
    if m3.any():
        print(f"# |err| t[{lo},{hi}): raw mean={err_raw[m3].mean():.3f} "
              f"max={err_raw[m3].max():.3f}  cor mean={err_cor[m3].mean():.3f} "
              f"max={err_cor[m3].max():.3f}")
