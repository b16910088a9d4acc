"""Smoke test of the SLAM engine on the GPU, through its normal entry points.

    python chip_smoke.py           # phases P0-P4 on one card
    python chip_smoke.py --multi   # fleet mapping + sharded global BA, 4 cards

Phases (one JSON object each, on its own line):
  P0 device     the card, its power limit and the compile-cache directory;
  P1 kernels    FAST+NMS, Hamming and BRIEF on the card against the same
                code on the CPU device of this process, at real widths;
  P2 solvers    pose GN, local BA, VI-BA, Sim3 RANSAC and DLT triangulation,
                card against CPU on seeded problems;
  P3 main path  FusedSlam + LoopCloser on the 8 s EuRoC-shaped adversarial
                world of bench.py, one warm and one timed pass, ATE bar;
  P4 loop       the blackout-and-revisit world with the loop closer: at least
                one correction (pose graph, seam fusion, global BA, VI refine).
With --multi only the multi-device path runs:
  M1 fleet      MultiSessionSlam, one session per card, against single-device
                FusedSlam on the same streams;
  M2 GBA        distributed_global_ba on a 4-device mesh against 1 device, on
                the same full-size point table.

The last line is {"ok": true, "device": {...}}; it is printed only when every
phase passed. Without a GPU the script exits non-zero before any phase.
"""
from __future__ import annotations

import argparse
import glob
import json
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh

from bench import (HARD_WORLD, bench_slam_config, build_revisit_world,
                   build_world, card_info, device_record, require_gpu,
                   run_pipeline, train_world_vocab)
from orbslam3_tpu.eval.metrics import ate_rmse
from orbslam3_tpu.frontend.orb import OrbConfig, _score_maps_batched
from orbslam3_tpu.geometry import quat
from orbslam3_tpu.imu import preintegration as pre
from orbslam3_tpu.io.synthetic import SyntheticConfig, SyntheticWorld
from orbslam3_tpu.loop.closer import LoopConfig
from orbslam3_tpu.loop.sim3 import sim3_ransac
from orbslam3_tpu.map.triangulation import _dlt, _projection_matrix
from orbslam3_tpu.models.fused import FusedSlam
from orbslam3_tpu.ops import brief, fast
from orbslam3_tpu.ops import pyramid as pyr
from orbslam3_tpu.ops.hamming import hamming_matrix, hamming_matrix_popcount
from orbslam3_tpu.optim.local_ba import BAProblem, solve_local_ba
from orbslam3_tpu.optim.pose_only import pose_optimize
from orbslam3_tpu.optim.vi_ba import VIBAProblem, solve_vi_ba
from orbslam3_tpu.parallel.distributed_ba import (GlobalBAPoints,
                                                  distributed_global_ba)
from orbslam3_tpu.parallel.multi_session import MultiSessionSlam
from orbslam3_tpu.utils import compile_cache

# P3's bar: the EuRoC-format loop e2e test's (tests/test_euroc_e2e.py)
ATE_BAR_M = 0.25
# P2: solutions agree to this relative tolerance, measured against
# max(|reference|, 1) so that metre-scale poses get ~0.1 mm
SOLVER_RTOL = 1e-4
# ... except two-view DLT: its 3x3 normal equations have condition number
# ~(z/b)^2 ~ 2500 for points at 20 m seen over a 0.4 m baseline, so f32
# rounding order alone moves far points by ~1.5e-4 relative
SOLVER_RTOL_DLT = 1e-3
# P1 BRIEF: rotated pattern points are rounded to pixels and the samples are
# bf16, so an f32 last-bit difference in the angle can flip a comparison
# that sits on a rounding boundary
BRIEF_MIN_BIT_AGREEMENT = 0.999
BRIEF_MAX_ANGLE_DIFF = 1e-3  # rad
# M1: sessions run the same step program as FusedSlam, sharded over the
# mesh; positions must agree to this bound [m]
FLEET_POS_ATOL = 1e-3
# M2: the 4-way psum reorders the Schur sums; poses [m] and points [m]
GBA_ATOL = 1e-3


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


class CompileClock:
    """Counts XLA backend compiles and their seconds while active."""

    EVENT = "/jax/core/compile/backend_compile_duration"

    def __init__(self):
        self.seconds = 0.0
        self.count = 0

    def _on(self, event, duration, **_):
        if event == self.EVENT:
            self.seconds += duration
            self.count += 1

    def __enter__(self):
        jax.monitoring.register_event_duration_secs_listener(self._on)
        return self

    def __exit__(self, *exc):
        jax.monitoring.unregister_event_duration_listener(self._on)


def _on_device(dev, fn, *args):
    """Run jitted `fn` on `dev`; args must be uncommitted (numpy) values."""
    with jax.default_device(dev):
        return jax.device_get(fn(*args))


def _rel_err(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(float(np.max(np.abs(b))), 1.0))


# ---------------------------------------------------------------- P1 kernels
def trace_device_time(fn, args, iters: int, logdir: str) -> dict:
    """Device time per call of jitted `fn` from a profiler trace: the union
    of kernel intervals on the card's stream lines, and the kernel count."""
    jax.block_until_ready(fn(*args))
    with jax.profiler.trace(logdir):
        for _ in range(iters):
            jax.block_until_ready(fn(*args))
    path = sorted(glob.glob(f"{logdir}/plugins/profile/*/*.xplane.pb"))[-1]
    spans, names = [], set()
    for plane in jax.profiler.ProfileData.from_file(path).planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            if not line.name.startswith("Stream"):
                continue
            for ev in line.events:
                if ev.name.startswith(("Memcpy", "Memset")):
                    continue
                spans.append((ev.start_ns, ev.start_ns + ev.duration_ns))
                names.add(ev.name)
    spans.sort()
    busy, end = 0.0, -1.0
    for s, e in spans:
        if e > end:
            busy += e - max(s, end)
            end = e
    return {"device_us_per_call": busy / iters / 1e3,
            "kernels_per_call": len(spans) / iters,
            "distinct_kernels": len(names)}


def phase_kernels(dev, ref, images, orb_cfg, n_kp: int = 1024,
                  trace_dir: str | None = None) -> dict:
    """images: (B, H, W) uint8 frames. Every part runs on `dev` and on
    `ref` from the same inputs."""
    imgs = np.asarray(images, np.float32)
    levels = _on_device(ref, jax.jit(jax.vmap(
        lambda im: pyr.build_pyramid(im, orb_cfg.n_levels, orb_cfg.scale_factor)
    )), imgs)
    score_fn = jax.jit(lambda lv: _score_maps_batched(list(lv), orb_cfg))
    s_dev = _on_device(dev, score_fn, levels)
    s_ref = _on_device(ref, score_fn, levels)
    fast_equal = all(np.array_equal(a, b) for a, b in zip(s_dev, s_ref))
    fast_mismatch = int(sum(np.sum(a != b) for a, b in zip(s_dev, s_ref)))

    rng = np.random.default_rng(0)
    da = rng.integers(0, 256, (n_kp, 32), dtype=np.uint8)
    db = rng.integers(0, 256, (n_kp, 32), dtype=np.uint8)
    h_dev = _on_device(dev, jax.jit(hamming_matrix), da, db)
    h_ref = _on_device(ref, jax.jit(hamming_matrix_popcount), da, db)
    hamming_equal = bool(np.array_equal(h_dev, h_ref))

    # BRIEF on level 0 of the first image at the detector's own keypoints
    img0 = levels[0][0]
    score0 = fast.mask_border(jnp.asarray(s_ref[0][0]), brief.GHALF + 2)
    ys, xs, _ = jax.device_get(fast.select_keypoints(
        score0, cell=orb_cfg.cell, k_cell=orb_cfg.k_cell, n_out=n_kp))

    def describe(img, ys, xs):
        patches = brief.gather_patches(pyr.blur(img), ys, xs, brief.GATHER)
        ang = brief.orientations_from_patches(patches)
        return ang, brief.descriptors_from_patches(patches, ang)

    a_dev, d_dev = _on_device(dev, jax.jit(describe), img0, ys, xs)
    a_ref, d_ref = _on_device(ref, jax.jit(describe), img0, ys, xs)
    bits_differ = np.unpackbits(np.bitwise_xor(d_dev, d_ref)).sum()
    bit_agree = 1.0 - float(bits_differ) / (d_ref.size * 8)
    dang = np.abs(np.angle(np.exp(1j * (a_dev.astype(np.float64) - a_ref))))
    angle_diff = float(dang.max())

    out = {
        "phase": "P1_kernels",
        "fast_nms": {"images": int(imgs.shape[0]),
                     "shape": list(imgs.shape[1:]),
                     "levels": len(levels), "exact": fast_equal,
                     "mismatched_pixels": fast_mismatch,
                     "tolerance": "exact (f32 compares, fixed-order sum)"},
        "hamming": {"n": n_kp, "exact": hamming_equal,
                    "tolerance": "exact (bf16 +-1 product, f32 accumulate)"},
        "brief": {"n_kp": n_kp, "bit_agreement": bit_agree,
                  "max_angle_diff_rad": angle_diff,
                  "tolerance": f"bits >= {BRIEF_MIN_BIT_AGREEMENT}, angle "
                               f"<= {BRIEF_MAX_ANGLE_DIFF} rad (f32, "
                               "precision=highest moments and blur)"},
    }
    if trace_dir is not None:
        # the plain FAST+NMS path, compiled for the card, at this batch;
        # a profiler that cannot attach costs the number, not the phase
        lv_dev = jax.device_put(levels, dev)
        try:
            out["fast_nms"]["trace"] = trace_device_time(
                score_fn, (lv_dev,), 20, trace_dir)
        except Exception as e:
            out["fast_nms"]["trace"] = {"error": repr(e)}
    out["ok"] = bool(fast_equal and hamming_equal
                     and bit_agree >= BRIEF_MIN_BIT_AGREEMENT
                     and angle_diff <= BRIEF_MAX_ANGLE_DIFF)
    return out


# ---------------------------------------------------------------- P2 solvers
def _stereo_obs(cam, q_wb, p_wb, X, rng, noise_px=0.3):
    """Noisy (uv, u_right, depth-ok) observations of world points X from a
    body pose, pinhole model of `cam` (identity extrinsics)."""
    xc = np.asarray(quat.rotate(quat.conj(np.asarray(q_wb, np.float32))[None],
                                X - p_wb))
    z = np.maximum(xc[:, 2], 0.1)
    fx, fy = float(cam.fx), float(cam.fy)
    u = fx * xc[:, 0] / z + float(cam.cx)
    v = fy * xc[:, 1] / z + float(cam.cy)
    ok = (xc[:, 2] > 0.5) & (u > 0) & (u < cam.width) & (v > 0) & (v < cam.height)
    uv = np.stack([u, v], -1) + rng.normal(0, noise_px, (len(X), 2))
    ur = uv[:, 0] - float(cam.bf) / z + rng.normal(0, noise_px, len(X))
    return uv.astype(np.float32), ur.astype(np.float32), ok


def _ba_scene(cam, rng, C, P, N):
    """C cameras along +x looking down +z at P points; N obs per camera."""
    p = np.stack([np.linspace(0, 2.0, C), np.zeros(C), np.zeros(C)], -1)
    q = np.tile([1.0, 0, 0, 0], (C, 1))
    X = np.stack([rng.uniform(-4, 6, P), rng.uniform(-3, 3, P),
                  rng.uniform(4, 14, P)], -1)
    obs_uv = np.zeros((C, N, 2), np.float32)
    obs_ur = np.zeros((C, N), np.float32)
    obs_pt = np.full((C, N), -1, np.int32)
    for c in range(C):
        picks = rng.choice(P, N, replace=False)
        uv, ur, ok = _stereo_obs(cam, q[c], p[c], X[picks], rng)
        obs_uv[c], obs_ur[c] = uv, ur
        obs_pt[c] = np.where(ok, picks, -1)
    return (q.astype(np.float32), p.astype(np.float32), X.astype(np.float32),
            obs_uv, obs_ur, obs_pt)


def _vi_problem(cam, rng, C, P, N):
    """Constant-rate, constant-acceleration trajectory with exact IMU
    preintegrations between consecutive keyframes (200 Hz, 0.25 s apart)."""
    g = np.array([0, 0, -9.81], np.float32)
    w = np.array([0.3, -0.1, 0.2], np.float32)
    a_w = np.array([0.4, 0.2, -0.2], np.float32)
    v0 = np.array([0.3, -0.2, 0.1], np.float32)
    q0 = np.asarray(quat.from_axis_angle(jnp.asarray([0.2, -0.1, 0.15])))
    kf_dt, hz = 0.25, 200.0
    qs = np.stack([np.asarray(quat.mul(q0, quat.from_axis_angle(w * c * kf_dt)))
                   for c in range(C)])
    ts = np.arange(C) * kf_dt
    ps = v0 * ts[:, None] + 0.5 * a_w * ts[:, None] ** 2
    vs = v0 + a_w * ts[:, None]
    n = int(kf_dt * hz)
    dts = np.full(n, 1.0 / hz, np.float32)
    preints = [pre.PreintState.identity()]
    for c in range(1, C):
        tm = (np.arange(n) + 0.5) / hz
        R = np.asarray(quat.to_matrix(jax.vmap(
            lambda t: quat.mul(qs[c - 1], quat.from_axis_angle(w * t)))(tm)))
        acc = np.einsum("nji,j->ni", R, a_w - g).astype(np.float32)
        preints.append(pre.integrate(
            np.tile(w, (n, 1)), acc, dts, np.ones(n, bool),
            jnp.zeros(3), jnp.zeros(3)))
    preints = jax.device_get(jax.tree.map(lambda *x: jnp.stack(x), *preints))
    fwd = np.asarray(quat.rotate(qs[C // 2], jnp.asarray([0.0, 0, 1.0])))
    X = (ps.mean(0) + fwd * rng.uniform(4, 12, (P, 1))
         + rng.uniform(-3, 3, (P, 3))).astype(np.float32)
    obs_uv = np.zeros((C, N, 2), np.float32)
    obs_ur = np.zeros((C, N), np.float32)
    obs_pt = np.full((C, N), -1, np.int32)
    for c in range(C):
        picks = rng.choice(P, N, replace=False)
        uv, ur, ok = _stereo_obs(cam, qs[c], ps[c], X[picks], rng)
        obs_uv[c], obs_ur[c] = uv, ur
        obs_pt[c] = np.where(ok, picks, -1)
    p_init = (ps + rng.normal(0, 0.04, (C, 3))).astype(np.float32)
    p_init[0] = ps[0]
    return VIBAProblem(
        q=qs.astype(np.float32), p=p_init,
        v=(vs + rng.normal(0, 0.25, (C, 3))).astype(np.float32),
        bg=np.zeros((C, 3), np.float32), ba=np.zeros((C, 3), np.float32),
        opt_cam=np.arange(C) > 0, cam_valid=np.ones(C, bool),
        Xw=(X + rng.normal(0, 0.06, (P, 3))).astype(np.float32),
        pt_valid=np.ones(P, bool), obs_uv=obs_uv, obs_ur=obs_ur,
        obs_oct=np.zeros((C, N), np.int32), obs_pt=obs_pt, preint=preints,
        imu_edge_valid=np.asarray(preints.dt) > 1e-4, gravity_w=g,
    )


def phase_solvers(dev, ref, cam, n_feat: int = 1024, ba_window: int = 8,
                  ba_points: int = 2048) -> dict:
    """Each solver on `dev` and on `ref` from the same seeded problem."""

    rng = np.random.default_rng(11)
    cases = {}

    # pose GN: n_feat stereo matches, 20 % gross outliers
    q_gt = np.asarray(quat.from_axis_angle(jnp.asarray([0.05, -0.1, 0.08])))
    p_gt = np.array([0.5, -0.3, 0.2], np.float32)
    xc = np.stack([rng.uniform(-4, 4, n_feat), rng.uniform(-2.5, 2.5, n_feat),
                   rng.uniform(2, 15, n_feat)], -1).astype(np.float32)
    Xw = np.asarray(quat.rotate(q_gt[None], xc)) + p_gt
    uv, ur, _ = _stereo_obs(cam, q_gt, p_gt, Xw, rng)
    bad = rng.choice(n_feat, n_feat // 5, replace=False)
    uv[bad, 0] += rng.uniform(20, 80, len(bad)) * rng.choice([-1, 1], len(bad))
    q0 = np.asarray(quat.mul(q_gt, quat.from_axis_angle(
        jnp.asarray([0.03, -0.02, 0.04]))))
    p0 = p_gt + np.array([0.15, -0.1, 0.08], np.float32)
    pose = jax.jit(lambda *a: pose_optimize(*a)[:2], static_argnums=())
    args = (q0, p0, cam, Xw, uv, ur, np.zeros(n_feat, np.int32),
            np.ones(n_feat, bool))
    cases["pose_optimize"] = (_on_device(dev, pose, *args),
                              _on_device(ref, pose, *args))

    # visual local BA over the window
    C, P = ba_window, ba_points
    q, p, X, obs_uv, obs_ur, obs_pt = _ba_scene(cam, rng, C, P, n_feat)
    p_init = (p + rng.normal(0, 0.05, (C, 3))).astype(np.float32)
    p_init[0] = p[0]
    prob = BAProblem(
        q=q, p=p_init, opt_cam=np.arange(C) > 0, cam_valid=np.ones(C, bool),
        Xw=(X + rng.normal(0, 0.08, (P, 3))).astype(np.float32),
        pt_valid=np.ones(P, bool), obs_uv=obs_uv, obs_ur=obs_ur,
        obs_oct=np.zeros((C, n_feat), np.int32), obs_pt=obs_pt,
    )
    lba = jax.jit(lambda pr, c: solve_local_ba(pr, c, iters=4)[:3])
    cases["solve_local_ba"] = (_on_device(dev, lba, prob, cam),
                               _on_device(ref, lba, prob, cam))

    # visual-inertial BA over the window
    vprob = _vi_problem(cam, rng, C, P, n_feat)
    vba = jax.jit(lambda pr, c: solve_vi_ba(pr, c, iters=4)[:6])
    cases["solve_vi_ba"] = (_on_device(dev, vba, vprob, cam),
                            _on_device(ref, vba, vprob, cam))

    # Sim3 RANSAC, 3D-3D with 30 % outliers, fixed key
    pa = rng.uniform(-3, 3, (n_feat, 3)).astype(np.float32)
    S_q = np.asarray(quat.from_axis_angle(jnp.asarray([0.1, 0.3, -0.2])))
    pb = (1.3 * np.asarray(quat.rotate(S_q[None], pa)) + [0.5, -1.0, 2.0]
          + rng.normal(0, 0.01, pa.shape)).astype(np.float32)
    out = rng.random(n_feat) < 0.3
    pb[out] += rng.uniform(-2, 2, (out.sum(), 3)).astype(np.float32)
    key = np.asarray(jax.random.key_data(jax.random.key(3)))
    sim3 = jax.jit(lambda a, b, k: (lambda S: (S[0].q, S[0].t, S[0].s, S[2]))(
        sim3_ransac(a, b, np.ones(n_feat, bool), jax.random.wrap_key_data(k),
                    fix_scale=False)))
    cases["sim3_ransac"] = (_on_device(dev, sim3, pa, pb, key),
                            _on_device(ref, sim3, pa, pb, key))

    # two-view DLT triangulation of n_feat points
    Xt = np.stack([rng.uniform(-4, 4, n_feat), rng.uniform(-2, 2, n_feat),
                   rng.uniform(3, 20, n_feat)], -1).astype(np.float32)
    qa, pa_ = np.array([1.0, 0, 0, 0], np.float32), np.zeros(3, np.float32)
    qb = np.asarray(quat.from_axis_angle(jnp.asarray([0.0, 0.05, 0.0])))
    pb_ = np.array([0.4, 0.0, 0.05], np.float32)
    uva, _, _ = _stereo_obs(cam, qa, pa_, Xt, rng)
    uvb, _, _ = _stereo_obs(cam, qb, pb_, Xt, rng)

    def tri(c, qa, pa, qb, pb, u1, u2):
        P1 = _projection_matrix(c, qa, pa)
        P2 = _projection_matrix(c, qb, pb)
        return jax.vmap(lambda a, b: _dlt(P1, P2, a, b))(u1, u2)

    targs = (cam, qa, pa_, qb, pb_, uva, uvb)
    cases["triangulate_dlt"] = (_on_device(dev, jax.jit(tri), *targs),
                                _on_device(ref, jax.jit(tri), *targs))

    errs, tol = {}, {}
    for name, (got, want) in cases.items():
        errs[name] = max(_rel_err(g, w) for g, w in
                         zip(jax.tree.leaves(got), jax.tree.leaves(want)))
        tol[name] = SOLVER_RTOL_DLT if name == "triangulate_dlt" else SOLVER_RTOL
    return {
        "phase": "P2_solvers", "rel_err": errs, "rel_tolerance": tol,
        "tolerance": "relative to max(|ref|, 1); matmuls at "
                     "precision=highest, default precision elsewhere",
        "ok": all(errs[k] <= tol[k] for k in errs),
    }


# -------------------------------------------------------------- P3 main path
def _ate(slam, gt_p) -> float:
    _, ps, _ = slam.trajectory_arrays()
    return float(ate_rmse(ps, gt_p[: len(ps)]))


def phase_main_path(world, times, frames, imu, slam_cfg, vocab, chunk: int = 8,
                    ate_bar: float = ATE_BAR_M) -> dict:
    with CompileClock() as warm_cc:
        run_pipeline(world, times, frames, imu, slam_cfg, vocab=vocab,
                     chunk=chunk)
    with CompileClock() as timed_cc:
        slam, fps, elapsed = run_pipeline(world, times, frames, imu, slam_cfg,
                                          vocab=vocab, chunk=chunk)
    _, ps, qs = slam.trajectory_arrays()
    finite = bool(np.isfinite(ps).all() and np.isfinite(qs).all())
    gt_p, _ = world.gt_trajectory()
    ate = _ate(slam, gt_p) if finite else float("nan")
    stats = jax.devices()[0].memory_stats() or {}
    return {
        "phase": "P3_main_path", "frames": len(times), "chunk": chunk,
        "smoke_fps_not_a_benchmark": fps, "timed_s": elapsed,
        "compile_s": warm_cc.seconds + timed_cc.seconds,
        "compiles": warm_cc.count, "compiles_in_timed_pass": timed_cc.count,
        "peak_bytes_in_use": stats.get("peak_bytes_in_use"),
        "finite": finite, "ate_m": ate, "ate_bar_m": ate_bar,
        "n_keyframes": int(slam.map.n_kf), "n_map_points": int(slam.map.n_mp),
        "loop_corrections": int(slam.loop_closer.stats.corrected),
        "ok": bool(finite and ate <= ate_bar),
    }


# ------------------------------------------------------------ P4 loop repair
def phase_loop_repair(world, times, frames, imu, slam_cfg, vocab,
                      chunk: int = 8, min_corrections: int = 1) -> dict:
    with CompileClock() as cc:
        slam, _, _ = run_pipeline(world, times, frames, imu, slam_cfg,
                                  vocab=vocab, chunk=chunk)
        odo, _, _ = run_pipeline(world, times, frames, imu, slam_cfg,
                                 chunk=chunk)
    gt_p, _ = world.gt_trajectory()
    corrected = int(slam.loop_closer.stats.corrected)
    timing = slam.timing_report()
    return {
        "phase": "P4_loop_repair", "frames": len(times),
        "loop_corrections": corrected, "min_corrections": min_corrections,
        "compile_s": cc.seconds, "compiles": cc.count,
        "ate_loop_m": _ate(slam, gt_p), "ate_odometry_m": _ate(odo, gt_p),
        "service_s": {k: v["total_s"] for k, v in timing.items()},
        "ok": corrected >= min_corrections,
    }


# ------------------------------------------------------------ --multi phases
def phase_fleet(devs, streams, cam, slam_cfg, chunk: int = 4,
                atol: float = FLEET_POS_ATOL) -> dict:
    """streams: one (times, frames, imu) per session/device."""

    D = len(streams)
    ms = MultiSessionSlam(cam, slam_cfg, n_sessions=D, chunk=chunk,
                          mesh=Mesh(np.array(devs[:D]), ("dp",)))
    t0 = time.perf_counter()
    for i in range(max(len(s[0]) for s in streams)):
        for s, (times, frames, imu) in enumerate(streams):
            if i < len(times):
                g, a, d = imu[i]
                ms.process_frame(s, frames[i][0], frames[i][1], g, a, d,
                                 float(times[i]))
    ms.finalize()
    fleet_s = time.perf_counter() - t0
    diffs, n_kf = [], []
    for s, (times, frames, imu) in enumerate(streams):
        single = FusedSlam(cam, slam_cfg, chunk=chunk, service_every=10**9)
        for i, t in enumerate(times):
            g, a, d = imu[i]
            single.process_frame(frames[i][0], frames[i][1], g, a, d, float(t))
        single.flush()
        _, p_ms, _ = ms.trajectory_arrays(s)
        _, p_one, _ = single.trajectory_arrays(corrected=False)
        n = min(len(p_ms), len(p_one))
        diffs.append(float(np.abs(p_ms[:n] - p_one[:n]).max()) if n else np.inf)
        n_kf.append(int(ms.session_state(s)[0].n_kf))
    return {
        "phase": "M1_fleet", "sessions": D, "chunk": chunk,
        "frames_per_session": [len(s[0]) for s in streams],
        "fleet_wall_s_incl_compile": fleet_s, "keyframes": n_kf,
        "max_pos_diff_m": diffs, "tolerance_m": atol,
        "ok": bool(all(d <= atol for d in diffs) and min(n_kf) >= 2),
    }


def gba_problem(K: int, P: int, O: int, seed: int = 3):
    """Whole-map BA table: K keyframes along a curve, P points each seen
    by up to O of them, perturbed points and poses."""
    rng = np.random.default_rng(seed)
    s = np.linspace(0, 6, K)
    p_gt = np.stack([s * 1.5, np.sin(s), np.zeros(K)], -1).astype(np.float32)
    q = np.tile(np.array([1.0, 0, 0, 0], np.float32), (K, 1))
    X = np.stack([rng.uniform(-5, 15, P), rng.uniform(-5, 5, P),
                  rng.uniform(3, 20, P)], -1).astype(np.float32)
    seen = np.argsort(rng.random((P, K)), axis=1)[:, : min(O, K)]
    xc = X[:, None, :] - p_gt[seen]  # (P, O, 3)
    ok = xc[..., 2] > 0.5
    z = np.maximum(xc[..., 2], 0.5)
    uv = np.stack([458 * xc[..., 0] / z + 376, 458 * xc[..., 1] / z + 240], -1)
    pts = GlobalBAPoints(
        Xw=(X + rng.normal(0, 0.05, (P, 3))).astype(np.float32),
        pt_valid=np.ones(P, bool),
        obs_kf=np.where(ok, seen, -1).astype(np.int32),
        obs_uv=(uv + rng.normal(0, 0.5, uv.shape)).astype(np.float32),
        obs_ur=np.full((P, O), -1.0, np.float32),
        obs_oct=np.zeros((P, O), np.int32),
    )
    p0 = (p_gt + rng.normal(0, 0.02, (K, 3))).astype(np.float32)
    p0[0] = p_gt[0]
    return pts, q, p0, np.arange(K) > 0


def gba_tile(n_points: int, n_dev: int, cfg_tile: int) -> int:
    """The loop closer's tile rule (loop/closer.py::_global_ba)."""
    return max(min(cfg_tile, -(-n_points // n_dev)), 1)


def phase_gba(devs, cam, K: int, P: int, O: int, iters: int, cfg_tile: int,
              atol: float = GBA_ATOL) -> dict:
    pts, q, p0, opt = jax.tree.map(jnp.asarray, gba_problem(K, P, O))
    res, walls = {}, {}
    for n in (len(devs), 1):
        mesh = Mesh(np.array(devs[:n]), ("pt",))
        tile = gba_tile(P, n, cfg_tile)
        t0 = time.perf_counter()
        out = distributed_global_ba(mesh, pts, q, p0, opt, cam, iters=iters,
                                    tile=tile)
        res[n] = jax.device_get(out)
        walls[n] = time.perf_counter() - t0
    n4 = len(devs)
    diff = {name: float(np.abs(np.asarray(a) - np.asarray(b)).max())
            for name, a, b in zip(("q", "p", "Xw"), res[n4], res[1])}
    finite = all(np.isfinite(np.asarray(a)).all() for a in res[n4])
    return {
        "phase": "M2_gba", "mesh": n4, "K": K, "P": P, "O": O,
        "iters": iters, "tiles": {n: gba_tile(P, n, cfg_tile) for n in walls},
        "wall_s_incl_compile": walls, "max_abs_diff": diff,
        "tolerance": atol,
        "ok": bool(finite and all(d <= atol for d in diff.values())),
    }


# --------------------------------------------------------------------- main
def _fleet_streams(n: int, duration: float):
    streams = []
    for s in range(n):
        w = SyntheticWorld(SyntheticConfig(duration=duration, n_landmarks=1500,
                                           seed=s, **HARD_WORLD))
        times = w.frame_times()
        imu = [w.imu_window(times[i - 1] if i else t, t)
               for i, t in enumerate(times)]
        streams.append((times, w.render_sequence(times), imu))
    return w.cam, streams


def run_phase(results: list, fn, *args, **kw) -> dict:
    """Run one phase, print its JSON line and record whether it passed. A
    phase that raises is reported as failed; the others still run."""
    t = time.perf_counter()
    try:
        out = fn(*args, **kw)
    except Exception as e:
        out = {"phase": fn.__name__, "ok": False, "error": repr(e)}
    out["seconds"] = time.perf_counter() - t
    results.append(out["ok"])
    emit(out)
    return out


def main_single(devs, results):
    t0 = time.perf_counter()
    world, times, frames, imu = build_world(8.0)
    rw, rtimes, rframes, rimu = build_revisit_world()
    emit({"phase": "render", "seconds": time.perf_counter() - t0})
    cpu = jax.devices("cpu")[0]
    cfg = bench_slam_config()
    # the chunk's 2C images, as the fused program sees them
    stack = np.stack([f[i] for f in frames[:8] for i in (0, 1)])
    run_phase(results, phase_kernels, devs[0], cpu, stack, OrbConfig(),
              trace_dir="build/trace_fast")
    run_phase(results, phase_solvers, devs[0], cpu, world.cam)
    vocab = train_world_vocab(world, frames)
    run_phase(results, phase_main_path, world, times, frames, imu, cfg, vocab)
    run_phase(results, phase_loop_repair, rw, rtimes, rframes, rimu, cfg,
              train_world_vocab(rw, rframes))


def main_multi(devs, results, n_dev: int = 4):
    if len(devs) < n_dev:
        raise SystemExit(f"--multi needs {n_dev} devices, have {len(devs)}")
    devs = devs[:n_dev]
    cam, streams = _fleet_streams(n_dev, duration=1.2)
    cfg = bench_slam_config()
    lc = LoopConfig()
    run_phase(results, phase_gba, devs, cam, cfg.cap.max_kf, lc.gba_max_points,
              lc.gba_obs, lc.gba_iters, lc.gba_tile)
    # chunk 8: the single-device reference is P3's program
    run_phase(results, phase_fleet, devs, streams, cam, cfg, chunk=8)
    return devs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the 4-device path (fleet + sharded GBA)")
    args = ap.parse_args(argv)

    devs = require_gpu()
    t_start = time.perf_counter()
    emit({"phase": "P0_device", "kind": devs[0].device_kind,
          "count": len(devs), "card": card_info(),
          "compile_cache": compile_cache.enable()})
    results: list[bool] = []
    if args.multi:
        devs = main_multi(devs, results)
    else:
        main_single(devs, results)
    ok = bool(results) and all(results)
    print(card_info(), flush=True)
    emit({"phase": "summary", "ok": ok,
          "seconds": time.perf_counter() - t_start})
    if not ok:
        return 1
    emit({"ok": True, "device": device_record(devs)})
    return 0


if __name__ == "__main__":
    sys.exit(main())
