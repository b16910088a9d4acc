"""Fully-fused on-device SLAM step: ONE jitted program per frame.

Why: the per-frame host orchestration in models/slam.py costs ~10
dispatch+sync round-trips per frame, each a host stall. Here the ENTIRE
tracking iteration — stereo ORB front-end, IMU
preintegration, prediction, local-map matching, robust pose solve,
keyframe decision, and (conditionally) keyframe insertion + local BA +
culling + lost/atlas handling — is one XLA program over (MapState,
TrackState). The host streams frames and reads results lazily, so
dispatches pipeline behind the device
(SURVEY.md §7.3 item 5: "keep full tracker step as one jitted program").

Control flow notes:
  * keyframe insertion / BA / cull run under lax.cond — compiled once,
    executed only on keyframe frames;
  * the IMU window since the last keyframe is maintained as a RUNNING
    PreintState via pre.merge (O(1) per frame) instead of re-integrating a
    sample ring buffer (O(window) scan);
  * rare host-side events (IMU init, loop closing) read the device state
    asynchronously every few frames.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from orbslam3_tpu.frontend.camera import Camera
from orbslam3_tpu.frontend.orb import detect_orb_batch, detect_orb_pair
from orbslam3_tpu.frontend.stereo import match_stereo
from orbslam3_tpu.geometry import quat
from orbslam3_tpu.imu import preintegration as pre
from orbslam3_tpu.map import slam_map as sm
from orbslam3_tpu.models.local_mapper import (
    apply_ba_results,
    apply_vi_ba_results,
    build_ba_problem,
    build_vi_ba_problem,
)
import orbslam3_tpu.models.policy as policy
from orbslam3_tpu.models.tracker import match_local_map, update_point_counters
from orbslam3_tpu.optim.local_ba import solve_local_ba
from orbslam3_tpu.optim.vi_ba import solve_vi_ba
from orbslam3_tpu.optim.pose_only import pose_inertial_optimize, pose_optimize

MODE_NOT_INIT = 0
MODE_OK = 1
MODE_RECENTLY_LOST = 2


class TrackState(NamedTuple):
    """Device-resident tracker state (the host never unpacks it per frame)."""

    q: jnp.ndarray  # (4,)
    p: jnp.ndarray  # (3,)
    v: jnp.ndarray  # (3,)
    bg: jnp.ndarray  # (3,)
    ba: jnp.ndarray  # (3,)
    motion_dq: jnp.ndarray  # (4,)
    motion_dp: jnp.ndarray  # (3,)
    mode: jnp.ndarray  # () int32
    lost_since: jnp.ndarray  # () f32, -1 = not lost
    # time tracking last FAILED (any frame with now_lost); drives the
    # recovery-state IMU-edge cap — after dead-reckoning, the IMU-carried
    # state is suspect until vision has held for a couple of seconds
    last_lost_t: jnp.ndarray  # () f32, very negative = never
    last_t: jnp.ndarray  # () f32
    frames_since_kf: jnp.ndarray  # () int32
    ref_inliers: jnp.ndarray  # () int32
    kfs_since_cull: jnp.ndarray  # () int32
    last_kf: jnp.ndarray  # () int32
    kf_preint: pre.PreintState  # running preintegration since last keyframe
    gravity_w: jnp.ndarray  # (3,)
    imu_ok: jnp.ndarray  # () bool

    @staticmethod
    def initial() -> "TrackState":
        return TrackState(
            q=quat.identity(),
            p=jnp.zeros(3),
            v=jnp.zeros(3),
            bg=jnp.zeros(3),
            ba=jnp.zeros(3),
            motion_dq=quat.identity(),
            motion_dp=jnp.zeros(3),
            mode=jnp.int32(MODE_NOT_INIT),
            lost_since=jnp.float32(-1.0),
            last_lost_t=jnp.float32(-1e9),
            last_t=jnp.float32(0.0),
            frames_since_kf=jnp.int32(0),
            ref_inliers=jnp.int32(1),
            kfs_since_cull=jnp.int32(0),
            last_kf=jnp.int32(0),
            kf_preint=pre.PreintState.identity(),
            gravity_w=jnp.asarray([0.0, 0.0, -9.81]),
            imu_ok=jnp.asarray(False),
        )


class FrameOut(NamedTuple):
    """Per-frame outputs (reference: TrackingResult/TrackingMetrics,
    result.rs:17-75 — features/matches/inliers/reprojection statistics)."""

    q: jnp.ndarray
    p: jnp.ndarray
    v: jnp.ndarray
    n_matches: jnp.ndarray
    n_inliers: jnp.ndarray
    mode: jnp.ndarray
    is_kf: jnp.ndarray
    kf_id: jnp.ndarray
    n_kf: jnp.ndarray
    n_features: jnp.ndarray  # valid detections this frame
    n_stereo: jnp.ndarray  # features with stereo depth
    mean_reproj_px: jnp.ndarray  # RMS reprojection error of inliers [px]
    # pose RELATIVE to the reference keyframe at record time: trajectory
    # export composes rel with the FINAL keyframe pose, so loop/merge
    # corrections apply retroactively (ORB-SLAM3's export convention; the
    # raw per-frame pose stream jumps at every map weld)
    ref_kf: jnp.ndarray  # () int32 (-1 = none)
    rel_q: jnp.ndarray  # (4,)
    rel_p: jnp.ndarray  # (3,)


@partial(jax.jit, static_argnames=("cfg",), donate_argnums=(0, 1))
def slam_step(st: sm.MapState, ts: TrackState, left_u8, right_u8,
              gyro, acc, dts, imu_mask, t, cam: Camera, cfg):
    """One full SLAM iteration. cfg is a SlamConfig (static)."""
    return _slam_step_core(st, ts, left_u8, right_u8, gyro, acc, dts,
                           imu_mask, t, cam, cfg)


@partial(jax.jit, static_argnames=("cfg",), donate_argnums=(0, 1))
def slam_step_chunk(st: sm.MapState, ts: TrackState, lefts, rights,
                    gyro, acc, dts, imu_mask, t, cam: Camera, cfg):
    """C SLAM iterations in ONE dispatch (lax.scan over the step core).

    Each dispatch marshals the ~45-buffer map pytree; batching C frames per
    dispatch amortizes that C-fold. Inputs carry a leading chunk axis;
    outputs are the batched per-frame FrameOuts. Latency grows by C frames —
    a throughput/latency knob (C=1 for real-time latency, larger C for
    offline runs).
    """

    fe = _frontend_chunk(lefts, rights, cam, cfg)

    def body(carry, x):
        st_, ts_ = carry
        fe_i, g, a, d, m, tt = x
        st_, ts_, out = _slam_step_core(st_, ts_, None, None, g, a, d, m,
                                        tt, cam, cfg, fe=fe_i)
        return (st_, ts_), out

    (st, ts), outs = jax.lax.scan(
        body, (st, ts), (fe, gyro, acc, dts, imu_mask, t)
    )
    return st, ts, outs


def _frontend(left_u8, right_u8, cam: Camera, cfg):
    """Per-frame front-end: ORB pair detection + stereo matching.

    State-independent (no MapState/TrackState input), so the chunked path
    batches it across ALL chunk frames before the sequential scan
    (see _frontend_chunk)."""
    left = left_u8.astype(jnp.float32)
    right = right_u8.astype(jnp.float32)

    # ---------------- front-end (both images in one batched program)
    featL, featR = detect_orb_pair(left, right, cfg.orb)
    u_r, depth, has_depth = match_stereo(featL, featR, cam, cfg.stereo)
    # body-frame 3D points: states are body poses, so map points spawn as
    # R_wb (T_BC ∘ X_cam) + p_wb inside insert_keyframe
    points_body = cam.cam_pts_to_body(
        cam.unproject(featL.uv, jnp.where(has_depth, depth, 1.0))
    )
    return featL, u_r, depth, has_depth, points_body


def _frontend_chunk(lefts_u8, rights_u8, cam: Camera, cfg):
    """Front-end for ALL C chunk frames in ONE batched program (2C images).

    Extraction/stereo matching depend only on the images, not on tracking
    state — lifting them out of the per-frame lax.scan turns C serial
    small-kernel passes into one 2C-wide batch (the front-end's per-level
    kernels are small, so launches, not bytes, bound them).
    """
    C = lefts_u8.shape[0]
    imgs = jnp.concatenate([lefts_u8, rights_u8]).astype(jnp.float32)
    f = detect_orb_batch(imgs, cfg.orb)
    featL = jax.tree.map(lambda a: a[:C], f)
    featR = jax.tree.map(lambda a: a[C:], f)
    u_r, depth, has_depth = jax.vmap(
        lambda fl, fr: match_stereo(fl, fr, cam, cfg.stereo)
    )(featL, featR)
    points_body = jax.vmap(
        lambda uv, hd, dp: cam.cam_pts_to_body(
            cam.unproject(uv, jnp.where(hd, dp, 1.0))
        )
    )(featL.uv, has_depth, depth)
    return featL, u_r, depth, has_depth, points_body


def _slam_step_core(st: sm.MapState, ts: TrackState, left_u8, right_u8,
                    gyro, acc, dts, imu_mask, t, cam: Camera, cfg,
                    fe=None):
    if fe is None:
        fe = _frontend(left_u8, right_u8, cam, cfg)
    featL, u_r, depth, has_depth, points_body = fe
    N = featL.uv.shape[0]

    # ---------------- IMU
    have_imu = jnp.sum(imu_mask.astype(jnp.int32)) > 0
    # associative-scan preintegration: O(log N) depth (merge is the
    # exact segment composition) instead of an N-step sequential scan
    preint_frame = pre.integrate_assoc(gyro, acc, dts, imu_mask, ts.bg, ts.ba,
                                       noise=cfg.imu_noise)
    kf_preint = jax.tree.map(
        lambda a, b: jnp.where(have_imu, a, b),
        pre.merge(ts.kf_preint, preint_frame),
        ts.kf_preint,
    )
    ts = ts._replace(kf_preint=kf_preint)

    dt_frame = jnp.maximum(t - ts.last_t, 0.0)

    # ---------------- predict
    q_imu, v_imu, p_imu = pre.propagate(
        preint_frame, ts.q, ts.v, ts.p, ts.bg, ts.ba, gravity=ts.gravity_w
    )
    q_mm = quat.normalize(quat.mul(ts.q, ts.motion_dq))
    p_mm = ts.p + quat.rotate(ts.q, ts.motion_dp)
    use_imu_pred = ts.imu_ok & have_imu
    q_pred = jnp.where(use_imu_pred, q_imu, q_mm)
    p_pred = jnp.where(use_imu_pred, p_imu, p_mm)
    v_pred = jnp.where(use_imu_pred, v_imu, ts.v)

    # ---------------- match + solve
    matched, mp_w, vis_ids, vis_ok = match_local_map(
        st, cam, featL.uv, featL.desc, featL.octave, featL.valid,
        q_pred, p_pred, cfg.track,
    )
    n_matches = jnp.sum((matched >= 0).astype(jnp.int32))

    # reference-keyframe fallback when projection matching under-fills
    # (reference: track_with_reference_kf, tracker.rs:992 — BoW-gated
    # brute-force match against the last keyframe; here a dense mutual-best
    # Hamming pass, pose-free so it survives a broken motion prior)
    def ref_kf_match(_):
        from orbslam3_tpu.ops.hamming import hamming_matrix

        kf = ts.last_kf
        M = st.mp_pos.shape[0]
        okB = st.kf_feat_valid[kf] & (st.kf_mp[kf] >= 0)
        D = hamming_matrix(featL.desc, st.kf_desc[kf]).astype(jnp.float32)
        BIG = 1e6
        cost = jnp.where(featL.valid[:, None] & okB[None, :], D, BIG)
        best = jnp.argmin(cost, axis=1)
        best_val = jnp.min(cost, axis=1)
        back = jnp.argmin(cost, axis=0)
        mutual = back[best] == jnp.arange(cost.shape[0])
        good = (best_val <= cfg.track.max_hamming) & mutual
        mp = st.kf_mp[kf][best]
        mp_safe = jnp.clip(mp, 0, M - 1)
        good = good & (mp >= 0) & st.mp_valid[mp_safe]
        return jnp.where(good, mp_safe, -1), st.mp_pos[mp_safe]

    use_fallback = (n_matches < cfg.min_track_inliers) & (ts.mode != MODE_NOT_INIT)
    matched, mp_w = jax.lax.cond(
        use_fallback, ref_kf_match, lambda _: (matched, mp_w), operand=None
    )
    n_matches = jnp.sum((matched >= 0).astype(jnp.int32))
    valid = matched >= 0
    enough = n_matches >= cfg.min_track_inliers

    # no-prior robust pose (the reference's PnP-RANSAC role, pnp.rs:29-137):
    # when projection matching under-filled — i.e. the motion/IMU prior is
    # suspect — seed the GN solve from a batched 3D-3D RANSAC over the
    # fallback matches instead of trusting the broken prior. Runs only
    # under the fallback branch, so the common path pays nothing.
    q_seed, p_seed = q_pred, p_pred
    if cfg.ransac_fallback:
        from orbslam3_tpu.optim.robust_pose import robust_pose_3d3d

        def ransac_seed(_):
            val3 = valid & has_depth
            key = jax.random.fold_in(
                jax.random.PRNGKey(17),
                jax.lax.bitcast_convert_type(
                    jnp.asarray(t, jnp.float32), jnp.int32),
            )
            q_h, p_h, _inl, n_h = robust_pose_3d3d(
                mp_w, points_body, val3, key, cam.bf, cam.fx,
                n_hyp=cfg.ransac_hyps,
            )
            ok = n_h >= cfg.min_track_inliers
            return (jnp.where(ok, q_h, q_pred), jnp.where(ok, p_h, p_pred))

        q_seed, p_seed = jax.lax.cond(
            use_fallback, ransac_seed, lambda _: (q_pred, p_pred),
            operand=None,
        )

    def solve_vi(_):
        kf = ts.last_kf
        # recovery-state IMU trust: while within imu_trust_recovery_s of
        # the last tracking failure the dead-reckoned prior is suspect —
        # vision leads (cap 10); steady tracking gets the full edge (30).
        # (The velocity/vision band above bounds steady-state velocity
        # error; this cap additionally protects the POSE during the
        # first seconds of reacquisition.)
        recovering = (t - ts.last_lost_t) < cfg.imu_trust_recovery_s
        q_n, p_n, v_n, _bg, _ba, inl, n_inl = pose_inertial_optimize(
            q_seed, p_seed, v_pred, ts.bg, ts.ba, cam,
            mp_w, featL.uv, jnp.where(valid, u_r, -1.0),
            featL.octave, valid.astype(jnp.float32),
            ts.kf_preint, st.kf_q[kf], st.kf_p[kf], st.kf_v[kf],
            st.kf_bg[kf], st.kf_ba[kf], gravity=ts.gravity_w,
            imu_cap=jnp.where(recovering, 10.0, 30.0),
        )
        return q_n, p_n, v_n, inl, n_inl

    def solve_vis(_):
        res = pose_optimize(
            q_seed, p_seed, cam, mp_w, featL.uv,
            jnp.where(valid, u_r, -1.0), featL.octave, valid,
        )
        v_n = jnp.where(
            dt_frame > 1e-6, (res.p - ts.p) / jnp.maximum(dt_frame, 1e-6), ts.v
        )
        return res.q, res.p, v_n, res.inliers, res.n_inliers

    q_new, p_new, v_new, inliers, n_inl = jax.lax.cond(
        ts.imu_ok & have_imu, solve_vi, solve_vis, operand=None
    )

    tracked_ok = enough & (n_inl >= cfg.min_track_inliers)
    # when tracking fails, dead-reckon on the prediction
    q_new = jnp.where(tracked_ok, q_new, q_pred)
    p_new = jnp.where(tracked_ok, p_new, p_pred)
    v_new = jnp.where(tracked_ok, v_new, v_pred)
    # velocity/vision consistency band: a gravity-direction error pumps
    # the velocity STATE up (~9.81*sin(eps) m/s^2) while per-frame vision
    # keeps the position pinned — the solve can hold |v| several m/s
    # wrong with a perfect visual fit (measured |v|=5 m/s while position
    # tracked to ~1 m), and the next tracking dip turns that into a
    # dead-reckoning explosion. Whenever tracking holds, the velocity is
    # clamped to within 0.5 m/s of the visual finite difference: the
    # band sits well above the finite-difference noise (~0.2 m/s at
    # 20 Hz) so nominal VI velocity passes through untouched, while a
    # pumped velocity is continuously bled back to what vision sees.
    v_vis = (p_new - ts.p) / jnp.maximum(dt_frame, 1e-6)
    dv = v_new - v_vis
    dv_n = jnp.linalg.norm(dv)
    v_band = jnp.where(
        tracked_ok & (dt_frame > 1e-6) & (dv_n > 0.5),
        v_vis + dv * (0.5 / jnp.maximum(dv_n, 1e-9)),
        v_new,
    )
    v_new = v_band
    # physical speed clamp: dead-reckoning with a wrong attitude integrates
    # the misprojected gravity into velocity without bound (measured: an
    # EuRoC-format blackout run reached |v| = 105 m/s and flew 500 m off);
    # no real platform this system targets exceeds max_speed
    speed = jnp.linalg.norm(v_new)
    v_new = v_new * jnp.minimum(1.0, cfg.max_speed / jnp.maximum(speed, 1e-6))

    initialized = ts.mode != MODE_NOT_INIT
    # NotInit keeps the previous pose (world anchored at first keyframe)
    q_new = jnp.where(initialized, q_new, ts.q)
    p_new = jnp.where(initialized, p_new, ts.p)
    v_new = jnp.where(initialized, v_new, ts.v)

    # ---------------- state machine
    now_lost = initialized & ~tracked_ok
    last_lost_t = jnp.where(now_lost, t, ts.last_lost_t)
    lost_since = jnp.where(
        now_lost, jnp.where(ts.lost_since < 0, t, ts.lost_since), -1.0
    )
    lost_timeout = now_lost & (lost_since >= 0) & (t - lost_since > cfg.lost_timeout)
    mode = jnp.where(
        initialized, jnp.where(tracked_ok, MODE_OK, MODE_RECENTLY_LOST), MODE_NOT_INIT
    ).astype(jnp.int32)

    # ---------------- atlas: lost beyond timeout -> reset or new map
    def do_lost(op):
        st_, = op
        n_active = sm.count_map_keyframes(st_, st_.active_map)
        st_small = sm.reset_active_map(st_)
        st_big = sm.create_new_map(st_)
        st_ = jax.tree.map(
            lambda a, b: jnp.where(n_active < cfg.min_kfs_keep_map, a, b),
            st_small, st_big,
        )
        return st_

    st = jax.lax.cond(lost_timeout, do_lost, lambda op: op[0], (st,))
    mode = jnp.where(lost_timeout, MODE_NOT_INIT, mode)

    # ---------------- keyframe decision
    n_stereo = jnp.sum(has_depth.astype(jnp.int32))
    want_init = (mode == MODE_NOT_INIT) & (n_stereo >= 50)
    frames_since = ts.frames_since_kf + 1
    policy_kf = policy.keyframe_wanted(
        mode == MODE_OK, frames_since, n_inl, ts.ref_inliers,
        cfg.kf_max_frames, cfg.kf_inlier_ratio, cfg.kf_min_inliers,
    )
    if cfg.insert_kfs_lost:
        policy_kf = policy_kf | policy.keyframe_wanted_lost(
            mode == MODE_RECENTLY_LOST, ts.imu_ok, have_imu,
            frames_since, cfg.kf_max_frames,
            allow_visual=cfg.insert_kfs_lost_visual,
        )
    # capacity guard: never insert past the keyframe array (XLA scatter
    # would silently drop rows while counters advance -> corrupted map)
    has_room = st.n_kf < st.kf_valid.shape[0]
    is_kf = (want_init | policy_kf) & has_room
    # a fresh map anchor cannot trust the carried velocity: after a lost-
    # timeout reset the dead-reckoned velocity is arbitrarily wrong, and
    # seeding the new map's IMU propagation with it re-loses tracking
    # immediately (reset -> fly off -> reset thrash). Vision re-estimates
    # the true velocity within a few frames. (At a session's very first
    # anchor v is already zero, so this is only active after resets.)
    v_new = jnp.where(want_init, jnp.zeros(3), v_new)

    matched_for_insert = jnp.where(want_init, -1, matched)

    def do_insert(op):
        st_, ts_ = op
        st_, kf_id = sm.insert_keyframe(
            st_, t, q_new, p_new, v_new, ts_.bg, ts_.ba,
            featL.uv, u_r, depth, featL.octave, featL.desc, points_body,
            featL.valid, matched_for_insert, ts_.kf_preint,
            jnp.where(want_init, -1, ts_.last_kf),
            new_mp_budget=cfg.new_mp_budget,
        )
        # insert-time tracking quality: pose-solve inliers (0 while dead-
        # reckoning, n_stereo for a map anchor). The loop closer weights
        # pose-graph odometry edges by it (weak edges absorb corrections).
        st_ = st_._replace(kf_inliers=st_.kf_inliers.at[kf_id].set(
            jnp.where(want_init, n_stereo,
                      jnp.where(tracked_ok, n_inl, 0)).astype(jnp.int32)))

        # local BA (skipped for the first few keyframes of a map);
        # visual-inertial temporal-window BA once the IMU is initialized
        # (reference: local_mapper.rs:334 chooses inertial vs visual BA)
        def do_vis_ba(stt):
            prob, ids, valid_w, pt_ids, pt_valid = build_ba_problem(
                stt, kf_id, cfg.ba_window, cfg.ba_points, cfg.ba_fixed
            )
            res = solve_local_ba(prob, cam, iters=cfg.ba_iters)
            kf_q, kf_p, mp_pos = apply_ba_results(
                stt, ids, valid_w & prob.opt_cam, res.q, res.p, pt_ids, pt_valid, res.Xw
            )
            return stt._replace(kf_q=kf_q, kf_p=kf_p, mp_pos=mp_pos)

        def do_vi_ba(stt):
            prob, ids, valid_w, pt_ids, pt_valid = build_vi_ba_problem(
                stt, kf_id, cfg.ba_window, cfg.ba_points, ts_.gravity_w,
                cfg.vi_ba_fixed,
            )
            res = solve_vi_ba(prob, cam, iters=cfg.ba_iters)
            kf_q, kf_p, kf_v, kf_bg, kf_ba, mp_pos = apply_vi_ba_results(
                stt, ids, valid_w & prob.opt_cam, res.q, res.p, res.v,
                res.bg, res.ba, pt_ids, pt_valid, res.Xw,
            )
            return stt._replace(
                kf_q=kf_q, kf_p=kf_p, kf_v=kf_v, kf_bg=kf_bg, kf_ba=kf_ba,
                mp_pos=mp_pos,
            )

        def do_ba(stt):
            return jax.lax.cond(ts_.imu_ok, do_vi_ba, do_vis_ba, stt)

        n_in_map = sm.count_map_keyframes(st_, st_.active_map)
        # skip window BA for keyframes inserted WITHOUT a visual solve
        # (dead-reckoning through a blackout): an observation-less VI-BA
        # window is unanchored — its velocity/bias states wander and the
        # junk keyframe states then poison every later pose-inertial
        # solve's reference/prior (measured: post-blackout velocity
        # divergence). The raw dead-reckoned states are the best available
        # estimate; the post-loop-correction inertial refinement
        # (loop/closer.py::_vi_refine) re-solves the segment once both
        # ends are visually anchored.
        st_ = jax.lax.cond((n_in_map >= 3) & tracked_ok, do_ba,
                           lambda s: s, st_)

        # mono triangulation + duplicate fusion (reference local-mapping
        # steps 3b/3c) — on-device, part of the same program
        if cfg.triangulate_mono:
            from orbslam3_tpu.map.triangulation import triangulate_with_neighbor

            def do_tri(s):
                s2, _ = triangulate_with_neighbor(s, kf_id, cam)
                return s2

            st_ = jax.lax.cond(n_in_map >= 2, do_tri, lambda s: s, st_)
        if cfg.fuse_neighbors:
            from orbslam3_tpu.map.mapping_ops import fuse_map_points

            st_ = jax.lax.cond(
                n_in_map >= 3,
                lambda s: fuse_map_points(s, kf_id, cam),
                lambda s: s,
                st_,
            )
        if cfg.update_point_stats:
            from orbslam3_tpu.map.mapping_ops import update_point_stats

            # medoid descriptor + normal/depth refresh for touched points
            # (reference runs it after fusion, search_in_neighbors.rs:139-150)
            st_ = jax.lax.cond(
                n_in_map >= 2,
                lambda s: update_point_stats(s, kf_id),
                lambda s: s,
                st_,
            )
        # redundancy keyframe culling (reference local_mapper.rs:487-571):
        # every covisible keyframe is a candidate (vectorized selection),
        # threshold 0.9 visual / kf_cull_redundancy_vi inertial; up to
        # kf_cull_max_per_insert removals per insertion (redundancy is
        # recomputed after each removal since obs counts change) bounds KF
        # growth during hovers the way the reference's cull-all pass does.
        if cfg.kf_cull_redundancy > 0:
            from orbslam3_tpu.map.mapping_ops import (
                remove_keyframe, select_cull_candidate)

            thresh = jnp.where(
                ts_.imu_ok, cfg.kf_cull_redundancy_vi, cfg.kf_cull_redundancy
            ).astype(jnp.float32)
            max_gap = jnp.float32(cfg.kf_cull_max_gap)

            def cull_once(s, _):
                cand = select_cull_candidate(s, kf_id, thresh, max_gap)
                s = jax.lax.cond(
                    (cand >= 0) & (n_in_map >= 7),
                    lambda ss: remove_keyframe(
                        ss, jnp.clip(cand, 0, ss.kf_valid.shape[0] - 1)),
                    lambda ss: ss,
                    s,
                )
                return s, None

            st_, _ = jax.lax.scan(
                cull_once, st_, None, length=cfg.kf_cull_max_per_insert
            )

        # cull every cull_every_kfs keyframes
        cull_due = ts_.kfs_since_cull + 1 >= cfg.cull_every_kfs
        st_ = jax.lax.cond(cull_due, lambda s: sm.cull_map_points(s), lambda s: s, st_)

        # adopt the VI-BA-refined biases (and velocity) along with the pose:
        # the bias-walk edges in the window BA are the only estimator that
        # tracks a mid-run bias drift/step, and a tracker frozen on its
        # IMU-init biases drags every later pose solve against vision
        # (measured: ~1 m/s systematic drift after the revisit world's
        # bias step, with 200+ visual inliers). ORB-SLAM3 does the same —
        # frames take the latest keyframe's bias. Adopting exactly at the
        # keyframe boundary keeps the running kf_preint's bias
        # linearization consistent (it resets to identity here).
        # ONLY when this insert had a solid visual solve: during a
        # blackout the VI-BA window is observation-less and its bias /
        # velocity states wander (measured: dead-reckoning drift grew 1.7x
        # when the tracker adopted mid-blackout estimates; an EuRoC-format
        # revisit run diverged to 335 m ATE) — a lost tracker keeps its
        # last vision-anchored biases instead.
        # LOW-PASSED adoption (alpha=0.3): the window VI-BA's bias states
        # carry ~0.03 rad/s absorption noise — larger than a typical true
        # gyro bias — so raw adoption trades a bias STEP response for
        # constant attitude-rate noise. The filter converges on a real
        # step within ~10 keyframes (1-3 s) while averaging the noise 3x
        # down; the rarer inertial_init refines still write ts.bg/ba
        # directly at full trust.
        adopt = ts_.imu_ok & tracked_ok
        new_bg = jnp.where(adopt, 0.7 * ts_.bg + 0.3 * st_.kf_bg[kf_id],
                           ts_.bg)
        new_ba = jnp.where(adopt, 0.7 * ts_.ba + 0.3 * st_.kf_ba[kf_id],
                           ts_.ba)
        ts_ = ts_._replace(
            last_kf=kf_id,
            frames_since_kf=jnp.int32(0),
            ref_inliers=jnp.maximum(jnp.where(want_init, n_stereo, n_matches), 1),
            kfs_since_cull=jnp.where(cull_due, 0, ts_.kfs_since_cull + 1).astype(jnp.int32),
            kf_preint=pre.PreintState.identity(new_bg, new_ba),
            # adopt the refined keyframe state
            q=st_.kf_q[kf_id],
            p=st_.kf_p[kf_id],
            v=jnp.where(adopt, st_.kf_v[kf_id], ts_.v),
            bg=new_bg,
            ba=new_ba,
        )
        return st_, ts_, kf_id

    def no_insert(op):
        st_, ts_ = op
        return st_, ts_._replace(frames_since_kf=frames_since), jnp.int32(-1)

    # counters for culling
    vis, fnd = update_point_counters(
        st.mp_visible, st.mp_found, vis_ids, vis_ok, matched, inliers
    )
    st = st._replace(mp_visible=vis, mp_found=fnd)

    ts = ts._replace(
        motion_dq=jnp.where(
            tracked_ok, quat.normalize(quat.mul(quat.conj(ts.q), q_new)), ts.motion_dq
        ),
        motion_dp=jnp.where(
            tracked_ok, quat.rotate(quat.conj(ts.q), p_new - ts.p), ts.motion_dp
        ),
        q=q_new,
        p=p_new,
        v=v_new,
        # want_init only flips to OK when the anchor keyframe actually went
        # in (has_room); otherwise we'd track against a map with no keyframe
        mode=jnp.where(want_init & has_room, MODE_OK, mode).astype(jnp.int32),
        lost_since=lost_since,
        last_lost_t=last_lost_t,
        last_t=t,
    )
    st, ts, kf_id = jax.lax.cond(is_kf, do_insert, no_insert, (st, ts))

    # tracking-quality metrics (reference: TrackingMetrics, result.rs:30-40)
    from orbslam3_tpu.optim.pose_only import _visual_residual as _vr

    r_fin = jax.vmap(
        lambda Xw, uv_i, ur_i: _vr(jnp.zeros(6), ts.q, ts.p, cam, Xw, uv_i, ur_i),
        in_axes=(0, 0, 0),
    )(mp_w, featL.uv, jnp.where(valid, u_r, -1.0))
    inl_f = inliers.astype(jnp.float32) * valid.astype(jnp.float32)
    sq = jnp.sum(r_fin[:, :2] ** 2, -1)
    mean_reproj = jnp.sqrt(
        jnp.sum(sq * inl_f) / jnp.maximum(jnp.sum(inl_f), 1.0)
    )

    # relative pose to the (post-insert) reference keyframe
    K = st.kf_valid.shape[0]
    ref = jnp.clip(ts.last_kf, 0, K - 1)
    ref_ok = (ts.mode != MODE_NOT_INIT) & st.kf_valid[ref]
    q_ref, p_ref = st.kf_q[ref], st.kf_p[ref]
    rel_q = quat.normalize(quat.mul(quat.conj(q_ref), ts.q))
    rel_p = quat.rotate(quat.conj(q_ref), ts.p - p_ref)

    out = FrameOut(
        q=ts.q, p=ts.p, v=ts.v,
        n_matches=n_matches, n_inliers=n_inl,
        mode=ts.mode, is_kf=is_kf, kf_id=kf_id, n_kf=st.n_kf,
        n_features=jnp.sum(featL.valid.astype(jnp.int32)),
        n_stereo=n_stereo,
        mean_reproj_px=mean_reproj,
        ref_kf=jnp.where(ref_ok, ref, -1),
        rel_q=rel_q,
        rel_p=rel_p,
    )
    return st, ts, out


@partial(jax.jit, static_argnames=("rotate_gravity",))
def _retarget_tracker(ts: TrackState, q_old, p_old, q_new, p_new,
                      rotate_gravity: bool = False) -> TrackState:
    """Apply a loop/merge correction's world-frame delta to the live tracker
    state. ts was estimated while keyframe k sat at (q_old, p_old); the
    correction moved k to (q_new, p_new), i.e. world points were remapped by
    T_delta = T_new . T_old^-1. The motion deltas (motion_dq/dp) are
    body-relative and invariant under this left multiplication.
    (reference analog: tracker reads corrected poses from the shared Atlas
    after loop_corrected is set — here the state is explicit.)

    gravity_w is a property of the MAP's world frame, not of the recent
    segment: a same-map loop correction anchors the candidate (old) side
    and folds the drifted recent segment back into that unchanged frame, so
    gravity must NOT ride the delta — rotating it would tilt it by exactly
    the drift rotation (~0.5 m/s^2 spurious specific force at 3 deg) and
    poison every later pose_inertial/VI-BA step. Only a cross-map MERGE
    (rotate_gravity=True) re-expresses the tracker's entire world frame in
    the matched older map's frame, and then gravity transforms with it."""
    qd = quat.normalize(quat.mul(q_new, quat.conj(q_old)))
    pd = p_new - quat.rotate(qd, p_old)
    return ts._replace(
        q=quat.normalize(quat.mul(qd, ts.q)),
        p=quat.rotate(qd, ts.p) + pd,
        v=quat.rotate(qd, ts.v),
        gravity_w=quat.rotate(qd, ts.gravity_w)
        if rotate_gravity else ts.gravity_w,
    )


def _materialize(tree):
    """Fresh, unshared device buffers for every leaf (donation-safe: XLA
    constant-dedupes literals like repeated zeros, and donating the same
    buffer twice is an error), committed to the default device so that
    state coming back from host services keeps the same placement and the
    step's jit cache key never changes."""
    dev = jax.devices()[0]
    return jax.tree.map(lambda a: jax.device_put(np.array(a), dev), tree)


class FusedSlam:
    """Host wrapper around slam_step: streams frames, reads lazily.

    Drop-in replacement for models.slam.SlamSystem with ~1 dispatch/frame.
    Host-side services (IMU initialization, loop closing) run every
    `service_every` frames on the lazily-fetched outputs.
    """

    def __init__(self, cam: Camera, cfg, vocabulary=None, service_every: int = 8,
                 chunk: int = 1, warmup: bool = False, loop_cfg=None):
        from orbslam3_tpu.map.slam_map import empty_map

        self.cam = cam
        self.cfg = cfg
        self.map = _materialize(empty_map(cfg.cap))
        self.ts = _materialize(TrackState.initial())
        self.outs: list = []  # (t, FrameOut) — device handles, no sync
        # compaction remap bookkeeping for corrected trajectory export:
        # out entry recorded at epoch e must pass its ref_kf through every
        # remap appended after e
        self._out_epochs: list = []
        self._kf_remaps: list = []
        self.service_every = service_every
        self.chunk = chunk  # frames per device dispatch (throughput knob)
        self._pending: list = []
        self._frames = 0
        self._imu_buffer_edges = []
        self.imu_initialized = False
        # host-side UPPER BOUNDS on row usage (incremented without device
        # syncs; resynced to true counts whenever a sync happens anyway).
        # Compaction triggers on the bound crossing the capacity margin.
        self._kf_ub = 0
        self._mp_ub = 0
        self.compactions = 0
        # IMU-init refinement phases (reference: inertial_init_optim.rs:
        # 12-14 — re-run bias-only / gravity refinement as the map
        # matures, with priors phased out by map age)
        self._imu_init_time: float | None = None
        self._imu_phase = 0  # 0 uninit, then one per _REFINE_PHASES entry
        # one-shot gravity/bias refine requested by a loop correction: the
        # just-corrected poses are the most accurate the map ever is, and
        # the pre-correction gravity estimate is what made the drifted
        # segment drift (measured 4 deg gravity error absorbed into a 10x
        # gyro-bias error on the revisit bench)
        self._refine_request = False
        # latest (one-round-stale) tracker-mode snapshot: time-phased
        # refines are deferred while not OK — a refine against a drifting
        # or dead-reckoned window estimates gravity in the DRIFTED
        # segment's frame and poisons the whole VI stack
        self._last_mode_snap = MODE_OK
        # async n_kf snapshot for one-round-delayed keyframe services
        self._nkf_inflight = None
        # async n_mp snapshot + frame stamp: tightens _kf_ub/_mp_ub each
        # service round without a sync (see _host_services)
        self._nmp_inflight = None
        self._snap_inflight_frame = 0
        # service-round counter: tags loop-verify dispatches so a verify
        # launched for an earlier keyframe of the SAME round is not
        # blocked on mid-round (loop/closer.py::_apply_verify)
        self._service_round = 0
        # pipelined atlas-size snapshot (same pattern): tells the loop
        # closer whether archived maps exist, so young single-map
        # keyframes can skip the exhaustive detection pass
        self._mapid_inflight = None
        self._multi_map = False
        # pipelined tracker-mode snapshot: when the (one-round-stale) mode
        # is RECENTLY_LOST, loop-closing services run in RELOCALIZATION
        # mode — consistency gate relaxed to 1 so the first verified
        # candidate re-enters the SAME map before the device's
        # lost-timeout spawns a new one (beats the reference, which only
        # resets — tracker.rs:549-581; VERDICT r3 next #6)
        self._mode_inflight = None
        # reloc mode stays armed a few service rounds past the last LOST
        # snapshot: tracking re-acquires against the FRESH (drift-
        # positioned) lost-keyframe points within a round or two, but the
        # drifted segment still needs the relocalization correction —
        # and the detection packet that carries it is pipelined one
        # keyframe behind
        self._reloc_until = -1
        self._last_t = 0.0
        self.loop_closer = None
        if vocabulary is not None:
            from orbslam3_tpu.loop.closer import LoopCloser, LoopConfig

            self.loop_closer = LoopCloser(vocabulary,
                                          loop_cfg or LoopConfig())
            if warmup:
                # compile detection/verify/pose-graph/GBA NOW instead of
                # at the first real loop closure mid-sequence, where the
                # first compiles would stall tracking
                self.loop_closer.warmup(self.map, self.cam)
        self._n_kf_seen = 0
        # in-pipeline wall-time accounting (reference TimingStats analog,
        # timing.rs): stage -> [total_s, calls]. Host wall time — device
        # work is async, so "dispatch" measures host cost and "services"
        # measures the pipeline syncs
        self.timing: dict[str, list] = {}
        from orbslam3_tpu.utils.logging import Throttle, get_logger

        self._log = get_logger("orbslam3_tpu.fused")
        # counts SERVICE ROUNDS (one per service_every frames): ~12 rounds
        # x default 8 ≈ the reference's every-100-frames throttle
        self._log_throttle = Throttle(max(100 // max(service_every, 1), 1))

    @classmethod
    def from_state(cls, cam: Camera, cfg, map_state, track_state,
                   **kwargs) -> "FusedSlam":
        """Resume a running system from a (MapState, TrackState) pair — a
        checkpoint (map/checkpoint.py::load_map) or an unstacked
        multi-session slot (parallel/multi_session.py::session_state).

        Host mirrors are resynced from the state: row bounds, last frame
        time, IMU phase (a resumed initialized-IMU session skips init and
        the time-phased refinements). Keyframes already in the map are NOT
        re-serviced for loop closing (_n_kf_seen starts at n_kf); they
        remain loop-closure CANDIDATES regardless, because place
        recognition matches against kf_desc directly."""
        slam = cls(cam, cfg, **kwargs)
        slam.map = _materialize(map_state)
        slam.ts = _materialize(track_state)
        slam._kf_ub = int(slam.map.n_kf)
        slam._mp_ub = int(slam.map.n_mp)
        slam._n_kf_seen = int(slam.map.n_kf)
        n_kf = int(slam.map.n_kf)
        if n_kf:
            slam._last_t = float(np.max(np.asarray(slam.map.kf_time[:n_kf])))
        if bool(slam.ts.imu_ok):
            slam.imu_initialized = True
            slam._imu_phase = 3  # past all refinement phases
            slam._imu_init_time = slam._last_t
        return slam

    def _tic(self):
        import time

        return time.perf_counter()

    def _toc(self, name: str, t0: float):
        import time

        cell = self.timing.setdefault(name, [0.0, 0])
        cell[0] += time.perf_counter() - t0
        cell[1] += 1

    def timing_report(self) -> dict:
        """Per-stage host wall time: {stage: {total_s, calls, mean_ms}}."""
        return {
            k: {
                "total_s": round(v[0], 4),
                "calls": v[1],
                "mean_ms": round(1e3 * v[0] / max(v[1], 1), 3),
            }
            for k, v in sorted(self.timing.items())
        }

    def _pad_imu(self, gyro, acc, dts):
        return pre.pad_imu_window(gyro, acc, dts, self.cfg.max_imu_per_frame)

    def process_frame(self, left, right, gyro, acc, dts, t: float):
        g, a, d, m = self._pad_imu(gyro, acc, dts)
        l_u8 = np.asarray(left, np.uint8) if left.dtype != np.uint8 else left
        r_u8 = np.asarray(right, np.uint8) if right.dtype != np.uint8 else right
        out = None
        if self.chunk > 1:
            self._pending.append((l_u8, r_u8, g, a, d, m, np.float32(t)))
            if len(self._pending) >= self.chunk:
                out = self.flush()
        else:
            self.map, self.ts, out = slam_step(
                self.map, self.ts, jnp.asarray(l_u8), jnp.asarray(r_u8),
                jnp.asarray(g), jnp.asarray(a), jnp.asarray(d), jnp.asarray(m),
                jnp.float32(t), self.cam, self.cfg,
            )
            self.outs.append((t, out))
            self._out_epochs.append(len(self._kf_remaps))
        self._frames += 1
        self._last_t = float(t)
        # worst-case rows a frame can add (1 KF; budget stereo spawns +
        # triangulated mono points)
        self._kf_ub += 1
        self._mp_ub += self.cfg.new_mp_budget + 128
        # host services force a pipeline sync; skip them entirely once
        # nothing host-side remains to do (IMU initialized, no loop closer)
        need_services = (
            self.loop_closer is not None
            or (self.cfg.use_imu and not self.imu_initialized)
            or self._imu_refine_due()
            or self._compact_due()
        )
        if need_services and self._frames % self.service_every == 0:
            if self._pending:
                self.flush()
            t0 = self._tic()
            self._host_services()
            self._toc("host_services", t0)
        return out

    def _compact_due(self) -> bool:
        cap = self.cfg.cap
        return (
            self._kf_ub >= cap.max_kf - 4
            or self._mp_ub >= cap.max_mp - 2 * self.cfg.new_mp_budget
        )

    def _compact_once(self):
        """One compaction pass + all host remap bookkeeping."""
        from orbslam3_tpu.map.compaction import compact_map

        prev_chain = np.asarray(self.map.kf_prev)  # pre-compaction rows
        self.map, kf_map, _mp_map = compact_map(self.map)
        km = np.asarray(kf_map)
        # If the tracker's reference keyframe was culled, walk its
        # temporal chain to the nearest surviving predecessor rather
        # than silently re-referencing row 0 (an arbitrary oldest KF).
        lk = int(self.ts.last_kf)
        new_lk = -1
        for _ in range(len(km)):
            if not (0 <= lk < len(km)):
                break
            new_lk = int(km[lk])
            if new_lk >= 0:
                break
            lk = int(prev_chain[lk])
        self.ts = self.ts._replace(last_kf=jnp.int32(max(new_lk, 0)))
        if self.loop_closer is not None:
            self.loop_closer.remap_rows(km)
        # only rows ALREADY serviced count as seen: with the pipelined
        # n_kf snapshot, 1-2 keyframes newer than the snapshot exist at
        # compaction time and must still get their loop-closing service
        # next round (jumping to the full post-compaction count would
        # silently skip their detection forever)
        self._n_kf_seen = int((km[: self._n_kf_seen] >= 0).sum())
        self._kf_remaps.append(km)
        self.compactions += 1
        # the in-flight n_kf snapshot indexes pre-compaction rows
        self._nkf_inflight = None
        self._nmp_inflight = None

    def _maybe_compact(self):
        """Reclaim culled rows when capacity nears exhaustion (the SoA
        analog of the reference's unbounded map — map.rs:30-41). Runs as a
        host service: one extra dispatch, only near the capacity ceiling.

        If capacity stays exhausted AFTER compaction, live rows are what
        occupy it and something must go or the system wedges/starves
        (found by the capacity soak test):
        - keyframe rows held by ARCHIVED maps: evict oldest-archived map
          first (a tracking loss at full capacity could otherwise never
          insert the fresh map's anchor keyframe);
        - keyframe rows of ONE giant active map: pressure-evict the most-
          connected non-recent keyframes (spatial thinning — without new
          keyframe rows, new map points can never spawn and tracking
          starves as the camera moves on);
        - map-point rows: evict stale low-value points (regular culling
          only removes weak YOUNG points; mature out-of-view points live
          forever and a textured world spawns corners without bound)."""
        if not self._compact_due():
            return
        n_kf, n_mp = int(self.map.n_kf), int(self.map.n_mp)
        cap = self.cfg.cap
        if n_kf >= cap.max_kf - 4 or n_mp >= cap.max_mp - 2 * self.cfg.new_mp_budget:
            from orbslam3_tpu.map import mapping_ops as mo
            from orbslam3_tpu.map.slam_map import (
                cull_map_points, drop_map, evict_stale_points)

            self._compact_once()
            while int(self.map.n_kf) >= cap.max_kf - 4:
                kf_map = np.asarray(self.map.kf_map_id)
                kf_valid = np.asarray(self.map.kf_valid)
                active = int(self.map.active_map)
                archived = sorted(
                    set(kf_map[kf_valid].tolist()) - {active})
                if archived:
                    self._log.info(
                        "capacity pressure: evicting archived map %d",
                        archived[0])
                    self.map = drop_map(self.map, jnp.int32(archived[0]))
                    self.map_evictions = getattr(
                        self, "map_evictions", 0) + 1
                else:
                    # one giant active map: thin the densest regions
                    evicted = 0
                    for _ in range(max(cap.max_kf // 8, 4)):
                        k = int(mo.select_pressure_evict_kf(
                            self.map, self.ts.last_kf))
                        if k < 0:
                            break
                        self.map = mo.remove_keyframe(self.map,
                                                      jnp.int32(k))
                        evicted += 1
                    if evicted == 0:
                        break
                    self._log.info(
                        "capacity pressure: evicted %d keyframes", evicted)
                    self.kf_evictions = getattr(
                        self, "kf_evictions", 0) + evicted
                    # orphaned points (lost their observers) go with them
                    self.map = cull_map_points(self.map)
                self._compact_once()
            # stale-point eviction: free >= 4 keyframes' spawn headroom
            # per pass, bounded by _remove_map_points' per-pass cull cap
            n_evict = min(max(cap.max_mp // 8,
                              4 * self.cfg.new_mp_budget), 4096)
            while int(self.map.n_mp) >= cap.max_mp - 2 * self.cfg.new_mp_budget:
                before = int(self.map.n_mp)
                self.map = evict_stale_points(self.map, n_evict)
                self._compact_once()
                after = int(self.map.n_mp)
                if after >= before:
                    break  # nothing eligible (all protected)
                self.mp_evictions = getattr(
                    self, "mp_evictions", 0) + (before - after)
        # resync bounds to the true (possibly just-compacted) counts
        self._kf_ub = int(self.map.n_kf)
        self._mp_ub = int(self.map.n_mp)

    def flush(self):
        """Dispatch any buffered frames as one chunked device call."""
        if not self._pending:
            return None
        t0 = self._tic()
        batch = self._pending
        self._pending = []
        stacked = [jnp.asarray(np.stack([b[i] for b in batch])) for i in range(7)]
        self.map, self.ts, outs = slam_step_chunk(
            self.map, self.ts, *stacked, self.cam, self.cfg
        )
        self._toc("dispatch_chunk", t0)
        # keep the batched FrameOut as ONE device handle; slicing per frame
        # here would issue dozens of tiny device ops and resurrect the
        # dispatch overhead the chunking removed. Host unpacks lazily.
        self.outs.append(([float(b[6]) for b in batch], outs))
        self._out_epochs.append(len(self._kf_remaps))
        return outs

    def finalize(self):
        """Dispatch buffered frames and run a final service round (drains
        the loop closer's in-flight detection packet — without it a loop
        whose closing keyframe is the last of the sequence is lost)."""
        self.flush()
        if self.loop_closer is not None or (
            self.cfg.use_imu and not self.imu_initialized
        ):
            self._host_services(final=True)
        self._drain_loop_closer()

    def _drain_loop_closer(self, sync: bool = True):
        """Act on the loop closer's in-flight detection packet and
        verification. sync=False (idle service rounds) keeps a verify
        dispatched by the drained packet in flight instead of blocking."""
        if self.loop_closer is None or self.loop_closer.pending_kf is None:
            return
        pk = self.loop_closer.pending_kf
        q_old, p_old = self.map.kf_q[pk], self.map.kf_p[pk]
        self.map, corrected = self.loop_closer.drain(self.map, self.cam,
                                                     sync=sync)
        if corrected:
            self.ts = _retarget_tracker(
                self.ts, q_old, p_old,
                self.map.kf_q[pk], self.map.kf_p[pk],
                rotate_gravity=self.loop_closer.last_was_merge,
            )
            self._refine_request = True

    # ------------------------------------------------------------------
    def _host_services(self, final: bool = False):
        """Rare host-side work on lazily-synced state.

        Keyframe discovery is pipelined one service round deep: reading
        `int(self.map.n_kf)` here would block the host on the chunk
        flushed a moment ago (a full device round trip, every round).
        Instead each round acts on the
        count snapshotted LAST round and launches this round's snapshot
        asynchronously. Rows below the stale count are fully written, so
        staleness only delays a keyframe's loop-closing service by one
        round — the detection packet itself is already pipelined the same
        way. `final=True` (finalize) reads synchronously and drains."""
        cfg = self.cfg
        self._service_round += 1
        # `+ 0` copies the scalar into a buffer of its own: self.map is
        # DONATED into the next slam_step, which would delete the raw
        # n_kf handle before next round reads it
        snap, self._nkf_inflight = self._nkf_inflight, self.map.n_kf + jnp.int32(0)
        snap_mp, self._nmp_inflight = self._nmp_inflight, self.map.n_mp + jnp.int32(0)
        snap_mm, self._mapid_inflight = (
            self._mapid_inflight, self.map.next_map_id + jnp.int32(0))
        snap_mode, self._mode_inflight = (
            self._mode_inflight, self.ts.mode + jnp.int32(0))
        snap_frame, self._snap_inflight_frame = (
            self._snap_inflight_frame, self._frames)
        try:
            self._nkf_inflight.copy_to_host_async()
            self._nmp_inflight.copy_to_host_async()
            self._mapid_inflight.copy_to_host_async()
            self._mode_inflight.copy_to_host_async()
        except AttributeError:
            pass
        if snap_mode is not None:
            self._last_mode_snap = int(snap_mode)
            if self._last_mode_snap != MODE_OK:
                # any non-OK snapshot marks "trouble": large loop-closing
                # seams stay plausible for the next ~20 s (drift from a
                # blackout/loss persists until repaired)
                self._trouble_round = self._service_round
            if self._last_mode_snap == MODE_RECENTLY_LOST:
                self._reloc_until = self._service_round + 4
        if final or snap is None:
            n_kf = int(self.map.n_kf)
        else:
            n_kf = int(snap)
        if snap is not None and snap_mp is not None:
            # tighten the host-side row upper bounds from the (one-round-
            # stale) async snapshot: without this, once the worst-case
            # bounds cross the compaction margin they STAY crossed and
            # every service round pays a blocking `int(n_kf)` sync inside
            # _maybe_compact. A
            # frame can add at most 1 KF and new_mp_budget+128 points, so
            # snapshot + lag*worst_case is still a true upper bound.
            lag = self._frames - snap_frame
            self._kf_ub = min(self._kf_ub, int(snap) + lag)
            self._mp_ub = min(
                self._mp_ub,
                int(snap_mp) + lag * (cfg.new_mp_budget + 128),
            )
        if snap_mm is not None:
            # sticky: once archived maps exist, detection stays full-scope
            self._multi_map = self._multi_map or int(snap_mm) > 1
        if self.loop_closer is not None and self.imu_initialized:
            # keep the closer's gravity in sync for the post-correction
            # inertial refinement (device handle, no sync cost)
            self.loop_closer.gravity_w = self.ts.gravity_w
        if cfg.use_imu and not self.imu_initialized:
            # TRUE count, synchronous: the stale snapshot excludes the
            # newest 1-2 keyframes, and on heavily-culled maps (static
            # camera) those are most of the valid rows — the bad_imu guard
            # starved forever on the stale count. Pre-init rounds are a
            # bounded early phase, so this sync doesn't touch steady-state
            # throughput.
            n_true = int(self.map.n_kf)
            if n_true >= cfg.imu_init_kfs:
                t0 = self._tic()
                self._try_imu_init(n_true)
                self._toc("imu_init", t0)
        elif self._imu_refine_due():
            t0 = self._tic()
            self._imu_refine()
            self._toc("imu_refine", t0)
        new_kfs = self._n_kf_seen < n_kf
        # per-keyframe host services: map maintenance (triangulation,
        # fusion, culling) runs ON-DEVICE inside slam_step's keyframe
        # branch; only loop closing remains host-side
        while self._n_kf_seen < n_kf:
            k = self._n_kf_seen
            if self.loop_closer is not None:
                # snapshot this keyframe's pose: if the loop closer corrects
                # the map, the LIVE tracker state (estimated against the
                # pre-correction world frame) must ride along or the next
                # frame's motion prior points at where the map used to be.
                # (the correction transforms EVERY valid keyframe, so the
                # delta measured at row k is exact even though the pipelined
                # closer acts on keyframe k-1's detection packet here)
                q_old, p_old = self.map.kf_q[k], self.map.kf_p[k]
                t0 = self._tic()
                self.map, corrected = self.loop_closer.on_keyframe(
                    self.map, k, self.cam, multi_map=self._multi_map,
                    round_id=self._service_round,
                    reloc=self._service_round < self._reloc_until,
                    # steady: no tracking trouble for ~20 s (50 service
                    # rounds at the default cadence) — arms the closer's
                    # seam plausibility veto. Real drift accumulates at
                    # cm/s while healthy, so a multi-meter seam without
                    # recent trouble is a periodic-texture alias; a seam
                    # right after a blackout (trouble recent) stays
                    # allowed. Session start counts as trouble so young
                    # maps aren't vetoed into paralysis either way.
                    steady=(self._last_mode_snap == MODE_OK
                            and self._service_round
                            - getattr(self, "_trouble_round", 0) > 50),
                )
                self._toc("loop_correct" if corrected else "loop_service", t0)
                if corrected:
                    self.ts = _retarget_tracker(
                        self.ts, q_old, p_old,
                        self.map.kf_q[k], self.map.kf_p[k],
                        rotate_gravity=self.loop_closer.last_was_merge,
                    )
                    # corrected poses are the most accurate the map gets:
                    # re-estimate gravity/biases against them next round
                    self._refine_request = True
            self._n_kf_seen += 1
        if not new_kfs:
            # idle round: act on the in-flight detection packet (leave any
            # freshly-dispatched verify in flight for the next round)
            self._drain_loop_closer(sync=False)
        t0 = self._tic()
        self._maybe_compact()
        self._toc("compaction", t0)
        # throttled run log — only host-side counters, no device sync
        if self._log_throttle.ready():
            self._log.info(
                "frame=%d t=%.2fs kfs_seen=%d imu=%s compactions=%d loops=%s",
                self._frames, self._last_t, self._n_kf_seen,
                self.imu_initialized, self.compactions,
                self.loop_closer.stats.corrected if self.loop_closer else "-",
            )

    def _try_imu_init(self, n_kf):
        from orbslam3_tpu.optim.imu_init import inertial_init

        cfg = self.cfg
        active = int(self.map.active_map)
        kf_valid = np.asarray(self.map.kf_valid[:n_kf])
        kf_map = np.asarray(self.map.kf_map_id[:n_kf])
        in_map = [k for k in range(n_kf) if kf_valid[k] and kf_map[k] == active]
        if len(in_map) < cfg.imu_init_kfs:
            return
        ids = in_map[-16:]
        W = len(ids)
        span = float(self.map.kf_time[ids[-1]] - self.map.kf_time[ids[0]])
        if span < cfg.imu_init_min_time:
            return
        # sufficient-motion guard (reference: check_sufficient_motion,
        # imu_init.rs:194-233): a static camera cannot observe gravity —
        # after bad_imu_timeout with < bad_imu_min_motion displacement,
        # reset the map rather than poison the init
        ps_w = np.asarray(self.map.kf_p[jnp.asarray(in_map)])
        motion = float(np.linalg.norm(ps_w - ps_w[0], axis=1).max())
        full_span = float(self.map.kf_time[in_map[-1]] - self.map.kf_time[in_map[0]])
        if motion < cfg.bad_imu_min_motion:
            if full_span >= cfg.bad_imu_timeout:
                self._reset_bad_imu()
            return  # too static: gravity unobservable, don't attempt init
        # pad to a FIXED 16-row window (repeat the oldest row, mask its
        # fake edges): every call shares one compiled inertial_init shape
        # — per-width variants were first-compiling inside timed windows
        pad = 16 - W
        if pad > 0:
            ids = [ids[0]] * pad + ids
        idx = jnp.asarray(ids)
        qs = self.map.kf_q[idx]
        ps = self.map.kf_p[idx]
        edge_ids = jnp.asarray(ids[1:])
        preints = jax.tree.map(lambda a_: a_[edge_ids], self.map.kf_preint)
        edge_valid = preints.dt > 1e-4
        if pad > 0:
            edge_valid = edge_valid & (jnp.arange(len(ids) - 1) >= pad)
        if int(jnp.sum(edge_valid)) < W - 2:
            return
        res = inertial_init(qs, ps, preints, edge_valid)
        g_norm = float(jnp.linalg.norm(res.gravity_w))
        if not (8.5 < g_norm < 11.0) or not float(res.cost1) < float(res.cost0):
            return
        # scatter only the REAL rows (duplicate pad indices would race)
        idx_r = idx[pad:] if pad > 0 else idx
        kf_v = self.map.kf_v.at[idx_r].set(res.vels[pad:])
        kf_bg = self.map.kf_bg.at[idx_r].set(jnp.tile(res.bias_g, (W, 1)))
        kf_ba = self.map.kf_ba.at[idx_r].set(jnp.tile(res.bias_a, (W, 1)))
        self.map = self.map._replace(kf_v=kf_v, kf_bg=kf_bg, kf_ba=kf_ba)
        self.ts = self.ts._replace(
            gravity_w=res.gravity_w,
            bg=res.bias_g,
            ba=res.bias_a,
            v=res.vels[-1],
            imu_ok=jnp.asarray(True),
        )
        self.imu_initialized = True
        self._imu_phase = 1
        self._imu_init_time = self._last_t

    # time-phased refinement thresholds [s since first init] and prior
    # scales (reference: <5 s strong, <15 s moderate, >=15 s none —
    # inertial_init_optim.rs:81-115; the 30 s phase keeps soak-length
    # sessions converging)
    _REFINE_PHASES = ((1, 5.0, 0.3), (2, 15.0, 0.02), (3, 30.0, 0.02))

    def _imu_refine_due(self) -> bool:
        if not self.imu_initialized or self._imu_init_time is None:
            return False
        if self._refine_request:
            # throttle armed-request retries: each attempt costs host
            # fetches + an inertial_init solve, and retrying EVERY service
            # round until the observability guards pass burned ~10 s of a
            # 40 s revisit run. Every 4th round is plenty — the guards
            # need seconds of new healthy keyframes to start passing.
            if self._service_round - getattr(self, "_refine_attempt_round",
                                             -99) >= 4:
                return True
            return False
        if self._last_mode_snap != MODE_OK:
            return False  # defer: window poses are dead-reckoned/drifting
        age = self._last_t - self._imu_init_time
        for phase, after, _scale in self._REFINE_PHASES:
            if self._imu_phase == phase and age >= after:
                return True
        return False

    def _imu_refine(self):
        """Re-estimate gravity direction + biases against the matured,
        VI-BA-polished keyframe poses (reference: bias-only and
        scale/Rwg refinement passes, inertial_init_optim.rs:12-14).
        Round 1 estimated gravity exactly once (VERDICT missing #8)."""
        from orbslam3_tpu.optim.imu_init import inertial_init

        self._refine_attempt_round = self._service_round
        is_request = self._refine_request
        if is_request:
            # post-loop-correction refine: poses just got their most
            # accurate; moderate prior (a weak prior over a short window
            # overfit and poisoned gravity — see the span guard below)
            scale = 0.1
        else:
            scale = dict(
                (p, s) for p, _a, s in self._REFINE_PHASES
            )[self._imu_phase]
            self._imu_phase += 1  # one attempt per phase either way
        cfg = self.cfg
        n_kf = int(self.map.n_kf)
        active = int(self.map.active_map)
        kf_valid = np.asarray(self.map.kf_valid[:n_kf])
        kf_map = np.asarray(self.map.kf_map_id[:n_kf])
        kf_inl = np.asarray(self.map.kf_inliers[:n_kf])
        all_in_map = [k for k in range(n_kf)
                      if kf_valid[k] and kf_map[k] == active]
        # trailing CONTIGUOUS healthy run only: a dead-reckoned (blackout)
        # keyframe's pose carries no gravity information and its drift
        # rotates the estimate off (30 = the loop closer's weak-edge
        # gate). Contiguity keeps the stored preint edges aligned with the
        # selected pose pairs — skipping interior rows would pair an edge
        # with the wrong baseline.
        in_map = []
        for k in reversed(all_in_map):
            if kf_inl[k] < 30:
                break
            in_map.append(k)
        in_map.reverse()
        if len(in_map) < cfg.imu_init_kfs:
            return  # a pending request stays armed until enough healthy KFs
        # observability guard: gravity direction is only observable from a
        # window with real duration (and the rotation/acceleration it
        # brings); a 16-KF burst spanning <3 s right after a correction
        # produced an overfit estimate that diverged the whole VI stack
        kf_time = np.asarray(self.map.kf_time[:n_kf])
        if float(kf_time[in_map[-1]] - kf_time[in_map[max(-len(in_map), -16)]]) < 3.0:
            return  # stays armed; retried once the healthy window grows
        if is_request:
            self._refine_request = False
        ids = in_map[-16:]
        W = len(ids)
        # fixed 16-row window (same rationale + masked pad edges as
        # _try_imu_init: one compiled inertial_init shape)
        pad = 16 - W
        if pad > 0:
            ids = [ids[0]] * pad + ids
        idx = jnp.asarray(ids)
        edge_ids = jnp.asarray(ids[1:])
        preints = jax.tree.map(lambda a_: a_[edge_ids], self.map.kf_preint)
        edge_valid = preints.dt > 1e-4
        if pad > 0:
            edge_valid = edge_valid & (jnp.arange(len(ids) - 1) >= pad)
        if int(jnp.sum(edge_valid)) < W - 2:
            return
        res = inertial_init(
            self.map.kf_q[idx], self.map.kf_p[idx], preints, edge_valid,
            prior_scale=jnp.float32(scale),
        )
        g_norm = float(jnp.linalg.norm(res.gravity_w))
        if not (9.0 < g_norm < 10.6) or not float(res.cost1) < float(res.cost0):
            return
        # direction-jump guard: once initialized, gravity error is a few
        # degrees at most — a large swing is a degenerate window's noise,
        # not signal
        g_old = np.asarray(self.ts.gravity_w)
        g_new = np.asarray(res.gravity_w)
        cosang = float(np.dot(g_old, g_new)
                       / max(np.linalg.norm(g_old) * np.linalg.norm(g_new),
                             1e-9))
        if cosang < np.cos(np.radians(10.0)):
            return
        self._log.info(
            "imu refine accepted: gravity moved %.2f deg (request=%s t=%.1f)",
            float(np.degrees(np.arccos(np.clip(cosang, -1, 1)))), is_request,
            self._last_t)
        # accept: update gravity + biases (velocities stay VI-BA-owned)
        self.ts = self.ts._replace(
            gravity_w=res.gravity_w, bg=res.bias_g, ba=res.bias_a
        )
        idx_r = idx[pad:] if pad > 0 else idx
        kf_bg = self.map.kf_bg.at[idx_r].set(jnp.tile(res.bias_g, (W, 1)))
        kf_ba = self.map.kf_ba.at[idx_r].set(jnp.tile(res.bias_a, (W, 1)))
        self.map = self.map._replace(kf_bg=kf_bg, kf_ba=kf_ba)
        self.imu_refines = getattr(self, "imu_refines", 0) + 1

    def _reset_bad_imu(self):
        """Static-start recovery: drop the poisoned map, restart tracking
        (reference: reset_for_bad_imu, tracker.rs:587-610)."""
        from orbslam3_tpu.map.slam_map import reset_active_map

        self.map = reset_active_map(self.map)
        # _materialize: identity()/zeros leaves share deduped buffers,
        # which the donating slam_step would otherwise receive twice
        self.ts = _materialize(
            self.ts._replace(
                mode=jnp.int32(MODE_NOT_INIT),
                v=jnp.zeros(3),
                bg=jnp.zeros(3),
                ba=jnp.zeros(3),
                kf_preint=pre.PreintState.identity(),
                frames_since_kf=jnp.int32(0),
                lost_since=jnp.float32(-1.0),
            )
        )
        self.bad_imu_resets = getattr(self, "bad_imu_resets", 0) + 1
        self._imu_phase = 0
        self._imu_init_time = None

    # ------------------------------------------------------------------
    def _flat_outs(self):
        """Host-side flatten: chunked entries hold batched FrameOuts.
        Returns (times, outs, epochs) with one epoch index per frame."""
        ts_, outs, eps = [], [], []
        for (t, o), ep in zip(self.outs, self._out_epochs):
            if isinstance(t, list):  # chunked
                arrs = jax.tree.map(np.asarray, o)
                for i in range(len(t)):
                    ts_.append(t[i])
                    outs.append(jax.tree.map(lambda a, idx=i: a[idx], arrs))
                    eps.append(ep)
            else:
                ts_.append(t)
                outs.append(jax.tree.map(np.asarray, o))
                eps.append(ep)
        return ts_, outs, eps

    def trajectory_arrays(self, corrected: bool = True):
        """(times, positions, quats). With corrected=True each frame pose
        is re-composed from its reference keyframe's FINAL pose (through
        any compaction remaps), so loop closures / map merges apply to the
        whole history — the raw stream keeps pre-correction poses and
        jumps at every weld."""
        from orbslam3_tpu.io.synthetic import _qmul, _qnorm, _qrot

        ts_, outs, eps = self._flat_outs()
        ps = np.stack([o.p for o in outs])
        qs = np.stack([o.q for o in outs])
        if not corrected or not len(outs):
            return np.asarray(ts_), ps, qs

        # host numpy throughout: per-frame device ops would each pay a
        # dispatch round trip
        kf_q = np.asarray(self.map.kf_q, np.float64)
        kf_p = np.asarray(self.map.kf_p, np.float64)
        K = len(kf_q)
        for i, o in enumerate(outs):
            ref = int(o.ref_kf)
            if ref < 0:
                continue
            for km in self._kf_remaps[eps[i]:]:
                ref = int(km[ref]) if 0 <= ref < len(km) else -1
                if ref < 0:
                    break
            if ref < 0 or ref >= K:
                continue  # reference compacted away: keep the raw pose
            # CULLED refs are still used: loop/merge corrections keep
            # culled same-map rows' poses coherent (closer.py::_correct
            # drags them via their temporal edge), and the blackout-era
            # frames whose keyframes get redundancy-culled would otherwise
            # export their raw dead-reckoned poses forever
            qr = kf_q[ref]
            qs[i] = _qnorm(_qmul(qr, np.asarray(o.rel_q, np.float64))).astype(
                np.float32
            )
            ps[i] = (kf_p[ref] + _qrot(qr, np.asarray(o.rel_p, np.float64))).astype(
                np.float32
            )
        return np.asarray(ts_), ps, qs

    def modes(self):
        ts_, outs, _ = self._flat_outs()
        return np.array([int(o.mode) for o in outs])
