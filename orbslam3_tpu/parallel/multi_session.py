"""Multi-session SLAM: D independent sessions, one per mesh device.

The data-parallel serving axis of the framework: a multi-GPU host maps
many robots / recorded sequences at once by sharding whole SLAM sessions
over a 1-D `jax.sharding.Mesh` axis "dp". Each device advances ITS session with the
exact single-session program (`models/fused.py::_slam_step_core` — the
per-device block is squeezed to rank-0 batch before the step, so
`lax.cond` keyframe branches stay real branches, not vmap-style selects
that would execute local BA every frame). Zero collectives: sessions are
independent; scaling is linear by construction.

No analog exists in the reference (single process, one sequence —
SURVEY.md §2.3 "no distributed backend"). The host API mirrors FusedSlam
but takes one frame PER SESSION per call; host services (IMU init, loop
closing) are per-session host work and run after `session_state()`
unstacks a session back to ordinary (MapState, TrackState) — the intended
offline-mapping flow is: stream all sequences through the mesh, then
finalize each session (loop closing / GBA) individually.
"""
from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from orbslam3_tpu.frontend.camera import Camera
from orbslam3_tpu.imu.preintegration import pad_imu_window
from orbslam3_tpu.map.slam_map import empty_map
from orbslam3_tpu.models.fused import FrameOut, TrackState, _slam_step_core


def _stack(tree, d: int):
    return jax.tree.map(lambda a: jnp.broadcast_to(a[None], (d,) + a.shape), tree)


def make_multi_session_step(mesh: Mesh, cam: Camera, cfg):
    """jitted (sts, tss, frames..., valid) -> (sts, tss, outs), all
    leading-dim D sharded over mesh axis 'dp'. Frame arrays carry
    (D, chunk, ...); `valid` (D, chunk) masks padding slots so sessions
    advance INDEPENDENTLY — a slot with valid=False leaves that session's
    state untouched (lax.cond skips the whole step program) and emits a
    placeholder FrameOut the host filters out. This is what un-locksteps
    the fleet: one stalled or short stream costs its own device an idle
    branch, never the mesh (VERDICT r2 weak #7)."""

    def per_device(st, ts, lefts, rights, g, a, d, m, t, valid):
        # block = this device's single session: squeeze the size-1 shard dim
        st1 = jax.tree.map(lambda x: x[0], st)
        ts1 = jax.tree.map(lambda x: x[0], ts)

        def body(carry, x):
            s_, t_ = carry
            ll, rr, gg, aa, dd, mm, tt, vv = x

            def step(_):
                return _slam_step_core(s_, t_, ll, rr, gg, aa, dd, mm, tt,
                                       cam, cfg)

            def skip(_):
                out = FrameOut(
                    q=t_.q, p=t_.p, v=t_.v,
                    n_matches=jnp.int32(0), n_inliers=jnp.int32(0),
                    mode=t_.mode, is_kf=jnp.asarray(False),
                    kf_id=jnp.int32(-1), n_kf=s_.n_kf,
                    n_features=jnp.int32(0), n_stereo=jnp.int32(0),
                    mean_reproj_px=jnp.float32(0.0), ref_kf=jnp.int32(-1),
                    rel_q=jnp.asarray([1.0, 0.0, 0.0, 0.0]),
                    rel_p=jnp.zeros(3),
                )
                return s_, t_, out

            s_, t_, out = jax.lax.cond(vv, step, skip, operand=None)
            return (s_, t_), out

        (st1, ts1), outs = jax.lax.scan(
            body, (st1, ts1),
            (lefts[0], rights[0], g[0], a[0], d[0], m[0], t[0], valid[0]),
        )
        ex = lambda x: x[None]
        return (jax.tree.map(ex, st1), jax.tree.map(ex, ts1),
                jax.tree.map(ex, outs))

    # check_vma=False: sessions are embarrassingly parallel (zero
    # collectives), but the varying-manual-axes checker rejects the many
    # literal-seeded scan carries inside the single-session solvers
    # (lam/cost carries in VI-BA etc.) that are replicated on input and
    # varying on output — semantically fine when nothing communicates
    sharded = jax.shard_map(
        per_device, mesh=mesh,
        in_specs=(P("dp"),) * 10, out_specs=(P("dp"),) * 3,
        check_vma=False,
    )
    return jax.jit(sharded, donate_argnums=(0, 1))


class MultiSessionSlam:
    """Host driver for D = mesh-size concurrent SLAM sessions."""

    def __init__(self, cam: Camera, cfg, n_sessions: int,
                 chunk: int = 4, mesh: Optional[Mesh] = None):
        if mesh is None:
            devs = jax.devices()
            if len(devs) < n_sessions:
                raise ValueError(
                    f"{n_sessions} sessions need {n_sessions} devices, have "
                    f"{len(devs)}"
                )
            mesh = Mesh(np.array(devs[:n_sessions]), ("dp",))
        if int(np.prod(mesh.devices.shape)) != n_sessions:
            raise ValueError("v1 runs exactly one session per device")
        self.mesh = mesh
        self.cam = cam
        self.cfg = cfg
        self.chunk = chunk
        self.d = n_sessions
        sh = NamedSharding(mesh, P("dp"))
        self.maps = jax.device_put(_stack(empty_map(cfg.cap), n_sessions), sh)
        self.tss = jax.device_put(_stack(TrackState.initial(), n_sessions), sh)
        self._step = make_multi_session_step(mesh, cam, cfg)
        self._pending: list[list] = [[] for _ in range(n_sessions)]
        self.outs: list = []  # (times (D, C), FrameOut (D, C), valid (D, C))
        self._frames = 0
        # a shape template for padding sessions that have no frame buffered
        # at dispatch time (their slots run with valid=False)
        self._template = None

    def process_frame(self, session: int, left, right, gyro, acc, dts,
                      t: float):
        """Buffer one frame for `session`; dispatches one mesh step as soon
        as ANY session holds `chunk` frames. Sessions advance independently:
        sessions with fewer buffered frames ride along with valid=False
        padding slots (their state does not advance), so one slow or short
        stream never stalls the mesh."""
        g, a, d, m = pad_imu_window(gyro, acc, dts,
                                    self.cfg.max_imu_per_frame)
        frame = (np.asarray(left, np.uint8), np.asarray(right, np.uint8),
                 g, a, d, m, np.float32(t))
        self._pending[session].append(frame)
        if self._template is None:
            self._template = tuple(np.zeros_like(x) for x in frame)
        if len(self._pending[session]) >= self.chunk:
            self.flush()

    def finalize(self):
        """Drain every session's buffered frames (ragged tails dispatch
        with valid=False padding — no repeated frames, no redundant
        keyframes)."""
        while any(self._pending):
            self.flush()

    def flush(self):
        c = min(self.chunk, max((len(p) for p in self._pending), default=0))
        if c == 0:
            return
        valid = np.zeros((self.d, c), bool)
        batches = [[] for _ in range(7)]
        for s, p in enumerate(self._pending):
            take = p[:c]
            valid[s, : len(take)] = True
            pad = [self._template] * (c - len(take))
            for i in range(7):
                batches[i].append(np.stack([f[i] for f in take + pad]))
        batches = [jnp.asarray(np.stack(b)) for b in batches]  # (D, C, ...)
        self._pending = [p[c:] for p in self._pending]
        self.maps, self.tss, outs = self._step(
            self.maps, self.tss, *batches, jnp.asarray(valid)
        )
        self.outs.append((np.asarray(batches[6]), outs, valid))
        self._frames += int(valid.sum())

    def session_state(self, i: int):
        """Unstack session i to a plain (MapState, TrackState) — feed it to
        per-session host services (loop closing, export, checkpoint)."""
        return (
            jax.tree.map(lambda a: a[i], self.maps),
            jax.tree.map(lambda a: a[i], self.tss),
        )

    def trajectory_arrays(self, i: int):
        """(times, positions, quats) tracked for session i so far —
        valid=False padding slots are filtered out."""
        ts_, ps, qs = [], [], []
        for t_arr, outs, valid in self.outs:
            o: FrameOut = jax.device_get(jax.tree.map(lambda a: a[i], outs))
            m = valid[i]
            ts_.append(np.asarray(t_arr[i])[m])
            ps.append(np.asarray(o.p)[m])
            qs.append(np.asarray(o.q)[m])
        if not ts_:
            z = np.zeros((0, 3))
            return np.zeros((0,)), z, np.zeros((0, 4))
        return np.concatenate(ts_), np.concatenate(ps), np.concatenate(qs)


def merge_session_maps(states, vocab, cam: Camera, loop_cfg=None):
    """Weld session maps into one global map (collaborative mapping).

    Concatenates every session's MapState into one multi-map Atlas state
    (map/compaction.py::concat_maps) and replays all keyframes through the
    cross-map loop-closing path: when a keyframe of one session recognizes
    another session's area, the verified Sim3 folds its whole map into the
    other's world frame (loop/closer.py::_merge_maps) and pose-graph + BA
    refine the weld. Sessions with no overlap simply remain separate atlas
    maps in the returned state.

    Returns (MapState, LoopCloser) — the closer carries merge stats.
    """
    from orbslam3_tpu.loop.closer import LoopCloser, LoopConfig
    from orbslam3_tpu.map.compaction import concat_maps

    st = states[0]
    for other in states[1:]:
        st, _, _ = concat_maps(st, other)
    closer = LoopCloser(vocab, loop_cfg or LoopConfig())
    for k in range(int(st.n_kf)):
        st, _ = closer.on_keyframe(st, k, cam)
    st, _ = closer.drain(st, cam)
    return st, closer
