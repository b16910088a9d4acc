"""IMU preintegration on manifold (Forster et al., TRO 2017) as a lax.scan.

Replaces the per-sample Rust loop of
/root/reference/src/imu/preintegration.rs:269-501 with a single jitted scan
over a padded sample array; covariance is the full 15x15 (state 9 + bias 6)
like the reference (preintegration.rs:383-458), bias Jacobians are the
standard five blocks (preintegration.rs:443-457).

Convention (differs from the reference on purpose — SURVEY.md §7.3 item 3):
deltas are *gravity-free*; gravity appears only in `propagate` and in the
residual. This is the textbook Forster formulation, consistent everywhere.

All quantities are float32; covariances stay well-conditioned because deltas
span <1 s of 200 Hz data.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from orbslam3_tpu.geometry import quat, so3
from orbslam3_tpu.utils.precision import matmul_hp as mm

GRAVITY = np.asarray([0.0, 0.0, -9.81], dtype=np.float32)


class ImuNoise(NamedTuple):
    """Continuous-time noise densities (EuRoC MH defaults, matching the
    reference's hard-coded values in src/imu/sample.rs:24-33)."""

    sigma_g: float = 1.7e-4  # rad/s/sqrt(Hz) gyro white noise
    sigma_a: float = 2.0e-3  # m/s^2/sqrt(Hz) accel white noise
    sigma_bg: float = 1.9e-5  # gyro bias random walk
    sigma_ba: float = 3.0e-3  # accel bias random walk

    @staticmethod
    def default() -> "ImuNoise":
        return ImuNoise()


class PreintState(NamedTuple):
    """Preintegrated IMU measurement between two frames/keyframes.

    Error-state ordering for cov: [dphi(3), dv(3), dp(3), dbg(3), dba(3)].
    """

    dq: jnp.ndarray  # (4,) delta rotation quaternion (body_i -> body_j)
    dv: jnp.ndarray  # (3,) delta velocity (gravity-free, in body_i frame)
    dp: jnp.ndarray  # (3,) delta position (gravity-free, in body_i frame)
    dt: jnp.ndarray  # () total integration time
    cov: jnp.ndarray  # (15, 15) error covariance
    J_r_bg: jnp.ndarray  # (3, 3) d(dR)/d(bias_gyro)
    J_v_bg: jnp.ndarray  # (3, 3)
    J_v_ba: jnp.ndarray  # (3, 3)
    J_p_bg: jnp.ndarray  # (3, 3)
    J_p_ba: jnp.ndarray  # (3, 3)
    bias_g: jnp.ndarray  # (3,) gyro bias used during integration
    bias_a: jnp.ndarray  # (3,) accel bias used during integration

    @staticmethod
    def identity(bias_g=None, bias_a=None) -> "PreintState":
        z3 = jnp.zeros(3, jnp.float32)
        z33 = jnp.zeros((3, 3), jnp.float32)
        return PreintState(
            dq=quat.identity(),
            dv=z3,
            dp=z3,
            dt=jnp.zeros((), jnp.float32),
            cov=jnp.zeros((15, 15), jnp.float32),
            J_r_bg=z33,
            J_v_bg=z33,
            J_v_ba=z33,
            J_p_bg=z33,
            J_p_ba=z33,
            bias_g=z3 if bias_g is None else bias_g,
            bias_a=z3 if bias_a is None else bias_a,
        )


def integrate(gyro, acc, dts, mask, bias_g, bias_a, noise: ImuNoise = ImuNoise()):
    """Preintegrate a padded sample window.

    Args:
      gyro: (N, 3) angular rates [rad/s]
      acc: (N, 3) specific force [m/s^2]
      dts: (N,) per-sample integration intervals [s]
      mask: (N,) bool/float validity (padding rows contribute nothing)
      bias_g, bias_a: (3,) biases held fixed across the window
    Returns:
      PreintState
    """
    maskf = mask.astype(jnp.float32)
    dts = dts * maskf  # padded rows integrate for zero time

    sg2 = noise.sigma_g**2
    sa2 = noise.sigma_a**2
    sbg2 = noise.sigma_bg**2
    sba2 = noise.sigma_ba**2

    def step(carry: PreintState, inp):
        w, a, dt, m = inp
        w = w - carry.bias_g
        a = a - carry.bias_a
        dt_safe = jnp.where(dt > 0, dt, 1.0)

        R_k = quat.to_matrix(carry.dq)  # DeltaR_ik
        wdt = w * dt
        dR = so3.exp_matrix(wdt)
        Jr = so3.right_jacobian(wdt)
        a_hat = so3.hat(a)

        # --- covariance propagation (before state update, Forster eq. A.8/9)
        A9 = jnp.zeros((9, 9), jnp.float32)
        A9 = A9.at[0:3, 0:3].set(dR.T)
        A9 = A9.at[3:6, 0:3].set(-mm(R_k, a_hat) * dt)
        A9 = A9.at[3:6, 3:6].set(jnp.eye(3))
        A9 = A9.at[6:9, 0:3].set(-0.5 * mm(R_k, a_hat) * dt * dt)
        A9 = A9.at[6:9, 3:6].set(jnp.eye(3) * dt)
        A9 = A9.at[6:9, 6:9].set(jnp.eye(3))
        # bias coupling (state wrt bias error)
        Asb = jnp.zeros((9, 6), jnp.float32)
        Asb = Asb.at[0:3, 0:3].set(-Jr * dt)
        Asb = Asb.at[3:6, 3:6].set(-R_k * dt)
        Asb = Asb.at[6:9, 3:6].set(-0.5 * R_k * dt * dt)
        A = jnp.zeros((15, 15), jnp.float32)
        A = A.at[0:9, 0:9].set(A9)
        A = A.at[0:9, 9:15].set(Asb)
        A = A.at[9:15, 9:15].set(jnp.eye(6))

        B = jnp.zeros((15, 6), jnp.float32)
        B = B.at[0:3, 0:3].set(Jr * dt)
        B = B.at[3:6, 3:6].set(R_k * dt)
        B = B.at[6:9, 3:6].set(0.5 * R_k * dt * dt)
        # discretized white noise: sigma^2 / dt
        Q = jnp.diag(
            jnp.concatenate(
                [jnp.full(3, sg2), jnp.full(3, sa2)]
            )
            / dt_safe
        )
        cov = mm(mm(A, carry.cov), A.T) + mm(mm(B, Q), B.T)
        # bias random walk
        cov = cov.at[9:15, 9:15].add(
            jnp.diag(jnp.concatenate([jnp.full(3, sbg2), jnp.full(3, sba2)])) * dt
        )

        # --- bias Jacobian propagation (order matters: use pre-update values)
        J_p_bg = carry.J_p_bg + carry.J_v_bg * dt - 0.5 * mm(mm(R_k, a_hat), carry.J_r_bg) * dt * dt
        J_p_ba = carry.J_p_ba + carry.J_v_ba * dt - 0.5 * R_k * dt * dt
        J_v_bg = carry.J_v_bg - mm(mm(R_k, a_hat), carry.J_r_bg) * dt
        J_v_ba = carry.J_v_ba - R_k * dt
        J_r_bg = mm(dR.T, carry.J_r_bg) - Jr * dt

        # --- mean update (midpoint attitude for 2nd-order accuracy, like the
        # reference's mid-point scheme at preintegration.rs:477-488)
        R_mid = mm(R_k, so3.exp_matrix(0.5 * wdt))
        Ra_dt = mm(R_mid, a) * dt
        dp = carry.dp + carry.dv * dt + 0.5 * Ra_dt * dt
        dv = carry.dv + Ra_dt
        dq = quat.normalize(quat.mul(carry.dq, quat.from_axis_angle(wdt)))

        new = PreintState(
            dq=dq,
            dv=dv,
            dp=dp,
            dt=carry.dt + dt,
            cov=cov,
            J_r_bg=J_r_bg,
            J_v_bg=J_v_bg,
            J_v_ba=J_v_ba,
            J_p_bg=J_p_bg,
            J_p_ba=J_p_ba,
            bias_g=carry.bias_g,
            bias_a=carry.bias_a,
        )
        # masked rows are no-ops (dt=0 already guarantees mean/Jacobian no-op,
        # but guard cov against the sigma^2/dt_safe term explicitly)
        new = jax.tree.map(lambda n, c: jnp.where(m > 0, n, c), new, carry)
        return new, None

    init = PreintState.identity(bias_g, bias_a)
    out, _ = jax.lax.scan(step, init, (gyro, acc, dts, maskf))
    return out


def bias_corrected_delta(st: PreintState, bias_g, bias_a):
    """First-order bias correction (reference: preintegration.rs:138-198).

    Returns (dq_corr, dv_corr, dp_corr) for the new bias estimate.
    """
    dbg = bias_g - st.bias_g
    dba = bias_a - st.bias_a
    dq = quat.normalize(quat.mul(st.dq, quat.from_axis_angle(mm(st.J_r_bg, dbg))))
    dv = st.dv + mm(st.J_v_bg, dbg) + mm(st.J_v_ba, dba)
    dp = st.dp + mm(st.J_p_bg, dbg) + mm(st.J_p_ba, dba)
    return dq, dv, dp


def propagate(st: PreintState, q_wb, v_w, p_w, bias_g=None, bias_a=None, gravity=GRAVITY):
    """Predict state j from state i using the preintegrated deltas.

    (reference: preintegration.rs:491-501, but with explicit gravity since our
    deltas are gravity-free)
    """
    if bias_g is None:
        dq, dv, dp = st.dq, st.dv, st.dp
    else:
        dq, dv, dp = bias_corrected_delta(st, bias_g, bias_a)
    dt = st.dt
    q_j = quat.normalize(quat.mul(q_wb, dq))
    v_j = v_w + gravity * dt + quat.rotate(q_wb, dv)
    p_j = p_w + v_w * dt + 0.5 * gravity * dt * dt + quat.rotate(q_wb, dp)
    return q_j, v_j, p_j


def imu_residual(st: PreintState, q_i, v_i, p_i, q_j, v_j, p_j, bias_g, bias_a, gravity=GRAVITY):
    """9-D preintegration residual [r_R, r_v, r_p] (Forster eq. 45).

    Capability parity with /root/reference/src/optimizer/imu_factors.rs:68-101
    (same residual, consistent gravity convention).
    """
    dq, dv, dp = bias_corrected_delta(st, bias_g, bias_a)
    dt = st.dt
    qi_inv = quat.conj(q_i)
    r_R = quat.to_axis_angle(quat.mul(quat.conj(dq), quat.mul(qi_inv, q_j)))
    r_v = quat.rotate(qi_inv, v_j - v_i - gravity * dt) - dv
    r_p = quat.rotate(qi_inv, p_j - p_i - v_i * dt - 0.5 * gravity * dt * dt) - dp
    return jnp.concatenate([r_R, r_v, r_p])


def merge(s1: PreintState, s2: PreintState) -> PreintState:
    """Concatenate two consecutive preintegrations (for keyframe culling —
    reference: preintegration.rs:204-265; its covariance merge is an
    acknowledged approximation, ours propagates error states exactly to
    first order).

    Assumes both were integrated with the same bias.
    """
    R1 = quat.to_matrix(s1.dq)
    R2 = quat.to_matrix(s2.dq)
    dt2 = s2.dt

    dq = quat.normalize(quat.mul(s1.dq, s2.dq))
    dv = s1.dv + mm(R1, s2.dv)
    dp = s1.dp + s1.dv * dt2 + mm(R1, s2.dp)

    # bias Jacobians of the composite
    J_r_bg = mm(R2.T, s1.J_r_bg) + s2.J_r_bg
    J_v_bg = s1.J_v_bg + mm(R1, s2.J_v_bg) - mm(mm(R1, so3.hat(s2.dv)), s1.J_r_bg)
    J_v_ba = s1.J_v_ba + mm(R1, s2.J_v_ba)
    J_p_bg = (
        s1.J_p_bg + s1.J_v_bg * dt2 + mm(R1, s2.J_p_bg) - mm(mm(R1, so3.hat(s2.dp)), s1.J_r_bg)
    )
    J_p_ba = s1.J_p_ba + s1.J_v_ba * dt2 + mm(R1, s2.J_p_ba)

    # first-order error composition:
    #   dphi = R2^T dphi1 + dphi2
    #   dv   = dv1 - R1 hat(dv2) dphi1 + R1 dv2
    #   dp   = dp1 + dv1 dt2 - R1 hat(dp2) dphi1 + R1 dp2
    A1 = jnp.zeros((15, 15), jnp.float32)
    A1 = A1.at[0:3, 0:3].set(R2.T)
    A1 = A1.at[3:6, 0:3].set(-mm(R1, so3.hat(s2.dv)))
    A1 = A1.at[3:6, 3:6].set(jnp.eye(3))
    A1 = A1.at[6:9, 0:3].set(-mm(R1, so3.hat(s2.dp)))
    A1 = A1.at[6:9, 3:6].set(jnp.eye(3) * dt2)
    A1 = A1.at[6:9, 6:9].set(jnp.eye(3))
    A1 = A1.at[9:15, 9:15].set(jnp.eye(6))

    A2 = jnp.zeros((15, 15), jnp.float32)
    A2 = A2.at[0:3, 0:3].set(jnp.eye(3))
    A2 = A2.at[3:6, 3:6].set(R1)
    A2 = A2.at[6:9, 6:9].set(R1)
    # bias-error block of segment 2 feeds the composite through A2 identity;
    # the random-walk accumulation sums naturally (sigma_bw^2 * (dt1 + dt2)).
    A2 = A2.at[9:15, 9:15].set(jnp.eye(6) * 0.0)

    cov = mm(mm(A1, s1.cov), A1.T) + mm(mm(A2, s2.cov), A2.T)
    # keep the full bias-walk accumulation from both segments
    cov = cov.at[9:15, 9:15].set(s1.cov[9:15, 9:15] + s2.cov[9:15, 9:15])

    return PreintState(
        dq=dq,
        dv=dv,
        dp=dp,
        dt=s1.dt + dt2,
        cov=cov,
        J_r_bg=J_r_bg,
        J_v_bg=J_v_bg,
        J_v_ba=J_v_ba,
        J_p_bg=J_p_bg,
        J_p_ba=J_p_ba,
        bias_g=s1.bias_g,
        bias_a=s1.bias_a,
    )


def information_9(st: PreintState):
    """9x9 information matrix of [r_R, r_v, r_p] from the covariance."""
    cov9 = st.cov[0:9, 0:9]
    cov9 = 0.5 * (cov9 + cov9.T) + jnp.eye(9) * 1e-8
    return jnp.linalg.inv(cov9)


def _single_step_states(gyro, acc, dts, mask, bias_g, bias_a, noise: ImuNoise):
    """Per-sample atomic PreintStates (vmapped single-interval integration)."""
    maskf = mask.astype(jnp.float32)
    dts = dts * maskf

    sg2, sa2 = noise.sigma_g**2, noise.sigma_a**2
    sbg2, sba2 = noise.sigma_bg**2, noise.sigma_ba**2

    def one(w, a, dt):
        w = w - bias_g
        a = a - bias_a
        dt_safe = jnp.where(dt > 0, dt, 1.0)
        wdt = w * dt
        dq = quat.from_axis_angle(wdt)
        Jr = so3.right_jacobian(wdt)
        R_mid = so3.exp_matrix(0.5 * wdt)
        Ra_dt = mm(R_mid, a) * dt
        dv = Ra_dt
        dp = 0.5 * Ra_dt * dt

        B = jnp.zeros((15, 6), jnp.float32)
        B = B.at[0:3, 0:3].set(Jr * dt)
        B = B.at[3:6, 3:6].set(jnp.eye(3) * dt)
        B = B.at[6:9, 3:6].set(0.5 * jnp.eye(3) * dt * dt)
        Q = jnp.diag(jnp.concatenate([jnp.full(3, sg2), jnp.full(3, sa2)]) / dt_safe)
        cov = mm(mm(B, Q), B.T)
        cov = cov.at[9:15, 9:15].add(
            jnp.diag(jnp.concatenate([jnp.full(3, sbg2), jnp.full(3, sba2)])) * dt
        )
        a_hat = so3.hat(a)
        return PreintState(
            dq=dq,
            dv=dv,
            dp=dp,
            dt=dt,
            cov=cov,
            J_r_bg=-Jr * dt,
            J_v_bg=jnp.zeros((3, 3)),
            J_v_ba=-jnp.eye(3) * dt,
            J_p_bg=jnp.zeros((3, 3)),
            J_p_ba=-0.5 * jnp.eye(3) * dt * dt,
            bias_g=bias_g,
            bias_a=bias_a,
        )

    return jax.vmap(one)(gyro, acc, dts)


def integrate_assoc(gyro, acc, dts, mask, bias_g, bias_a, noise: ImuNoise = ImuNoise()):
    """Preintegration via jax.lax.associative_scan over `merge`.

    Same inputs/semantics as `integrate`, but O(log N) sequential depth
    instead of an N-step scan — the composition of preintegrated segments
    (merge) is associative, so the window parallelizes: a 32-deep chain
    of tiny matmuls becomes 5 rounds of batched ones.
    """
    states = _single_step_states(gyro, acc, dts, mask, bias_g, bias_a, noise)
    merged = jax.lax.associative_scan(jax.vmap(merge), states)
    return jax.tree.map(lambda a: a[-1], merged)


def pad_imu_window(gyro, acc, dts, n):
    """Right-pad a variable-length host IMU window to the fixed device
    shape: (gyro (n,3), acc (n,3), dt (n,), mask (n,)) numpy float32/bool.
    The one padding implementation every pipeline front door shares
    (FusedSlam / SlamSystem / MultiSessionSlam)."""
    import numpy as np

    k = min(len(dts), n)
    g = np.zeros((n, 3), np.float32)
    a = np.zeros((n, 3), np.float32)
    d = np.zeros((n,), np.float32)
    m = np.zeros((n,), bool)
    if k:
        g[:k], a[:k], d[:k], m[:k] = gyro[:k], acc[:k], dts[:k], True
    return g, a, d, m
