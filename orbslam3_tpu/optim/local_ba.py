"""Local bundle adjustment with a Schur-complement reduced camera system.

Replaces the reference's dense-LU LM over (6K+3M)^2 systems
(/root/reference/src/optimizer/local_ba_lm.rs:454-507) — which is fatal at
scale — with a fixed-shape Schur formulation (SURVEY.md §7.1 item 4):

  1. per-edge residuals + jacfwd-exact Jacobians, vmapped over a fixed
     (C cams x N feats) edge grid;
  2. Hessian blocks by segment scatters: Hcc (C,6,6), Hpp (P,3,3),
     and a dense per-point cam-stack W (P, 6C, 3);
  3. Schur reduction S = Hcc - sum_p W_p Hpp_p^-1 W_p^T as batched einsums
     (matmul work), Jacobi-preconditioned f32 solve of the (6C, 6C) system;
  4. point back-substitution, masked retraction.

Fixed cameras are handled by zeroing their Jacobians (they still constrain
points). Gauge is fixed by marking at least one camera fixed. Step control:
GN with cost-guarded step rejection + adaptive damping (LM-style), all
inside one lax.scan — no abort flags needed (reference: abort_ba polling at
local_ba_lm.rs:454-456 becomes just a bounded iteration count).
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from orbslam3_tpu.frontend.camera import Camera
from orbslam3_tpu.optim import robust
from orbslam3_tpu.optim.pose_only import _retract, _visual_residual


class BAProblem(NamedTuple):
    """Fixed-shape local BA problem (C cams, P points, E = C*N edges)."""

    q: jnp.ndarray  # (C, 4) body->world
    p: jnp.ndarray  # (C, 3)
    opt_cam: jnp.ndarray  # (C,) bool — False = fixed (anchor / boundary)
    cam_valid: jnp.ndarray  # (C,) bool
    Xw: jnp.ndarray  # (P, 3)
    pt_valid: jnp.ndarray  # (P,) bool
    obs_uv: jnp.ndarray  # (C, N, 2)
    obs_ur: jnp.ndarray  # (C, N)
    obs_oct: jnp.ndarray  # (C, N) int32
    obs_pt: jnp.ndarray  # (C, N) int32 point slot (-1 = no edge)


class BAResult(NamedTuple):
    q: jnp.ndarray
    p: jnp.ndarray
    Xw: jnp.ndarray
    cost0: jnp.ndarray
    cost1: jnp.ndarray
    inlier_edges: jnp.ndarray  # (C, N) bool


def _edge_residual(xi_c, dxp, q0, p0, X0, uv, ur, cam):
    q, p = _retract(q0, p0, xi_c)
    return _visual_residual(jnp.zeros(6), q, p, cam, X0 + dxp, uv, ur)


@partial(jax.jit, static_argnames=("iters",))
def solve_local_ba(prob: BAProblem, cam: Camera, iters: int = 10,
                   init_damping: float = 1e-4) -> BAResult:
    C, N = prob.obs_pt.shape
    P = prob.Xw.shape[0]
    E = C * N

    e_cam = jnp.repeat(jnp.arange(C, dtype=jnp.int32), N)
    e_pt = prob.obs_pt.reshape(-1)
    e_uv = prob.obs_uv.reshape(E, 2)
    e_ur = prob.obs_ur.reshape(E)
    e_oct = prob.obs_oct.reshape(E)
    e_valid = (
        (e_pt >= 0)
        & prob.cam_valid[e_cam]
        & prob.pt_valid[jnp.clip(e_pt, 0, P - 1)]
    )
    e_pt_safe = jnp.where(e_valid, e_pt, 0)
    s2inv = robust.octave_sigma2_inv(e_oct)
    delta2 = jnp.where(e_ur >= 0, robust.CHI2_STEREO, robust.CHI2_MONO)

    zero6 = jnp.zeros(6, jnp.float32)
    zero3 = jnp.zeros(3, jnp.float32)
    res_v = jax.vmap(_edge_residual, in_axes=(None, None, 0, 0, 0, 0, 0, None))
    jc_v = jax.vmap(jax.jacfwd(_edge_residual, 0), in_axes=(None, None, 0, 0, 0, 0, 0, None))
    jp_v = jax.vmap(jax.jacfwd(_edge_residual, 1), in_axes=(None, None, 0, 0, 0, 0, 0, None))

    def residuals(q, p, Xw):
        return res_v(zero6, zero3, q[e_cam], p[e_cam], Xw[e_pt_safe], e_uv, e_ur, cam)

    # truncated-Huber cutoff, annealed: early iterations keep every edge
    # (coarse initializations make inliers look like outliers), later ones
    # hard-drop gross outliers at 16x the 95% quantile. Re-evaluated every
    # iteration from the current state, so misclassifications self-heal.
    cutoff_mults = jnp.maximum(16.0, 1e4 * 0.3 ** jnp.arange(iters, dtype=jnp.float32))

    def cost_of(q, p, Xw, cutoff_mult):
        r = residuals(q, p, Xw)
        chi2 = jnp.sum(r * r, -1) * s2inv
        hub = jnp.where(
            chi2 <= delta2, chi2, 2.0 * jnp.sqrt(delta2 * jnp.maximum(chi2, 1e-12)) - delta2
        )
        hub_cap = 2.0 * jnp.sqrt(delta2 * cutoff_mult * delta2) - delta2
        # truncated: constant beyond the cutoff so outliers can't steer the
        # accept/reject test
        return jnp.sum(jnp.minimum(hub, hub_cap) * e_valid)

    def gn_step(carry, cutoff_mult):
        q, p, Xw, damping, cost = carry
        cutoff2 = cutoff_mult * delta2
        qe, pe, Xe = q[e_cam], p[e_cam], Xw[e_pt_safe]
        r = res_v(zero6, zero3, qe, pe, Xe, e_uv, e_ur, cam)  # (E, 3)
        Jc = jc_v(zero6, zero3, qe, pe, Xe, e_uv, e_ur, cam)  # (E, 3, 6)
        Jp = jp_v(zero6, zero3, qe, pe, Xe, e_uv, e_ur, cam)  # (E, 3, 3)

        chi2 = jnp.sum(r * r, -1) * s2inv
        # current cost from the residuals already in hand (saves a third
        # full residual pass per iteration vs re-evaluating cost_of)
        hub = jnp.where(
            chi2 <= delta2, chi2, 2.0 * jnp.sqrt(delta2 * jnp.maximum(chi2, 1e-12)) - delta2
        )
        hub_cap = 2.0 * jnp.sqrt(delta2 * cutoff2) - delta2
        old_cost = jnp.sum(jnp.minimum(hub, hub_cap) * e_valid)
        w = (
            robust.huber_weight(chi2, delta2)
            * (chi2 <= cutoff2).astype(jnp.float32)
            * s2inv
            * e_valid
        )
        # fixed cams: no pose Jacobian (but keep point Jacobian)
        Jc = Jc * prob.opt_cam[e_cam].astype(jnp.float32)[:, None, None]

        Jc_w = Jc * w[:, None, None]
        Jp_w = Jp * w[:, None, None]

        Hcc = jnp.zeros((C, 6, 6)).at[e_cam].add(
            jnp.einsum("eij,eik->ejk", Jc_w, Jc, precision="highest")
        )
        bc = jnp.zeros((C, 6)).at[e_cam].add(
            jnp.einsum("eij,ei->ej", Jc_w, r, precision="highest")
        )
        Hpp = jnp.zeros((P, 3, 3)).at[e_pt_safe].add(
            jnp.einsum("eij,eik->ejk", Jp_w, Jp, precision="highest")
        )
        bp = jnp.zeros((P, 3)).at[e_pt_safe].add(
            jnp.einsum("eij,ei->ej", Jp_w, r, precision="highest")
        )
        Wcp = jnp.einsum("eij,eik->ejk", Jc_w, Jp, precision="highest")  # (E, 6, 3)

        # per-point dense cam stack: (P, C, 6, 3)
        Wstack = jnp.zeros((P, C, 6, 3)).at[e_pt_safe, e_cam].add(Wcp)
        Wstack = Wstack.reshape(P, C * 6, 3)

        lam = damping
        # scale-relative damping keeps rank-deficient point blocks f32-invertible
        tr = (Hpp[:, 0, 0] + Hpp[:, 1, 1] + Hpp[:, 2, 2]) / 3.0
        Hpp_d = Hpp + jnp.eye(3)[None] * (lam + jnp.maximum(lam, 1e-5) * tr + 1e-6)[:, None, None]
        # guard unobserved points
        pt_has_obs = jnp.zeros((P,)).at[e_pt_safe].add(e_valid.astype(jnp.float32)) > 0
        Hpp_inv = jnp.linalg.inv(Hpp_d)
        Hpp_inv = jnp.where(pt_has_obs[:, None, None], Hpp_inv, 0.0)

        # Schur complement (batched einsums)
        Hcc_full = jnp.zeros((C * 6, C * 6))
        Hcc_full = Hcc_full.reshape(C, 6, C, 6).at[jnp.arange(C), :, jnp.arange(C), :].set(
            Hcc
        ).reshape(C * 6, C * 6)
        WHW = jnp.einsum(
            "pik,pkl,pjl->ij", Wstack, Hpp_inv, Wstack, precision="highest"
        )
        S = Hcc_full - WHW
        b_red = bc.reshape(C * 6) - jnp.einsum(
            "pik,pkl,pl->i", Wstack, Hpp_inv, bp, precision="highest"
        )

        # fixed / invalid cams: identity rows
        free = (prob.opt_cam & prob.cam_valid).astype(jnp.float32)
        free6 = jnp.repeat(free, 6)
        S = S * free6[:, None] * free6[None, :] + jnp.diag(1.0 - free6)
        S = S + jnp.eye(C * 6) * lam
        b_red = b_red * free6

        # Jacobi preconditioning for f32 stability
        d = jnp.sqrt(jnp.clip(jnp.diag(S), 1e-8, None))
        S_n = S / d[:, None] / d[None, :]
        dxc = -jnp.linalg.solve(S_n, b_red / d) / d  # (C*6,)

        # back-substitute points: dxp = -Hpp^-1 (bp + W^T dxc)
        Wt_dxc = jnp.einsum("pik,i->pk", Wstack, dxc, precision="highest")
        dxp = -jnp.einsum(
            "pkl,pl->pk", Hpp_inv, bp + Wt_dxc, precision="highest"
        )

        dxc = dxc.reshape(C, 6)
        q_new, p_new = jax.vmap(_retract)(q, p, dxc)
        upd_pt = (prob.pt_valid & pt_has_obs)[:, None]
        Xw_new = jnp.where(upd_pt, Xw + dxp, Xw)

        new_cost = cost_of(q_new, p_new, Xw_new, cutoff_mult)
        accept = new_cost < old_cost
        q, p, Xw = jax.tree.map(
            lambda a, b: jnp.where(accept, b, a), (q, p, Xw), (q_new, p_new, Xw_new)
        )
        damping = jnp.where(accept, jnp.maximum(damping * 0.5, 1e-6), damping * 4.0)
        cost = jnp.where(accept, new_cost, old_cost)
        return (q, p, Xw, damping, cost), cost

    cost0 = cost_of(prob.q, prob.p, prob.Xw, jnp.float32(16.0))
    (q, p, Xw, _, cost1), _ = jax.lax.scan(
        gn_step,
        (prob.q, prob.p, prob.Xw, jnp.float32(init_damping), cost0),
        cutoff_mults,
    )
    r = res_v(zero6, zero3, q[e_cam], p[e_cam], Xw[e_pt_safe], e_uv, e_ur, cam)
    chi2 = jnp.sum(r * r, -1) * s2inv
    inl = (chi2 <= delta2) & e_valid
    return BAResult(q, p, Xw, cost0, cost1, inl.reshape(C, N))