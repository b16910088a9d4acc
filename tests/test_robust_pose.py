"""Batched 3D-3D RANSAC pose (batched replacement for the reference's
PnP-RANSAC, pnp.rs:29-137): exact recovery on clean data, robustness to
gross outliers, graceful failure below the minimal-sample size."""
import jax
import jax.numpy as jnp
import numpy as np

from orbslam3_tpu.geometry import quat
from orbslam3_tpu.optim.robust_pose import robust_pose_3d3d

RNG = np.random.default_rng(11)
FX = 458.0
BF = FX * 0.11  # EuRoC-ish fx * baseline


def make_scene(n=256, n_out=0, q_true=None, p_true=None):
    q_true = quat.normalize(jnp.asarray(q_true if q_true is not None
                                        else [0.9, 0.1, -0.2, 0.15]))
    p_true = jnp.asarray(p_true if p_true is not None else [0.7, -0.4, 0.3])
    Xw = jnp.asarray(
        np.stack([RNG.uniform(-4, 4, n), RNG.uniform(-3, 3, n),
                  RNG.uniform(2.0, 8.0, n)], -1).astype(np.float32)
    )
    # body frame: Xb = R_wb^T (Xw - p_wb)
    Xb = quat.rotate(quat.conj(q_true)[None], Xw - p_true[None])
    if n_out:
        bad = jnp.asarray(
            np.stack([RNG.uniform(-5, 5, n_out), RNG.uniform(-5, 5, n_out),
                      RNG.uniform(1, 9, n_out)], -1).astype(np.float32)
        )
        Xb = Xb.at[:n_out].set(bad)  # corrupt the first rows
    valid = jnp.ones((n,), bool)
    return Xw, Xb, valid, q_true, p_true


def test_exact_recovery_clean():
    Xw, Xb, valid, q_true, p_true = make_scene()
    q, p, inl, n = robust_pose_3d3d(Xw, Xb, valid, jax.random.PRNGKey(0), BF, FX)
    assert int(n) > 250
    # quaternion up to sign
    qe = np.asarray(q) * np.sign(float(q[0]) * float(q_true[0]) or 1.0)
    np.testing.assert_allclose(qe, np.asarray(q_true), atol=2e-3)
    np.testing.assert_allclose(np.asarray(p), np.asarray(p_true), atol=5e-3)


def test_survives_60pct_outliers():
    Xw, Xb, valid, q_true, p_true = make_scene(n=256, n_out=154)
    q, p, inl, n = robust_pose_3d3d(Xw, Xb, valid, jax.random.PRNGKey(1), BF, FX,
                                    n_hyp=256)
    assert int(n) >= 80, int(n)
    np.testing.assert_allclose(np.asarray(p), np.asarray(p_true), atol=3e-2)
    ang = 2 * np.degrees(
        np.arccos(np.clip(abs(float(jnp.sum(q * q_true))), -1, 1))
    )
    assert ang < 2.0, ang
    # outlier rows overwhelmingly rejected (a few random outliers can land
    # inside the depth-aware radius of the true pose by chance)
    assert int(jnp.sum(inl[:154])) <= 8


def test_too_few_points_fails_gracefully():
    Xw, Xb, valid, *_ = make_scene(n=16)
    valid = valid.at[2:].set(False)  # only 2 usable
    q, p, inl, n = robust_pose_3d3d(Xw, Xb, valid, jax.random.PRNGKey(2), BF, FX)
    assert int(n) == 0
    np.testing.assert_allclose(np.asarray(q), [1, 0, 0, 0])
    assert not bool(jnp.any(inl))


def test_anisotropic_threshold():
    """Stereo depth noise grows as z^2/(fx*b) ALONG the ray but only z/fx
    laterally: the same 0.4 m along-ray error is an inlier far away and an
    outlier up close, while 0.4 m of lateral error is an outlier even far."""
    Xw, Xb, valid, q_true, p_true = make_scene(n=128)
    z = np.asarray(Xb[:, 2])
    far = int(np.argmax(z))
    near = int(np.argmin(z))
    assert 4.0 * z[far] ** 2 / BF > 0.4 > 4.0 * z[near] ** 2 / BF
    u_far = np.asarray(Xb[far]) / np.linalg.norm(np.asarray(Xb[far]))
    # pick a lateral victim distinct from far/near
    lat = int(np.argsort(z)[-2])
    u_lat = np.asarray(Xb[lat]) / np.linalg.norm(np.asarray(Xb[lat]))
    perp = np.cross(u_lat, [0.0, 0.0, 1.0])
    perp /= np.linalg.norm(perp)
    Xb = (
        Xb.at[far].add(jnp.asarray(0.4 * u_far, jnp.float32))
        .at[near, 2].add(0.4)
        .at[lat].add(jnp.asarray(0.4 * perp, jnp.float32))
    )
    q, p, inl, n = robust_pose_3d3d(Xw, Xb, valid, jax.random.PRNGKey(3),
                                    BF, FX)
    assert bool(inl[far])  # along-ray error within far-range depth noise
    assert not bool(inl[near])  # same error at close range: gross outlier
    assert not bool(inl[lat])  # lateral error: outlier at any range
