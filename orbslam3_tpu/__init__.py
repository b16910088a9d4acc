"""orbslam3_tpu — a stereo-inertial SLAM engine in JAX.

A JAX/XLA implementation of the full ORB-SLAM3 stereo-inertial
pipeline (reference capability set: jurmy24/orb-slam3-rust): ORB front-end,
IMU preintegration, tracking, local mapping with Schur-complement bundle
adjustment, loop closing (BoW + Sim3 + pose graph + global BA), multi-map
Atlas, and distributed global BA over a `jax.sharding.Mesh`.

Design principles (accelerator-first, see SURVEY.md §7):
  * structure-of-arrays fixed-capacity map state with validity masks
  * every solver is a jitted fixed-iteration program (lax.scan / fori_loop)
  * batched hypotheses instead of data-dependent RANSAC loops
  * Schur-complement reduced camera system instead of dense LU
  * device mesh + collectives for multi-device global BA
"""

__version__ = "0.1.0"
