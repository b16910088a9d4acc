"""Compute kernels (plain JAX, compiled by XLA) for the SLAM front-end and solvers.

These replace the reference's native OpenCV calls (SURVEY.md §2.2):
  * pyramid + FAST + orientation + BRIEF  <- features2d::ORB (stereo.rs:38-78)
  * hamming (+-1 bf16 matmul)              <- BFMatcher NORM_HAMMING
  * schur (reduced camera system)         <- dense LU in local_ba_lm.rs
"""
