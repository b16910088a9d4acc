"""Lie-group math for SLAM: SO(3), SE(3), Sim(3) as functional JAX ops.

All functions are pure, broadcast over leading batch dimensions, and are
jit/vmap/grad-safe (small-angle branches via jnp.where with safe operands).

Reference capability: /root/reference/src/geometry/{so3.rs,se3.rs,sim3.rs}.
Representation choice differs deliberately: rotations are unit quaternions
(wxyz) stored in flat arrays, which batch and normalize cheaply,
instead of nalgebra UnitQuaternion objects.
"""
from orbslam3_tpu.geometry import quat, se3, sim3, so3  # noqa: F401
from orbslam3_tpu.geometry.se3 import SE3  # noqa: F401
from orbslam3_tpu.geometry.sim3 import Sim3  # noqa: F401
