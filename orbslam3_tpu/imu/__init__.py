"""IMU preintegration and noise models (scan-based).

Capability parity with /root/reference/src/imu/ (preintegration.rs, sample.rs,
types.rs, state.rs) — but using standard Forster-style *gravity-free* deltas
(the reference folds gravity into its deltas; SURVEY.md §7.3 flags that
convention as internally tense and says not to copy it).
"""
from orbslam3_tpu.imu.preintegration import (  # noqa: F401
    GRAVITY,
    ImuNoise,
    PreintState,
    bias_corrected_delta,
    imu_residual,
    integrate,
    merge,
    propagate,
)
