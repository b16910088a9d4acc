"""Multi-device parallelism: mesh construction + distributed global BA.

No analog exists in the reference (single process, thread pipeline —
SURVEY.md §2.3); this is the scaling axis: landmark blocks sharded over
the mesh, per-device partial Hessians, Schur reduction via one psum over
the devices' interconnect.
"""
from orbslam3_tpu.parallel.distributed_ba import (  # noqa: F401
    GlobalBAPoints,
    distributed_global_ba,
    make_point_table,
)
