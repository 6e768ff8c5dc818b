"""Multi-device ISP steps over ``torch.distributed``: the cameras of a rig
split over ranks (``sharding``), each frame's rows split over ranks with a
halo exchange (``spatial``), or both on a 2-D mesh; device discovery,
meshes, the dispatch queue and a helper that runs a function on ``n``
ranks (``runtime``); and ``dryrun_multigpu``, which checks every mesh
variant against the unsharded step (``dryrun``)."""

from taichi_image_tpu_torch.parallel.runtime import (
    CAMERA_AXIS,
    DispatchQueue,
    NullExecutor,
    device_count,
    devices,
    dispatch_queue,
    make_camera_mesh,
    queued,
    run_ranks,
)
from taichi_image_tpu_torch.parallel.sharding import (
    gather_cameras,
    make_sharded_isp_step,
    replicate,
    shard_cameras,
    sharded_step_for_isp,
)
from taichi_image_tpu_torch.parallel.spatial import (
    ROW_AXIS,
    demosaic_phases_spatial,
    gather_rows,
    make_grid_isp_step,
    make_spatial_isp_step,
    shard_rows,
)

__all__ = [
    "CAMERA_AXIS", "DispatchQueue", "NullExecutor", "device_count",
    "devices", "dispatch_queue", "make_camera_mesh", "queued",
    "make_sharded_isp_step", "replicate", "shard_cameras",
    "sharded_step_for_isp", "ROW_AXIS", "demosaic_phases_spatial",
    "make_spatial_isp_step", "shard_rows",
    "gather_cameras", "gather_rows", "make_grid_isp_step", "run_ranks",
]
