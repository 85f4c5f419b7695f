from stereo_vo.parallel.distributed import (
    host_local_problem_to_global,
    initialize_multihost,
    shard_for_host,
)
from stereo_vo.parallel.mesh import make_mesh
from stereo_vo.parallel.sharded_ba import (
    dp_sharded_bundle_adjust,
    sharded_bundle_adjust,
    sharded_lm_solve,
    window_to_landmark_major,
)

__all__ = [
    "dp_sharded_bundle_adjust",
    "host_local_problem_to_global",
    "initialize_multihost",
    "make_mesh",
    "shard_for_host",
    "sharded_bundle_adjust",
    "sharded_lm_solve",
    "window_to_landmark_major",
]
