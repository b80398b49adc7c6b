"""Distribution: device meshes, sharded frame batches, distributed
Schur-complement bundle adjustment (SURVEY.md §2.7 mappings)."""

from .mesh import make_mesh, frame_sharding, replicated_sharding
from .sharded import (ba_problem_specs, distributed_ba,
                      distributed_pose_graph, pose_graph_specs,
                      sharded_depth_association)

__all__ = ["make_mesh", "frame_sharding", "replicated_sharding",
           "ba_problem_specs", "pose_graph_specs",
           "distributed_ba", "distributed_pose_graph",
           "sharded_depth_association"]
