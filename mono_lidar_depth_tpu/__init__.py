"""mono_lidar_depth_tpu — batched depth-augmented monocular SLAM engine.

A from-scratch JAX/XLA re-design of the capabilities of
KIT-MRT `mono_lidar_depth` (LIMO's lidar→camera depth-fusion subsystem),
extended with keyframe bundle adjustment and a pose-graph backend.
See SURVEY.md at the repo root for the reference structural analysis.
"""

from .config import DepthEstimatorConfig, TrackletConfig
from .core.depth_estimator import (DepthEstimate, estimate_depths,
                                   estimate_depths_from_frame,
                                   no_ground_plane, rasterize_cloud)
from .core.geometry import SE3, PinholeCamera
from .core.ransac import GroundPlane, fit_ground_plane_ransac, fit_ground_plane_semantic
from .core.result_types import DepthResultType

__all__ = [
    "DepthEstimatorConfig",
    "TrackletConfig",
    "DepthEstimate",
    "estimate_depths",
    "estimate_depths_from_frame",
    "rasterize_cloud",
    "no_ground_plane",
    "SE3",
    "PinholeCamera",
    "GroundPlane",
    "fit_ground_plane_ransac",
    "fit_ground_plane_semantic",
    "DepthResultType",
]

__version__ = "0.1.0"
