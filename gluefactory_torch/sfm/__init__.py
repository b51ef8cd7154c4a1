"""The multi-view SfM back-end (gluefactory_tpu/sfm): triangulation, the
Sim(3) alignment and trajectory error, Levenberg-Marquardt bundle adjustment
on the Schur complement, the pose graph, and the incremental pipeline that
chains two-view poses into a trajectory."""

from .alignment import absolute_trajectory_error, umeyama_alignment
from .ba import BAProblem, bundle_adjust, bundle_adjust_sharded
from .pipeline import run_sfm
from .pose_graph import optimize_pose_graph
from .triangulation import triangulate_linear, triangulate_two_view

__all__ = [
    "BAProblem",
    "absolute_trajectory_error",
    "bundle_adjust",
    "bundle_adjust_sharded",
    "optimize_pose_graph",
    "run_sfm",
    "triangulate_linear",
    "triangulate_two_view",
    "umeyama_alignment",
]
