"""optim: pose-only and bundle-adjustment solvers (see os1_tpu/optim)."""
from .pose_opt import PoseOptResult, optimize_pose  # noqa: F401
from .ba_core import (  # noqa: F401
    BAProblem,
    BAResult,
    BAState,
    ba_begin,
    ba_iterate,
    ba_result,
)
