"""parallel: the distributed back end over a device mesh (see os1_tpu/parallel)."""
from .backend import MeshBABackend, default_mesh_backend, two_level_backend  # noqa: F401
from .dist_ba import distributed_ba, make_distributed_ba, shard_problem  # noqa: F401
from .dist_database import DistKeyFrameDatabase  # noqa: F401
from .dist_pose_graph import (  # noqa: F401
    distributed_pose_graph,
    make_distributed_pose_graph,
)
from .mesh import Mesh, psum  # noqa: F401
