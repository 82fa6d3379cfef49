from .frame_drawer import draw_frame  # noqa: F401
from .map_drawer import draw_map  # noqa: F401
