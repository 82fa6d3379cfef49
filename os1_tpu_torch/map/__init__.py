"""map: the host map store and its device mirror (see os1_tpu/map)."""
from .store import MapConfig, MapStore  # noqa: F401
from .mirror import DeviceMirror  # noqa: F401
