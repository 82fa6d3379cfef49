"""pipeline: the System facade, the tracking state machine and its device
programs (see os1_tpu/pipeline)."""
from .config import SlamConfig, TrackingThresholds  # noqa: F401
from .system import System  # noqa: F401
from .tracking import Tracker, TrackingState  # noqa: F401
