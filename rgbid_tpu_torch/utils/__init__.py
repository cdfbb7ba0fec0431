from .logging import JsonlLogger  # noqa: F401
from .profiling import StageTimer  # noqa: F401
