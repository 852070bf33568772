from .base import *  # noqa: F401,F403
from .registry import ARCHS, SHAPES, get_config, get_shapes, all_cells  # noqa: F401
