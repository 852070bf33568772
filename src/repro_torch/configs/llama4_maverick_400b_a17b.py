"""llama4_maverick_400b_a17b — thin module per assignment structure; config in registry."""
from .registry import LLAMA4_MAVERICK as CONFIG  # noqa: F401
from .registry import get_shapes

SHAPES = get_shapes(CONFIG.arch_id)
