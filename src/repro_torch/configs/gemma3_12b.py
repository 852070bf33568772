"""gemma3_12b — thin module per assignment structure; config in registry."""
from .registry import GEMMA3_12B as CONFIG  # noqa: F401
from .registry import get_shapes

SHAPES = get_shapes(CONFIG.arch_id)
