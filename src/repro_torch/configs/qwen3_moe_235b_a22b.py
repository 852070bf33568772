"""qwen3_moe_235b_a22b — thin module per assignment structure; config in registry."""
from .registry import QWEN3_MOE as CONFIG  # noqa: F401
from .registry import get_shapes

SHAPES = get_shapes(CONFIG.arch_id)
