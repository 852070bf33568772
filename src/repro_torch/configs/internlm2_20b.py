"""internlm2_20b — thin module per assignment structure; config in registry."""
from .registry import INTERNLM2_20B as CONFIG  # noqa: F401
from .registry import get_shapes

SHAPES = get_shapes(CONFIG.arch_id)
