"""equiformer_v2 — thin module per assignment structure; config in registry."""
from .registry import EQUIFORMER_V2 as CONFIG  # noqa: F401
from .registry import get_shapes

SHAPES = get_shapes(CONFIG.arch_id)
