"""gcn_cora — thin module per assignment structure; config in registry."""
from .registry import GCN_CORA as CONFIG  # noqa: F401
from .registry import get_shapes

SHAPES = get_shapes(CONFIG.arch_id)
