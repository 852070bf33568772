from .plans import LocalPlan, MeshPlan, ShardedState, mesh_key_of  # noqa: F401
