"""The GNN family (the port of the reference's ``models/gnn/``): segment
ops and the neighbour sampler (``common``), the SO(3) algebra (``so3``),
GCN and MeshGraphNet (``simple``), MACE (``mace``), Equiformer-v2
(``equiformer_v2``), and the unified interface with the ``GNN`` module
(``api``).  Importing the package imports no torch (``dims`` is read by the
numpy-only data pipeline)."""
