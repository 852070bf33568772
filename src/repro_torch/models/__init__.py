"""The reference's ``models/`` as torch ops: shared blocks, attention, MoE,
the transformer and its weight loader, the recommender (``recsys``) and the
GNN family (``gnn``)."""
