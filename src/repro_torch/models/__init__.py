"""The LM's modules as torch ops: shared blocks, attention, MoE, the
transformer and its weight loader (the reference's ``models/`` minus the
GNN and recsys families, which have not been ported yet)."""
