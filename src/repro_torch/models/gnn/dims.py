"""The widths that the GNN batch layout fixes per arch, shared by the models
(``api.py``) and the data pipeline (``train/data.py``, which stays numpy
only, so this module imports no torch)."""

D_EDGE = 4  # meshgraphnet edge features: rel-pos (3) + length (1)
D_OUT = {"gcn": None, "meshgraphnet": 3, "equiformer_v2": 1, "mace": 1}
