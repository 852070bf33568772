"""Hand-written CUDA kernels of the port, their plain torch versions
(``ref.py``) and the dispatching wrappers (``ops.py``)."""
