"""PyTorch/CUDA port of the CFPQ system (``repro`` is the JAX reference).

The package mirrors ``repro`` module by module.  Entry points run on the
CUDA device unless the caller passes ``device="cpu"``; asking for CUDA on
a machine without a card raises.
"""
