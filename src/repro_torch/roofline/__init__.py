"""The roofline of the port: ``hlo`` (the reference's collective accounting,
copied), ``count`` (the FLOP, byte and collective counter) and ``analysis``
(three time terms per cell, priced at the H100's rates)."""
