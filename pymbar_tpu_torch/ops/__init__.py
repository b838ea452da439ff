"""Numeric building blocks of the PyTorch port: the MBAR reductions, the
double-word storage helpers and the hand-written CUDA ``wsum_dd`` kernel."""
