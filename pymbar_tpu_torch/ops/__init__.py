"""Numeric building blocks of the PyTorch port: the MBAR reductions, the
double-word storage helpers and the hand-written CUDA kernels (``wsum_dd``,
and the many-state route's ``denom_sums_dd`` + ``wsum_denom_dd``)."""
