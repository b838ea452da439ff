"""Numeric building blocks of the PyTorch port: the MBAR reductions, the
double-word storage helpers and the hand-written CUDA kernels (``wsum_dd``,
the many-state route's ``denom_sums_dd`` + ``wsum_denom_dd``, and the
lognum family ``logden_dd``, ``lognum_dd``, ``lognum_fused_dd``)."""
