"""Numeric building blocks of the PyTorch port: the MBAR reductions, the
stable weighted ``logsumexp``, the double-word storage helpers and the
hand-written CUDA kernels (``wsum_dd``, the many-state route's
``denom_sums_dd`` + ``wsum_denom_dd``, the lognum family ``logden_dd``,
``lognum_dd``, ``lognum_fused_dd``, and the roofline probes of
:mod:`pymbar_tpu_torch.ops.roofline`)."""
