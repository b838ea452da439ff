"""Build configuration of pymbar_tpu_torch, read from the environment.

The counterpart of :mod:`pymbar_tpu.config`.  Importing this module reads
nothing and changes nothing: the toggle is read when its function is
called.

Environment variables
---------------------
``PYMBAR_TPU_TORCH_CACHE_DIR``
    Where the CUDA kernels are built and loaded from (:func:`build_dir`;
    default ``pymbar_tpu_torch/_build/``), the analog of
    ``PYMBAR_TPU_CACHE_DIR``.

The JAX package's other toggles have no counterpart here:

- its x64 switch (``jax_enable_x64``): torch has float64 without one;
- ``PYMBAR_TPU_DISABLE_X64`` and ``PYMBAR_TPU_FORCE_DTYPE``: the port
  computes in the dtype of the ``u_kn`` it is given, and its routes pick
  their own precision (float32 planes with float64 sums on the card), so a
  working-dtype toggle would change no computation;
- ``on_tpu()``: an entry point places its data on the card unless the caller
  passes ``device="cpu"`` (:func:`pymbar_tpu_torch.solvers.target_device`),
  and a wrapper launches its kernel when its tensor lies on the card;
- ``PYMBAR_TPU_NO_COMPILE_CACHE``: a kernel is loaded only from its stored
  build, so there is no cache to opt out of.
"""

import os
from pathlib import Path

__all__ = ["build_dir"]

_DEFAULT_BUILD_DIR = Path(__file__).resolve().parent / "_build"


def build_dir():
    """The directory of the built CUDA kernels: ``PYMBAR_TPU_TORCH_CACHE_DIR``
    when set, else ``pymbar_tpu_torch/_build/``."""
    return Path(os.environ.get("PYMBAR_TPU_TORCH_CACHE_DIR") or _DEFAULT_BUILD_DIR)
