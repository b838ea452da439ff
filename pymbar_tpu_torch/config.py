"""Build configuration of pymbar_tpu_torch, read from the environment.

The counterpart of :mod:`pymbar_tpu.config`.  Importing this module reads
nothing and changes nothing: each toggle is read when its function is
called.

Environment variables
---------------------
``PYMBAR_TPU_TORCH_CACHE_DIR``
    Where the CUDA kernels are built and loaded from (:func:`build_dir`;
    default ``pymbar_tpu_torch/_build/``), the analog of
    ``PYMBAR_TPU_CACHE_DIR``.
``PYMBAR_TPU_TORCH_DEVICE``
    The process default device (:func:`default_device`), the counterpart
    of the JAX package's platform choice (``JAX_PLATFORMS=cpu``): where an
    entry point puts numpy input when the call names no ``device``
    (:func:`target_device`).  Unset or empty: the CUDA card, and without
    one the call raises.  Set: a ``torch.device`` string ("cpu", "cuda",
    "cuda:1"); an explicit ``device=`` still wins.  Nothing runs on the
    CPU unless the caller named it, here or in ``device=``.

The JAX package's other toggles have no counterpart here:

- its x64 switch (``jax_enable_x64``): torch has float64 without one;
- ``PYMBAR_TPU_DISABLE_X64`` and ``PYMBAR_TPU_FORCE_DTYPE``: the port
  computes in the dtype of the ``u_kn`` it is given, and its routes pick
  their own precision (float32 planes with float64 sums on the card), so a
  working-dtype toggle would change no computation;
- ``on_tpu()``: an entry point places numpy input on :func:`target_device`
  (the card unless ``device=`` or ``PYMBAR_TPU_TORCH_DEVICE`` names another
  device), a tensor stays where it lies, and a wrapper launches its kernel
  when its tensor lies on the card;
- ``PYMBAR_TPU_NO_COMPILE_CACHE``: a kernel is loaded only from its stored
  build, so there is no cache to opt out of.
"""

import os
from pathlib import Path

import torch

from pymbar_tpu_torch.utils import ParameterError

__all__ = ["build_dir", "default_device", "target_device"]

_DEFAULT_BUILD_DIR = Path(__file__).resolve().parent / "_build"


def build_dir():
    """The directory of the built CUDA kernels: ``PYMBAR_TPU_TORCH_CACHE_DIR``
    when set, else ``pymbar_tpu_torch/_build/``."""
    return Path(os.environ.get("PYMBAR_TPU_TORCH_CACHE_DIR") or _DEFAULT_BUILD_DIR)


def default_device():
    """``PYMBAR_TPU_TORCH_DEVICE`` as a ``torch.device``, or None when it is
    unset or empty.  A value that is no device raises
    :class:`ParameterError` naming the variable."""
    value = os.environ.get("PYMBAR_TPU_TORCH_DEVICE", "").strip()
    if not value:
        return None
    try:
        return torch.device(value)
    except (RuntimeError, ValueError) as exc:
        raise ParameterError(
            f"PYMBAR_TPU_TORCH_DEVICE={value!r} is not a torch device "
            '(e.g. "cpu", "cuda", "cuda:1")'
        ) from exc


def target_device(device=None):
    """Where an entry point places a numpy input: ``device`` when given,
    else :func:`default_device`, else the CUDA card.  Without a card, when
    neither names a non-CUDA device, it raises :class:`ParameterError`:
    nothing falls back to the CPU unasked."""
    if device is None:
        device = default_device()
    if device is not None and torch.device(device).type != "cuda":
        return torch.device(device)
    if not torch.cuda.is_available():
        raise ParameterError(
            'no CUDA device is available: pass device="cpu" or set '
            "PYMBAR_TPU_TORCH_DEVICE=cpu to run on the CPU"
        )
    return torch.device("cuda") if device is None else torch.device(device)
