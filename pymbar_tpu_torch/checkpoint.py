"""Checkpoint / warm-start helpers (PyTorch port).

The counterpart of :mod:`pymbar_tpu.checkpoint`, with the same ``.npz``
layout, so a file written by either package loads in the other.  The
reference has no built-in checkpointing; its idiom is warm-starting via
``initial_f_k``.  These helpers make that idiom durable: persist a
converged solve's state and rebuild an MBAR object from it without
re-solving from zeros.
"""

import numpy as np

__all__ = ["save_mbar", "load_mbar_state", "resume_mbar"]

_FORMAT_VERSION = 1


def save_mbar(mbar, path):
    """Persist the converged state of an MBAR object to ``path`` (.npz).

    Stores f_k, N_k, bootstrap free energies/resample indices when present,
    and shape metadata.  u_kn is NOT stored (it is the caller's input data).
    """
    payload = dict(
        format_version=np.int64(_FORMAT_VERSION),
        f_k=np.asarray(mbar.f_k),
        N_k=np.asarray(mbar.N_k),
        x_kindices=np.asarray(mbar.x_kindices),
        K=np.int64(mbar.K),
        N=np.int64(mbar.N),
    )
    if getattr(mbar, "n_bootstraps", 0):
        payload["f_k_boots"] = np.asarray(mbar.f_k_boots)
        payload["bootstrap_rints"] = np.asarray(mbar.bootstrap_rints)
    np.savez_compressed(path, **payload)


def load_mbar_state(path):
    """Load a saved MBAR state dict (arrays + metadata)."""
    with np.load(path) as data:
        state = {k: data[k] for k in data.files}
    if int(state["format_version"]) != _FORMAT_VERSION:
        raise ValueError(
            f"Unsupported checkpoint version {int(state['format_version'])}"
        )
    return state


def resume_mbar(path, u_kn, skip_solve=False, device=None, **mbar_kwargs):
    """Rebuild an MBAR object from a checkpoint, warm-started at the saved f_k.

    ``u_kn`` is a numpy array or a tensor and is placed as in
    :class:`pymbar_tpu_torch.MBAR` (``device``; a tensor keeps its own and
    is never copied to the host).  By default the solve re-runs from the
    saved point, so all derived state is consistent with the given
    ``u_kn``.  With ``skip_solve=True`` the saved f_k is trusted as it is
    and the object is built through :meth:`MBAR.from_solution` around the
    same tensor: no solver stage runs, and bootstrap options cannot be
    combined with it.
    """
    from pymbar_tpu_torch.mbar import MBAR

    state = load_mbar_state(path)
    # shape only: the matrix itself stays where it is
    if len(u_kn.shape) == 2 and u_kn.shape[0] != int(state["K"]):
        raise ValueError(
            f"u_kn has {u_kn.shape[0]} states but the checkpoint was "
            f"saved with K={int(state['K'])}"
        )

    if skip_solve:
        if mbar_kwargs.pop("n_bootstraps", 0):
            raise ValueError(
                "skip_solve=True cannot re-solve bootstrap replicates; "
                "resume without skip_solve for bootstrap uncertainties."
            )
        # from_solution runs no solver stage, so solver kwargs (valid on
        # the re-solve path) have nothing to act on: reject them up front
        # instead of letting from_solution raise a bare TypeError.
        allowed = {"rseed", "verbose"}
        bad = set(mbar_kwargs) - allowed
        if bad:
            raise TypeError(
                f"skip_solve=True accepts only {sorted(allowed)} as extra "
                f"MBAR kwargs (no solver runs); got {sorted(bad)}. Resume "
                "without skip_solve to pass solver options."
            )
        return MBAR.from_solution(
            u_kn, state["N_k"], state["f_k"],
            x_kindices=state["x_kindices"], device=device, **mbar_kwargs,
        )
    mbar_kwargs.setdefault("initial_f_k", state["f_k"])
    mbar_kwargs.setdefault("x_kindices", state["x_kindices"])
    return MBAR(u_kn, state["N_k"], device=device, **mbar_kwargs)
