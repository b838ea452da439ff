"""Forward/reverse Gaussian work distributions obeying Crooks.

Capability parity with pymbar 4.x testsystems/gaussian_work.py:4-105.
mu_F and DeltaF are linked by the Zwanzig relation: DeltaF = mu_F - sigma_F^2/2.
"""

import numpy as np

__all__ = ["gaussian_work_example"]


def gaussian_work_example(N_F=200, N_R=200, mu_F=2.0, DeltaF=None, sigma_F=1.0, seed=None):
    """Sample Gaussian forward/reverse work values consistent with the CFT.

    Exactly one of mu_F / DeltaF must be given.  The reverse distribution has
    mu_R = -mu_F + sigma_F^2 and sigma_R = sigma_F exp(mu_F - sigma_F^2/2 - DeltaF).

    Examples
    --------
    >>> w_F, w_R = gaussian_work_example(seed=0)
    """
    if (mu_F is not None) and (DeltaF is not None):
        raise ValueError(
            "mu_F and DeltaF are not independent, and cannot both be "
            "specified; one must be set to None."
        )
    if (mu_F is None) and (DeltaF is None):
        raise ValueError("Either mu_F or DeltaF must be specified.")
    if mu_F is None:
        mu_F = DeltaF + sigma_F**2 / 2.0
    if DeltaF is None:
        DeltaF = mu_F - sigma_F**2 / 2.0

    random = np.random.RandomState(seed)

    mu_R = -mu_F + sigma_F**2
    sigma_R = sigma_F * np.exp(mu_F - sigma_F**2 / 2.0 - DeltaF)

    w_F = random.randn(N_F) * sigma_F + mu_F
    w_R = random.randn(N_R) * sigma_R + mu_R

    return [w_F, w_R]
