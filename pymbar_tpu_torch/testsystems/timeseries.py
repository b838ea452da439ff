"""AR(1) correlated-timeseries generator with known correlation time.

Capability parity with pymbar 4.x testsystems/timeseries.py:4-74
(Janke Eq. 41).  The reference evaluates the AR(1) recursion in a Python
loop; here it runs through scipy.signal.lfilter (the exact same recursion,
evaluated in compiled code).
"""

import numpy as np
import scipy.signal

__all__ = ["correlated_timeseries_example"]


def correlated_timeseries_example(N=10000, tau=5.0, seed=None):
    """Synthetic AR(1) series with true tau_int = (1/2)(1+rho)/(1-rho), rho=e^(-1/tau).

    Examples
    --------
    >>> A_t = correlated_timeseries_example(N=10000, tau=10.0)
    >>> A_t = correlated_timeseries_example(N=1000, tau=1.0)
    >>> A_t = correlated_timeseries_example(N=1000, tau=2000.0)
    """
    random = np.random.RandomState(seed)

    rho = np.exp(-1.0 / tau)
    sigma = np.sqrt(1.0 - rho * rho)

    e_n = random.randn(N)

    # A_n = rho * A_{n-1} + sigma * e_n, with A_0 = e_0.
    x = sigma * e_n
    x[0] = e_n[0]
    A_n = scipy.signal.lfilter([1.0], [1.0, -rho], x)

    return A_n.astype(np.float32)
