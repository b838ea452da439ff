"""Exponential-distribution test case with analytic ground truth.

Capability parity with
pymbar 4.x testsystems/exponential_distributions.py:4-246.
U_k(x) = rate_k * x on x >= 0; f_k = ln(rate_k).
"""

import numpy as np

__all__ = ["ExponentialTestCase"]


class ExponentialTestCase:
    """K exponential distributions with the given rate parameters.

    Examples
    --------
    >>> testcase = ExponentialTestCase()
    >>> x_kn, u_kln, N_k = testcase.sample(seed=0)
    """

    def __init__(self, rates=(1, 2, 3, 4, 5), beta=1.0):
        rates = np.array(rates, np.float64)
        self.n_states = len(rates)
        self.rates = rates
        self.beta = beta

    def analytical_free_energies(self):
        """f_k = -ln Z_k = ln(rate_k)."""
        return np.log(self.rates)

    def analytical_means(self):
        return self.rates**-1.0

    def analytical_variances(self):
        return self.rates**-2.0

    def analytical_standard_deviations(self):
        return np.sqrt(self.rates**-2.0)

    def analytical_observable(self, observable="position"):
        if observable == "position":
            return self.analytical_means()
        if observable == "position^2":
            return 2.0 * self.analytical_variances()
        if observable == "RMS displacement":
            return self.analytical_variances()
        if observable == "potential energy":
            return np.ones(len(self.rates))
        raise ValueError(f"Unknown observable {observable!r}")

    def analytical_entropies(self):
        return (
            self.analytical_observable(observable="potential energy")
            - self.analytical_free_energies()
        )

    def analytical_x_squared(self):
        return self.analytical_variances() + self.analytical_means() ** 2.0

    def sample(self, N_k=(10, 20, 30, 40, 50), mode="u_kln", seed=None):
        """Draw exponential samples per state; modes as in HarmonicOscillatorsTestCase."""
        rng = np.random.RandomState(seed)

        N_k = np.array(N_k, np.int32)
        if len(N_k) != self.n_states:
            raise Exception(
                f"N_k has {len(N_k):d} states while self.n_states has "
                f"{self.n_states:d} states."
            )
        if mode == "wFwR" and len(N_k) != 2:
            raise Exception(
                f"N_k has {len(N_k):d} states instead of 2, we cannot "
                "generate forward and reverse work distributions"
            )

        N_max = int(N_k.max())
        N_tot = int(N_k.sum())

        x_kn = np.zeros([self.n_states, N_max], np.float64)
        u_kln = np.zeros([self.n_states, self.n_states, N_max], np.float64)
        x_n = np.zeros([N_tot], np.float64)
        s_n = np.zeros([N_tot], int)
        u_kn = np.zeros([self.n_states, N_tot], np.float64)

        index = 0
        for k, N in enumerate(N_k):
            x = rng.exponential(scale=self.rates[k] ** -1.0, size=N)
            x_kn[k, 0:N] = x
            x_n[index : index + N] = x
            s_n[index : index + N] = k
            u = self.beta * self.rates[:, None] * x[None, :]
            u_kln[k, :, 0:N] = u
            u_kn[:, index : index + N] = u
            index += N

        if mode == "u_kn":
            return x_n, u_kn, N_k, s_n
        if mode == "u_kln":
            return x_kn, u_kln, N_k
        if mode == "wFwR":
            return (
                u_kln[0, 1, : N_k[0]] - u_kln[0, 0, : N_k[0]],
                u_kln[1, 0, : N_k[1]] - u_kln[1, 1, : N_k[1]],
                N_k,
            )
        raise Exception(f"Unknown mode '{mode}'")

    @classmethod
    def evenly_spaced_exponentials(
        cls, n_states, n_samples_per_state, lower_rate=1.0, upper_rate=3.0, seed=None
    ):
        """Evenly spaced exponentials factory."""
        name = f"{n_states:d}x{n_samples_per_state:d} exponentials"
        rates = np.linspace(lower_rate, upper_rate, n_states)
        N_k = (np.ones(n_states) * n_samples_per_state).astype("int")
        testsystem = cls(rates)
        x_n, u_kn, N_k_output, s_n = testsystem.sample(N_k, mode="u_kn", seed=seed)
        return name, testsystem, x_n, u_kn, N_k_output, s_n
