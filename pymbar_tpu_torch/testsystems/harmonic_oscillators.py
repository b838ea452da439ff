"""Harmonic-oscillator test case with analytic ground truth.

Capability parity with
pymbar 4.x testsystems/harmonic_oscillators.py:4-261.
U_k(x) = (K_k/2)(x - O_k)^2; the dimensionless free energy is
f_k = -(1/2) ln[2 pi / (beta K_k)].
"""

import numpy as np

__all__ = ["HarmonicOscillatorsTestCase"]


class HarmonicOscillatorsTestCase:
    """K harmonic oscillators with offsets O_k and force constants K_k.

    Examples
    --------
    >>> testcase = HarmonicOscillatorsTestCase()
    >>> x_n, u_kn, N_k, s_n = testcase.sample(seed=0)
    >>> f_k = testcase.analytical_free_energies()
    """

    def __init__(self, O_k=(0, 1, 2, 3, 4), K_k=(1, 2, 4, 8, 16), beta=1.0):
        self.beta = beta
        self.O_k = np.array(O_k, np.float64)
        self.n_states = len(self.O_k)
        self.K_k = np.array(K_k, np.float64)
        if len(self.K_k) != self.n_states:
            raise ValueError(
                f"Lengths of K_k={len(self.K_k)} and O_k={len(self.O_k)} "
                "should be equal"
            )

    def analytical_means(self):
        return self.O_k

    def analytical_variances(self):
        return (self.beta * self.K_k) ** -1.0

    def analytical_standard_deviations(self):
        return (self.beta * self.K_k) ** -0.5

    def analytical_observable(self, observable="position"):
        if observable == "position":
            return self.analytical_means()
        if observable == "potential energy":
            return (0.5 / self.beta) * np.ones(self.n_states)
        if observable == "position^2":
            return 1.0 / (self.beta * self.K_k) + np.square(self.O_k)
        if observable == "RMS displacement":
            return self.analytical_standard_deviations()
        raise ValueError(f"Unknown observable {observable!r}")

    def analytical_free_energies(self, subtract_component=0):
        fe = -0.5 * np.log(2 * np.pi / (self.beta * self.K_k))
        if subtract_component is not None:
            fe -= fe[subtract_component]
        return fe

    def analytical_entropies(self, subtract_component=0):
        return self.analytical_observable(
            observable="potential energy"
        ) - self.analytical_free_energies(subtract_component)

    def sample(self, N_k=(10, 20, 30, 40, 50), mode="u_kn", seed=None):
        """Draw N_k[k] Gaussian samples per state and evaluate all potentials.

        mode='u_kn'  -> (x_n, u_kn, N_k, s_n) in concatenated sample layout
        mode='u_kln' -> (x_kn, u_kln, N_k) in padded per-origin layout
        mode='wFwR'  -> (w_F, w_R, N_k) forward/reverse work (requires K=2)
        """
        rng = np.random.RandomState(seed)

        N_k = np.array(N_k, int)
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
            sigma = (self.beta * self.K_k[k]) ** -0.5
            x = rng.normal(loc=self.O_k[k], scale=sigma, size=N)
            x_kn[k, 0:N] = x
            x_n[index : index + N] = x
            s_n[index : index + N] = k
            # All L potentials evaluated on this state's samples at once.
            u = self.beta * 0.5 * self.K_k[:, None] * (x[None, :] - self.O_k[:, None]) ** 2
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
    def evenly_spaced_oscillators(
        cls,
        n_states,
        n_samples_per_state,
        lower_O_k=1.0,
        upper_O_k=5.0,
        lower_k_k=1.0,
        upper_k_k=3.0,
        seed=None,
    ):
        """Evenly spaced oscillators factory.

        Note: the reference version references an undefined ``seed``
        (harmonic_oscillators.py:259); here it is an explicit parameter.
        """
        name = f"{n_states:d}x{n_samples_per_state:d} oscillators"

        O_k = np.linspace(lower_O_k, upper_O_k, n_states)
        k_k = np.linspace(lower_k_k, upper_k_k, n_states)
        N_k = (np.ones(n_states) * n_samples_per_state).astype("int")

        testsystem = cls(O_k, k_k)
        x_n, u_kn, N_k_output, s_n = testsystem.sample(N_k, mode="u_kn", seed=seed)

        return name, testsystem, x_n, u_kn, N_k_output, s_n
