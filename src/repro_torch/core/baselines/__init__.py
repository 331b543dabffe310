"""Baselines from the paper's evaluation (Table 1): GRETA (non-shared online),
MCEP-style two-step construction, SHARON-style flattened sequences, plus a
brute-force trend enumeration oracle used by the tests.

Only GRETA runs on a device (the masked propagation kernel, by default);
brute, MCEP and SHARON are host numpy, as in the JAX package."""
