"""ODE constants of the digital-memcomputing dynamical system.

Values match the reference solver (reference: src/system.rs:19-23) and the
Bearden/Pei/Di Ventra paper (arXiv:2011.06551).
"""

ALPHA = 5.0  # long-term memory growth rate
BETA = 20.0  # short-term memory rate
GAMMA = 0.25  # clause satisfaction threshold for short-term memory / allsat
DELTA = 0.05  # long-term memory threshold
EPSILON = 1e-3  # short-term memory clamp margin

# Long-term memory upper clamp is 1e4 * n_clauses (reference: src/system.rs:95).
XL_CAP_PER_CLAUSE = 1e4

# Adaptive step-size bounds (reference: src/system.rs:132-135).
DT_MIN = 2.0**-7
DT_MAX = 1e3
DT_INIT = 0.01  # initial adaptive dt (reference: src/system.rs:205)
DEFAULT_TOLERANCE = 1e-3  # reference: src/system.rs:174

# Stochastic engine clause-weight increment (reference: src/stoch.rs:18).
STOCH_ALPHA = 20
