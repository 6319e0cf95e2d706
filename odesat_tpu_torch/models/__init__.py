"""Solver engines: the continuous-time ODE engine (``ode``), the
stochastic engine (``stoch``), the hybrid portfolio racing both
(``hybrid``) and their chunked host loop (``loop``)."""
