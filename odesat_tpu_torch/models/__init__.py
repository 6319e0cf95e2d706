"""Solver engines: the continuous-time ODE engine (``ode``) and its
chunked host loop (``loop``). The stochastic and hybrid engines are not
ported yet."""
