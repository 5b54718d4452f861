"""Device busy ms a leapfrog step of all chains (the graphed density and HMC's own ops)."""
from portbench.readers import busy_ms_per_step as read  # noqa: F401
