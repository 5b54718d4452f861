"""The HMC window's conditioner FLOPs (2x the forward a leapfrog step) over the TF32 peak, in %."""
from portbench.readers import mfu as read  # noqa: F401
