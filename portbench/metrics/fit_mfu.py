"""The whitening window's conditioner FLOPs (3x the forward a step) over the TF32 peak, in %."""
from portbench.readers import mfu as read  # noqa: F401
