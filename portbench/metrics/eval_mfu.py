"""The evaluation window's conditioner FLOPs (the forward) over the TF32 peak, in %."""
from portbench.readers import mfu as read  # noqa: F401
