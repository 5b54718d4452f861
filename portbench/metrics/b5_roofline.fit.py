"""B5's share of its roofline in the whitening step's launches, in %."""
from portbench.readers import b5_roofline as read  # noqa: F401
