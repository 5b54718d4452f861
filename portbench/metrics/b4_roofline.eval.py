"""B4's share of its roofline in the evaluation calls, in %."""
from portbench.readers import b4_roofline as read  # noqa: F401
