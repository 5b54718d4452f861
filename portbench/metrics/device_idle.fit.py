"""Share of the traced whitening window with the device idle, in %."""
from portbench.readers import idle_pct as read  # noqa: F401
