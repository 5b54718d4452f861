"""Host ms a whitening step in the program's B4/B5 ranges (ops/coupling.py)."""
from portbench.readers import coupling_host_ms as read  # noqa: F401
