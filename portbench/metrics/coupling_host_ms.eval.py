"""Host ms an evaluation call in the program's B4 range (ops/coupling.py)."""
from portbench.readers import coupling_host_ms as read  # noqa: F401
