"""Device ms a whitening step outside B4/B5: Adam, the loss, the plan and autograd's glue."""
from portbench.readers import other_device_ms as read  # noqa: F401
