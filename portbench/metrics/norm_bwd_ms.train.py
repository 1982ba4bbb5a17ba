"""Device ms per iteration inside the 18 norm sites' backward."""
from portbench.readers import norm_backward_ms as read  # noqa: F401
