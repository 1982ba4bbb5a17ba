"""Images scored or served per second over the window (host clock)."""
from portbench.readers import images_per_s as read  # noqa: F401
