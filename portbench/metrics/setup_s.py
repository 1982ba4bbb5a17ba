"""Seconds from the process's start to the window: loading, weights,
build, warm-up."""
from portbench.readers import setup_s as read  # noqa: F401
