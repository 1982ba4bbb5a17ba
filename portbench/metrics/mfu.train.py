"""Model FLOPs of the window's iterations (the reference's count) per
second of the window, % of the card's peak."""
from portbench.readers import mfu as read  # noqa: F401
